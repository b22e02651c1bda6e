"""Forward pair compositor: the CUDA kernel's wrapper and its plain version.

`fwd_call_pairs` replaces `fwd_call_pairs` of the JAX package
(`gaussianavatars_tpu/ops/pallas/composite_pairs.py:913`), whose Pallas
kernel `_fwd_kernel_pairs_v3` becomes `csrc/composite_pairs_fwd.cu`. Same
signature and outputs: acc [NT, 3, P] premultiplied colour, t_final [NT, P]
and stop [NT, P] in the TPU kernel's window-local ids (segment index +
starts % 128; STOP_NEVER for pixels that never stopped).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs `fwd_call_pairs_reference`, the plain PyTorch version. There is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import cuda_build
from .rasterize_dense import ALPHA_CUTOFF, ALPHA_MAX, T_EPS

STOP_NEVER = 0x3FFFFFFF
MAX_TILE_PIXELS = 1024  # one thread per pixel, one block per tile
_KERNEL = "composite_pairs_fwd"


def _check(dataT, starts, counts, th, tw):
    if dataT.dtype != torch.float32 or dataT.dim() != 2 or dataT.shape[0] != 16:
        raise ValueError(f"dataT must be float32 [16, M], got {dataT.dtype} {tuple(dataT.shape)}")
    for name, x in (("starts", starts), ("counts", counts)):
        if x.dtype != torch.int32 or x.dim() != 1:
            raise ValueError(f"{name} must be int32 [NT], got {x.dtype} {tuple(x.shape)}")
        if x.device != dataT.device:
            raise ValueError(f"{name} is on {x.device}, dataT on {dataT.device}")
    if starts.shape != counts.shape:
        raise ValueError("starts and counts must have the same shape")
    if th <= 0 or tw <= 0:
        raise ValueError(f"bad tile shape {th}x{tw}")


@functools.cache
def _kernel_fn():
    """The C entry point, built and loaded at first use, with its signature."""
    fn = cuda_build.load(_KERNEL).composite_pairs_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return fn


def _launch_cuda(dataT, starts, counts, th, tw, ntx):
    p = th * tw
    if p > MAX_TILE_PIXELS:
        raise ValueError(f"tile of {p} pixels exceeds the kernel's {MAX_TILE_PIXELS}")
    if not (dataT.is_contiguous() and starts.is_contiguous() and counts.is_contiguous()):
        raise ValueError("dataT, starts and counts must be contiguous")
    fn = _kernel_fn()
    nt = starts.shape[0]
    dev = dataT.device
    acc = torch.empty((nt, 3, p), dtype=torch.float32, device=dev)
    t_final = torch.empty((nt, p), dtype=torch.float32, device=dev)
    stop = torch.empty((nt, p), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(dataT.data_ptr(), dataT.stride(0), starts.data_ptr(), counts.data_ptr(),
                 nt, th, tw, ntx, acc.data_ptr(), t_final.data_ptr(), stop.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed with CUDA error {err}")
    fwd_call_pairs.launches += 1
    return acc, t_final, stop


def fwd_call_pairs(dataT, starts, counts, th: int, tw: int, ntx: int):
    """Run the forward pair compositor.

    dataT: [16, M] float32 param-major pair table; starts, counts: [NT]
    int32 segment bounds per tile. Returns (acc [NT, 3, P], t_final [NT, P],
    stop [NT, P] int32).
    """
    _check(dataT, starts, counts, th, tw)
    if dataT.device.type == "cuda":
        return _launch_cuda(dataT, starts, counts, th, tw, ntx)
    if dataT.device.type != "cpu":
        raise ValueError(f"no compositor for device {dataT.device}")
    return fwd_call_pairs_reference(dataT, starts, counts, th, tw, ntx)


fwd_call_pairs.launches = 0  # kernel launches, for callers to check the path


def fwd_call_pairs_reference(dataT, starts, counts, th: int, tw: int, ntx: int):
    """Plain PyTorch version of the kernel: same outputs, stop ids included.

    Walks slot s = 0, 1, ... of every tile's segment at once, with the
    kernel's per-pixel arithmetic in the same order.
    """
    nt = starts.shape[0]
    p = th * tw
    dev = dataT.device
    f32 = torch.float32
    lin = torch.arange(p, device=dev)
    tiles = torch.arange(nt, device=dev)
    px = (lin % tw).to(f32)[None, :] + ((tiles % ntx) * tw).to(f32)[:, None]
    py = (lin // tw).to(f32)[None, :] + ((tiles // ntx) * th).to(f32)[:, None]

    T = torch.ones((nt, p), dtype=f32, device=dev)
    acc = torch.zeros((nt, 3, p), dtype=f32, device=dev)
    stop = torch.full((nt, p), STOP_NEVER, dtype=torch.int32, device=dev)
    head = (starts % 128)[:, None]
    last = dataT.shape[1] - 1
    max_count = int(counts.max()) if nt else 0
    for s in range(max_count):
        if s % 64 == 0 and s and not ((stop == STOP_NEVER) & (counts > s)[:, None]).any():
            break
        live = (counts > s)[:, None]
        d = dataT[:9, torch.clamp_max(starts.long() + s, last)]    # [9, NT]
        mx, my, a, b, c, _r, _g, _b, op = (x[:, None] for x in d)
        dx = px - mx
        dy = py - my
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
        use = (power <= 0.0) & (alpha >= ALPHA_CUTOFF) & live & (stop == STOP_NEVER)
        test_t = T * (1.0 - alpha)
        ok = test_t >= T_EPS
        stop = torch.where(use & ~ok, (head + s).to(torch.int32), stop)
        contrib = use & ok
        w = torch.where(contrib, alpha * T, torch.zeros_like(T))
        acc = acc + w[:, None, :] * d[5:8].T[:, :, None]
        T = torch.where(contrib, test_t, T)
    return acc, T, stop
