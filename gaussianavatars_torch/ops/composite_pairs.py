"""Pair compositor, forward and backward: the CUDA kernels' wrappers and
their plain versions.

`fwd_call_pairs` replaces `fwd_call_pairs` of the JAX package
(`gaussianavatars_tpu/ops/pallas/composite_pairs.py:913`). Same signature
and outputs: acc [NT, 3, P] premultiplied colour, t_final [NT, P] and stop
[NT, P] in the TPU kernel's window-local ids (segment index + starts % 128;
STOP_NEVER for pixels that never stopped).

`bwd_call_pairs` replaces the JAX `bwd_call_pairs` (`:947`): the pair-major
gradient table of the forward, every slot the walk never reaches exact
zeros; `amp=True` is the TPU kernels' bf16 contraction (`:684-685`,
`:790-798`).

The pair table has 9 rows (mx, my, conic a/b/c, r, g, b, opacity), as the
port's `sort_gather` builds it, or 16, as the JAX package pads it for the
TPU's 8-row tiles. Both wrappers and their plain versions read rows 0..8
of either; the gradient has the table's shape, rows 9..15 of a 16-row
table exact zeros.

Each Pallas kernel of the JAX module has its CUDA kernel under `csrc/`,
chosen by the implementation switch `_FWD_IMPL`/`_BWD_IMPL`, as in the JAX
module (`:888-891`):

    "v2"  `_fwd_kernel_pairs_v2` → composite_pairs_fwd_v2.cu
          `_bwd_kernel_pairs_v2` → composite_pairs_bwd_v2.cu
    "v3"  `_fwd_kernel_pairs_v3` → composite_pairs_fwd.cu
          `_bwd_kernel_pairs_v3` → composite_pairs_bwd.cu
    "v4"  the v3 forward (`:885`)
          `_bwd_kernel_pairs_v4` → composite_pairs_bwd.cu (`gc_vpu`)

The switch is flipped only by the A/B entry point (`tools/kernel_ab.py`)
and by tests: it is no configuration knob. All implementations compute the
same function, so one plain version serves them all.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain PyTorch version (`*_reference`). There is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import cuda_build
from ..utils import profiling
from .rasterize_dense import ALPHA_CUTOFF, ALPHA_MAX, T_EPS

STOP_NEVER = 0x3FFFFFFF
MAX_TILE_PIXELS = 1024  # 4 pixels a thread, at most 8 warps a tile

# The implementation switch (see the module docstring).
_FWD_IMPL = "v3"
_BWD_IMPL = "v3"
IMPLS = ("v2", "v3", "v4")

# Kernel launches per C entry point, for callers to check which kernel ran.
LAUNCHES = profiling.counter("composite_pairs", (
    "composite_pairs_fwd", "composite_pairs_fwd_v2",
    "composite_pairs_bwd", "composite_pairs_bwd_amp",
    "composite_pairs_bwd_v2", "composite_pairs_bwd_v2_amp",
    "composite_pairs_bwd_v4", "composite_pairs_bwd_v4_amp",
))


def fwd_entry(impl: str) -> tuple[str, str]:
    """(source under csrc/, C entry point) of forward implementation `impl`."""
    if impl == "v2":
        return "composite_pairs_fwd_v2", "composite_pairs_fwd_v2"
    if impl in ("v3", "v4"):
        return "composite_pairs_fwd", "composite_pairs_fwd"
    raise ValueError(f"unknown forward implementation {impl!r}; expected one of {IMPLS}")


def bwd_entry(impl: str, amp: bool) -> tuple[str, str]:
    """(source under csrc/, C entry point) of backward implementation `impl`
    in float32 or `amp` mode."""
    entries = {"v2": ("composite_pairs_bwd_v2", "composite_pairs_bwd_v2"),
               "v3": ("composite_pairs_bwd", "composite_pairs_bwd"),
               "v4": ("composite_pairs_bwd", "composite_pairs_bwd_v4")}
    if impl not in entries:
        raise ValueError(f"unknown backward implementation {impl!r}; expected one of {IMPLS}")
    lib, sym = entries[impl]
    return lib, sym + ("_amp" if amp else "")


def _check(dataT, starts, counts, th, tw):
    if dataT.dtype != torch.float32 or dataT.dim() != 2 or dataT.shape[0] not in (9, 16):
        raise ValueError(f"dataT must be float32 [9, M] or [16, M], got {dataT.dtype} "
                         f"{tuple(dataT.shape)}")
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
def _fwd_kernel_fn(lib: str, sym: str):
    """A forward C entry point, built and loaded at first use, with its signature."""
    fn = getattr(cuda_build.load(lib), sym)
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return fn


def _fwd_output(dataT, starts, th, tw):
    """The forward kernel's three outputs (acc [NT, 3, P], t_final [NT, P],
    stop [NT, P] int32), uninitialised: the kernel writes every element."""
    nt, p, dev = starts.shape[0], th * tw, dataT.device
    return (torch.empty((nt, 3, p), dtype=torch.float32, device=dev),
            torch.empty((nt, p), dtype=torch.float32, device=dev),
            torch.empty((nt, p), dtype=torch.int32, device=dev))


def _launch_fwd_cuda(out, dataT, starts, counts, th, tw, ntx):
    """Launch the `_FWD_IMPL` forward kernel into `out` (as `_fwd_output`
    makes it)."""
    entry = fwd_entry(_FWD_IMPL)
    if th * tw > MAX_TILE_PIXELS or tw % 4:
        raise ValueError(f"tile {th}x{tw}: the kernel takes up to {MAX_TILE_PIXELS} pixels "
                         "in rows of a multiple of 4")
    if not (dataT.is_contiguous() and starts.is_contiguous() and counts.is_contiguous()):
        raise ValueError("dataT, starts and counts must be contiguous")
    fn = _fwd_kernel_fn(*entry)
    acc, t_final, stop = out
    with torch.cuda.device(dataT.device):
        stream = torch.cuda.current_stream(dataT.device).cuda_stream
        err = fn(dataT.data_ptr(), dataT.stride(0), starts.data_ptr(), counts.data_ptr(),
                 starts.shape[0], th, tw, ntx, acc.data_ptr(), t_final.data_ptr(),
                 stop.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{entry[1]} launch failed with CUDA error {err}")
    LAUNCHES[entry[1]] += 1


def fwd_call_pairs(dataT, starts, counts, th: int, tw: int, ntx: int):
    """Run the forward pair compositor (the `_FWD_IMPL` kernel).

    dataT: [9, M] or [16, M] float32 param-major pair table (rows 0..8
    read); starts, counts: [NT] int32 segment bounds per tile. Returns
    (acc [NT, 3, P], t_final [NT, P], stop [NT, P] int32).
    """
    fwd_entry(_FWD_IMPL)
    _check(dataT, starts, counts, th, tw)
    if dataT.device.type == "cuda":
        out = _fwd_output(dataT, starts, th, tw)
        _launch_fwd_cuda(out, dataT, starts, counts, th, tw, ntx)
        return out
    if dataT.device.type != "cpu":
        raise ValueError(f"no compositor for device {dataT.device}")
    return fwd_call_pairs_reference(dataT, starts, counts, th, tw, ntx)



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


def _check_bwd(dataT, starts, counts, acc, t_final, stop, g_acc_t, g_t, th, tw):
    _check(dataT, starts, counts, th, tw)
    nt, p = starts.shape[0], th * tw
    shapes = {
        "acc": (acc, torch.float32, (nt, 3, p)),
        "t_final": (t_final, torch.float32, (nt, p)),
        "stop": (stop, torch.int32, (nt, p)),
        "g_acc_t": (g_acc_t, torch.float32, (nt, p, 3)),
        "g_t": (g_t, torch.float32, (nt, p)),
    }
    for name, (x, dtype, shape) in shapes.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got {x.dtype} {tuple(x.shape)}")
        if x.device != dataT.device:
            raise ValueError(f"{name} is on {x.device}, dataT on {dataT.device}")


@functools.cache
def _bwd_kernel_fn(lib: str, sym: str):
    """A backward C entry point, built and loaded at first use, with its signature."""
    fn = getattr(cuda_build.load(lib), sym)
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    return fn


def _bwd_output(dataT, starts):
    """The backward kernel's output, dataT's shape. Every implementation's
    kernel writes rows 0..8 of every column, zeros included, which takes
    segments that tile [0, total) in tile order (as `segment_bounds` makes
    them); rows 9..15 of a 16-row table, and the whole output when there
    is no tile to launch, are zero-filled here."""
    if starts.shape[0] == 0:
        return torch.zeros_like(dataT)
    dgrad = torch.empty_like(dataT)
    dgrad[9:].zero_()
    return dgrad


def _launch_bwd_cuda(dgrad, dataT, starts, counts, acc, t_final, stop, g_acc_t, g_t,
                     th, tw, ntx, amp: bool = False):
    """Launch the `_BWD_IMPL` backward kernel into `dgrad` (dataT's shape and
    dtype, as `_bwd_output` makes it)."""
    entry = bwd_entry(_BWD_IMPL, amp)
    p = th * tw
    if p > MAX_TILE_PIXELS or p % 32:
        raise ValueError(f"tile of {p} pixels: the kernel takes a multiple of 32 up to "
                         f"{MAX_TILE_PIXELS}")
    args = (dataT, starts, counts, acc, t_final, stop, g_acc_t, g_t)
    if not all(x.is_contiguous() for x in args):
        raise ValueError("bwd_call_pairs takes contiguous tensors")
    fn = _bwd_kernel_fn(*entry)
    with torch.cuda.device(dataT.device):
        stream = torch.cuda.current_stream(dataT.device).cuda_stream
        err = fn(dataT.data_ptr(), dataT.stride(0), starts.data_ptr(), counts.data_ptr(),
                 acc.data_ptr(), t_final.data_ptr(), stop.data_ptr(), g_acc_t.data_ptr(),
                 g_t.data_ptr(), starts.shape[0], th, tw, ntx, dgrad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{entry[1]} launch failed with CUDA error {err}")
    LAUNCHES[entry[1]] += 1


def bwd_call_pairs(dataT, starts, counts, acc, t_final, stop, g_acc_t, g_t,
                   th: int, tw: int, ntx: int, amp: bool = False):
    """Run the backward pair compositor (the `_BWD_IMPL` kernel).

    dataT, starts, counts: the forward's inputs; acc [NT, 3, P], t_final
    [NT, P], stop [NT, P]: its outputs; g_acc_t [NT, P, 3] (pixel-major)
    and g_t [NT, P]: the cotangents of acc and t_final. starts and counts
    are `segment_bounds`' (the segments tile [0, total) in tile order).
    Returns the pair-major gradient table, float32 of dataT's shape (9 or
    16 rows): rows d mx, d my, d conic a/b/c, d rgb, d opacity; rows 9..15
    of a 16-row table and slots no walk reaches exact zeros. `amp`: the
    per-pair sums take bf16-rounded operands (see
    `bwd_call_pairs_reference`).
    """
    bwd_entry(_BWD_IMPL, amp)
    _check_bwd(dataT, starts, counts, acc, t_final, stop, g_acc_t, g_t, th, tw)
    if dataT.device.type == "cuda":
        dgrad = _bwd_output(dataT, starts)
        _launch_bwd_cuda(dgrad, dataT, starts, counts, acc, t_final, stop, g_acc_t, g_t,
                         th, tw, ntx, amp)
        return dgrad
    if dataT.device.type != "cpu":
        raise ValueError(f"no compositor for device {dataT.device}")
    return bwd_call_pairs_reference(dataT, starts, counts, acc, t_final, stop, g_acc_t, g_t,
                                    th, tw, ntx, amp)



def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest bfloat16, kept as float32."""
    return x.to(torch.bfloat16).float()


def bwd_call_pairs_reference(dataT, starts, counts, acc, t_final, stop, g_acc_t, g_t,
                             th: int, tw: int, ntx: int, amp: bool = False):
    """Plain PyTorch version of the backward kernels.

    Walks slot s = 0, 1, ... of every tile's segment at once, up to the
    tile's `needed` horizon, with the kernels' per-pixel arithmetic in the
    same order (tile-local coordinates, the G − prefix form), and sums each
    slot's nine values over the tile's pixels.

    `amp` follows the TPU kernels' bf16 contraction (`composite_pairs.py:684-685`,
    `:790-798`): its left operand (d_p and w) and its right operand (the
    moment basis {1, x, y, x², xy, y²} and the three g_acc channels) are
    rounded to bf16; the products of two bf16 values are exact in float32,
    and the sums, gc, G, the T and q chains and all that follows the sums
    stay float32. At 32×32 tiles the basis itself rounds (x² = 961 → 960).
    """
    nt = starts.shape[0]
    p = th * tw
    dev = dataT.device
    f32 = torch.float32
    lin = torch.arange(p, device=dev)
    x = (lin % tw).to(f32)
    y = (lin // tw).to(f32)
    basis = torch.stack([torch.ones_like(x), x, y, x * x, x * y, y * y])   # [6, P]
    tiles = torch.arange(nt, device=dev)
    x0 = ((tiles % ntx) * tw).to(f32)[:, None]
    y0 = ((tiles // ntx) * th).to(f32)[:, None]

    g = g_acc_t.permute(0, 2, 1)                                          # [NT, 3, P]
    g0, g1, g2 = g[:, 0], g[:, 1], g[:, 2]
    # The contraction's right operand: the basis and g_c.
    basis, right_g = (_bf16(basis), _bf16(g)) if amp else (basis, g)
    big_g = g_t * t_final + g0 * acc[:, 0] + g1 * acc[:, 1] + g2 * acc[:, 2]
    head = (starts % 128).long()
    needed = torch.minimum(counts.long(), stop.long().max(dim=1).values - head + 1)

    dgrad = torch.zeros_like(dataT)
    T = torch.ones((nt, p), dtype=f32, device=dev)
    qsum = torch.zeros((nt, p), dtype=f32, device=dev)
    last = dataT.shape[1] - 1
    n_slots = int(needed.max()) if nt else 0
    for s in range(n_slots):
        live = needed > s                                                 # [NT]
        cols = torch.clamp_max(starts.long() + s, last)
        d = dataT[:9, cols]                                               # [9, NT]
        mx, my, ca, cb, cc, r, gg, b, op = (v[:, None] for v in d)
        mxl = mx - x0
        myl = my - y0
        dx = x[None] - mxl
        dy = y[None] - myl
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
        contrib = ((power <= 0.0) & (alpha >= ALPHA_CUTOFF)
                   & ((head + s)[:, None] < stop) & live[:, None])
        alpha_eff = torch.where(contrib, alpha, torch.zeros_like(alpha))
        gc = r * g0 + gg * g1 + b * g2
        t_before = T
        T = T * (1.0 - alpha_eff)
        w = alpha_eff * t_before
        qsum = qsum + w * gc
        d_alpha = t_before * gc - (1.0 / (1.0 - alpha)) * (big_g - qsum)
        d_p = torch.where(contrib & (alpha < ALPHA_MAX), d_alpha * alpha,
                          torch.zeros_like(alpha))
        left_dp, left_w = (_bf16(d_p), _bf16(w)) if amp else (d_p, w)
        mom = (left_dp[:, None, :] * basis[None]).sum(dim=2)              # [NT, 6]
        dl = (left_w[:, None, :] * right_g).sum(dim=2)                    # [NT, 3]
        m1, mmx, mmy, mxx, mxy, myy = mom.unbind(1)
        mxl, myl = mxl[:, 0], myl[:, 0]
        ca, cb, cc, op = ca[:, 0], cb[:, 0], cc[:, 0], op[:, 0]
        s1 = mmx - mxl * m1
        s2 = mmy - myl * m1
        sxx = mxx - 2.0 * mxl * mmx + mxl * mxl * m1
        sxy = mxy - mxl * mmy - myl * mmx + mxl * myl * m1
        syy = myy - 2.0 * myl * mmy + myl * myl * m1
        rows = torch.stack([
            ca * s1 + cb * s2, cc * s2 + cb * s1, -0.5 * sxx, -sxy, -0.5 * syy,
            dl[:, 0], dl[:, 1], dl[:, 2], m1 / torch.clamp_min(op, 1e-12),
        ])                                                                # [9, NT]
        dgrad[:9, cols[live]] = rows[:, live]
    return dgrad
