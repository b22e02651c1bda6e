"""Micro-benchmark of per-slot reduction strategies, on one card.

The port of the JAX package's `scripts/micro_reduce_bench.py`: the
backward compositor needs, per chunk of K = 64 slots, 9 scalar reductions
per slot over an [8, 128] pixel block. Four formulations of that inner
pattern, with the real kernel's grid and chunk structure (one block per
tile, a loop over the 8 chunks of the tile's C = 512 slots):

  A  per-slot sum loop: one block-wide reduction per slot and field
  B  two-step vectorised reduce: lanes, then rows
  C  per field, the chunk's plane times a one-column basis on the tensor
     cores (3xTF32)
  D  the chunk's plane times the 9-column basis in one product (3xTF32)

Each computes out[t, s] = Σ_r Σ_pixels (1 + r)·x[t, s] for x [NT, C, 1]
float32 (46,080·x up to rounding). Each C entry point of
`csrc/micro_reduce.cu` has its plain PyTorch version here, which
materialises the [K, 8, 128] planes and does what the JAX kernel does; a
CPU tensor runs it, a CUDA tensor launches the kernel or raises.

    python -m gaussianavatars_torch.tools.micro_reduce_bench [--device cuda] [--nt 468] [--iters 50]

Prints one line per formulation, `name: ms` (`--iters` launches chained on
one stream between two CUDA events; on the CPU, the plain versions on the
host clock), and returns, per formulation, its ms, its relative error
against its plain version, and its launches.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import time

import torch

from .. import cuda_build
from ..device import resolve_device

NT = 468          # tiles at 802x550 / 32x32
C = 512           # capacity
K = 64            # chunk
ROWS, LANES = 8, 128
N_CHUNKS = C // K
NRED = 9

LABELS = {
    "a": "A per-slot sum loop      ",
    "b": "B two-step vector reduce ",
    "c": "C batched dot per field  ",
    "d": "D reshape + single dot   ",
}

# Kernel launches per C entry point, for callers to check which kernel ran.
LAUNCHES = dict.fromkeys((f"micro_reduce_{k}" for k in LABELS), 0)


def _fields(x: torch.Tensor, base: int) -> torch.Tensor:
    """Slot-broadcast planes [NT, K, ROWS, LANES] of one chunk, every tile
    at once (`_fields`: v · ones)."""
    v = x[:, base:base + K, 0]
    ones = torch.ones((1, 1, ROWS, LANES), dtype=torch.float32, device=x.device)
    return v[:, :, None, None] * ones


def _by_chunk(x: torch.Tensor, chunk_sums) -> torch.Tensor:
    out = torch.empty_like(x)
    for k in range(N_CHUNKS):
        base = k * K
        out[:, base:base + K, 0] = chunk_sums(_fields(x, base))
    return out


def kern_a_reference(x: torch.Tensor) -> torch.Tensor:
    """A: per slot and field, one sum over the whole [8, 128] plane."""
    def chunk(f):
        s = torch.zeros(f.shape[:2], dtype=torch.float32, device=f.device)
        for r in range(NRED):
            s = s + torch.sum(f * (1.0 + r), dim=(2, 3))
        return s
    return _by_chunk(x, chunk)


def _pairwise(parts: list) -> torch.Tensor:
    """((p0 + p1) + (p2 + p3)) + ...: a butterfly's order of addition."""
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def kern_b_reference(x: torch.Tensor) -> torch.Tensor:
    """B: per field, the lanes' sum of each row, then the rows'; the rows
    and the fields 0..7 added pairwise as the kernel's shuffles add them,
    field 8 last."""
    def chunk(f):
        fields = [_pairwise(list(torch.sum(f * (1.0 + r), dim=3).unbind(2)))
                  for r in range(NRED)]
        return _pairwise(fields[:8]) + fields[8]
    return _by_chunk(x, chunk)


def kern_c_reference(x: torch.Tensor) -> torch.Tensor:
    """C: per field, the plane contracted over lanes with the field's
    [8, 128] basis, batched over rows, then the rows' sum."""
    def chunk(f):
        s = torch.zeros(f.shape[:2], dtype=torch.float32, device=f.device)
        for r in range(NRED):
            basis = torch.full((ROWS, LANES), 1.0 + r, dtype=torch.float32, device=f.device)
            d = torch.einsum("tkrl,rl->trk", f, basis)        # [NT, ROWS, K]
            s = s + torch.sum(d, dim=1)
        return s
    return _by_chunk(x, chunk)


def kern_d_reference(x: torch.Tensor) -> torch.Tensor:
    """D: the [K, 1024] plane times the [1024, 9] basis, then the sum over
    the 9 columns. The contraction runs as 8 float32 products of 128 pixels
    (one per row of the block) whose partials are summed: one pass of a
    card's float32 GEMM over all 1024 terms drifts 1e-5 from the exact sum
    (1.02e-5 measured on an H100), while the kernels stay within 4e-7."""
    bmat = torch.cat([torch.full((ROWS * LANES, 1), 1.0 + r, dtype=torch.float32,
                                 device=x.device) for r in range(NRED)], dim=1)
    bmat_rows = bmat.reshape(ROWS, LANES, NRED)

    def chunk(f):
        d = torch.einsum("tkrl,rln->tkrn", f, bmat_rows).sum(dim=2)   # [NT, K, 9]
        return torch.sum(d, dim=2)
    return _by_chunk(x, chunk)


PLAIN = {"a": kern_a_reference, "b": kern_b_reference, "c": kern_c_reference,
         "d": kern_d_reference}


@functools.cache
def _kernel_fn(sym: str):
    """A C entry point of csrc/micro_reduce.cu, built and loaded at first use."""
    fn = getattr(cuda_build.load("micro_reduce"), sym)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return fn


def _launch(name: str, x: torch.Tensor) -> torch.Tensor:
    sym = f"micro_reduce_{name}"
    fn = _kernel_fn(sym)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), x.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"{sym} launch failed with CUDA error {err}")
    LAUNCHES[sym] += 1
    return out


def reduce_slots(name: str, x: torch.Tensor) -> torch.Tensor:
    """Formulation `name` ("a".."d") of the per-slot sums of x [NT, C, 1]
    float32: its kernel on a CUDA tensor, its plain version on a CPU one."""
    if name not in PLAIN:
        raise ValueError(f"unknown formulation {name!r}; expected one of {sorted(PLAIN)}")
    if x.dtype != torch.float32 or x.dim() != 3 or tuple(x.shape[1:]) != (C, 1):
        raise ValueError(f"x must be float32 [NT, {C}, 1], got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type == "cuda":
        return _launch(name, x)
    if x.device.type != "cpu":
        raise ValueError(f"no micro_reduce kernel for device {x.device}")
    return PLAIN[name](x)


def kern_a(x):
    return reduce_slots("a", x)


def kern_b(x):
    return reduce_slots("b", x)


def kern_c(x):
    return reduce_slots("c", x)


def kern_d(x):
    return reduce_slots("d", x)


def relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over slots of |got − want| / |want| (inputs are positive)."""
    return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


def run(name: str, x: torch.Tensor, iters: int) -> dict:
    """Time `iters` launches of formulation `name` chained on one stream
    (CUDA events; on the CPU, the host clock around the plain version), and
    its result against its plain version."""
    fn = lambda: reduce_slots(name, x)   # noqa: E731
    out = fn()                           # build, warm up
    if x.device.type == "cuda":
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
        err = relative_error(out, PLAIN[name](x))
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = 1e3 * (time.perf_counter() - t0) / iters
        err = 0.0   # the wrapper ran the plain version itself
    print(f"{LABELS[name]}: {ms:8.3f} ms", flush=True)
    return {"ms": ms, "max_rel_err_vs_plain": err,
            "max_rel_err_vs_46080x": relative_error(out, 46080.0 * x),
            "launches": LAUNCHES[f"micro_reduce_{name}"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nt", type=int, default=NT)
    ap.add_argument("--iters", type=int, default=50)
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    g = torch.Generator().manual_seed(0)
    x = torch.rand((a.nt, C, 1), generator=g, dtype=torch.float32).to(dev)
    results = {name: run(name, x, a.iters) for name in LABELS}
    results["device"] = str(dev)
    return results


if __name__ == "__main__":
    main()
