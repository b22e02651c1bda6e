"""Speed-of-light model of the splatting hot path on the card.

The port of the JAX package's `utils/roofline.py`, with its stage models
unchanged: a bytes-and-operations count of each stage of the rasterizer at
a scene's occupancy, against the card's published peaks and its measured
primitive rates.

  * Compositing forward: 32 float32 operations a (pair, pixel) —
    dx/dy (2), the quadratic form (7), exp (~4), the alpha clamp and
    cutoff tests (4), the stop and contribution selects (5), weight and
    transmittance (4), three colour FMAs (6). Backward: 33.
  * Sorts, row gathers and stacks: measured primitive rates
    (`measure_primitive_rates`), seconds an element.
  * HBM floor: the tables in and out at the card's memory rate.

`compositor_roofline` models the table pipeline (`bin_gaussians` +
`composite_tiles`), `sorted_roofline` the sorted-data pipeline
(`sort_gather` + the pair compositor kernels).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """The H100 SXM5 80 GB. Peaks from NVIDIA's H100 Tensor Core GPU
    datasheet (SXM5 column): 67 TFLOP/s FP32 on the CUDA cores, 989.4
    TFLOP/s dense BF16 on the tensor cores, 3.35 TB/s of HBM3. The
    primitive rates are `measure_primitive_rates` at n = 2^20 on an NVIDIA
    H100 80GB HBM3 at a 700.00 W power limit (`chip_smoke.py` phase 17,
    `[table/primitive_rates]`), to three digits."""

    name: str = "H100 SXM5"
    vpu_flops: float = 6.7e13        # FP32, CUDA cores (the field keeps the JAX name)
    mxu_flops: float = 9.894e14      # dense BF16, tensor cores
    hbm_bw: float = 3.35e12          # bytes/s
    sort_s_per_pair: float = 1.26e-10      # torch.sort of int32 keys + one int32 payload
    gather_s_per_row: float = 6.68e-11     # [N, 9] float32 row gather, random rows
    wide_sort_s_per_pair: float = 1.79e-10  # int32 keys + a [N, 9] payload
    wsort_s_per_slot: float = 1.91e-10     # int32 keys + a [N, 11] payload
    wsort2_s_per_slot: float = 2.74e-10    # two keys packed in int64 + a [N, 10] payload
    stack_s_per_slot: float = 3.12e-11     # 10 columns stacked into [10, N]


FWD_FLOPS_PER_PAIR = 32.0
BWD_FLOPS_PER_PAIR = 33.0


def compositor_roofline(
    counts: np.ndarray,
    capacity: int,
    tile_pixels: int,
    n_gauss: int,
    tiles_per_gauss: float,
    height: int,
    width: int,
    chip: ChipSpec = ChipSpec(),
    sort_pairs: float | None = None,
) -> Dict[str, float]:
    """Speed-of-light times of one forward (and backward) render of the
    table pipeline at this occupancy.

    counts: [NT] Gaussians binned a tile (before the cap); capacity: the
    tile capacity; n_gauss: the PADDED Gaussian count (the binning sorts
    every padded slot); tiles_per_gauss: the static tile budget
    (`max_tiles_per_gaussian`); `sort_pairs` overrides the sorted pair
    count.
    """
    counts = np.asarray(counts)
    pairs = float(np.minimum(counts, capacity).sum()) * tile_pixels
    if sort_pairs is None:
        sort_pairs = float(n_gauss) * tiles_per_gauss

    t_fwd_vpu = pairs * FWD_FLOPS_PER_PAIR / chip.vpu_flops
    t_bwd_vpu = pairs * BWD_FLOPS_PER_PAIR / chip.vpu_flops
    t_sort = sort_pairs * chip.sort_s_per_pair
    # One packed row gather feeds the forward; the backward re-reads it.
    gather_rows = float(np.minimum(counts, capacity).sum())
    t_gather = gather_rows * chip.gather_s_per_row
    # HBM floor: the packed table [slots, 9] f32 in, image and grads out.
    slots = float(counts.shape[0]) * capacity
    bytes_moved = slots * 9 * 4 * 2 + height * width * 3 * 4 * 4
    t_hbm = bytes_moved / chip.hbm_bw

    t_render_sol = t_fwd_vpu + t_sort + t_gather
    t_train_sol = t_fwd_vpu + t_bwd_vpu + t_sort + 2 * t_gather
    mpix = height * width / 1e6
    return {
        "pairs": pairs,
        "t_fwd_vpu_ms": t_fwd_vpu * 1e3,
        "t_bwd_vpu_ms": t_bwd_vpu * 1e3,
        "t_sort_ms": t_sort * 1e3,
        "t_gather_ms": t_gather * 1e3,
        "t_hbm_floor_ms": t_hbm * 1e3,
        "sol_render_fps": 1.0 / t_render_sol,
        "sol_train_mpix_s": mpix / t_train_sol,
        "sol_train_iters_s": 1.0 / t_train_sol,
    }


def sorted_roofline(
    counts: np.ndarray,
    tile_pixels: int,
    n_gauss: int,
    n_expand: int,
    height: int,
    width: int,
    chip: ChipSpec = ChipSpec(),
) -> Dict[str, float]:
    """Speed-of-light model of the sorted-data pipeline:

      * binning — the footprint sort over N (wide, 16 payloads), the tiered
        expansion (bandwidth, ~10 columns), the two-key (tile, depth) pair
        sort over the expansion M with 10 payloads, and the [16, M] stack;
      * compositing — per (pair, pixel) work; pairs = Σ counts ·
        tile_pixels, an upper bound (the kernels stop early on saturated
        pixels, so a measured time can beat this "speed of light");
      * gradient reduction — the un-permute over M (pos + 9 payloads), the
        slice sums (bandwidth), and the un-permute over N.
    """
    counts = np.asarray(counts)
    pairs = float(counts.sum()) * tile_pixels

    t_fwd_vpu = pairs * FWD_FLOPS_PER_PAIR / chip.vpu_flops
    t_bwd_vpu = pairs * BWD_FLOPS_PER_PAIR / chip.vpu_flops
    t_fp_sort = float(n_gauss) * chip.wsort_s_per_slot
    t_expand = float(n_expand) * 10 * 4 * 2 / chip.hbm_bw
    t_pair_sort = float(n_expand) * chip.wsort2_s_per_slot
    t_stack = float(n_expand) * chip.stack_s_per_slot
    t_binning = t_fp_sort + t_expand + t_pair_sort + t_stack
    t_unperm_m = float(n_expand) * chip.wsort_s_per_slot
    t_reduce = float(n_expand) * 9 * 4 * 2 / chip.hbm_bw
    t_unperm_n = float(n_gauss) * chip.wsort_s_per_slot
    t_grad_reduce = t_unperm_m + t_reduce + t_unperm_n
    # HBM floor: the data table in (forward and backward) + grads out + images.
    bytes_moved = float(n_expand) * 16 * 4 * 3 + height * width * 3 * 4 * 4
    t_hbm = bytes_moved / chip.hbm_bw

    t_render_sol = t_fwd_vpu + t_binning
    t_train_sol = t_fwd_vpu + t_bwd_vpu + t_binning + t_grad_reduce
    mpix = height * width / 1e6
    return {
        "pairs": pairs,
        "t_fwd_vpu_ms": t_fwd_vpu * 1e3,
        "t_bwd_vpu_ms": t_bwd_vpu * 1e3,
        "t_binning_ms": t_binning * 1e3,
        "t_grad_reduce_ms": t_grad_reduce * 1e3,
        "t_hbm_floor_ms": t_hbm * 1e3,
        "sol_render_fps": 1.0 / t_render_sol,
        "sol_train_mpix_s": mpix / t_train_sol,
        "sol_train_iters_s": 1.0 / t_train_sol,
    }


def _seconds_per_call(fn: Callable[[], object], device: torch.device, reps: int) -> float:
    """Mean seconds a call of `fn` over `reps` calls after one warm-up: CUDA
    events around the calls on a card (one synchronisation), the host
    clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def measure_primitive_rates(device="cuda", n: int = 1 << 20, reps: int = 10,
                            seed: int = 0) -> Dict[str, float]:
    """The primitive rates of `ChipSpec`, in seconds an element, measured on
    `device` at n elements: `torch.sort` of random int32 keys with one
    int32 payload gathered by the sort's permutation (`sort_s_per_pair`),
    with a [n, 9] and a [n, 11] float32 payload (`wide_sort_s_per_pair`,
    `wsort_s_per_slot`), of int64 keys packing two keys with a [n, 10]
    payload (`wsort2_s_per_slot`); a [n, 9] row gather at random rows
    (`gather_s_per_row`); ten [n] columns stacked into [10, n]
    (`stack_s_per_slot`)."""
    dev = torch.device(device)
    g = torch.Generator().manual_seed(seed)
    key32 = torch.randint(0, 1 << 30, (n,), generator=g, dtype=torch.int32).to(dev)
    key64 = ((torch.randint(0, 1 << 12, (n,), generator=g, dtype=torch.int64) << 31)
             | torch.randint(0, 1 << 31, (n,), generator=g, dtype=torch.int64)).to(dev)
    pay1 = torch.arange(n, dtype=torch.int32, device=dev)
    rows = {w: torch.rand((n, w), generator=g).to(dev) for w in (9, 10, 11)}
    perm = torch.randperm(n, generator=g).to(dev)
    cols = [rows[10][:, i].contiguous() for i in range(10)]

    def sort_with(key, payload):
        _s, order = torch.sort(key)
        return payload[order]

    fns = {
        "sort_s_per_pair": lambda: sort_with(key32, pay1),
        "wide_sort_s_per_pair": lambda: sort_with(key32, rows[9]),
        "wsort_s_per_slot": lambda: sort_with(key32, rows[11]),
        "wsort2_s_per_slot": lambda: sort_with(key64, rows[10]),
        "gather_s_per_row": lambda: rows[9][perm],
        "stack_s_per_slot": lambda: torch.stack(cols),
    }
    return {k: _seconds_per_call(f, dev, reps) / n for k, f in fns.items()}
