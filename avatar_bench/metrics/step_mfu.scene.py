"""Per cent of the card's float32 peak that an unbound training step's
operations take of its time: `work.step_flops`'s count with the unbound
geometry (the activations of world-space leaves, projection and SH, no
FLAME and no binding) in place of FLAME's and the binding's and no
regulariser, the compositors on the reference's walked pair-pixels of the
traced chunk's views (every `trace_work_every`-th), over the traced chunk's
host-clock time a step × 67 TFLOP/s."""
from avatar_bench import work

# exp of three scales (3 × ~4), the rotation's normalisation (~8), the
# opacity's sigmoid (~4)
PER_GAUSSIAN_ACTIVATE = 24


def step_flops(cfg: dict, w: dict) -> float:
    """An unbound step: the geometry forward and backward (twice the
    forward), the loss's, both compositors, the statistics and Adam."""
    n = cfg["gaussians"]
    geometry = n * (PER_GAUSSIAN_ACTIVATE + work.PER_GAUSSIAN_PROJECT + work.PER_GAUSSIAN_SH3)
    return (3 * geometry + 3 * work.PER_PIXEL_LOSS * w["pixels"]
            + (work.FWD_PER_PAIR_PIXEL + work.BWD_PER_PAIR_PIXEL) * w["pair_pixels"]
            + n * work.PER_GAUSSIAN_STATS + work.PER_ELEMENT_ADAM * n * work.GAUSSIAN_FLOATS)


def read(run):
    t = run.trace
    if t is None or not run.work or t.units <= 0 or t.window_s <= 0:
        return None
    return 100.0 * step_flops(run.cfg, run.work) / (t.window_s / t.units * work.PEAK_FLOPS
                                                    * run.chips)
