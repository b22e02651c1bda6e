"""Per cent of its roofline at which the forward compositor kernel runs in
served frames: the least time for a frame's compositing work (the
pair-pixels the alpha rule walks and the bytes it must move, counted by
the reference on the traced frames' own poses, `work.compositor_fwd`) over
the kernel's device time a frame in the traced stretch."""
from avatar_bench import work

KERNEL = "composite_pairs_fwd_kernel"


def read(run):
    t = run.trace
    if t is None or not run.work or t.units <= 0:
        return None
    s = t.kernel_s(KERNEL) / t.units
    if s <= 0:
        return None
    return 100.0 * work.least_s(*work.compositor_fwd(run.work))[0] / s
