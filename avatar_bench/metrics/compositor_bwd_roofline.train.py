"""Per cent of its roofline at which the backward compositor kernel runs in
training steps: the least time for a step's backward compositing work
(`work.compositor_bwd`, on the reference's count of the pair-pixels of
the traced steps' own views) over the kernel's device time a step in the
traced stretch."""
from avatar_bench import work

KERNEL = "composite_pairs_bwd_kernel"


def read(run):
    t = run.trace
    if t is None or not run.work or t.units <= 0:
        return None
    s = t.kernel_s(KERNEL) / t.units
    if s <= 0:
        return None
    return 100.0 * work.least_s(*work.compositor_bwd(run.work))[0] / s
