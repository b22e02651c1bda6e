"""Mean device milliseconds a training step spends in its geometry backward:
the program's span `train/geometry_bwd` (autograd back through
projection, SH, the binding and FLAME, and the regularisers) on the
stage clock, over the stamped stretch of `avatar_bench/stages.py`."""
from avatar_bench import stages


def read(run):
    return stages.span_ms(run, "train/step", "train/geometry_bwd")
