"""Mean device milliseconds a training step spends in its image backward: the
program's span `train/image_bwd` (the loss's backward, the backward
compositor, the binning's backward) on the stage clock, over the stamped
stretch of `avatar_bench/stages.py`."""
from avatar_bench import stages


def read(run):
    return stages.span_ms(run, "train/step", "train/image_bwd")
