"""Mean device milliseconds a training step spends in its image forward: the
program's span `train/image_fwd` (binning, the forward compositor, the
loss and the innovations' forward) on the stage clock, over the stamped
stretch of `avatar_bench/stages.py`."""
from avatar_bench import stages


def read(run):
    return stages.span_ms(run, "train/step", "train/image_fwd")
