"""Mean device milliseconds a training step spends updating: the program's
spans `train/densify_stats`, `train/adam` and (with the contrastive term)
`train/contrastive_update` on the stage clock, summed, over the stamped
stretch of `avatar_bench/stages.py`."""
from avatar_bench import stages


def read(run):
    return stages.span_ms(run, "train/step", "train/densify_stats", "train/adam",
                          "train/contrastive_update")
