"""Mean device milliseconds a training step spends in the innovations: the
program's spans `train/color_net`, `train/region_map`, `train/contrastive`
and `train/contrastive_update` on the stage clock, summed, over the
stamped stretch of `avatar_bench/stages.py`."""
from avatar_bench import stages


def read(run):
    return stages.span_ms(run, "train/step", "train/color_net", "train/region_map",
                          "train/contrastive", "train/contrastive_update")
