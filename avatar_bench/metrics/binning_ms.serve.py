"""Mean device milliseconds a served frame spends binning: the program's span
`sort_gather/fwd` (the footprint sort, the tiered expansion, the pair sort
and the gathers of `_SortGather`) on the stage clock, over the stamped
stretch of `avatar_bench/stages.py`."""
from avatar_bench import stages


def read(run):
    return stages.span_ms(run, "frame", "sort_gather/fwd")
