"""Mean device milliseconds a served frame spends in the forward compositor:
the program's span `frame/composite` (the forward of `composite_sorted`)
on the stage clock, over the stamped stretch of `avatar_bench/stages.py`."""
from avatar_bench import stages


def read(run):
    return stages.span_ms(run, "frame", "frame/composite")
