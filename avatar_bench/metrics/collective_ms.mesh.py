"""Mean device milliseconds a step of the mesh spends in the sharded step's
collective stages: the spans `sharded/screen_reduce` (the screen
cotangents' all-reduce over `tile`) and `sharded/reduce` (the world sum and
maximum, with what they reduce) on rank 0's stage clock, summed, over the
stamped stretch of `avatar_bench/stages.py`. None from a program whose
sharded step is no row of the clock."""
from avatar_bench import stages


def read(run):
    return stages.span_ms(run, "sharded/step", "sharded/screen_reduce", "sharded/reduce")
