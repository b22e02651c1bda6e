"""Mean device milliseconds from one served frame's end to the next one's
begin (the program's span `frame`, on the device's clock): the pose's
copy in, the launch, the outputs' copies, the caller's wait and loop,
over the stamped stretch of `avatar_bench/stages.py`."""
from avatar_bench import stages


def read(run):
    return stages.gap_ms(run, "frame")
