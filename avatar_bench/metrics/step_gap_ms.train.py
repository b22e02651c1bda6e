"""Mean device milliseconds from one training step's end to the next one's
begin (the program's span `train/step`, on the device's clock), the
chunk boundaries included: the step's buffers written back, the next
view gathered, each chunk's launch and the loop's read of its losses,
over the stamped stretch of `avatar_bench/stages.py`."""
from avatar_bench import stages


def read(run):
    return stages.gap_ms(run, "train/step")
