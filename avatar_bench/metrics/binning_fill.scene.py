"""Per cent of the binning's expansion slots that hold a live (tile,
Gaussian) pair, over the traced chunk of training steps: the program's
counts (`ops/sort_binning.COUNTS` and `PAIRS`, summed on the device inside
the captured step) after the chunk less before it. The rest is padding,
which the pair sort and the gathers carry all the same. None from a
program that keeps no such counts."""


def read(run):
    b = getattr(run, "binning", None)
    if not b or b["slots"] <= 0:
        return None
    return 100.0 * b["live_pairs"] / b["slots"]
