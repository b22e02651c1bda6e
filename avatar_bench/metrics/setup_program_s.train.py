"""Seconds of the program's top-level set-up spans closed before the window
(`utils/profiling.setup_report`: the kernels' build and load, the FLAME
model's set-up, the tier probe, warm-ups, captures), host clock."""
from avatar_bench import stages


def read(run):
    return stages.setup_s(run)
