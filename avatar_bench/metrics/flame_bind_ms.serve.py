"""Mean device milliseconds a served frame spends in FLAME and the binding:
the program's span `frame/flame_bind` (`FlameModel`'s forward,
`face_frames`, `world_gaussians`) on the stage clock, over the stamped
stretch of `avatar_bench/stages.py`."""
from avatar_bench import stages


def read(run):
    return stages.span_ms(run, "frame", "frame/flame_bind")
