"""Mean device milliseconds a served frame spends in projection and the SH
colours: the program's span `frame/project_sh` (`project_from_params`,
`view_colors` in `render_tiled`) on the stage clock, over the stamped
stretch of `avatar_bench/stages.py`."""
from avatar_bench import stages


def read(run):
    return stages.span_ms(run, "frame", "frame/project_sh")
