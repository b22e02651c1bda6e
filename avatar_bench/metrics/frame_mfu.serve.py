"""Per cent of the card's float32 peak that a served frame's operations
(`work.frame_flops`: the shapes' FLAME, binding, projection and SH, and the
compositor's walked pair-pixels, counted on the compared frames, a seeded
sample of the window's own) take of the window's time a frame."""
from avatar_bench import scene, work


def read(run):
    if not run.window_work or run.attempted <= 0:
        return None
    cfg = run.cfg
    verts = cfg["num_verts"] + (120 if cfg["add_teeth"] else 0)
    flops = work.frame_flops(cfg, verts, scene.num_faces(cfg), run.window_work)
    return 100.0 * flops / (run.window_s / run.attempted * work.PEAK_FLOPS)
