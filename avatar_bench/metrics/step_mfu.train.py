"""Per cent of the cell's cards' float32 peak that a training step's
operations (`work.step_flops`: the geometry and the loss forward and
backward, both compositors on the walked pair-pixels, the regularisers,
the statistics and Adam) take of a step's time, both over the traced
stretch's steps: the work counted on their own views, the time on the
host clock from the stretch's first call to its last step done."""
from avatar_bench import scene, work


def read(run):
    t = run.trace
    if t is None or not run.work or t.units <= 0 or t.window_s <= 0:
        return None
    cfg = run.cfg
    verts = cfg["num_verts"] + (120 if cfg["add_teeth"] else 0)
    flops = work.step_flops(cfg, verts, scene.num_faces(cfg), run.work, cfg["timesteps"])
    return 100.0 * flops / (t.window_s / t.units * work.PEAK_FLOPS * run.chips)
