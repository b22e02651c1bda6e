"""Per cent of the mesh's cards' float32 peak that a mesh step's operations
take of its time, as `step_mfu.train` counts a step: `work.step_flops` a
view (on the traced steps' own views, counted by the reference) for each
of the step's views, Adam counted once, over the traced stretch's host-clock
time a step × 67 TFLOP/s × the cell's cards."""
from avatar_bench import scene, work


def read(run):
    t = run.trace
    if t is None or not run.work or t.units <= 0 or t.window_s <= 0:
        return None
    cfg = run.cfg
    views = run.traffic["mesh"][0]
    verts = cfg["num_verts"] + (120 if cfg["add_teeth"] else 0)
    per_view = work.step_flops(cfg, verts, scene.num_faces(cfg), run.work, cfg["timesteps"])
    adam = work.PER_ELEMENT_ADAM * (cfg["gaussians"] * work.GAUSSIAN_FLOATS
                                    + cfg["timesteps"] * (cfg["n_expr"] + 18))
    flops = views * per_view - (views - 1) * adam
    return 100.0 * flops / (t.window_s / t.units * work.PEAK_FLOPS * run.chips)
