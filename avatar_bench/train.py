"""Training: a fit's steady phase, chunks of steps through the program's
training chunk, each step on one (camera, timestep) view of a seeded
shuffle over the ground-truth cache.

Set-up builds one training state and one chunk object, drives them from
the seed through the check's first steps (the chunk's first steps of a
fit run eagerly, then it captures its step), captures, takes one replayed
step for the check, runs chunks for the traffic's `settle_s` seconds, and
hands the same chunk and state to the window. The reference follows the
first three steps from the seed's inputs, and the replayed step from the
program's state before it.
"""
from __future__ import annotations

import gc
import statistics
import time

import torch

from . import reference, scene
from .check import leaf_gap, moving_leaves, rel
from .work import mean as mean_work


def _size(r):
    s = r.traffic["resolution_scale"]
    # The program's rounding of a scaled view (Python's round, half to even).
    return max(1, round(r.cfg["width"] * s)), max(1, round(r.cfg["height"] * s))


def _inputs(r):
    cfg = r.cfg
    gen = scene.generator(r.seed, r.device)
    arrays = scene.flame_arrays(cfg, gen)
    leaves, binding, alive = scene.gaussians(cfg, gen)
    shape = scene.shape_coeffs(cfg, gen)
    poses = scene.trajectory(cfg, r.traffic, cfg["timesteps"], gen)
    if cfg["opt"].get("use_color_calibration"):
        leaves = {**leaves, **scene.color_net(cfg, gen)}
    w, h = _size(r)
    cams = scene.rig(cfg, w, h, r.device)
    gt = scene.ground_truth(cfg["cameras"] * cfg["timesteps"], h, w, gen)
    return arrays, leaves, binding, alive, shape, poses, cams, gt


class Schedule:
    """Views (ground-truth cache rows, camera-major) in seeded shuffles of
    the whole cache, one after another."""

    def __init__(self, seed: int, n: int):
        self.gen = torch.Generator().manual_seed(seed)
        self.n, self.buf = n, []

    def take(self, k: int) -> list[int]:
        while len(self.buf) < k:
            self.buf += torch.randperm(self.n, generator=self.gen).tolist()
        out, self.buf = self.buf[:k], self.buf[k:]
        return out


def _cpu(tree: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


# Options of the recipe the reference does not implement, and their values.
OFF = dict(metric_xyz=False, metric_scale=False, lambda_dynamic_offset=0.0,
           lambda_laplacian=0.0, lambda_dynamic_offset_std=0.0, use_amp=False)


def _opt(r) -> dict:
    opt = r.cfg["opt"]
    on = {k: opt[k] for k, v in OFF.items() if opt.get(k, v) != v}
    if on:
        raise ValueError(f"the reference does not implement {on}")
    return dict(opt, spatial_lr_scale=r.cfg["spatial_lr_scale"])


def run(r) -> None:
    from . import program, trace

    cfg, traffic = r.cfg, r.traffic
    arrays, leaves, binding, alive, shape, poses, cams, gt = _inputs(r)
    t_count = cfg["timesteps"]
    pcfg = program.program_config(cfg)
    model = program.flame_model(arrays, cfg, r.device)
    params, aux = program.gaussian_state(leaves, binding, alive)
    pcams = [program.camera(c) for c in cams]
    stacked = program.rig_cameras(cams)
    sched = Schedule(r.seed, len(cams) * t_count)
    probe = torch.linspace(0, t_count - 1, traffic["probe_timesteps"]).round().long().tolist()
    tile_cfg = program.probe_tile_config(
        model, params, aux,
        [(program.flame_params(shape, poses, t), c) for c in pcams for t in probe], cfg["tile"])
    state = program.train_state(params, aux, pcfg, shape, poses, t_count, leaves,
                                (cams[0]["height"], cams[0]["width"]))
    chunk = program.make_train_chunk(model, pcfg, tile_cfg, cfg["spatial_lr_scale"])
    bg = torch.zeros(3, device=r.device)
    sh = cfg["sh_degree"]

    def call(st, views):
        idx = torch.tensor([v // t_count for v in views], device=r.device)
        return chunk(st, gt, views, program.camera_rows(stacked, idx),
                     [v % t_count for v in views], bg, sh)

    # The check's steps: one, then two (the chunk's eager first steps of a
    # fit), the capture with a chunk, then one replayed step.
    views = sched.take(3)
    s1, m1 = call(state, views[:1])
    start = dict(views=views, loss=[float(m1["loss"][0])], grad1=program.adam_mu(s1))
    start["grad1"] = {k: v.detach().cpu() / 0.1 for k, v in start["grad1"].items()}
    s3, m3 = call(s1, views[1:])
    start["loss"] += m3["loss"].tolist()
    start["leaves3"] = _cpu(program.state_leaves(s3))
    start["stats3"] = s3.aux.grad_accum.detach().cpu()
    st, _ = call(s3, sched.take(traffic["steps_per_call"]))
    before = program.reference_state(st)
    before = {k: (_cpu(v) if isinstance(v, dict) else v.detach().cpu()) for k, v in before.items()}
    view = sched.take(1)
    st, mr = call(st, view)
    replay = dict(view=view[0], state=before, loss=float(mr["loss"][0]),
                  leaves=_cpu(program.state_leaves(st)),
                  grad={k: (v.detach().cpu() - 0.9 * before["mu"][k]) / 0.1
                        for k, v in program.adam_mu(st).items()})
    r.sync()

    k = traffic["steps_per_call"]
    # A fresh process replays slower until it switches, for good and at a
    # time of its own, to a faster pace (PERF.md §5): the window's own
    # chunks run for `settle_s` first.
    settle = time.perf_counter() + traffic["settle_s"]
    while time.perf_counter() < settle:
        st, m = call(st, sched.take(k))
        float(m["loss"][-1])
    overflow = torch.zeros((), dtype=torch.int64, device=r.device)
    host = []
    r.start_window()
    t_start = time.perf_counter()
    steps = 0
    while True:
        t0 = time.perf_counter()
        st, m = call(st, sched.take(k))
        host.append(time.perf_counter() - t0)
        # The fit's loop reads each chunk's losses: the chunk is done here.
        overflow = torch.maximum(overflow, m["budget_overflow"].max().to(torch.int64))
        last = float(m["loss"][-1])
        t1 = time.perf_counter()
        steps += k
        if t1 - t_start >= r.seconds:
            break
    r.window_s = t1 - t_start
    r.attempted = steps
    r.memory_peak = r.peak_memory()
    r.e2e["train_images_per_s"] = steps / r.window_s
    r.host_ms = [h * 1e3 for h in host]
    r.captures = chunk.captures
    r.note(f"steps {steps} in {r.window_s:.6f} s, chunk call ms median "
           f"{statistics.median(host) * 1e3:.6f}, last loss {last:.6f}, "
           f"budget overflow {int(overflow)}; chunk call ms "
           + " ".join(f"{h * 1e3:.1f}" for h in host))
    traced = [sched.take(k) for _ in range(traffic["trace_calls"])] if r.traced else []
    if traced:
        at_trace = _cpu(program.state_leaves(st))

        def stretch():
            nonlocal st
            for views in traced:
                st, _m = call(st, views)
            return len(traced) * k
        r.trace = trace.profile(stretch, r.device)
    used = sorted({*start["views"], replay["view"]})
    gt_used = {v: gt[v].clone() for v in used}
    del st, s1, s3, m, m1, m3, mr, chunk, model, params, aux, state, gt
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    r.finish_check(check(r, arrays, leaves, binding, alive, shape, poses, cams, gt_used,
                         start, replay))
    if traced:
        r.work = traced_work(r, arrays, at_trace, binding, alive, shape, cams,
                             [v for views in traced for v in views])


def traced_work(r, arrays, at: dict, binding, alive, shape, cams, views: list) -> dict:
    """A step's mean compositor work over the traced steps' views, counted by
    the reference's forward at the program's state when the stretch began
    (the geometry moves little within a chunk)."""
    prec = reference.Precision()
    flame = reference.Flame(arrays, r.device, prec)
    t_count = r.cfg["timesteps"]
    g = {k: at[k].to(r.device) for k in reference.GAUSS_LEAVES}
    pose = {k: at[k].to(r.device) for k in reference.FLAME_LEAVES}
    bg = torch.zeros(3, device=r.device)
    work = []
    for v in views:
        t = v % t_count
        fp = dict(shape=shape, **{k: x[t:t + 1] for k, x in pose.items()})
        work.append(reference.render(flame, fp, g, binding, alive, cams[v // t_count], bg,
                                     r.cfg["tile"], prec).work)
    return mean_work(work)


def _step(r, flame, st, gt_used, cams, v, prec, fault=""):
    t_count = r.cfg["timesteps"]
    gt = gt_used[v].to(r.device).float() / 255.0
    bg = torch.zeros(3, device=r.device)
    return reference.train_step(flame, st, gt, cams[v // t_count], v % t_count, bg, _opt(r),
                                r.cfg["tile"], prec, fault)


def _initial(r, leaves, binding, alive, shape, poses) -> reference.TrainState:
    lv = {**leaves, **poses}
    zeros = torch.zeros(binding.shape, device=r.device)
    opt, cache = r.cfg["opt"], None
    if opt.get("use_contrastive_reg"):
        d = opt["contrastive_downsample"]
        cache = dict(images=torch.zeros((opt["contrastive_cache_size"], d, d, 3),
                                        device=r.device), count=0, head=0)
    return reference.TrainState(
        leaves=lv, mu={k: torch.zeros_like(v) for k, v in lv.items()},
        nu={k: torch.zeros_like(v) for k, v in lv.items()}, step=0, binding=binding,
        alive=alive, shape=shape, grad_accum=zeros, denom=zeros.clone(), cache=cache)


def check(r, arrays, leaves, binding, alive, shape, poses, cams, gt_used, start, replay) -> dict:
    """The reference follows the three steps from the seed's inputs, then
    the replayed step from the state the program had before it."""
    prec = reference.Precision()
    flame = reference.Flame(arrays, r.device, prec)
    st = st0 = _initial(r, leaves, binding, alive, shape, poses)
    losses = []
    for i, v in enumerate(start["views"]):
        st, loss, grads, _w = _step(r, flame, st, gt_used, cams, v, prec)
        losses.append(loss)
        if i == 0:
            g1 = grads
    keep = moving_leaves(g1)
    grad_gap, grad_leaf = leaf_gap(start["grad1"], g1)
    change_gap, change_leaf = leaf_gap(
        {k: start["leaves3"][k] - st0.leaves[k].cpu() for k in st.leaves},
        {k: st.leaves[k] - st0.leaves[k] for k in st.leaves}, keep)
    stats_gap = rel(float(torch.linalg.norm(start["stats3"].double())),
                    float(torch.linalg.norm(st.grad_accum.double())))
    a = replay["state"]
    dev = lambda t: {k: x.to(r.device) for k, x in t.items()}  # noqa: E731
    sta = reference.TrainState(
        leaves=dev(a["leaves"]), mu=dev(a["mu"]), nu=dev(a["nu"]), step=int(a["step"]),
        binding=binding, alive=alive, shape=shape, grad_accum=a["grad_accum"].to(r.device),
        denom=a["denom"].to(r.device),
        cache=None if "cache" not in a else dict(images=a["cache"]["images"].to(r.device),
                                                 count=int(a["cache"]["count"]),
                                                 head=int(a["cache"]["head"])))
    stb, loss_b, grads_b, _w = _step(r, flame, sta, gt_used, cams, replay["view"], prec)
    keep_b = moving_leaves(grads_b)
    g_b, gl_b = leaf_gap(replay["grad"], grads_b)
    c_b, cl_b = leaf_gap({k: replay["leaves"][k] - a["leaves"][k] for k in stb.leaves},
                         {k: stb.leaves[k] - sta.leaves[k] for k in stb.leaves}, keep_b)
    loss_gaps = [rel(p, q) for p, q in zip(start["loss"] + [replay["loss"]], losses + [loss_b])]
    r.note(f"losses program {start['loss'] + [replay['loss']]} reference {losses + [loss_b]}; "
           f"worst leaves: gradient {grad_leaf} / {gl_b}, change {change_leaf} / {cl_b}; "
           f"leaves left out of the change: {sorted(set(g1) - keep)} / "
           f"{sorted(set(grads_b) - keep_b)}")
    numbers = dict(loss_gap=max(loss_gaps), grad_gap=max(grad_gap, g_b),
                   change_gap=max(change_gap, c_b), stats_gap=stats_gap)
    failed = sum(numbers[k] > r.limits[k] for k in numbers)
    return dict(numbers=numbers, failed=int(failed), compared=len(loss_gaps))


def control(r, kind: str) -> dict:
    """A stand-in for the program: the reference in TF32 ("tf32"), or in
    float32 with the loss over the top half of the image only
    ("half_image"), through the same steps; then the check as a run makes
    it."""
    if kind not in ("tf32", "half_image"):
        raise ValueError(f"training has no control {kind!r}")
    arrays, leaves, binding, alive, shape, poses, cams, gt = _inputs(r)
    prec = reference.precision("tf32" if kind == "tf32" else "float32")
    fault = "half_image" if kind == "half_image" else ""
    flame = reference.Flame(arrays, r.device, prec)
    sched = Schedule(r.seed, len(cams) * r.cfg["timesteps"])
    views = sched.take(3)
    sched.take(r.traffic["steps_per_call"])
    view = sched.take(1)[0]
    gt_used = {v: gt[v].clone() for v in {*views, view}}
    del gt
    st = st0 = _initial(r, leaves, binding, alive, shape, poses)
    start = dict(views=views, loss=[])
    for i, v in enumerate(views):
        st, loss, grads, _w = _step(r, flame, st, gt_used, cams, v, prec, fault)
        start["loss"].append(loss)
        if i == 0:
            start["grad1"] = _cpu(grads)
    start["leaves3"] = _cpu(st.leaves)
    start["stats3"] = st.grad_accum.cpu()
    before = dict(leaves=_cpu(st.leaves), mu=_cpu(st.mu), nu=_cpu(st.nu),
                  step=torch.tensor(st.step), grad_accum=st.grad_accum.cpu(),
                  denom=st.denom.cpu())
    if st.cache is not None:
        before["cache"] = dict(images=st.cache["images"].cpu(), count=torch.tensor(
            st.cache["count"]), head=torch.tensor(st.cache["head"]))
    stb, loss_b, grads_b, _w = _step(r, flame, st, gt_used, cams, view, prec, fault)
    replay = dict(view=view, state=before, loss=loss_b, leaves=_cpu(stb.leaves),
                  grad=_cpu(grads_b))
    del st0
    return check(r, arrays, leaves, binding, alive, shape, poses, cams, gt_used, start, replay)
