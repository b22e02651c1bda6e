"""Host training loop: the library behind `tools/train.py` and
`tools/train_synthetic.py`.

The port of the JAX package's `training/loop.py` (the reference training script,
`train.py:45-311`): training steps (`trainer.make_train_step`), one a
dispatch or `steps_per_call` a chunk (`trainer.make_train_chunk`: on the
card one captured CUDA graph of the step, replayed once a step; chunks end
at every host event, `chunk_boundary`), with host events at the
reference's cadence —

  * SH warm-up every 1000 iterations (`train.py:176-177`),
  * densify/prune every `densification_interval` in
    (densify_from_iter, densify_until_iter) (`train.py:264-273`),
  * opacity reset every `opacity_reset_interval`,
  * eval reports (`training_report`, `train.py:313-394`: PSNR, SSIM, and
    LPIPS when `$GSAVATARS_LPIPS_WEIGHTS` names a weights file), PLY saves
    and full resume checkpoints (`train.py:287-289`),

TensorBoard scalars, images and histograms at the JAX loop's events and
tags (`_maybe_tensorboard`; none when the package is missing), the viewer
GUI service after every dispatch (`gui_service`, for
`viewers/network_gui.TrainingGuiServer`; single steps while a client is
connected), single steps with finite assertions from `debug_from` on, and
the host side of the innovations: progressive resolution (the scale
of each iteration from `innovations.resolution_scale_at`, one ground-truth
cache and sampler per scale, the scales that cannot recur evicted), smart
densification's thresholds at each densify event, and the colour net in
`make_render_fn`, so that eval scores the calibrated image.

The loop owns host-side state (the ground-truth cache, the sampler, logs);
everything numeric is in the `TrainState` on the device. The step's
budget counters are kept as running maxima on the device and read only
at the log cadence and at the end of a chunk: an iteration that does not
log makes no host read of a device value beyond what the step itself
does.

The harness is FLAME-bound (`bind_to_mesh`) or unbound: a point cloud of
the dataset (COLMAP, or Blender's `points3d.ply` or random points)
initialised by `models/gaussians.init_from_points`, trained with no FLAME
leaves. `train_sharded` trains over a rank mesh, one step a dispatch, as
the JAX package's does.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import sys
import time
import types
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config, to_json
from ..data.cameras import Camera
from ..data.pipeline import EpochSampler, Prefetcher, gt_to_float, load_view, view_stack
from ..data.scene import Scene
from ..device import resolve_device
from ..metrics.lpips import lpips as lpips_fn, maybe_load_default
from ..models.binding import face_frames
from ..models.densify import DensifyConfig, densify_and_prune, grow_capacity, reset_opacity
from ..models.flame.assets import save_assets
from ..models.flame.flame_model import FlameModel, FlameParams
from ..models.gaussians import init_bound, init_from_points, num_alive, world_gaussians
from ..ops.rasterize_tiled import TileConfig, render_tiled
from ..ops.sort_binning import grow_tiers
from ..render import probe_tile_config
from ..utils.debug import assert_finite
from ..utils.image import error_map
from .checkpoint import flatten_state, load_train_state, save_train_state
from .innovations import color_net_apply, resolution_scale_at, smart_thresholds
from .loss import psnr as psnr_fn, ssim as ssim_fn
from .trainer import (
    TrainState, active_sh_degree, init_train_state, make_train_chunk, make_train_step,
    stack_cameras,
)


def flame_init_from_table(
    table: Dict[str, np.ndarray],
    n_shape: Optional[int] = None,
    n_expr: Optional[int] = None,
) -> dict:
    """Scene flame table (reference npz key names) → trainer kwarg names.

    `n_shape`/`n_expr` truncate or zero-pad the dataset coefficients to the
    model's blendshape count."""

    def fit(x: np.ndarray, n: Optional[int]) -> np.ndarray:
        if n is None or x.shape[-1] == n:
            return x
        if x.shape[-1] > n:
            return x[..., :n]
        pad = [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])]
        return np.pad(x, pad)

    return {
        "shape": fit(table["shape"], n_shape),
        "expr": fit(table["expr"], n_expr),
        "rotation": table["rotation"],
        "neck": table["neck_pose"],
        "jaw": table["jaw_pose"],
        "eyes": table["eyes_pose"],
        "translation": table["translation"],
        "static_offset": table["static_offset"],
    }


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def flame_table_from_state(state: TrainState, template: Dict[str, np.ndarray]) -> dict:
    """Export trained FLAME params in the reference npz layout
    (`scene/flame_gaussian_model.py:218-223`)."""
    out = dict(template)
    out["shape"] = _np(state.flame_static.shape)
    out["expr"] = _np(state.flame.expr)
    out["rotation"] = _np(state.flame.rotation)
    out["neck_pose"] = _np(state.flame.neck)
    out["jaw_pose"] = _np(state.flame.jaw)
    out["eyes_pose"] = _np(state.flame.eyes)
    out["translation"] = _np(state.flame.translation)
    if state.flame_static.static_offset is not None:
        out["static_offset"] = _np(state.flame_static.static_offset)
    return out


def tile_config(cfg: Config) -> TileConfig:
    p = cfg.pipeline
    return TileConfig(tile_h=p.tile_h, tile_w=p.tile_w, capacity=p.capacity_per_tile,
                      max_tiles_per_gaussian=p.max_tiles_per_gaussian,
                      base_budget=p.base_budget, tiers=tuple(p.tiers))


@dataclasses.dataclass
class TrainerHarness:
    """Everything `train()` assembles before the loop."""

    cfg: Config
    scene: Scene
    model: Optional[FlameModel]   # None: unbound
    state: TrainState
    spatial_lr_scale: float
    start_iteration: int = 0
    # The loop's current tile budgets (grown on overflow recovery).
    live_tile_config: Optional[TileConfig] = None
    # Every host event: {"kind", "iteration", "ms" (host milliseconds), and
    # what it reported (the densify counts, the eval metrics, ...)}.
    events: List[dict] = dataclasses.field(default_factory=list)
    # Training steps taken at each image size (height, width): host counts.
    steps_by_size: Dict[tuple, int] = dataclasses.field(default_factory=dict)
    # CUDA graphs captured by the loop's chunks (`trainer.TrainChunk`).
    chunk_captures: int = 0


def image_scales(cfg: Config) -> tuple:
    """The image-scale factors a run trains at, largest first: the
    progressive schedule's, else (1.0,)."""
    o = cfg.opt
    if o.use_progressive_resolution:
        return tuple(sorted(set(o.resolution_schedule), reverse=True))
    return (1.0,)


def build_harness(
    cfg: Config,
    model: Optional[FlameModel] = None,
    generator: Optional[torch.Generator] = None,
    start_checkpoint: str = "",
    device="cuda",
    coordinator: bool = True,
) -> TrainerHarness:
    """Scene, initial state (or `start_checkpoint`'s), and the model
    directory's `cameras.json`, `cfg_args.json` (and `flame_assets.npz`
    when bound); another rank than the coordinator writes and prints
    nothing.

    With `cfg.model.bind_to_mesh` the Gaussians are bound to `model`'s
    faces; without it (the model is ignored) they start from the dataset's
    point cloud. `generator` (default: seeded with 0) draws the initial
    colours and the split noise."""
    dev = resolve_device(device)
    m = cfg.model
    if m.bind_to_mesh:
        if model is None:
            raise ValueError("bind_to_mesh requires a FlameModel")
        model = model.to(dev)
    else:
        model = None
    scene = Scene(
        m.source_path, model_path=m.model_path if coordinator else "",
        resolution=m.resolution,
        white_background=m.white_background, eval_split=m.eval,
        target_path=m.target_path, select_camera_id=m.select_camera_id,
        num_verts_hint=model.num_verts if model is not None else 0, device=dev,
        # The schedule's image-scale factors (< 1: smaller); Scene takes
        # divisors.
        resolution_scales=tuple(1.0 / s for s in image_scales(cfg)),
    )
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    cam0 = scene.train_cameras()[0]
    if model is not None:
        params, aux = init_bound(model.num_faces, capacity=m.capacity, generator=gen,
                                 device=dev)
        flame_init = flame_init_from_table(scene.flame_table, n_shape=model.cfg.n_shape,
                                           n_expr=model.cfg.n_expr)
        state = init_train_state(
            params, aux, cfg, num_timesteps=scene.num_timesteps, n_expr=model.cfg.n_expr,
            n_shape=model.cfg.n_shape, num_verts=model.num_verts, flame_init=flame_init,
            generator=gen, image_hw=(cam0.height, cam0.width),
        )
    else:
        pcd = scene.info.point_cloud
        if pcd is None:
            raise ValueError("unbound training requires a dataset point cloud")
        params, aux = init_from_points(pcd.points, pcd.colors, capacity=m.capacity, device=dev)
        state = init_train_state(params, aux, cfg, generator=gen,
                                 image_hw=(cam0.height, cam0.width))
    start_iteration = 0
    if start_checkpoint:
        state, start_iteration = load_train_state(start_checkpoint, state)
        if coordinator:
            print(f"resumed from {start_checkpoint} at iteration {start_iteration}")
    if m.model_path and coordinator:
        os.makedirs(m.model_path, exist_ok=True)
        with open(os.path.join(m.model_path, "cfg_args.json"), "w") as f:
            f.write(to_json(cfg))
        if model is not None:
            # A self-contained model directory: render and viewers reload
            # this exact topology without the original template.
            save_assets(model.assets, os.path.join(m.model_path, "flame_assets.npz"))

    return TrainerHarness(cfg=cfg, scene=scene, model=model, state=state,
                          spatial_lr_scale=scene.cameras_extent,
                          start_iteration=start_iteration)


def _flame_params(state: TrainState, t: int) -> FlameParams:
    return FlameParams(
        shape=state.flame_static.shape,
        expr=state.flame.expr[t][None], rotation=state.flame.rotation[t][None],
        neck=state.flame.neck[t][None], jaw=state.flame.jaw[t][None],
        eyes=state.flame.eyes[t][None], translation=state.flame.translation[t][None],
        static_offset=state.flame_static.static_offset,
    )


def probe_tier_budgets(tcfg: TileConfig, cfg: Config, model: Optional[FlameModel],
                       state: TrainState, camera: Camera, verbose: bool = True) -> TileConfig:
    """Tier budgets sized from the first training frame's footprints, when
    none are configured: `render.probe_tile_config`, the serving path's
    probe, at the camera's timestep (no FLAME when `model` is None). Off
    the sorted pipeline there are no tiers: `tcfg` comes back unchanged."""
    if tcfg.tiers or not (cfg.pipeline.use_sorted and cfg.pipeline.use_pallas):
        return tcfg
    fp = None if model is None else _flame_params(state, int(camera.timestep or 0))
    probed = probe_tile_config(model, state.params, state.aux, fp, camera,
                               tcfg.tile_h, tcfg.tile_w)
    if verbose:
        spec = probed.tier_spec(state.params.capacity)
        print(f"[info] tier auto-probe: base={spec.base} tiers={spec.tiers} "
              f"(expansion {spec.expansion_size(state.params.capacity)} slots)")
    return dataclasses.replace(tcfg, base_budget=probed.base_budget, tiers=probed.tiers)


def make_render_fn(model: Optional[FlameModel], cfg: Config, tcfg: TileConfig):
    """Full-forward render for eval and offline use: render(state, camera,
    timestep, bg, sh_degree) → image [H, W, 3]. `model=None` renders the
    stored Gaussians as they are (an unbound point cloud; `timestep` is
    ignored). A state with a colour net gets the calibrated image, as in
    the JAX package; a render-only state (`tools/render`) has none. The
    pipeline is chosen by `cfg.pipeline.use_pallas` alone, as in the JAX
    package: with `use_sorted=False` and `use_pallas=True` the step runs
    the table path and this render the sorted one."""

    @torch.no_grad()
    def render(state: TrainState, camera: Camera, timestep: int, bg: torch.Tensor,
               sh_degree: int) -> torch.Tensor:
        frames = None
        if model is not None:
            verts = model(_flame_params(state, int(timestep)))
            frames = face_frames(verts[0], model.faces)
        wg = world_gaussians(state.params, state.aux, frames)
        img = render_tiled(wg.means, wg.scales, wg.quats, wg.opacity, camera, bg,
                           sh=wg.sh, sh_degree=sh_degree, alive=wg.alive, cfg=tcfg,
                           use_pallas=cfg.pipeline.use_pallas).color
        if state.color_net is not None:
            img = color_net_apply(state.color_net, img)
        return img

    return render


def _background(cfg: Config, device) -> torch.Tensor:
    return (torch.ones(3, device=device) if cfg.model.white_background
            else torch.zeros(3, device=device))


@functools.lru_cache(maxsize=4)
def _eval_lpips_params(device: str):
    """LPIPS weights for eval ($GSAVATARS_LPIPS_WEIGHTS; the reference
    evaluates LPIPS at every report, `train.py:375-384`), cached per device.
    None when no weights file is given."""
    return maybe_load_default(device=device)


def evaluate_split(harness: TrainerHarness, split: str, render_fn, sh_degree: int,
                   max_views: Optional[int] = None, bg: Optional[torch.Tensor] = None,
                   return_images: bool = False):
    """PSNR/SSIM[/LPIPS] over a split (`training_report`, `train.py:313-394`).
    LPIPS is included when `$GSAVATARS_LPIPS_WEIGHTS` names a converted
    weights file (`metrics/lpips.py`). `return_images=True` also returns
    the first (render, ground truth) pair as numpy, for TensorBoard."""
    scene, cfg = harness.scene, harness.cfg
    cams = scene.cameras(split)
    recs = scene.records(split)
    if not cams:
        return ({}, None) if return_images else {}
    dev = scene.device
    if bg is None:
        bg = _background(cfg, dev)
    n = len(cams) if max_views is None else min(max_views, len(cams))
    lp = _eval_lpips_params(str(dev))
    psnrs, ssims, lpipss = [], [], []
    first_pair = None
    for i in range(n):
        gt = torch.from_numpy(load_view(recs[i], cams[i])).to(dev)
        img = torch.clamp(render_fn(harness.state, cams[i], cams[i].timestep, bg, sh_degree),
                          0.0, 1.0)
        if i == 0 and return_images:
            first_pair = (img.cpu().numpy(), gt.cpu().numpy())
        psnrs.append(float(psnr_fn(img, gt)))
        ssims.append(float(ssim_fn(img.permute(2, 0, 1), gt.permute(2, 0, 1))))
        if lp is not None:
            lpipss.append(float(lpips_fn(lp, img, gt)))
    m = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)), "n": n}
    if lpipss:
        m["lpips"] = float(np.mean(lpipss))
    if return_images:
        return m, first_pair
    return m


def densify_event(harness: TrainerHarness, iteration: int) -> dict:
    """One adaptive-density-control event (cadence: `train.py:264-273`)."""
    cfg, state, model = harness.cfg, harness.state, harness.model
    o = cfg.opt
    dcfg = DensifyConfig(
        grad_threshold=o.densify_grad_threshold,
        percent_dense=o.percent_dense,
        min_opacity=0.005,
        max_screen_size=20.0 if iteration > o.opacity_reset_interval else 0.0,
    )
    clone_thr = split_thr = None
    if o.use_smart_densification:
        clone_thr, split_thr = smart_thresholds(
            state.aux.grad_accum, state.aux.denom, o.densify_grad_threshold,
            o.densify_percentile_clone, o.densify_percentile_split)
    frames = None
    if model is not None:
        with torch.no_grad():
            frames = face_frames(model(_flame_params(state, 0))[0], model.faces)
    params, aux, mu, nu, report = densify_and_prune(
        state.params, state.aux, state.adam.mu, state.adam.nu,
        extent=harness.spatial_lr_scale, cfg=dcfg, frames=frames, generator=state.generator,
        clone_threshold=clone_thr, split_threshold=split_thr,
    )
    harness.state = dataclasses.replace(state, params=params, aux=aux,
                                        adam=state.adam._replace(mu=mu, nu=nu))
    out = {k: int(v) for k, v in report._asdict().items()}
    if clone_thr is not None:
        out.update(clone_threshold=float(clone_thr), split_threshold=float(split_thr))
    return out


def grow_gauss_capacity_event(harness: TrainerHarness, factor: int = 2) -> int:
    """Double the Gaussian slot capacity after densify dropped requests
    (the reference grows its tensors; padded buffers grow explicitly)."""
    state = harness.state
    new_cap = state.params.capacity * factor
    params, aux, mu, nu = grow_capacity(state.params, state.aux, state.adam.mu,
                                        state.adam.nu, new_cap)
    harness.state = dataclasses.replace(state, params=params, aux=aux,
                                        adam=state.adam._replace(mu=mu, nu=nu))
    return new_cap


def opacity_reset_event(harness: TrainerHarness) -> None:
    state = harness.state
    params, mu, nu = reset_opacity(state.params, state.adam.mu, state.adam.nu)
    harness.state = dataclasses.replace(state, params=params,
                                        adam=state.adam._replace(mu=mu, nu=nu))


class DeviceGtCache:
    """All ground-truth views resident on the device as uint8, uploaded once
    (4× smaller than float32; `get` converts). At 802×550 a view is 1.3 MB,
    so 96 views are 127 MB of device memory."""

    def __init__(self, records, cameras, device, max_bytes: int = 4 << 30):
        h, w = cameras[0].height, cameras[0].width
        if len(records) * h * w * 3 > max_bytes:
            raise MemoryError("dataset too large for the device GT cache")
        self.data = torch.from_numpy(view_stack(records, cameras)).to(device)

    def get(self, view: int) -> torch.Tensor:
        return gt_to_float(self.data[view])


def _timed(harness: TrainerHarness, kind: str, it: int, fn, **info):
    """fn() on the host clock, recorded in `harness.events` with `info` and,
    when fn returns a dict (or a tuple that starts with one), its items."""
    t0 = time.perf_counter()
    out = fn()
    ev = {"kind": kind, "iteration": it, "ms": 1e3 * (time.perf_counter() - t0), **info}
    rec = out[0] if isinstance(out, tuple) else out
    if isinstance(rec, dict):
        ev.update(rec)
    harness.events.append(ev)
    return out


def _post_step_events(
    harness: TrainerHarness,
    it: int,
    sh_deg: int,
    *,
    writer,
    render_fn,
    eval_every: Optional[int],
    eval_views: int,
    bg: torch.Tensor,
    save_set: set,
    ckpt_set: set,
    eval_set: frozenset = frozenset(),
    coordinator: bool = True,
) -> None:
    """Densify / opacity reset / eval / save / checkpoint at the standard
    cadences (`train.py:264-289`), with the JAX loop's TensorBoard records
    when `writer` is given. Each event's host milliseconds go to
    `harness.events`.

    Shared by `train` and `train_sharded`. The events that change the
    state (densify, capacity growth, opacity reset) run in every rank:
    they are functions of the replicated state (and of its generator's
    draws, taken alike in every rank). Eval, saves, checkpoints and prints
    run only when `coordinator` (rank 0); the eval render makes no
    collective."""
    cfg, scene, model = harness.cfg, harness.scene, harness.model
    o = cfg.opt
    # Strictly after densify_from_iter (reference train.py:268 uses `>`).
    if o.densify_from_iter < it < o.densify_until_iter and it % o.densification_interval == 0:
        report = _timed(harness, "densify", it, lambda: densify_event(harness, it))
        if coordinator:
            print(f"  [densify {it}] {report}")
        if writer:
            for k in ("cloned", "split", "pruned", "dropped"):
                writer.add_scalar(f"densify/{k}", report[k], it)
        if report.get("dropped", 0) > 0:
            new_cap = grow_gauss_capacity_event(harness)
            if coordinator:
                print(f"[warn] densify dropped {report['dropped']} grow requests "
                      f"— Gaussian capacity doubled to {new_cap}")
    # The reference resets opacity on the interval and once at
    # densify_from_iter for white-background scenes (train.py:272-273).
    if it < o.densify_until_iter and (
            it % o.opacity_reset_interval == 0
            or (cfg.model.white_background and it == o.densify_from_iter)):
        _timed(harness, "opacity_reset", it, lambda: opacity_reset_event(harness))
    if not coordinator:
        return
    if (eval_every and it % eval_every == 0) or it in eval_set:
        for split in ("val", "test"):
            res = _timed(harness, "eval", it, lambda: evaluate_split(
                harness, split, render_fn, sh_deg, max_views=eval_views, bg=bg,
                return_images=writer is not None), split=split)
            m, pair = res if writer else (res, None)
            if m:
                extra = f" lpips={m['lpips']:.4f}" if "lpips" in m else ""
                print(f"  [eval {split}] psnr={m['psnr']:.2f} ssim={m['ssim']:.4f}{extra}")
                if writer:
                    for k in ("psnr", "ssim", "lpips"):
                        if k in m:
                            writer.add_scalar(f"{split}/{k}", m[k], it)
            if writer and pair is not None:
                # Render / GT / seismic error map images + opacity histogram
                # (reference logging set, train.py:326-346,385-391).
                img, gt = pair
                writer.add_image(f"{split}/render", img, it, dataformats="HWC")
                writer.add_image(f"{split}/gt", gt, it, dataformats="HWC")
                writer.add_image(f"{split}/error", error_map(img, gt), it, dataformats="HWC")
        if writer:
            alive = harness.state.aux.alive
            opac = torch.sigmoid(harness.state.params.logit_opacity[:, 0])[alive]
            if opac.numel():
                writer.add_histogram("scene/opacity", opac.cpu().numpy(), it)
            writer.add_scalar("scene/total_points", int(alive.sum()), it)
    if it in save_set:
        def save():
            flame_param = (flame_table_from_state(harness.state, scene.flame_table)
                           if model is not None else None)
            scene.save(it, harness.state.params, harness.state.aux, flame_param)
        _timed(harness, "save", it, save)
    if it in ckpt_set:
        _timed(harness, "checkpoint", it, lambda: save_train_state(
            os.path.join(cfg.model.model_path, f"chkpnt{it}.npz"), harness.state, it))


def _grow_tile_budgets(tcfg: TileConfig, overflow: int, budget_overflow: int,
                       verbose: bool = True, max_footprint: int = 0, n_gauss: int = 0,
                       sorted_mode: bool = False) -> Optional[TileConfig]:
    """Grow whichever static tile budget overflowed (the CUDA reference's
    per-tile lists are dynamic). Returns the grown config, or None if
    nothing overflowed. The sorted pipeline (`sorted_mode`) grows its tier
    budgets toward the observed footprint; the table pipeline doubles its
    tile capacity after a capacity overflow and its tiles a Gaussian after
    a budget overflow."""
    if overflow <= 0 and budget_overflow <= 0:
        return None
    if sorted_mode and budget_overflow > 0:
        new = grow_tiers(tcfg.tier_spec(n_gauss), max_footprint, n_gauss)
        if verbose:
            print(f"[warn] tier-budget overflow ({budget_overflow} bbox tiles truncated, max "
                  f"footprint {max_footprint}) — tiers grown to {new.tiers} (rebuilding steps)")
        return dataclasses.replace(tcfg, base_budget=new.base, tiers=new.tiers)
    if overflow > 0:
        tcfg = dataclasses.replace(tcfg, capacity=tcfg.capacity * 2)
        if verbose:
            print(f"[warn] tile capacity overflow ({overflow} splats culled) — tile capacity "
                  f"doubled to {tcfg.capacity} (rebuilding steps)")
    if budget_overflow > 0:
        tcfg = dataclasses.replace(tcfg, max_tiles_per_gaussian=tcfg.max_tiles_per_gaussian * 2)
        if verbose:
            print(f"[warn] tile-budget overflow ({budget_overflow} bbox tiles truncated) — "
                  f"max_tiles_per_gaussian doubled to {tcfg.max_tiles_per_gaussian} "
                  "(rebuilding steps)")
    return tcfg


BUDGET_METRICS = ("overflow", "budget_overflow", "max_footprint")


class _LogCadence:
    """What both loops do with the step's budget counters and at their log
    cadence: the counters kept as running maxima on the device (`add`;
    a chunk's [K] metrics add their maxima), read on the host only by
    `grow` (at a log, and at the end of each chunk), the budgets grown when
    one overflowed (`_grow_tile_budgets`, recorded in `harness.events`); the
    log record (its overflow counts the maxima read since the last log),
    TensorBoard, the print (when `verbose`) and `on_step`."""

    def __init__(self, harness: TrainerHarness, iterations: int, sorted_mode: bool, writer,
                 on_step, verbose: bool = True):
        self.harness, self.iterations, self.sorted_mode = harness, iterations, sorted_mode
        self.writer, self.on_step, self.verbose = writer, on_step, verbose
        self.maxima = None
        self.seen = (0, 0)
        self.ema = None
        self.logs: List[dict] = []
        self.t0 = time.time()

    def add(self, metrics: dict) -> None:
        new = [metrics[k] if metrics[k].dim() == 0 else torch.max(metrics[k])
               for k in BUDGET_METRICS]
        self.maxima = new if self.maxima is None else [
            torch.maximum(a, b) for a, b in zip(self.maxima, new)]

    def grow(self, it: int, tcfg: TileConfig) -> Optional[TileConfig]:
        """Read the maxima added since the last read; returns the grown tile
        config, or None."""
        if self.maxima is None:
            return None
        overflow_seen, budget_overflow_seen, mfp_seen = (int(x) for x in self.maxima)
        self.maxima = None
        self.seen = (max(self.seen[0], overflow_seen), max(self.seen[1], budget_overflow_seen))
        harness = self.harness
        grown = _grow_tile_budgets(tcfg, overflow_seen, budget_overflow_seen,
                                   verbose=self.verbose, max_footprint=mfp_seen,
                                   n_gauss=harness.state.params.capacity,
                                   sorted_mode=self.sorted_mode)
        if grown is not None:
            harness.events.append({
                "kind": "grow_tiers" if self.sorted_mode else "grow_table",
                "iteration": it, "ms": 0.0, "overflow": overflow_seen,
                "budget_overflow": budget_overflow_seen, "tiers": grown.tiers,
                "capacity": grown.capacity,
                "max_tiles_per_gaussian": grown.max_tiles_per_gaussian})
            harness.live_tile_config = grown
        return grown

    def log(self, it: int, metrics: dict, tcfg: TileConfig, **extra) -> Optional[TileConfig]:
        """Log iteration `it` (after `grow`); returns the grown tile config,
        or None."""
        harness = self.harness
        grown = self.grow(it, tcfg)
        (overflow_seen, budget_overflow_seen), self.seen = self.seen, (0, 0)
        loss = float(metrics["loss"])
        self.ema = ema = loss if self.ema is None else 0.6 * self.ema + 0.4 * loss
        rec = {
            "iteration": it,
            "loss": loss,
            "ema_loss": ema,
            "psnr": float(metrics["psnr"]),
            "num_points": int(num_alive(harness.state.aux)),
            "overflow": overflow_seen,
            "budget_overflow": budget_overflow_seen,
            **extra,
            "elapsed_s": time.time() - self.t0,
        }
        self.logs.append(rec)
        if self.writer:
            for k in ("loss", "psnr", "num_points"):
                self.writer.add_scalar(f"train/{k}", rec[k], it)
        if self.verbose:
            print(f"[{it}/{self.iterations}] loss={loss:.5f} ema={ema:.5f} "
                  f"psnr={rec['psnr']:.2f} pts={rec['num_points']}")
        if self.on_step:
            self.on_step(it, rec)
        return grown


class _ScaleSources:
    """Both loops' ground truth: one source an image divisor (1 / scale),
    built when its scale first runs and dropped once it cannot recur (the
    JAX loop's eviction, `loop.py:759-777`). A source is a device cache of
    every training view (uint8) when it fits in `device_cache_bytes`, with
    a sampler seeded by `seed`; else a threaded prefetcher of `batch` views
    a draw, seeded alike."""

    def __init__(self, harness: TrainerHarness, recs, seed: int, device_cache_bytes: int,
                 prefetch_workers: int, batch: int = 1):
        self.harness, self.recs, self.seed = harness, recs, seed
        self.cache_bytes, self.workers, self.batch = device_cache_bytes, prefetch_workers, batch
        self.sources: Dict[float, tuple] = {}

    def _source(self, div: float, it: int) -> tuple:
        if div not in self.sources:
            scene, recs = self.harness.scene, self.recs
            cams = scene.cameras("train", div)
            try:
                src = _timed(self.harness, "gt_cache", it, lambda: DeviceGtCache(
                    recs, cams, scene.device, max_bytes=self.cache_bytes), views=len(recs),
                    scale=1.0 / div)
                sampler = iter(EpochSampler(len(recs), self.seed))
            except MemoryError:
                src = Prefetcher(recs, cams, scene.device, seed=self.seed,
                                 workers=self.workers, batch=self.batch)
                sampler = None
            self.sources[div] = (src, sampler, cams)
        return self.sources[div]

    def draw(self, div: float, it: int, row: int = 0) -> tuple:
        """The next `batch` views of scale 1 / `div`, the float ground
        truth [H, W, 3] of view `row` of them, and the scale's cameras."""
        src, sampler, cams = self._source(div, it)
        if sampler is not None:
            views = [next(sampler) for _ in range(self.batch)]
            return views, src.get(views[row]), cams
        views, gt = src.next()
        return views, gt[row], cams

    def draw_chunk(self, div: float, it: int, k: int) -> tuple:
        """The next `k` views of scale 1 / `div` for a chunk: (views, the
        device cache [V, H, W, 3] uint8, the scale's cameras). Only a
        device cache serves chunks (`resident`)."""
        src, sampler, cams = self._source(div, it)
        return [next(sampler) for _ in range(k)], src.data, cams

    def resident(self, div: float, it: int) -> bool:
        """Whether scale 1 / `div`'s views are in a device cache (else a
        prefetcher streams them)."""
        return self._source(div, it)[1] is not None

    def evict_past(self, it: int) -> list:
        """Drop the sources of scales that cannot recur after `it`; returns
        their divisors."""
        o = self.harness.cfg.opt
        seg = sum(1 for m in o.resolution_milestones if it >= m)
        future = {1.0 / s for s in o.resolution_schedule[seg:]}
        gone = [d for d in self.sources if d not in future]
        for d in gone:
            src = self.sources.pop(d)[0]
            if isinstance(src, Prefetcher):
                src.close()
            self.harness.events.append({"kind": "evict_scale", "iteration": it, "ms": 0.0,
                                        "scale": 1.0 / d})
        return gone

    def scales(self) -> list:
        return sorted(1.0 / d for d in self.sources)

    def close(self) -> None:
        for src, _, _ in self.sources.values():
            if isinstance(src, Prefetcher):
                src.close()


def chunk_boundary(
    i: int,
    *,
    iterations: int,
    steps_per_call: int,
    log_every: int,
    eval_every: Optional[int],
    opt,
    save_iterations: Sequence[int] = (),
    checkpoint_iterations: Sequence[int] = (),
    eval_iterations: Sequence[int] = (),
) -> int:
    """Last iteration (inclusive) of a chunk starting at iteration `i` (the
    JAX package's `chunk_boundary`, `training/loop.py:555-590`).

    Two kinds of host events bound a chunk:

      * **post-step** events (log, densify, opacity reset, eval, save,
        checkpoint) act *after* iteration k — the chunk must END AT k;
      * **pre-step** config changes (SH warm-up bumps `active_sh_degree` at
        multiples of 1000; progressive resolution swaps cameras at each
        milestone m) take effect *for* iteration k — the chunk must end at
        k − 1 so the next chunk re-reads sh_degree / resolution before
        running k. Ending at k would run iteration k with the stale value
        and break single-step equivalence.
    """
    o = opt
    cands = [iterations, i + steps_per_call - 1]
    # Post-step events: end the chunk AT the event iteration.
    for interval in (log_every, o.densification_interval,
                     o.opacity_reset_interval, eval_every or 0):
        if interval and interval > 0:
            cands.append(((i + interval - 1) // interval) * interval)
    for s in (list(save_iterations) + list(checkpoint_iterations)
              + list(eval_iterations)):
        if s >= i:
            cands.append(s)
    # The one-time white-background opacity reset fires at exactly
    # densify_from_iter (train.py:272-273) — a post-step event that is not
    # necessarily a multiple of any interval above.
    if o.densify_from_iter >= i:
        cands.append(o.densify_from_iter)
    # Pre-step config changes: end the chunk one iteration BEFORE.
    cands.append((i // 1000 + 1) * 1000 - 1)          # SH warm-up
    if o.use_progressive_resolution:
        for m in o.resolution_milestones:
            if m - 1 >= i:
                cands.append(m - 1)
    return max(min(c for c in cands if c >= i), i)


def train(
    harness: TrainerHarness,
    iterations: Optional[int] = None,
    log_every: int = 100,
    eval_every: Optional[int] = None,
    save_iterations: Sequence[int] = (),
    checkpoint_iterations: Sequence[int] = (),
    eval_iterations: Sequence[int] = (),
    eval_views: int = 4,
    on_step: Optional[Callable[[int, dict], None]] = None,
    seed: int = 0,
    prefetch_workers: int = 4,
    device_cache_bytes: int = 4 << 30,
    steps_per_call: int = 1,
    gui_service: Optional[Callable[[int], bool]] = None,
    debug_from: int = -1,
) -> List[dict]:
    """Run the loop; returns the logged metric dicts.

    The ground truth comes from a device cache of every training view
    (uint8) when it fits in `device_cache_bytes`, else from a threaded
    prefetcher; one per image scale under progressive resolution, built
    when its scale first runs and dropped once it cannot recur (the JAX
    loop's eviction, `loop.py:759-777`). The tier budgets are probed at
    scale 1.0. A log record also holds the iteration's
    `resolution_scale` and the scales whose caches are held
    (`cached_scales`).

    `steps_per_call` > 1 runs chunks of up to that many steps a dispatch
    (`trainer.make_train_chunk`: on the card one captured CUDA graph of the
    step, replayed once a step), as the JAX loop runs them as one
    `lax.scan`. A chunk never crosses a host event (`chunk_boundary`), so
    the result is that of single steps. Chunks need the device cache (with
    a prefetcher the loop single-steps), and one fov for every training
    camera (mixed intrinsics single-step, with a warning). The budget
    counters' maxima over a chunk are read once at its end, and the log
    takes the chunk's last metrics.

    `gui_service(it)` is called after every dispatch (the reference services
    its viewer socket every iteration, `train.py:143-172`); it returns True
    while a client is connected, which drops the loop to single steps so
    that every iteration is served. From `debug_from` on (when >= 0) the
    loop single-steps (a chunk ends at `debug_from` − 1), and every step's
    metrics and the parameters are checked finite
    (`utils/debug.assert_finite`, which raises `FloatingPointError`; the
    reference's `--debug_from`, `train.py:189-190`). TensorBoard records go
    to `model_path` when the package is importable (`_maybe_tensorboard`)."""
    cfg, scene, model = harness.cfg, harness.scene, harness.model
    o = cfg.opt
    iterations = iterations if iterations is not None else o.iterations
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    dev = scene.device
    tcfg = tile_config(cfg)
    recs = scene.records("train")
    if recs:
        tcfg = probe_tier_budgets(tcfg, cfg, model, harness.state, scene.cameras("train")[0])
    bg = _background(cfg, dev)
    if steps_per_call > 1 and len({(c.fovx, c.fovy) for c in scene.cameras("train")}) > 1:
        print("[warn] per-camera intrinsics detected — disabling chunks (single-step "
              "dispatch; train_sharded supports mixed intrinsics at full speed)")
        steps_per_call = 1

    step = chunk = None
    sources = _ScaleSources(harness, recs, seed, device_cache_bytes, prefetch_workers)
    render_fn = make_render_fn(model, cfg, tcfg)
    save_set = set(save_iterations)
    ckpt_set = set(checkpoint_iterations)
    eval_set = frozenset(eval_iterations)
    harness.live_tile_config = tcfg
    writer = _maybe_tensorboard(cfg.model.model_path)
    cadence = _LogCadence(harness, iterations, cfg.pipeline.use_sorted and cfg.pipeline.use_pallas,
                          writer, on_step)
    gui_connected = False
    try:
        it = harness.start_iteration + 1
        while it <= iterations:
            if step is None:
                step = make_train_step(model, cfg, tcfg, spatial_lr_scale=harness.spatial_lr_scale)
                if steps_per_call > 1:
                    chunk = make_train_chunk(model, cfg, tcfg,
                                             spatial_lr_scale=harness.spatial_lr_scale)
            scale = 1.0
            if o.use_progressive_resolution:
                scale = resolution_scale_at(it, o.resolution_schedule, o.resolution_milestones)
                if sources.evict_past(it) and chunk is not None:
                    chunk.drop()    # its graph reads the evicted cache
            sh_deg = active_sh_degree(it, cfg.model.sh_degree)
            debugging = 0 <= debug_from <= it
            end = it if (gui_connected or debugging) else chunk_boundary(
                it, iterations=iterations, steps_per_call=steps_per_call, log_every=log_every,
                eval_every=eval_every, opt=o, save_iterations=save_iterations,
                checkpoint_iterations=checkpoint_iterations, eval_iterations=eval_iterations)
            if not debugging and debug_from > it:
                # Single steps (and finite checks) begin AT debug_from.
                end = min(end, debug_from - 1)
            k = end - it + 1
            chunked = k > 1 and chunk is not None and sources.resident(1.0 / scale, it)
            if chunked:
                views, cache, cams_all = sources.draw_chunk(1.0 / scale, it, k)
                cams = stack_cameras([cams_all[v] for v in views])
                n0 = chunk.captures
                harness.state, m_all = chunk(harness.state, cache, views, cams,
                                             [cams_all[v].timestep for v in views], bg, sh_deg)
                harness.chunk_captures += chunk.captures - n0
                metrics = {name: v[-1] for name, v in m_all.items()}
                cadence.add(m_all)
                it = end
                size = (cams.height, cams.width)
            else:
                (v,), gt0, cams_all = sources.draw(1.0 / scale, it)
                cam = cams_all[v]
                out = step(harness.state, gt0, cam, cam.timestep, bg, sh_deg)
                harness.state = out.state
                metrics = out.metrics
                cadence.add(metrics)
                k, size = 1, (cam.height, cam.width)
            harness.steps_by_size[size] = harness.steps_by_size.get(size, 0) + k
            if gui_service is not None:
                gui_connected = bool(gui_service(it))
            if debugging:
                assert_finite(metrics, f"metrics@it{it}")
                assert_finite(harness.state.params, f"params@it{it}")

            if it % log_every == 0 or it == iterations:
                grown = cadence.log(it, metrics, tcfg, resolution_scale=scale,
                                    cached_scales=sources.scales())
            else:
                # A chunk's budget maxima are read at its end.
                grown = cadence.grow(it, tcfg) if chunked else None
            if grown is not None:
                tcfg = grown
                step = chunk = None
                render_fn = make_render_fn(model, cfg, tcfg)

            _post_step_events(
                harness, it, active_sh_degree(it, cfg.model.sh_degree),
                writer=writer, render_fn=render_fn, eval_every=eval_every,
                eval_views=eval_views, bg=bg,
                save_set=save_set, ckpt_set=ckpt_set, eval_set=eval_set,
            )
            it += 1
    finally:
        sources.close()
        if writer:
            writer.close()
    return cadence.logs


def train_sharded(
    harness: TrainerHarness,
    mesh,
    iterations: Optional[int] = None,
    log_every: int = 100,
    eval_every: Optional[int] = None,
    save_iterations: Sequence[int] = (),
    checkpoint_iterations: Sequence[int] = (),
    eval_iterations: Sequence[int] = (),
    eval_views: int = 4,
    gauss_shard: bool = False,
    seed: int = 0,
    prefetch_workers: int = 4,
    device_cache_bytes: int = 4 << 30,
    on_step: Optional[Callable[[int, dict], None]] = None,
    gui_service: Optional[Callable[[int], bool]] = None,
    debug_from: int = -1,
    collectives=None,
) -> List[dict]:
    """The loop over a ('data', 'tile') rank mesh (`parallel/mesh.RankMesh`);
    every rank of the world runs it.

    Each step trains `mesh.data` cameras, one a data group, with the
    compositing split over `mesh.tile` row bands (and with `gauss_shard`
    the per-Gaussian geometry too): `parallel/sharded.py`. The state is
    replicated, so densification, opacity resets, eval, saves and
    checkpoints are the single-device loop's events at its cadences
    (`_post_step_events`); I/O, prints, TensorBoard and `gui_service` (given
    on rank 0) run on rank 0 only, and the other ranks wait for it after
    each (`CoordinatorHold`, no practical deadline: a viewer client may
    pause training). Every rank draws the same views from the same seeded
    source (`_ScaleSources`, as `train`'s) and keeps its own row's ground
    truth; the tier budgets are probed on the full frame and grown from the
    mesh-reduced metrics, so every rank grows them alike. Rank 0's initial
    state is broadcast first. Under progressive resolution each image scale
    has its own step and source, dropped once the scale cannot recur.
    At the log cadence every rank checks that all hold the same state
    (`state_digest` in the log record); they raise when one has drifted.
    `collectives` (default: a new `Collectives` on the world's backend)
    keeps the step's collective bookkeeping."""
    from ..parallel.distributed import (
        Collectives, CoordinatorHold, is_coordinator, make_local_batch,
    )
    from ..parallel.sharded import (
        camera_batch, make_sharded_train_step, pad_gt_for_mesh, padded_height,
    )

    cfg, scene, model = harness.cfg, harness.scene, harness.model
    o = cfg.opt
    iterations = iterations if iterations is not None else o.iterations
    dev = scene.device
    coord = is_coordinator()
    coll = collectives or Collectives(torch.distributed.get_backend())
    for leaf in flatten_state(harness.state).values():
        coll.broadcast(leaf)
    hold = CoordinatorHold()
    viewer = bool(hold.wait(coord and gui_service is not None))   # rank 0 serves one
    tcfg = tile_config(cfg)
    recs = scene.records("train")
    if recs:
        # The full frame's footprints bound every band's.
        tcfg = probe_tier_budgets(tcfg, cfg, model, harness.state, scene.cameras("train")[0],
                                  verbose=coord)
    bg = _background(cfg, dev)
    steps: Dict[float, Callable] = {}
    sources = _ScaleSources(harness, recs, seed, device_cache_bytes, prefetch_workers,
                            batch=mesh.data)
    render_fn = make_render_fn(model, cfg, tcfg)
    harness.live_tile_config = tcfg
    writer = _maybe_tensorboard(cfg.model.model_path) if coord else None
    cadence = _LogCadence(harness, iterations, cfg.pipeline.use_sorted and cfg.pipeline.use_pallas,
                          writer, on_step, verbose=coord)
    logs = cadence.logs
    save_set, ckpt_set = set(save_iterations), set(checkpoint_iterations)
    eval_set = frozenset(eval_iterations)
    try:
        for it in range(harness.start_iteration + 1, iterations + 1):
            sh_deg = active_sh_degree(it, cfg.model.sh_degree)
            scale = 1.0
            if o.use_progressive_resolution:
                scale = resolution_scale_at(it, o.resolution_schedule, o.resolution_milestones)
                for d in sources.evict_past(it):
                    steps.pop(d, None)
            # The same views in every rank (the samplers are seeded alike);
            # each rank keeps its own row's ground truth.
            views, gt, cams_all = sources.draw(1.0 / scale, it, row=mesh.d)
            template = cams_all[0]
            if 1.0 / scale not in steps:
                steps[1.0 / scale] = make_sharded_train_step(
                    model, cfg, tcfg, mesh, template, spatial_lr_scale=harness.spatial_lr_scale,
                    gauss_shard=gauss_shard, collectives=coll)
            step = steps[1.0 / scale]
            hp = padded_height(template.height, tcfg.tile_h, mesh.tile)
            cams, gt = make_local_batch(mesh, camera_batch([cams_all[v] for v in views]),
                                        pad_gt_for_mesh(gt[None], hp))
            size = (template.height, template.width)
            harness.steps_by_size[size] = harness.steps_by_size.get(size, 0) + 1
            harness.state, metrics = step(harness.state, cams, gt, bg, sh_deg)
            cadence.add(metrics)
            if viewer:
                if coord:
                    gui_service(it)
                hold.wait()
            if 0 <= debug_from <= it:
                assert_finite(metrics, f"metrics@it{it}")
                assert_finite(harness.state.params, f"params@it{it}")

            if it % log_every == 0 or it == iterations:
                # The reduced metrics read alike in every rank: every rank
                # grows its budgets alike.
                grown = cadence.log(it, metrics, tcfg, resolution_scale=scale,
                                    cached_scales=sources.scales())
                if grown is not None:
                    tcfg = grown
                    steps.clear()
                    render_fn = make_render_fn(model, cfg, tcfg)

            _post_step_events(
                harness, it, sh_deg, writer=writer, render_fn=render_fn,
                eval_every=eval_every, eval_views=eval_views, bg=bg,
                save_set=save_set, ckpt_set=ckpt_set, eval_set=eval_set, coordinator=coord)
            if ((eval_every and it % eval_every == 0) or it in eval_set or it in save_set
                    or it in ckpt_set):
                hold.wait()   # rank 0 evaluated or wrote
            if it % log_every == 0 or it == iterations:
                logs[-1]["state_digest"] = _same_state_everywhere(harness.state, coll)
    finally:
        sources.close()
        if writer:
            writer.close()
    if coord and logs:
        rate = ""
        if len(logs) > 1:
            first, last = logs[0], logs[-1]
            per_s = ((last["iteration"] - first["iteration"])
                     / (last["elapsed_s"] - first["elapsed_s"]))
            rate = (f"; {per_s:.2f} steps/s from iteration {first['iteration']} to "
                    f"{last['iteration']}, events included")
        print(f"[mesh {mesh.data}x{mesh.tile}] {mesh.size} ranks hold state "
              f"{logs[-1]['state_digest']}{rate}")
    return logs


def _same_state_everywhere(state: TrainState, coll) -> str:
    """The state's digest (`parallel.sharded.state_digest`), checked equal
    in every rank by an all-gather of the 20 digest bytes; raises
    `RuntimeError` when the ranks have drifted apart."""
    from ..parallel.sharded import state_digest

    digest = state_digest(state)
    mine = torch.tensor(list(bytes.fromhex(digest)), dtype=torch.uint8,
                        device=state.params.means.device)
    every = coll.all_gather(mine[None], None).cpu()
    if not bool((every == every[0]).all()):
        raise RuntimeError(f"the ranks' states differ: {[bytes(r.tolist()).hex() for r in every]}")
    return digest


def _maybe_tensorboard(model_path: str):
    """A `SummaryWriter` on `model_path`; None when the path is empty or
    TensorBoard is not installed.

    The writer needs nothing of TensorFlow, whose import costs seconds,
    so unless TensorFlow is already loaded TensorBoard is given the marker
    module of its TensorFlow-free build (`tensorboard.compat.notf`), with
    which it uses its own stub."""
    if not model_path:
        return None
    if "tensorflow" not in sys.modules:
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(model_path)
