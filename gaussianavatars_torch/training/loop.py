"""Host training loop: the library behind `tools/train.py` and
`tools/train_synthetic.py`.

The port of the JAX package's `training/loop.py` (the reference training script,
`train.py:45-311`): one training step per iteration
(`trainer.make_train_step`) with host events at the reference's cadence —

  * SH warm-up every 1000 iterations (`train.py:176-177`),
  * densify/prune every `densification_interval` in
    (densify_from_iter, densify_until_iter) (`train.py:264-273`),
  * opacity reset every `opacity_reset_interval`,
  * eval reports (`training_report`, `train.py:313-394`: PSNR, SSIM, and
    LPIPS when `$GSAVATARS_LPIPS_WEIGHTS` names a weights file), PLY saves
    and full resume checkpoints (`train.py:287-289`),

TensorBoard scalars, images and histograms at the JAX loop's events and
tags (`_maybe_tensorboard`; none when the package is missing), the viewer
GUI service after every step (`gui_service`, for
`viewers/network_gui.TrainingGuiServer`), per-step finite assertions from
`debug_from` on, and the host side of the innovations: progressive resolution (the scale
of each iteration from `innovations.resolution_scale_at`, one ground-truth
cache and sampler per scale, the scales that cannot recur evicted), smart
densification's thresholds at each densify event, and the colour net in
`make_render_fn`, so that eval scores the calibrated image.

The loop owns host-side state (the ground-truth cache, the sampler, logs);
everything numeric is in the `TrainState` on the device. The step's
budget counters are kept as running maxima on the device and read only
at the log cadence: an iteration that does not log makes no host read of
a device value beyond what the step itself does.

The harness is FLAME-bound (`bind_to_mesh`) or unbound: a point cloud of
the dataset (COLMAP, or Blender's `points3d.ply` or random points)
initialised by `models/gaussians.init_from_points`, trained with no FLAME
leaves.

Not ported, each named in `ROADMAP.md`: `train_sharded` (multi-device),
and the JAX loop's fused chunks of steps (`steps_per_call`): the port runs
one step per iteration.
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
from .checkpoint import load_train_state, save_train_state
from .innovations import color_net_apply, resolution_scale_at, smart_thresholds
from .loss import psnr as psnr_fn, ssim as ssim_fn
from .trainer import TrainState, active_sh_degree, init_train_state, make_train_step


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
) -> TrainerHarness:
    """Scene, initial state (or `start_checkpoint`'s), and the model
    directory's `cfg_args.json` (and `flame_assets.npz` when bound).

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
        m.source_path, model_path=m.model_path, resolution=m.resolution,
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
        print(f"resumed from {start_checkpoint} at iteration {start_iteration}")

    if m.model_path:
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
) -> None:
    """Densify / opacity reset / eval / save / checkpoint at the standard
    cadences (`train.py:264-289`), with the JAX loop's TensorBoard records
    when `writer` is given. Each event's host milliseconds go to
    `harness.events`."""
    cfg, scene, model = harness.cfg, harness.scene, harness.model
    o = cfg.opt
    # Strictly after densify_from_iter (reference train.py:268 uses `>`).
    if o.densify_from_iter < it < o.densify_until_iter and it % o.densification_interval == 0:
        report = _timed(harness, "densify", it, lambda: densify_event(harness, it))
        print(f"  [densify {it}] {report}")
        if writer:
            for k in ("cloned", "split", "pruned", "dropped"):
                writer.add_scalar(f"densify/{k}", report[k], it)
        if report.get("dropped", 0) > 0:
            new_cap = grow_gauss_capacity_event(harness)
            print(f"[warn] densify dropped {report['dropped']} grow requests "
                  f"— Gaussian capacity doubled to {new_cap}")
    # The reference resets opacity on the interval and once at
    # densify_from_iter for white-background scenes (train.py:272-273).
    if it < o.densify_until_iter and (
            it % o.opacity_reset_interval == 0
            or (cfg.model.white_background and it == o.densify_from_iter)):
        _timed(harness, "opacity_reset", it, lambda: opacity_reset_event(harness))
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

    `gui_service(it)` is called after every step (the reference services
    its viewer socket every iteration, `train.py:143-172`). From
    `debug_from` on (when >= 0), every step's metrics and the parameters
    are checked finite (`utils/debug.assert_finite`, which raises
    `FloatingPointError`; the reference's `--debug_from`,
    `train.py:189-190`). TensorBoard records go to `model_path` when the
    package is importable (`_maybe_tensorboard`)."""
    cfg, scene, model = harness.cfg, harness.scene, harness.model
    o = cfg.opt
    iterations = iterations if iterations is not None else o.iterations
    dev = scene.device
    tcfg = tile_config(cfg)
    recs = scene.records("train")
    if recs:
        tcfg = probe_tier_budgets(tcfg, cfg, model, harness.state, scene.cameras("train")[0])
    bg = _background(cfg, dev)

    step = None
    # Per image divisor (1 / scale): the GT source and its sampler.
    sources: Dict[float, object] = {}
    samplers: Dict[float, object] = {}

    def source_for(div: float, it: int):
        if div not in sources:
            cams = scene.cameras("train", div)
            try:
                sources[div] = _timed(harness, "gt_cache", it, lambda: DeviceGtCache(
                    recs, cams, dev, max_bytes=device_cache_bytes), views=len(recs),
                    scale=1.0 / div)
                samplers[div] = iter(EpochSampler(len(recs), seed))
            except MemoryError:
                sources[div] = Prefetcher(recs, cams, dev, seed=seed, workers=prefetch_workers)
                samplers[div] = None
        return sources[div], samplers[div], scene.cameras("train", div)

    def evict_past(it: int) -> None:
        """Drop the sources of scales that cannot recur after `it`."""
        seg = sum(1 for m in o.resolution_milestones if it >= m)
        future = {1.0 / s for s in o.resolution_schedule[seg:]}
        for d in [k for k in sources if k not in future]:
            src = sources.pop(d)
            samplers.pop(d)
            if isinstance(src, Prefetcher):
                src.close()
            harness.events.append({"kind": "evict_scale", "iteration": it, "ms": 0.0,
                                   "scale": 1.0 / d})

    render_fn = make_render_fn(model, cfg, tcfg)
    logs: List[dict] = []
    ema = None
    save_set = set(save_iterations)
    ckpt_set = set(checkpoint_iterations)
    eval_set = frozenset(eval_iterations)
    # Running maxima of the step's budget counters, on the device.
    ovf_dev = bovf_dev = mfp_dev = None
    sorted_mode = cfg.pipeline.use_sorted and cfg.pipeline.use_pallas
    harness.live_tile_config = tcfg
    writer = _maybe_tensorboard(cfg.model.model_path)
    t0 = time.time()
    try:
        it = harness.start_iteration + 1
        while it <= iterations:
            if step is None:
                step = make_train_step(model, cfg, tcfg, spatial_lr_scale=harness.spatial_lr_scale)
            scale = 1.0
            if o.use_progressive_resolution:
                scale = resolution_scale_at(it, o.resolution_schedule, o.resolution_milestones)
                evict_past(it)
            source, sampler, cams_all = source_for(1.0 / scale, it)
            sh_deg = active_sh_degree(it, cfg.model.sh_degree)
            if sampler is not None:
                v = next(sampler)
                gt0 = source.get(v)
            else:
                views, gt = source.next()
                v, gt0 = views[0], gt[0]
            cam = cams_all[v]
            size = (cam.height, cam.width)
            harness.steps_by_size[size] = harness.steps_by_size.get(size, 0) + 1
            out = step(harness.state, gt0, cam, cam.timestep, bg, sh_deg)
            harness.state = out.state
            metrics = out.metrics
            ovf_dev = (metrics["overflow"] if ovf_dev is None
                       else torch.maximum(ovf_dev, metrics["overflow"]))
            bovf_dev = (metrics["budget_overflow"] if bovf_dev is None
                        else torch.maximum(bovf_dev, metrics["budget_overflow"]))
            mfp_dev = (metrics["max_footprint"] if mfp_dev is None
                       else torch.maximum(mfp_dev, metrics["max_footprint"]))
            if gui_service is not None:
                gui_service(it)
            if 0 <= debug_from <= it:
                assert_finite(metrics, f"metrics@it{it}")
                assert_finite(harness.state.params, f"params@it{it}")

            if it % log_every == 0 or it == iterations:
                overflow_seen = int(ovf_dev)
                budget_overflow_seen = int(bovf_dev)
                mfp_seen = int(mfp_dev)
                ovf_dev = bovf_dev = mfp_dev = None
                grown = _grow_tile_budgets(tcfg, overflow_seen, budget_overflow_seen,
                                           max_footprint=mfp_seen,
                                           n_gauss=harness.state.params.capacity,
                                           sorted_mode=sorted_mode)
                if grown is not None:
                    harness.events.append({
                        "kind": "grow_tiers" if sorted_mode else "grow_table",
                        "iteration": it, "ms": 0.0, "overflow": overflow_seen,
                        "budget_overflow": budget_overflow_seen, "tiers": grown.tiers,
                        "capacity": grown.capacity,
                        "max_tiles_per_gaussian": grown.max_tiles_per_gaussian})
                    tcfg = grown
                    harness.live_tile_config = tcfg
                    step = None
                    render_fn = make_render_fn(model, cfg, tcfg)

                loss = float(metrics["loss"])
                ema = loss if ema is None else 0.6 * ema + 0.4 * loss
                rec = {
                    "iteration": it,
                    "loss": loss,
                    "ema_loss": ema,
                    "psnr": float(metrics["psnr"]),
                    "num_points": int(num_alive(harness.state.aux)),
                    "overflow": overflow_seen,
                    "budget_overflow": budget_overflow_seen,
                    "resolution_scale": scale,
                    "cached_scales": sorted(1.0 / d for d in sources),
                    "elapsed_s": time.time() - t0,
                }
                logs.append(rec)
                if writer:
                    for k in ("loss", "psnr", "num_points"):
                        writer.add_scalar(f"train/{k}", rec[k], it)
                print(f"[{it}/{iterations}] loss={loss:.5f} ema={ema:.5f} "
                      f"psnr={rec['psnr']:.2f} pts={rec['num_points']}")
                if on_step:
                    on_step(it, rec)

            _post_step_events(
                harness, it, active_sh_degree(it, cfg.model.sh_degree),
                writer=writer, render_fn=render_fn, eval_every=eval_every,
                eval_views=eval_views, bg=bg,
                save_set=save_set, ckpt_set=ckpt_set, eval_set=eval_set,
            )
            it += 1
    finally:
        for src in sources.values():
            if isinstance(src, Prefetcher):
                src.close()
        if writer:
            writer.close()
    return logs


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
