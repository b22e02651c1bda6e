"""The training step, FLAME-bound or unbound: one function over a
`TrainState` of tensors.

The port of the JAX package's `training/trainer.make_train_step` on the
sorted-data pipeline (the reference's train loop body, `train.py:174-290`).
The step runs in two differentiable stages joined by an explicit
screen-space seam:

    geometry: (GaussianParams, FlameTrainable) → (mean2d, conic, colors, α)
              and the binding regularisers (xyz, scale, dynamic offsets,
              laplacian), under autograd;
    image:    the screen-space values, detached into leaves that require
              grad → rasterize → L1 + D-SSIM, whose gradient with respect to
              those leaves (`g_screen`) comes from `torch.autograd.grad`.

∂loss/∂mean2d (`g_screen[0]`) feeds the densification statistics, then one
backward of [*screen, reg_total] with [*g_screen, 1] takes the image and
regulariser gradients into the Gaussian parameters and the FLAME leaves
together, and per-group Adam (the exponential xyz schedule included)
updates both. `use_amp` runs the compositor's backward with its bf16
contraction and SSIM's blurs on bf16 operands, as the JAX step does.

The step-level innovations (`training/innovations.py`) sit in the image
stage, as in the JAX step: the colour net calibrates the rasterised image
(whose gradient drives the net's own Adam), the region-adaptive L1 weighs
it by the FLAME region map of the detached posed vertices, and the
colour-net and contrastive terms join the loss; the contrastive cache
takes the detached calibrated image after the step. An unbound step
(`model=None`, a point cloud) has no FLAME forward, no binding
regularisers and no FLAME Adam group, and its region-adaptive L1 weighs
by the heuristic face prior (`innovations.heuristic_weight_map`), as the
JAX step's `use_flame=False` branches do. Off the sorted pipeline
(`use_sorted=False` or `use_pallas=False`, or an explicit `compositor`)
the image stage bins once from the detached projection with the screen
opacity and composites the padded table (`rasterize_tiled.rasterize_binned`),
as the JAX step's table branch does; its `overflow` and `budget_overflow`
come from the table. On the sorted pipeline each step counts its binning
(`ops/sort_binning.count_plan`: expansion slots, and on the device its
live pairs and dropped tiles). The step is the span `train/step`, a row of the
stage clock (`utils/profiling.annotate`), and each stage a span inside it
(`train/*`; the innovations' `train/region_map`, `train/color_net` and
`train/contrastive` inside `train/image_fwd`, the thumbnail cache's
`train/contrastive_update` after Adam). An eager profile names the
stages' ranges; a captured step replays without them, and the stage
clock's stamps, captured with the step, split its device time by stage.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..config import Config
from ..data.cameras import Camera
from ..models.binding import face_frames
from ..models.densify import add_densification_stats
from ..models.flame.flame_model import FlameModel, FlameParams
from ..models.gaussians import GaussianAux, GaussianParams, world_gaussians
from ..ops.binding_gather import binding_gather
from ..ops.projection import project_from_params
from ..ops.rasterize_sorted import rasterize_sorted
from ..ops.rasterize_tiled import (
    TileConfig, bin_gaussians, composite_tiles, rasterize_binned, view_colors,
)
from ..ops.sort_binning import count_plan
from ..utils.graphs import GraphSlot, copy_in, graph_key, warm_up
from ..utils.profiling import annotate
from . import innovations as inn
from .loss import l1_loss, psnr, safe_norm, ssim, weighted_l1_loss
from .optim import AdamState, adam_init, adam_update, expon_lr, tree_leaves, tree_map


@dataclasses.dataclass
class FlameTrainable:
    """Per-timestep FLAME parameters under optimisation
    (`FlameGaussianModel.training_setup`, `scene/flame_gaussian_model.py:173-216`)."""

    expr: torch.Tensor         # [T, E]
    rotation: torch.Tensor     # [T, 3]
    neck: torch.Tensor         # [T, 3]
    jaw: torch.Tensor          # [T, 3]
    eyes: torch.Tensor         # [T, 6]
    translation: torch.Tensor  # [T, 3]
    # Per-timestep vertex offsets [T, V, 3] for the dynamic-offset
    # regularisers; not an optimiser group in the reference (lr 0).
    dynamic_offset: Optional[torch.Tensor] = None


@dataclasses.dataclass
class FlameStatic:
    shape: torch.Tensor                     # [S]
    static_offset: Optional[torch.Tensor]   # [V, 3] or None


@dataclasses.dataclass
class TrainState:
    params: GaussianParams
    aux: GaussianAux
    adam: AdamState
    # None for an unbound (point-cloud) model.
    flame: Optional[FlameTrainable]
    flame_static: Optional[FlameStatic]
    flame_adam: Optional[AdamState]
    # Innovations 4 and 5: None when off (the contrastive cache also when
    # `init_train_state` had no image size).
    color_net: Optional[inn.ColorNetParams] = None
    color_adam: Optional[AdamState] = None
    contrastive: Optional[inn.ContrastiveCache] = None
    # The host loop's random draws (the colour net's initial weights, the
    # densify split's normals): a CPU generator, where the JAX state
    # carries a PRNG key.
    generator: Optional[torch.Generator] = None


class StepOutput(NamedTuple):
    state: TrainState
    metrics: dict
    image: torch.Tensor


def init_train_state(params: GaussianParams, aux: GaussianAux, cfg: Config,
                     num_timesteps: int = 0, n_expr: int = 100, n_shape: int = 300,
                     num_verts: int = 0, flame_init: Optional[dict] = None,
                     generator: Optional[torch.Generator] = None,
                     image_hw: Optional[tuple] = None) -> TrainState:
    """Fresh Adam moments and FLAME leaves (zeros, or `flame_init`'s tensors)
    on the device of `params`, no FLAME leaves when `num_timesteps` is 0
    (an unbound model); the colour net (weights drawn from
    `generator`) and its Adam moments with `use_color_calibration`; the
    contrastive cache with `use_contrastive_reg` when `image_hw` is given,
    as in the JAX package. `generator` (default: a CPU generator seeded
    with 0, as the JAX package defaults to PRNGKey(0)) is carried in the
    state for the loop's draws."""
    dev = params.means.device
    fi = flame_init or {}

    def get(name, shape):
        v = fi.get(name)
        if v is None:
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    flame = flame_static = flame_adam = None
    if num_timesteps > 0:
        t = num_timesteps
        dyn = fi.get("dynamic_offset")
        if dyn is None and num_verts > 0 and (
                cfg.opt.lambda_dynamic_offset != 0 or cfg.opt.lambda_dynamic_offset_std != 0):
            dyn = torch.zeros((t, num_verts, 3))
        flame = FlameTrainable(
            expr=get("expr", (t, n_expr)), rotation=get("rotation", (t, 3)),
            neck=get("neck", (t, 3)), jaw=get("jaw", (t, 3)), eyes=get("eyes", (t, 6)),
            translation=get("translation", (t, 3)),
            dynamic_offset=None if dyn is None else torch.as_tensor(
                dyn, dtype=torch.float32, device=dev),
        )
        static_offset = None
        if "static_offset" in fi or num_verts:
            static_offset = get("static_offset", (num_verts, 3))
        flame_static = FlameStatic(shape=get("shape", (n_shape,)), static_offset=static_offset)
        flame_adam = adam_init(flame)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    o = cfg.opt
    color_net = color_adam = contrastive = None
    if o.use_color_calibration:
        color_net = inn.color_net_init(o.color_net_hidden_dim, o.color_net_layers,
                                       generator=generator, device=dev)
        color_adam = adam_init(color_net)
    if o.use_contrastive_reg and image_hw is not None:
        contrastive = inn.contrastive_init(o.contrastive_cache_size, image_hw[0], image_hw[1],
                                           o.contrastive_downsample, device=dev)
    return TrainState(params=params, aux=aux, adam=adam_init(params), flame=flame,
                      flame_static=flame_static, flame_adam=flame_adam,
                      color_net=color_net, color_adam=color_adam, contrastive=contrastive,
                      generator=generator)


def gaussian_lr_tree(params: GaussianParams, step, cfg: Config,
                     spatial_lr_scale: float) -> GaussianParams:
    """Per-field learning rates (`training_setup`, `scene/gaussian_model.py:214-232`)."""
    o = cfg.opt
    pos_lr = expon_lr(step, o.position_lr_init * spatial_lr_scale,
                      o.position_lr_final * spatial_lr_scale,
                      lr_delay_mult=o.position_lr_delay_mult,
                      max_steps=o.position_lr_max_steps)
    return GaussianParams(means=pos_lr, log_scales=o.scaling_lr, quats=o.rotation_lr,
                          sh_dc=o.feature_lr, sh_rest=o.feature_lr / 20.0,
                          logit_opacity=o.opacity_lr)


def flame_lr_tree(cfg: Config, flame: Optional[FlameTrainable] = None) -> FlameTrainable:
    o = cfg.opt
    return FlameTrainable(
        expr=o.flame_expr_lr, rotation=o.flame_pose_lr, neck=o.flame_pose_lr,
        jaw=o.flame_pose_lr, eyes=o.flame_pose_lr, translation=o.flame_trans_lr,
        # Not optimised in the reference (`scene/flame_gaussian_model.py:213-216`):
        # lr 0, so the buffer never moves.
        dynamic_offset=None if flame is None or flame.dynamic_offset is None else 0.0,
    )


def _leaves(tree):
    """A copy of a tree of tensors whose tensors are fresh leaves that
    require grad (None fields stay None)."""
    return tree_map(lambda x: x.detach().requires_grad_(), tree)


def _grads(leaves):
    """The leaves' gradients, zeros where none reached a leaf."""
    return tree_map(lambda x: torch.zeros_like(x) if x.grad is None else x.grad, leaves)


def _at(x: torch.Tensor, ts) -> torch.Tensor:
    """Row `ts` of `x` as [1, ...]. An int indexes; a 0-dim integer tensor
    on `x`'s device selects with `index_select`, which reads nothing on the
    host (indexing with it would), so a step with a tensor timestep can be
    captured in a CUDA graph. Both give the same values."""
    if isinstance(ts, torch.Tensor):
        return x.index_select(0, ts.reshape(1).to(torch.int64))
    return x[ts][None]


def flame_forward(model: FlameModel, state: TrainState, flame: FlameTrainable, ts):
    """The posed and canonical vertices [1, V, 3] of timestep `ts` (an int
    or a 0-dim tensor, `_at`)."""
    fp = FlameParams(
        shape=state.flame_static.shape,
        expr=_at(flame.expr, ts), rotation=_at(flame.rotation, ts),
        neck=_at(flame.neck, ts), jaw=_at(flame.jaw, ts), eyes=_at(flame.eyes, ts),
        translation=_at(flame.translation, ts),
        static_offset=state.flame_static.static_offset,
        dynamic_offset=None if flame.dynamic_offset is None
        else _at(flame.dynamic_offset, ts),
    )
    return model(fp, return_verts_cano=True)


def screen_space(params: GaussianParams, aux: GaussianAux, frames, camera, sh_degree: int):
    """The Gaussians on screen: ((mean2d, conic, colors, α), projection),
    α zero where the projection masks a Gaussian."""
    wg = world_gaussians(params, aux, frames)
    proj = project_from_params(wg.means, wg.scales, wg.quats, camera, alive=wg.alive)
    colors = view_colors(wg.means, wg.sh, camera, sh_degree)
    opac_eff = torch.where(proj.mask, wg.opacity, torch.zeros_like(wg.opacity))
    return (proj.mean2d, proj.conic, colors, opac_eff), proj


def binding_regularisers(model: FlameModel, cfg: Config, state: TrainState,
                         params: GaussianParams, flame: FlameTrainable, ts, frames,
                         verts, verts_cano, visible: torch.Tensor) -> dict:
    """The FLAME-bound regularisers by name (`train.py:229-243`): xyz and
    scale over the `visible` Gaussians, the dynamic offsets, the laplacian."""
    o = cfg.opt
    reg_terms = {}
    nvis = torch.clamp_min(visible.sum(), 1)
    zero = torch.zeros((), dtype=torch.float32, device=visible.device)
    (fs,) = binding_gather(state.aux.binding, frames.scaling)   # [N, 1]
    if o.metric_xyz:
        xyz_excess = safe_norm(torch.relu(params.means * fs - o.threshold_xyz), dim=1)
    else:
        xyz_excess = torch.relu(safe_norm(params.means, dim=1) - o.threshold_xyz)
    reg_terms["xyz"] = torch.where(visible, xyz_excess, zero).sum() / nvis * o.lambda_xyz
    if o.lambda_scale != 0:
        scale_val = torch.exp(params.log_scales)
        if o.metric_scale:
            scale_val = scale_val * fs
        sc_norm = safe_norm(torch.relu(scale_val - o.threshold_scale), dim=1)
        reg_terms["scale"] = (torch.where(visible, sc_norm, zero).sum() / nvis
                              * o.lambda_scale)
    if flame.dynamic_offset is not None and o.lambda_dynamic_offset != 0:
        reg_terms["dy_off"] = (safe_norm(_at(flame.dynamic_offset, ts)[0], dim=-1).mean()
                               * o.lambda_dynamic_offset)
    if flame.dynamic_offset is not None and o.lambda_dynamic_offset_std != 0:
        reg_terms["dynamic_offset_std"] = (
            torch.std(flame.dynamic_offset, dim=0, correction=1).mean()
            * o.lambda_dynamic_offset_std)
    if o.lambda_laplacian != 0:
        reg_terms["lap"] = model.laplacian_loss(verts, verts_cano) * o.lambda_laplacian
    return reg_terms


def geometry(model: Optional[FlameModel], cfg: Config, state: TrainState,
             params: GaussianParams, flame: Optional[FlameTrainable], ts, camera,
             sh_degree: int):
    """Stage 1 of the step, under autograd: (screen, reg_total, proj,
    reg_terms, posed vertices [V, 3] or None). Unbound (`model=None`):
    no binding and no regulariser."""
    frames = None
    if model is not None:
        verts, verts_cano = flame_forward(model, state, flame, ts)
        frames = face_frames(verts[0], model.faces)
    screen, proj = screen_space(params, state.aux, frames, camera, sh_degree)
    if model is None:
        return screen, torch.zeros((), device=screen[3].device), proj, {}, None
    reg_terms = binding_regularisers(model, cfg, state, params, flame, ts, frames, verts,
                                     verts_cano, proj.radius > 0)
    return screen, sum(reg_terms.values()), proj, reg_terms, verts[0]


class ImageLoss:
    """The image loss of a rendered frame, with the step-level innovations:
    the colour net calibrates the image, the region-adaptive L1 weighs it
    (by the FLAME region map of the detached posed vertices, or unbound by
    the heuristic face prior), D-SSIM, and the colour-net and contrastive
    terms. Call: (img, gt, camera, color_net, verts_sg, contrastive) →
    (total, terms by name, calibrated image)."""

    def __init__(self, model: Optional[FlameModel], cfg: Config):
        o = self.o = cfg.opt
        # The region tables clipped to the model's vertex count
        # (`vid_by_region`), as device index tensors built once; unbound,
        # the heuristic prior, built once an image size.
        self.region_idx = None
        self.heuristic_maps: dict = {}
        if o.use_region_adaptive_loss and model is not None:
            self.region_idx = inn.region_index_tensors(
                {k: model.vid_by_region([k])
                 for k in ("eyes_left", "eyes_right", "mouth", "nose")
                 if k in model.assets.vertex_masks}, model.faces.device)

    def heuristic_map(self, h: int, w: int, device) -> torch.Tensor:
        o = self.o
        if (h, w) not in self.heuristic_maps:
            self.heuristic_maps[h, w] = inn.heuristic_weight_map(
                h, w, o.region_weight_eyes, o.region_weight_mouth, o.region_weight_nose,
                o.region_weight_face, device=device)
        return self.heuristic_maps[h, w]

    def __call__(self, img, gt_image, camera, color_net, verts_sg, contrastive):
        o = self.o
        h, w = camera.height, camera.width
        if color_net is not None:
            with annotate("train/color_net"):
                img = inn.color_net_apply(color_net, img)
        if self.region_idx is not None:
            with annotate("train/region_map"):
                wmap = inn.flame_region_weight_map(
                    verts_sg, self.region_idx, camera, h, w, o.region_weight_eyes,
                    o.region_weight_mouth, o.region_weight_nose)
            losses = {"l1": weighted_l1_loss(img, gt_image, wmap[..., None])
                      * (1.0 - o.lambda_dssim)}
        elif o.use_region_adaptive_loss:
            wmap = self.heuristic_map(h, w, img.device)
            losses = {"l1": weighted_l1_loss(img, gt_image, wmap[..., None])
                      * (1.0 - o.lambda_dssim)}
        else:
            losses = {"l1": l1_loss(img, gt_image) * (1.0 - o.lambda_dssim)}
        chw = img.permute(2, 0, 1)
        gt_chw = gt_image.permute(2, 0, 1)
        losses["ssim"] = (1.0 - ssim(chw, gt_chw, amp=o.use_amp)) * o.lambda_dssim
        if color_net is not None and o.lambda_color_reg > 0:
            losses["color_reg"] = inn.color_net_reg(color_net) * o.lambda_color_reg
        if contrastive is not None and o.lambda_contrastive > 0:
            with annotate("train/contrastive"):
                losses["contrastive"] = (inn.contrastive_loss(contrastive, img,
                                                              o.contrastive_downsample)
                                         * o.lambda_contrastive)
        return sum(losses.values()), losses, img


def apply_updates(cfg: Config, spatial_lr_scale: float, state: TrainState, g_params,
                  g_flame, g_color) -> dict:
    """Per-group Adam on the Gaussians, FLAME (when bound) and the colour
    net (when on): the new state's fields by name."""
    o = cfg.opt
    lr_tree = gaussian_lr_tree(state.params, state.adam.step + 1, cfg, spatial_lr_scale)
    new = {}
    new["params"], new["adam"] = adam_update(state.params, g_params, state.adam, lr_tree)
    new["flame"], new["flame_adam"] = state.flame, state.flame_adam
    if state.flame is not None:
        new["flame"], new["flame_adam"] = adam_update(state.flame, g_flame, state.flame_adam,
                                                      flame_lr_tree(cfg, state.flame))
    new["color_net"], new["color_adam"] = state.color_net, state.color_adam
    if state.color_net is not None:
        new["color_net"], new["color_adam"] = adam_update(
            state.color_net, g_color, state.color_adam,
            tree_map(lambda _: o.color_net_lr, state.color_net))
    return new


def make_train_step(model: Optional[FlameModel], cfg: Config, tile_cfg: TileConfig,
                    spatial_lr_scale: float = 1.0, compositor=None):
    """Build the train step: FLAME-bound, or unbound with `model=None`.

    Call: step(state, gt_image [H, W, 3], camera, timestep, bg_color [3],
    sh_degree) → StepOutput(new state, metrics (0-dim tensors), image). The
    timestep is an int or a 0-dim integer tensor on the state's device
    (selected with `index_select`: the step then reads no device value on
    the host, so it can be captured in a CUDA graph); both give the same
    bits. The given state is not modified. An unbound step ignores
    `timestep`. The
    sorted pipeline runs when `cfg.pipeline.use_sorted` and `use_pallas`
    and no `compositor` is given; otherwise the table pipeline, composited
    by `compositor` (default `composite_tiles`).
    """
    o = cfg.opt
    use_sorted = cfg.pipeline.use_sorted and cfg.pipeline.use_pallas and compositor is None
    step_compositor = compositor or composite_tiles
    image_loss = ImageLoss(model, cfg)

    def rasterize(screen, proj, camera, bg_color, binned):
        mean2d, conic, colors, opac = screen
        h, w = camera.height, camera.width
        if use_sorted:
            img, _alpha, plan = rasterize_sorted(
                proj._replace(mean2d=mean2d, conic=conic), colors, opac,
                h, w, bg_color, tile_cfg.tile_h, tile_cfg.tile_w,
                tile_cfg.tier_spec(mean2d.shape[0]), amp=o.use_amp)
            count_plan(plan)
            return img, plan
        img, _alpha = rasterize_binned(mean2d, conic, colors, opac, binned, h, w, bg_color,
                                       tile_cfg, compositor=step_compositor)
        return img, None

    def train_step(state: TrainState, gt_image: torch.Tensor, camera: Camera, timestep,
                   bg_color: torch.Tensor, sh_degree: int) -> StepOutput:
        with annotate("train/step", row=True):
            return step_body(state, gt_image, camera, timestep, bg_color, sh_degree)

    def step_body(state, gt_image, camera, timestep, bg_color, sh_degree) -> StepOutput:
        ts = timestep if isinstance(timestep, torch.Tensor) else int(timestep)
        params = _leaves(state.params)
        flame = _leaves(state.flame)
        color = _leaves(state.color_net)
        color_leaves = [] if color is None else tree_leaves(color)

        # ---- stage 1: geometry and regularisers, under autograd
        with torch.enable_grad():
            with annotate("train/geometry_fwd"):
                screen, reg_total, proj, reg_terms, verts = geometry(
                    model, cfg, state, params, flame, ts, camera, sh_degree)
            proj_sg = proj._replace(**{k: v.detach() for k, v in proj._asdict().items()})
            binned = None
            if not use_sorted:
                # The table path bins once, from the detached projection
                # with the screen opacity.
                with annotate("train/binning"):
                    binned = bin_gaussians(proj_sg, camera.height, camera.width, tile_cfg,
                                           opacity=screen[3].detach())

            # ---- stage 2: the image loss from detached screen-space leaves
            screen_in = [x.detach().requires_grad_() for x in screen]
            with annotate("train/image_fwd"):
                img, plan = rasterize(screen_in, proj_sg, camera, bg_color, binned)
                img_total, loss_terms, img = image_loss(
                    img, gt_image, camera, color,
                    None if verts is None else verts.detach(), state.contrastive)
            with annotate("train/image_bwd"):
                g_all = torch.autograd.grad(img_total, screen_in + color_leaves)
            g_screen, g_color = g_all[:4], iter(g_all[4:])
            # ∂loss/∂mean2d → densification statistics.
            with annotate("train/densify_stats"):
                aux_new = add_densification_stats(state.aux, g_screen[0], proj_sg.radius,
                                                  camera.width, camera.height)
            # One backward: screen cotangents and a unit cotangent on the
            # regularisers (none unbound), into the Gaussian parameters and
            # FLAME.
            outs, cots = [*screen], [*g_screen]
            if reg_total.requires_grad:
                outs.append(reg_total)
                cots.append(torch.ones_like(reg_total))
            with annotate("train/geometry_bwd"):
                torch.autograd.backward(outs, cots)

        with annotate("train/adam"):
            new = apply_updates(cfg, spatial_lr_scale, state, _grads(params),
                                None if flame is None else _grads(flame),
                                None if color is None else tree_map(lambda _: next(g_color),
                                                                    color))
        img = img.detach()
        new_contrastive = state.contrastive
        if state.contrastive is not None:
            with annotate("train/contrastive_update"):
                new_contrastive = inn.contrastive_update(state.contrastive, img,
                                                         o.contrastive_downsample)
        if use_sorted:   # no tile capacity to overflow
            overflow = torch.zeros((), dtype=torch.int32, device=img.device)
            budget_overflow, max_footprint = plan.budget_overflow, plan.max_footprint
        else:
            overflow, budget_overflow = binned.overflow, binned.budget_overflow
            max_footprint = torch.zeros((), dtype=torch.int32, device=img.device)
        metrics = {
            "loss": (img_total + reg_total).detach(),
            "psnr": psnr(img, gt_image),
            "num_visible": (proj_sg.radius > 0).sum(),
            "overflow": overflow,
            "budget_overflow": budget_overflow,
            "max_footprint": max_footprint,
            **{k: v.detach() for k, v in {**loss_terms, **reg_terms}.items()},
        }
        new_state = TrainState(aux=aux_new, flame_static=state.flame_static,
                               contrastive=new_contrastive, generator=state.generator, **new)
        return StepOutput(state=new_state, metrics=metrics, image=img)

    return train_step


# The tensor fields of a `Camera`, stacked along a new leading axis by
# `stack_cameras`.
CAMERA_TENSORS = ("world_view", "proj", "full_proj", "camera_center")
# Eager steps before a chunk captures its step: lazy initialisation
# (kernel libraries, cached windows and maps, autograd's streams) happens
# outside the capture.
CHUNK_WARMUP = 3


def stack_cameras(cams) -> Camera:
    """Same-intrinsics cameras stacked along a new leading axis: a `Camera`
    whose tensor fields are [K, ...], with the first camera's size, fovs and
    metadata. The size and fovs are Python values fixed for a chunk, so
    mixed resolutions or intrinsics raise `ValueError` (the JAX package's
    `stack_cameras` asserts the same; `train()` single-steps such rigs)."""
    c0 = cams[0]
    for c in cams:
        if (c.width, c.height) != (c0.width, c0.height):
            raise ValueError("mixed resolutions")
        if (c.fovx, c.fovy) != (c0.fovx, c0.fovy):
            raise ValueError("mixed per-camera intrinsics cannot ride one chunk "
                             "(fov is static metadata)")
    return dataclasses.replace(c0, **{f: torch.stack([getattr(c, f) for c in cams])
                                      for f in CAMERA_TENSORS})


def camera_row(cams: Camera, i) -> Camera:
    """Camera `i` of a `stack_cameras` stack: `i` an int, or a [1] integer
    tensor on the cameras' device (selected with `index_select`)."""
    if isinstance(i, torch.Tensor):
        return dataclasses.replace(cams, **{f: getattr(cams, f).index_select(0, i)[0]
                                            for f in CAMERA_TENSORS})
    return dataclasses.replace(cams, **{f: getattr(cams, f)[i] for f in CAMERA_TENSORS})


def _host_ints(x) -> list:
    return x.tolist() if isinstance(x, torch.Tensor) else [int(v) for v in x]


def _stack_metrics(rows: list) -> dict:
    return {k: torch.stack([m[k] for m in rows]) for k in rows[0]}


class _StepBuffers:
    """The static buffers of a captured training step.

    Inputs: the state leaves (`state`, written back in place by every
    replay), the chunk's views, timesteps and camera tensors (`cap` rows),
    the background, and `counter`, the row a replay takes. A replay selects
    row `counter` of each (`index_select`), gathers that view's uint8
    ground truth from the cache and converts it (`gt_to_float`), runs the
    step, copies the new state into the state leaves, writes each metric
    into row `counter` of its [cap] buffer and adds one to `counter`."""

    def __init__(self, state: TrainState, cams: Camera, bg, metrics_like: dict, cap: int):
        from .checkpoint import flatten_state

        dev = bg.device
        self.cap, self.state = cap, state
        self.leaves = flatten_state(state)
        self.counter = torch.zeros(1, dtype=torch.int64, device=dev)
        self.views = torch.zeros(cap, dtype=torch.int64, device=dev)
        self.timesteps = torch.zeros(cap, dtype=torch.int64, device=dev)
        self.cams = dataclasses.replace(cams, **{
            f: torch.zeros((cap, *getattr(cams, f).shape[1:]), dtype=getattr(cams, f).dtype,
                           device=dev) for f in CAMERA_TENSORS})
        self.bg = bg.detach().clone()
        self.metrics = {k: torch.zeros(cap, dtype=v.dtype, device=dev)
                        for k, v in metrics_like.items()}

    def step(self, step, gt_cache, sh_degree: int) -> None:
        """One step over the buffers: the body the graph captures."""
        from ..data.pipeline import gt_to_float
        from .checkpoint import flatten_state

        c = self.counter
        gt = gt_to_float(gt_cache.index_select(0, self.views.index_select(0, c))[0])
        out = step(self.state, gt, camera_row(self.cams, c), self.timesteps.index_select(0, c)[0],
                   self.bg, sh_degree)
        for name, new in flatten_state(out.state).items():
            if new is not self.leaves[name]:
                self.leaves[name].copy_(new)
        for name, buf in self.metrics.items():
            buf.index_copy_(0, c, out.metrics[name].reshape(1).to(buf.dtype))
        self.counter.add_(1)

    def fill(self, state: TrainState, views, timesteps, cams: Camera, bg, start: int,
             k: int) -> None:
        """Rows ..k-1 of the chunk and `state` (copied into the state leaves
        unless it is they); the next replay takes row `start`."""
        from .checkpoint import flatten_state

        copy_in(self.leaves, flatten_state(state))
        copy_in({"views": self.views[:k], "timesteps": self.timesteps[:k], "bg": self.bg,
                 **{f: getattr(self.cams, f)[:k] for f in CAMERA_TENSORS}},
                {"views": torch.tensor(views, dtype=torch.int64),
                 "timesteps": torch.tensor(timesteps, dtype=torch.int64), "bg": bg,
                 **{f: getattr(cams, f)[:k] for f in CAMERA_TENSORS}})
        self.counter.fill_(start)


class TrainChunk:
    """K training steps a call, the port of the JAX package's
    `make_train_scan` (`make_train_chunk` builds it).

    Call: chunk(state, gt_cache [V, H, W, 3] uint8 (or float) on the
    state's device, views [K] ints, cams (`stack_cameras` of the K views'
    cameras; rows past K are not read), timesteps [K] ints, bg [3],
    sh_degree) → (state, metrics: dict of [K] tensors, row k that of step
    k). The K steps are the step's own, so the result is K
    `make_train_step` calls on the same views. The
    given state is consumed, as the JAX chunk donates it: on the card the
    returned state's tensors are the captured graph's buffers, which the
    next chunk overwrites.

    On the CPU the steps run one after another in a Python loop. On the
    card, on the sorted and the table pipeline alike, the step is captured
    once in a CUDA graph and replayed (`utils/graphs.py`): the first
    `CHUNK_WARMUP` steps of a chunk with no graph yet run eagerly on a side
    stream (real steps of the chunk), then one step is captured and
    replayed for the rest; later chunks replay it from their first step.
    Nothing is issued per step but the replay. The captured step runs the
    table pipeline in its host-read-free form (`ops/rasterize_tiled.
    fixed_walk`: every slot of the table's capacity, a pass over every
    tile), the same bits as the planned walk of eager steps. The graph is
    kept for one key, (image size, fovs, sh_degree, the state's leaf
    shapes, the ground truth cache, the stage clock's state), so one
    private memory pool is alive at a time; a chunk with another key drops
    it and captures anew, as does `drop()`. A capture that fails raises: a chunk never falls back
    to eager steps on the card. The engagement counts
    (`utils/profiling.counter`: the compositor's and the binding segment
    sum's launches, the binding index's builds) grow by their counts a
    step for every replay, so they count steps as eager steps do. The call's host
    phases are the spans `chunk/fill`, `chunk/replay` and `chunk/rows`."""

    def __init__(self, model: Optional[FlameModel], cfg: Config, tile_cfg: TileConfig,
                 spatial_lr_scale: float = 1.0):
        self.step = make_train_step(model, cfg, tile_cfg, spatial_lr_scale)
        self.slot = GraphSlot("train_chunk")
        self.buffers: Optional[_StepBuffers] = None

    @property
    def captures(self) -> int:
        return self.slot.captures

    @property
    def captured(self):
        return self.slot.captured

    def drop(self) -> None:
        """Release the captured graph and its memory pool."""
        self.slot.drop()
        self.buffers = None

    @staticmethod
    def key(state: TrainState, gt_cache: torch.Tensor, cams: Camera, sh_degree: int) -> tuple:
        """The captured step's key (`utils/graphs.graph_key`)."""
        from .checkpoint import flatten_state

        return graph_key(size=(cams.height, cams.width), fov=(cams.fovx, cams.fovy),
                         sh_degree=int(sh_degree),
                         gt_cache=(gt_cache.data_ptr(), tuple(gt_cache.shape), gt_cache.dtype),
                         state=tuple((n, tuple(x.shape), x.dtype)
                                     for n, x in flatten_state(state).items()))

    def eager(self, state, gt_cache, views, cams, timesteps, bg, sh_degree):
        """The plain version: the step once a row, in order."""
        from ..data.pipeline import gt_to_float

        rows = []
        for i, (v, ts) in enumerate(zip(_host_ints(views), _host_ints(timesteps))):
            out = self.step(state, gt_to_float(gt_cache[v]), camera_row(cams, i), ts, bg,
                            sh_degree)
            state = out.state
            rows.append(out.metrics)
        return state, _stack_metrics(rows)

    def __call__(self, state: TrainState, gt_cache: torch.Tensor, views, cams: Camera,
                 timesteps, bg: torch.Tensor, sh_degree: int):
        if gt_cache.device.type != "cuda":
            return self.eager(state, gt_cache, views, cams, timesteps, bg, sh_degree)
        views, timesteps = _host_ints(views), _host_ints(timesteps)
        k = len(views)
        key = self.key(state, gt_cache, cams, sh_degree)
        g = self.slot.get(key)
        if g is not None and self.buffers.cap < k:
            self.drop()
            g = None
        start, warm = 0, None
        if g is None:
            start = min(k, CHUNK_WARMUP)
            state, warm = warm_up(gt_cache.device, lambda: self.eager(
                state, gt_cache, views[:start], cams, timesteps[:start], bg, sh_degree))
            if start == k:
                return state, warm
            self.buffers = b = _StepBuffers(state, cams, bg, {n: m[0] for n, m in warm.items()},
                                            cap=max(64, 1 << (k - 1).bit_length()))
            g = self.slot.capture(key, lambda: b.step(self.step, gt_cache, sh_degree))
        b = self.buffers
        with annotate("chunk/fill", stamp=False):
            b.fill(state, views, timesteps, cams, bg, start, k)
        with annotate("chunk/replay", stamp=False):
            g.replay(k - start)
        with annotate("chunk/rows", stamp=False):
            rows = {name: buf[start:k].clone() for name, buf in b.metrics.items()}
            if warm is not None:
                rows = {n: torch.cat([warm[n], r]) for n, r in rows.items()}
        return dataclasses.replace(b.state, generator=state.generator), rows


def make_train_chunk(model: Optional[FlameModel], cfg: Config, tile_cfg: TileConfig,
                     spatial_lr_scale: float = 1.0) -> TrainChunk:
    """K training steps a dispatch (`TrainChunk`): one captured CUDA graph
    of one step, replayed K times, on the card's sorted pipeline; the
    step in a loop elsewhere. The port of the JAX package's
    `make_train_scan` (one `lax.scan` a chunk)."""
    return TrainChunk(model, cfg, tile_cfg, spatial_lr_scale)


def active_sh_degree(iteration: int, max_degree: int = 3) -> int:
    """SH warm-up: one more band every 1000 iterations (`train.py:176-177`)."""
    return min(iteration // 1000, max_degree)
