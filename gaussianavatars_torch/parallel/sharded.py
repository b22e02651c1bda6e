"""The sharded training step over a ('data', 'tile') rank mesh.

The port of the JAX package's `parallel/sharded.py` to `torch.distributed`.
Every rank holds the whole state (replicated). Rank (d, t) trains data row
d's camera and composites image row band t of it (`rows` =
`padded_height(H, tile_h, n_tile) / n_tile` rows from `t · rows`), with
the single-device step's kernels: the sorted pipeline's forward and
backward compositors (`csrc/composite_pairs_fwd.cu`,
`composite_pairs_bwd.cu`, its `_amp` backward under `use_amp`), or the
table pipeline (`bin_gaussians` and `rasterize_binned` on the band). The
geometry, the image loss and the updates are the single-device step's own
functions (`training/trainer.py`).

The collective bookkeeping. JAX's loss is replicated over `tile`, so JAX
seeds its VJP with 1/(n_tile · n_data) and sums the parameter gradients
over the whole mesh. Here each sum happens once:

  1. each rank rasterises its band from detached screen-space leaves
     (mean2d, conic, colour, α) that require grad;
  2. it all-gathers the band images over `tile`, without autograd;
  3. it computes the loss on the full image, a detached leaf that
     requires grad (the colour net, the region map and the contrastive
     term included);
  4. it takes the gradient with respect to that image and keeps its own
     band's rows;
  5. it back-propagates them into its band's screen-space leaves;
  6. it sum-reduces those screen cotangents over `tile` (9 floats a
     Gaussian, against 59 for the raw parameters): the camera's whole
     ∂L/∂screen, whose ∂L/∂mean2d the densification statistics read;
  7. it runs one geometry backward with the regularisers counted once;
  8. it sums the parameter, FLAME and colour-net gradients over the world
     and divides by n_data: the mean over the cameras.

Ranks must not drift apart by a rounding. Two ranks of one data group
hold the same camera's gradients, but a CUDA backward with atomic
additions (the binding gathers, cuDNN's SSIM blur) need not round alike in
two processes. So what is replicated over `tile` is taken from tile rank 0
alone: the other tile ranks add zeros to the world sum (x + 0 is exact)
and skip the geometry backward; the world sum's result is the same on
every rank. With `gauss_shard` the geometry of each tile rank is its own
slice of the Gaussians, so every tile rank adds its slice's gradients and
tile rank 0 adds the regularisers' (counted once).

`gauss_shard` makes `tile` dual-role. Each tile rank runs the world
composition, projection and SH of its 1/n_tile slice of the capacity
(capacity % n_tile == 0); one all-gather over `tile` of the compact screen
attributes (15 floats a Gaussian, with the binning's depth, radius, mask
and 2D covariance) restores the full set in order; its backward is a
reduce-scatter over `tile` of the summed screen cotangents, which hands
each rank its slice's, and an all-gather of the ∂L/∂mean2d part gives the
statistics every Gaussian's. The regularisers see the full parameters and
the gathered visibility.

The densification statistics follow JAX `sharded.py:409-432`: the
pixel-space norm scales by the full frame's W/2 and H/2, not the band's;
`grad_accum` and `denom` increments are summed over `data`; `max_radii2d`
takes the maximum over `data`. The metrics are the same on every rank:
the loss terms and PSNR are the mean over the cameras, `overflow` and
`budget_overflow` are flags (the mesh maximum: any nonzero grows the
budgets) and `max_footprint` is the mesh maximum.

Per step the world sees: one band gather (H_pad·W·3 floats), one screen
reduction (9 floats a Gaussian; a reduce-scatter and a 2-float gather
under `gauss_shard`, after a 15-float gather), one world sum (the
gradients, the statistics, the metrics and the contrastive thumbnail) and
one world maximum (the radii and the budget flags).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import record_function

from ..config import Config
from ..data.cameras import Camera
from ..data.pipeline import gt_to_float
from ..models.binding import face_frames
from ..models.densify import add_densification_stats
from ..models.flame.flame_model import FlameModel
from ..ops.projection import Projected
from ..ops.rasterize_sorted import rasterize_sorted
from ..ops.rasterize_tiled import TileConfig, bin_gaussians, rasterize_binned
from ..training import innovations as inn
from ..training.checkpoint import flatten_state
from ..training.loss import psnr
from ..training.optim import tree_leaves, tree_map
from ..training.trainer import (
    ImageLoss, TrainState, _grads, _leaves, apply_updates, binding_regularisers,
    flame_forward, geometry, screen_space,
)
from .distributed import Collectives
from .mesh import RankMesh


class CameraBatch(NamedTuple):
    """Per-view tensors of B cameras (the image size is shared; the fovs
    are per camera, so rigs with per-camera intrinsics project right).
    `tan_half_fov*` are float64, the `Camera` properties' own values."""

    world_view: torch.Tensor     # [B, 4, 4]
    proj: torch.Tensor           # [B, 4, 4]
    full_proj: torch.Tensor      # [B, 4, 4]
    camera_center: torch.Tensor  # [B, 3]
    timestep: torch.Tensor       # [B] int32
    tan_half_fovx: torch.Tensor  # [B] float64
    tan_half_fovy: torch.Tensor  # [B] float64

    def row(self, i: int) -> "CameraBatch":
        return CameraBatch(*(x[i:i + 1] for x in self))


def camera_batch(cams: list[Camera]) -> CameraBatch:
    def stack(f):
        return torch.stack([getattr(c, f) for c in cams])

    dev = cams[0].device
    return CameraBatch(
        world_view=stack("world_view"), proj=stack("proj"), full_proj=stack("full_proj"),
        camera_center=stack("camera_center"),
        timestep=torch.tensor([c.timestep for c in cams], dtype=torch.int32, device=dev),
        tan_half_fovx=torch.tensor([c.tan_half_fovx for c in cams], dtype=torch.float64,
                                   device=dev),
        tan_half_fovy=torch.tensor([c.tan_half_fovy for c in cams], dtype=torch.float64,
                                   device=dev),
    )


@dataclasses.dataclass(frozen=True)
class _DeviceCamera:
    """The attribute surface `projection.py` and the region map read, for
    one row of a `CameraBatch`: its own fovs, the template's size."""

    world_view: torch.Tensor
    proj: torch.Tensor
    full_proj: torch.Tensor
    camera_center: torch.Tensor
    tan_half_fovx: float
    tan_half_fovy: float
    width: int
    height: int

    @property
    def device(self) -> torch.device:
        return self.world_view.device

    @property
    def focal_x(self) -> float:
        return self.width / (2 * self.tan_half_fovx)

    @property
    def focal_y(self) -> float:
        return self.height / (2 * self.tan_half_fovy)


def padded_height(height: int, tile_h: int, n_tile_shards: int) -> int:
    unit = tile_h * n_tile_shards
    return -(-height // unit) * unit


def pad_gt_for_mesh(gt: torch.Tensor, height_pad: int) -> torch.Tensor:
    """Pad [B, H, W, 3] ground truth rows to the mesh-divisible height."""
    h = gt.shape[1]
    if h == height_pad:
        return gt
    return F.pad(gt, (0, 0, 0, 0, 0, height_pad - h))


def state_digest(state: TrainState) -> str:
    """SHA-1 of every tensor leaf of the state (bytes, in field order) and
    of its generator's state: equal on two ranks iff they hold the same
    state bit for bit."""
    h = hashlib.sha1()
    for k, v in flatten_state(state).items():
        h.update(k.encode())
        h.update(np.ascontiguousarray(v.detach().cpu().numpy()).tobytes())
    if state.generator is not None:
        h.update(state.generator.get_state().numpy().tobytes())
    return h.hexdigest()


def _flat(tensors) -> torch.Tensor:
    return torch.cat([x.reshape(-1).to(torch.float32) for x in tensors])


def _unflat(buf: torch.Tensor, likes) -> list:
    out, i = [], 0
    for x in likes:
        out.append(buf[i:i + x.numel()].reshape(x.shape).to(x.dtype))
        i += x.numel()
    return out


def _gather_screen(coll: Collectives, mesh: RankMesh, screen, proj: Projected):
    """All-gather over `tile` of the slices' screen attributes and the
    binning's fields (detached): (screen, projection) of every Gaussian."""
    mean2d, conic, colors, opac = (x.detach() for x in screen)
    packed = torch.cat([mean2d, conic, colors, opac[:, None], proj.depth[:, None],
                        proj.radius[:, None].to(torch.float32),
                        proj.mask[:, None].to(torch.float32), proj.cov2d.detach()], 1)
    full = coll.all_gather(packed, mesh.tile_group)                   # [N, 15]
    screen_full = (full[:, 0:2], full[:, 2:5], full[:, 5:8], full[:, 8])
    proj_full = Projected(mean2d=full[:, 0:2], depth=full[:, 9], conic=full[:, 2:5],
                          radius=full[:, 10].to(torch.int32), mask=full[:, 11] > 0,
                          cov2d=full[:, 12:15])
    return screen_full, proj_full


def make_sharded_train_step(model: Optional[FlameModel], cfg: Config, tile_cfg: TileConfig,
                            mesh: RankMesh, template_camera: Camera,
                            spatial_lr_scale: float = 1.0, gauss_shard: bool = False,
                            collectives: Optional[Collectives] = None):
    """Build this rank's sharded train step.

    Call: step(state, cams: CameraBatch [1] (this rank's data row,
    `distributed.make_local_batch`), gt [1, H_pad, W, 3] (uint8 or float,
    `pad_gt_for_mesh`), bg [3], sh_degree) → (new state, metrics). The
    state is replicated and not modified; the new state is the same on
    every rank. `step.collectives` keeps the collectives' bookkeeping.

    With `gauss_shard` the per-Gaussian geometry is also split over
    `tile` (the module docstring); the capacity must divide by n_tile.
    """
    o = cfg.opt
    use_flame = model is not None
    use_sorted = cfg.pipeline.use_sorted and cfg.pipeline.use_pallas
    H, W = template_camera.height, template_camera.width
    n_tile, n_data = mesh.tile, mesh.data
    H_pad = padded_height(H, tile_cfg.tile_h, n_tile)
    rows = H_pad // n_tile
    y0 = mesh.t * rows
    # What is replicated over `tile` enters the world sum from tile rank 0.
    lead = mesh.t == 0
    coll = collectives or Collectives(dist.get_backend())
    image_loss = ImageLoss(model, cfg)

    def shard_slice(tree, chunk: int):
        sl = slice(mesh.t * chunk, (mesh.t + 1) * chunk)
        return dataclasses.replace(tree, **{f.name: getattr(tree, f.name)[sl]
                                            for f in dataclasses.fields(tree)})

    def sharded_geometry(state, params, flame, ts, cam, sh_degree):
        """The geometry of this rank's slice of the Gaussians, gathered:
        (slice screen under autograd, full screen, reg_total, full proj,
        reg_terms, posed vertices)."""
        cap = params.means.shape[0]
        if cap % n_tile:
            raise ValueError(f"gauss_shard needs the capacity ({cap}) divisible by "
                             f"n_tile ({n_tile})")
        frames = verts = verts_cano = None
        if use_flame:
            verts, verts_cano = flame_forward(model, state, flame, ts)
            frames = face_frames(verts[0], model.faces)
        chunk = cap // n_tile
        screen, proj = screen_space(shard_slice(params, chunk), shard_slice(state.aux, chunk),
                                    frames, cam, sh_degree)
        screen_full, proj_full = _gather_screen(coll, mesh, screen, proj)
        if not use_flame:
            return screen, screen_full, torch.zeros((), device=screen[3].device), proj_full, \
                {}, None
        reg_terms = binding_regularisers(model, cfg, state, params, flame, ts, frames, verts,
                                         verts_cano, proj_full.radius > 0)
        return screen, screen_full, sum(reg_terms.values()), proj_full, reg_terms, verts[0]

    def step(state: TrainState, cams: CameraBatch, gt: torch.Tensor, bg: torch.Tensor,
             sh_degree: int = 0):
        if cams.world_view.shape[0] != 1 or gt.shape[0] != 1:
            raise ValueError("the sharded step takes this rank's data row (make_local_batch)")
        cam = _DeviceCamera(
            world_view=cams.world_view[0], proj=cams.proj[0], full_proj=cams.full_proj[0],
            camera_center=cams.camera_center[0], tan_half_fovx=float(cams.tan_half_fovx[0]),
            tan_half_fovy=float(cams.tan_half_fovy[0]), width=W, height=H)
        ts = int(cams.timestep[0])
        gt_full = gt_to_float(gt[0, :H])
        dev = gt_full.device
        band_shift = torch.tensor([[0.0, float(y0)]], device=dev)
        params = _leaves(state.params)
        flame = _leaves(state.flame)
        color = _leaves(state.color_net)
        color_leaves = [] if color is None else tree_leaves(color)

        with torch.enable_grad():
            with record_function("sharded/geometry_fwd"):
                if gauss_shard:
                    screen, screen_full, reg_total, proj, reg_terms, verts = sharded_geometry(
                        state, params, flame, ts, cam, sh_degree)
                else:
                    screen, reg_total, proj, reg_terms, verts = geometry(
                        model, cfg, state, params, flame, ts, cam, sh_degree)
                    screen_full = screen
            proj_sg = proj._replace(**{k: v.detach() for k, v in proj._asdict().items()})
            screen_in = [x.detach().requires_grad_() for x in screen_full]
            n_g = screen_in[0].shape[0]

            # ---- this rank's band
            with record_function("sharded/band"):
                mean2d_band = screen_in[0] - band_shift
                if use_sorted:
                    img_band, _alpha, plan = rasterize_sorted(
                        proj_sg._replace(mean2d=mean2d_band, conic=screen_in[1]), screen_in[2],
                        screen_in[3], rows, W, bg, tile_cfg.tile_h, tile_cfg.tile_w,
                        tile_cfg.tier_spec(n_g), amp=o.use_amp)
                    flags = [torch.zeros((), device=dev), plan.budget_overflow,
                             plan.max_footprint]
                else:
                    binned = bin_gaussians(
                        proj_sg._replace(mean2d=mean2d_band.detach()), rows, W, tile_cfg,
                        opacity=screen_in[3].detach())
                    img_band, _alpha = rasterize_binned(
                        mean2d_band, screen_in[1], screen_in[2], screen_in[3], binned, rows, W,
                        bg, tile_cfg)
                    flags = [binned.overflow, binned.budget_overflow, torch.zeros((), device=dev)]

            # ---- the full image and its loss
            with record_function("sharded/image"):
                img_pad = coll.all_gather(img_band.detach(), mesh.tile_group)   # [H_pad, W, 3]
                img_leaf = img_pad[:H].detach().requires_grad_()
                img_total, loss_terms, img = image_loss(
                    img_leaf, gt_full, cam, color,
                    None if verts is None else verts.detach(), state.contrastive)
                g_all = torch.autograd.grad(img_total, [img_leaf] + color_leaves)
                g_img, g_color = g_all[0], list(g_all[1:])
                g_band = F.pad(g_img, (0, 0, 0, 0, 0, H_pad - H))[y0:y0 + rows]
                g_part = torch.autograd.grad(img_band, screen_in, g_band)

            # ---- the camera's screen cotangents
            with record_function("sharded/screen_reduce"):
                g_flat = torch.cat([g.reshape(n_g, -1) for g in g_part], 1)        # [N, 9]
                if gauss_shard:
                    g_own = coll.reduce_scatter(g_flat, mesh.tile_group)
                    g_mean2d = coll.all_gather(g_own[:, 0:2], mesh.tile_group)
                else:
                    g_own = coll.all_reduce(g_flat, "sum", mesh.tile_group)
                    g_mean2d = g_own[:, 0:2]
                g_screen = (g_own[:, 0:2], g_own[:, 2:5], g_own[:, 5:8], g_own[:, 8])

            # ---- one geometry backward, the regularisers counted once
            if gauss_shard or lead:
                with record_function("sharded/geometry_bwd"):
                    outs, cots = [*screen], [*g_screen]
                    if reg_total.requires_grad and lead:
                        outs.append(reg_total)
                        cots.append(torch.ones_like(reg_total))
                    torch.autograd.backward(outs, cots)

        # ---- the world sum: gradients, statistics, metrics, thumbnail
        with record_function("sharded/reduce"):
            img = img.detach()
            zero_aux = dataclasses.replace(
                state.aux, grad_accum=torch.zeros_like(state.aux.grad_accum),
                denom=torch.zeros_like(state.aux.denom),
                max_radii2d=torch.zeros_like(state.aux.max_radii2d))
            inc = add_densification_stats(zero_aux, g_mean2d, proj_sg.radius, W, H)
            g_params = tree_leaves(_grads(params))
            g_flame = [] if flame is None else tree_leaves(_grads(flame))
            metrics = {"loss": img_total.detach() + reg_total.detach(),
                       "psnr": psnr(img, gt_full),
                       "num_visible": (proj_sg.radius > 0).sum().to(torch.float32),
                       **{k: v.detach() for k, v in {**loss_terms, **reg_terms}.items()}}
            new_contrastive = state.contrastive
            thumb = []
            if state.contrastive is not None:
                new_contrastive = inn.contrastive_update(state.contrastive, img,
                                                         o.contrastive_downsample)
                # The cache takes data row 0's render.
                thumb = [new_contrastive.images * float(mesh.d == 0)]
            gauss_part = g_params + g_flame
            replicated = (g_color + [inc.grad_accum, inc.denom] + list(metrics.values())
                          + thumb)
            if not (gauss_shard or lead):
                gauss_part = [torch.zeros_like(x) for x in gauss_part]
            if not lead:
                replicated = [torch.zeros_like(x) for x in replicated]
            likes = gauss_part + replicated
            summed = _unflat(coll.all_reduce(_flat(likes), "sum"), likes)
            maxed = coll.all_reduce(torch.cat([
                inc.max_radii2d, torch.stack([f.to(torch.float32) for f in flags])]), "max")

        n_p, n_f, n_c = len(g_params), len(g_flame), len(g_color)
        mean = [x / n_data for x in summed[:n_p + n_f + n_c]]
        rest = summed[n_p + n_f + n_c:]
        d_accum, d_denom = rest[0], rest[1]
        metrics = {k: v / n_data for k, v in zip(metrics, rest[2:2 + len(metrics)])}
        if thumb:
            new_contrastive = new_contrastive._replace(images=rest[-1])
        n_g_all = state.aux.max_radii2d.shape[0]
        metrics["overflow"], metrics["budget_overflow"], metrics["max_footprint"] = (
            maxed[n_g_all:].unbind())
        aux_new = dataclasses.replace(
            state.aux, grad_accum=state.aux.grad_accum + d_accum,
            denom=state.aux.denom + d_denom,
            max_radii2d=torch.maximum(state.aux.max_radii2d, maxed[:n_g_all]))

        with record_function("sharded/adam"):
            it = iter(mean)
            new = apply_updates(
                cfg, spatial_lr_scale, state, tree_map(lambda _: next(it), state.params),
                None if flame is None else tree_map(lambda _: next(it), state.flame),
                None if color is None else tree_map(lambda _: next(it), state.color_net))
        new_state = TrainState(aux=aux_new, flame_static=state.flame_static,
                               contrastive=new_contrastive, generator=state.generator, **new)
        return new_state, metrics

    step.collectives = coll
    return step
