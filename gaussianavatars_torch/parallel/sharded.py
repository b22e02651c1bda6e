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

The step is the span `sharded/step`, a row of the stage clock
(`utils/profiling.annotate`), and its stages the `sharded/*` spans inside
it: `sharded/screen_reduce` (step 6) and `sharded/reduce` (the world sum
and maximum) hold the collectives.

The JAX step is one `jax.jit` a step, its collectives inside. Its
counterpart here is `ShardedStep`'s captured form: on the card, over NCCL
and on the sorted pipeline, each rank captures its step once in a CUDA
graph, the collectives above inside, and replays it once a step; the
step's body reads nothing on the host (the row's fovs are Python floats
of the graph's key, the timestep a device scalar). Elsewhere the step
runs eagerly (`step_form`).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

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
from ..training.checkpoint import _rebuild, flatten_state
from ..training.loss import psnr
from ..training.optim import tree_leaves, tree_map
from ..training.trainer import (
    CAMERA_TENSORS, CHUNK_WARMUP, ImageLoss, TrainState, _grads, _leaves, apply_updates,
    binding_regularisers, flame_forward, geometry, screen_space,
)
from ..utils.graphs import GraphSlot, copy_in, graph_key, warm_up
from ..utils.profiling import annotate
from .distributed import Collectives
from .mesh import RankMesh


class CameraBatch(NamedTuple):
    """Per-view tensors of B cameras (the image size is shared; the fovs
    are per camera, so rigs with per-camera intrinsics project right).
    The matrices and centres lie on the cameras' device; `timestep` and
    `tan_half_fov*` are the batch's host copy (CPU tensors), which the
    step reads without waiting for the device. `tan_half_fov*` are
    float64, the `Camera` properties' own values."""

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

    return CameraBatch(
        world_view=stack("world_view"), proj=stack("proj"), full_proj=stack("full_proj"),
        camera_center=stack("camera_center"),
        timestep=torch.tensor([c.timestep for c in cams], dtype=torch.int32),
        tan_half_fovx=torch.tensor([c.tan_half_fovx for c in cams], dtype=torch.float64),
        tan_half_fovy=torch.tensor([c.tan_half_fovy for c in cams], dtype=torch.float64),
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
    """Build this rank's sharded train step, a `ShardedStep` (its call and
    forms there).

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
    band_shift = torch.tensor([[0.0, float(y0)]], device=template_camera.device)

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

    def body(state: TrainState, cam: _DeviceCamera, ts, gt: torch.Tensor, bg: torch.Tensor,
             sh_degree: int):
        """The step of one camera row: (new state, metrics). `ts` is an int
        or a 0-dim int64 tensor on the device (the same bits); `gt` is the
        row's [H_pad, W, 3]. It reads nothing on the host. It runs in the
        span `sharded/step`, a row of the stage clock (the module's
        docstring), so that a replay stamps its stages as an eager call
        does."""
        with annotate("sharded/step", row=True):
            return step_body(state, cam, ts, gt, bg, sh_degree)

    def step_body(state, cam, ts, gt, bg, sh_degree):
        gt_full = gt_to_float(gt[:H])
        dev = gt_full.device
        params = _leaves(state.params)
        flame = _leaves(state.flame)
        color = _leaves(state.color_net)
        color_leaves = [] if color is None else tree_leaves(color)

        with torch.enable_grad():
            with annotate("sharded/geometry_fwd"):
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
            with annotate("sharded/band"):
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
            with annotate("sharded/image"):
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
            with annotate("sharded/screen_reduce"):
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
                with annotate("sharded/geometry_bwd"):
                    outs, cots = [*screen], [*g_screen]
                    if reg_total.requires_grad and lead:
                        outs.append(reg_total)
                        cots.append(torch.ones_like(reg_total))
                    torch.autograd.backward(outs, cots)

        # ---- the world sum: gradients, statistics, metrics, thumbnail
        with annotate("sharded/reduce"):
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

        with annotate("sharded/adam"):
            it = iter(mean)
            new = apply_updates(
                cfg, spatial_lr_scale, state, tree_map(lambda _: next(it), state.params),
                None if flame is None else tree_map(lambda _: next(it), state.flame),
                None if color is None else tree_map(lambda _: next(it), state.color_net))
        new_state = TrainState(aux=aux_new, flame_static=state.flame_static,
                               contrastive=new_contrastive, generator=state.generator, **new)
        return new_state, metrics

    form = step_form(template_camera.device, coll.backend, use_sorted)
    return ShardedStep(body, form, coll, (H, W))


# The forms of a sharded step (`step_form`).
CAPTURED = "captured"
EAGER_CPU = "eager (cpu)"
EAGER_GLOO = "eager (gloo)"
EAGER_TABLE = "eager (table pipeline)"


def step_form(device, backend: str, use_sorted: bool) -> str:
    """The form of a sharded step, chosen by rule when it is built: captured
    on the card over NCCL on the sorted pipeline, else eager: on the CPU;
    under gloo, which stages every collective through host buffers, so that
    a CUDA graph cannot hold it; on the table pipeline, whose captured form,
    the fixed walk over every slot and tile, is many times slower a step
    than the eager planned walk (`ops/rasterize_tiled.fixed_walk`)."""
    if torch.device(device).type != "cuda":
        return EAGER_CPU
    if backend != "nccl":
        return EAGER_GLOO
    if not use_sorted:
        return EAGER_TABLE
    return CAPTURED


def _check_row(cams: CameraBatch, gt: torch.Tensor) -> None:
    if cams.world_view.shape[0] != 1 or gt.shape[0] != 1:
        raise ValueError("the sharded step takes this rank's data row (make_local_batch)")


class _StepBuffers:
    """The static inputs of a captured sharded step: the state's leaves
    (which every replay writes back in place), the row's camera tensors,
    the timestep (a 0-dim int64 device tensor), the padded ground truth
    [H_pad, W, 3] and the background; `key` is the graph's."""

    def __init__(self, key, state: TrainState, cams: CameraBatch, gt: torch.Tensor,
                 bg: torch.Tensor):
        self.key = key
        self.leaves = {k: torch.empty_like(v) for k, v in flatten_state(state).items()}
        self.state = _rebuild(state, "", self.leaves)
        self.inputs = {f: torch.empty_like(getattr(cams, f)[0]) for f in CAMERA_TENSORS}
        self.inputs.update(timestep=torch.zeros((), dtype=torch.int64, device=bg.device),
                           gt=torch.empty_like(gt[0]), bg=torch.empty_like(bg))
        self.fill(state, cams, gt, bg)

    def fill(self, state: TrainState, cams: CameraBatch, gt: torch.Tensor,
             bg: torch.Tensor) -> None:
        """The state (nothing to copy for a leaf that is its buffer) and the
        row's inputs into the buffers, with no host synchronisation."""
        copy_in(self.leaves, flatten_state(state))
        copy_in(self.inputs, {**{f: getattr(cams, f)[0] for f in CAMERA_TENSORS},
                              "timestep": int(cams.timestep[0]), "gt": gt[0], "bg": bg})


class ShardedStep:
    """This rank's sharded train step (`make_sharded_train_step`).

    Call: step(state, cams: CameraBatch [1] (this rank's data row,
    `distributed.make_local_batch`), gt [1, H_pad, W, 3] (uint8 or float,
    `pad_gt_for_mesh`), bg [3], sh_degree) → (new state, metrics). The new
    state is the same on every rank. `collectives` keeps the collectives'
    bookkeeping. `form` (`step_form`) says how the step runs:

      * captured, the port of the JAX step's `jax.jit`: the first
        CHUNK_WARMUP calls with a key run `eager` on a side stream (kernel
        libraries, NCCL's communicators and cached tables initialise
        outside the capture); the next captures the step over static
        buffers (`_StepBuffers`), its collectives inside, and it and every
        later call copy their inputs into the buffers and replay the graph,
        one launch from the host. The given state is consumed, as the JAX
        step donates it: the returned state's tensors are the graph's
        buffers, which the next call overwrites; handed back, they copy
        nothing, and a leaf an event replaced is copied in. The key is (the
        ground truth's shape and dtype, the row's fovs, sh_degree, the
        state's leaf shapes and dtypes; the graph's, also the stage clock's
        state: switching the clock re-captures without eager calls); another
        key, or `drop`, releases
        the graph and its memory pool (a rig whose cameras have their own
        intrinsics changes the key from view to view, so its steps are
        mostly eager warm-up calls). A capture or replay that fails
        raises: the step never falls back to eager calls. The collectives'
        `stats` and the compositor launch counts grow a replay by the
        step's own.
      * eager (the CPU, gloo, the table pipeline): `eager`, every kernel
        and collective issued from Python; the given state is not
        modified.

    `through_buffers` runs the captured form's body over its buffers
    without a graph: the CPU tests hold it to `eager` bit for bit.

    `drop` the step before the world is left (`distributed.shutdown`):
    NCCL does not destroy a communicator while a graph that captured its
    collectives lives, so the ranks would hang there."""

    def __init__(self, body, form: str, collectives: Collectives, size: tuple):
        self.body, self.form, self.collectives = body, form, collectives
        self.height, self.width = size
        self.slot = GraphSlot("sharded_step")
        self.buffers: Optional[_StepBuffers] = None
        self.names: list = []
        self._per_replay: dict = {}
        self._warm = (None, 0)   # (key, eager calls with it)

    @property
    def captures(self) -> int:
        return self.slot.captures

    def drop(self) -> None:
        """Release the captured graph, its memory pool and the buffers."""
        self.slot.drop()
        self.buffers = None

    def _camera(self, tensors: dict, fovx: float, fovy: float) -> _DeviceCamera:
        return _DeviceCamera(**tensors, tan_half_fovx=fovx, tan_half_fovy=fovy,
                             width=self.width, height=self.height)

    def eager(self, state: TrainState, cams: CameraBatch, gt: torch.Tensor, bg: torch.Tensor,
              sh_degree: int = 0):
        """The plain version: the body on the row's own tensors."""
        _check_row(cams, gt)
        cam = self._camera({f: getattr(cams, f)[0] for f in CAMERA_TENSORS},
                           float(cams.tan_half_fovx[0]), float(cams.tan_half_fovy[0]))
        return self.body(state, cam, int(cams.timestep[0]), gt[0], bg, sh_degree)

    def _key(self, state: TrainState, cams: CameraBatch, gt: torch.Tensor, sh_degree: int):
        return (tuple(gt.shape), gt.dtype, float(cams.tan_half_fovx[0]),
                float(cams.tan_half_fovy[0]), int(sh_degree),
                tuple((k, tuple(v.shape), v.dtype) for k, v in flatten_state(state).items()))

    def _fill(self, key, state, cams, gt, bg) -> None:
        if self.buffers is None or self.buffers.key != key:
            self.buffers = _StepBuffers(key, state, cams, gt, bg)
        else:
            self.buffers.fill(state, cams, gt, bg)

    def _buffer_body(self, sh_degree: int) -> torch.Tensor:
        """One step over the buffers, the body the graph captures: the new
        state written into the state's buffers; the metrics stacked [M]."""
        b = self.buffers
        cam = self._camera({f: b.inputs[f] for f in CAMERA_TENSORS}, b.key[2], b.key[3])
        new, metrics = self.body(b.state, cam, b.inputs["timestep"], b.inputs["gt"],
                                 b.inputs["bg"], sh_degree)
        for name, x in flatten_state(new).items():
            if x is not b.leaves[name]:
                b.leaves[name].copy_(x)
        self.names = list(metrics)
        return torch.stack([metrics[k] for k in self.names])

    def _out(self, stacked: torch.Tensor, generator):
        return (dataclasses.replace(self.buffers.state, generator=generator),
                dict(zip(self.names, stacked.clone().unbind())))

    def through_buffers(self, state: TrainState, cams: CameraBatch, gt: torch.Tensor,
                        bg: torch.Tensor, sh_degree: int = 0):
        """The captured form's body over its buffers, run eagerly; the given
        state is consumed as the captured form consumes it."""
        _check_row(cams, gt)
        self._fill(self._key(state, cams, gt, sh_degree), state, cams, gt, bg)
        return self._out(self._buffer_body(sh_degree), state.generator)

    def __call__(self, state: TrainState, cams: CameraBatch, gt: torch.Tensor, bg: torch.Tensor,
                 sh_degree: int = 0):
        if self.form != CAPTURED:
            return self.eager(state, cams, gt, bg, sh_degree)
        _check_row(cams, gt)
        key = self._key(state, cams, gt, sh_degree)
        g = self.slot.get(graph_key(step=key))
        if g is None:
            n = self._warm[1] + 1 if self._warm[0] == key else 1
            self._warm = (key, n)
            if n <= CHUNK_WARMUP:
                return warm_up(gt.device, lambda: self.eager(state, cams, gt, bg, sh_degree))
            self._fill(key, state, cams, gt, bg)
            before = self.collectives.snapshot()
            g = self.slot.capture(graph_key(step=key), lambda: self._buffer_body(sh_degree))
            self._per_replay = self.collectives.since(before)
        else:
            self._fill(key, state, cams, gt, bg)
        g.replay()
        self.collectives.add(self._per_replay)
        return self._out(g.outputs, state.generator)
