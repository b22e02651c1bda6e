"""The benchmark's inputs in the program's own types, and the program's
public entry points that the cells drive.

This is the one module of the harness that imports the program
(`gaussianavatars_torch`). It takes from it the system under test (the
FLAME model, the renderer, the training chunk, the tier-budget probe);
nothing here computes what the check compares. The per-layer readers
name the program's kernels as the profiler shows them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gaussianavatars_torch import cuda_build, render  # noqa: F401  (the harness's entry points)
from gaussianavatars_torch.config import Config, OptimizationConfig, PipelineConfig
from gaussianavatars_torch.data.cameras import Camera
from gaussianavatars_torch.models.flame.assets import FlameAssets
from gaussianavatars_torch.models.flame.flame_model import FlameConfig, FlameModel, FlameParams
from gaussianavatars_torch.models.gaussians import GaussianAux, GaussianParams
from gaussianavatars_torch.ops.rasterize_tiled import TileConfig
from gaussianavatars_torch.render import AvatarRenderer  # noqa: F401  (serving's entry point)
from gaussianavatars_torch.training.innovations import ColorNetParams
from gaussianavatars_torch.training.optim import adam_init
from gaussianavatars_torch.training.trainer import (
    CAMERA_TENSORS, init_train_state, make_train_chunk, stack_cameras,  # noqa: F401
)

from . import reference
from .scene import FLAME_POSE

# Vertex tables FLAME's topology defines, as the program looks them up: the
# lip rings its teeth are built from.
VERTEX_MASKS = {"lip_outside_ring_upper": reference.LIP_UPPER,
                "lip_outside_ring_lower": reference.LIP_LOWER,
                **{k: np.arange(*v) for k, v in reference.REGION_RANGES.items()}}


def flame_model(arrays: dict, cfg: dict, device) -> FlameModel:
    f = arrays["faces"].shape[0]
    assets = FlameAssets(
        v_template=arrays["v_template"], shapedirs=arrays["shapedirs"],
        n_shape=cfg["n_shape"], posedirs=arrays["posedirs"],
        j_regressor=arrays["j_regressor"], parents=arrays["parents"].astype(np.int32),
        lbs_weights=arrays["lbs_weights"], faces=arrays["faces"].astype(np.int32),
        verts_uvs=np.zeros((arrays["v_template"].shape[0], 2), np.float32),
        faces_uv=arrays["faces"].astype(np.int32),
        lmk_faces_idx=np.arange(68, dtype=np.int32) % f,
        lmk_bary_coords=np.full((68, 3), 1 / 3, np.float32),
        vertex_masks={k: v.astype(np.int32) for k, v in VERTEX_MASKS.items()})
    return FlameModel(assets, FlameConfig(n_shape=cfg["n_shape"], n_expr=cfg["n_expr"],
                                          add_teeth=cfg["add_teeth"]), device=device)


def gaussian_state(leaves: dict, binding, alive) -> tuple[GaussianParams, GaussianAux]:
    zeros = torch.zeros(binding.shape, dtype=torch.float32, device=binding.device)
    params = GaussianParams(**{k: v.clone() for k, v in leaves.items()
                               if k in reference.GAUSS_LEAVES})
    aux = GaussianAux(alive=alive.clone(), binding=binding.clone(), grad_accum=zeros,
                      denom=zeros.clone(), max_radii2d=zeros.clone())
    return params, aux


def camera(cam: dict) -> Camera:
    return Camera(world_view=cam["world_view"], proj=cam["proj"], full_proj=cam["full_proj"],
                  camera_center=cam["camera_center"], fovx=cam["fovx"], fovy=cam["fovy"],
                  width=cam["width"], height=cam["height"])


def flame_params(shape, pose: dict, i) -> FlameParams:
    """Pose `i` (an int or a slice) of a trajectory as the program's input."""
    sl = slice(i, i + 1) if isinstance(i, int) else i
    return FlameParams(shape=shape, **{k: pose[k][sl] for k, _ in FLAME_POSE})


def program_config(cfg: dict) -> Config:
    opt = dataclasses.replace(OptimizationConfig(), **{
        k: tuple(v) if isinstance(v, list) else v for k, v in cfg["opt"].items()})
    return Config(opt=opt, pipeline=PipelineConfig(tile_h=cfg["tile"], tile_w=cfg["tile"]))


@torch.inference_mode()
def probe_tile_config(model: FlameModel, params, aux, views, tile: int) -> TileConfig:
    """The program's tier budgets (`render.probe_tile_config`, which sizes
    them from one frame) for each probed view, keeping the largest: the
    one that gives the most expansion slots. `views` yields (FlameParams,
    Camera)."""
    probed = [render.probe_tile_config(model, params, aux, fp, cam, tile, tile)
              for fp, cam in views]
    n = params.capacity
    return max(probed, key=lambda c: c.tier_spec(n).expansion_size(n))


def train_state(params, aux, cfg: Config, shape, poses: dict, timesteps: int,
                color: dict, image_hw: tuple):
    """The program's training state from the benchmark's inputs; the colour
    net (innovation 4) takes the benchmark's weights `color`."""
    flame_init = {k: poses[k].clone() for k, _ in FLAME_POSE}
    flame_init["shape"] = shape.clone()
    state = init_train_state(params, aux, cfg, num_timesteps=timesteps,
                             n_expr=poses["expr"].shape[1], n_shape=shape.shape[0],
                             flame_init=flame_init, image_hw=image_hw)
    if state.color_net is not None:
        n = len(state.color_net.weights)
        net = ColorNetParams(weights=tuple(color[f"color_w{i}"].clone() for i in range(n)),
                             biases=tuple(color[f"color_b{i}"].clone() for i in range(n)))
        state = dataclasses.replace(state, color_net=net, color_adam=adam_init(net))
    return state


def rig_cameras(cams: list[dict]) -> Camera:
    """The rig's cameras stacked [K, ...], as a chunk takes them."""
    return stack_cameras([camera(c) for c in cams])


def camera_rows(stacked: Camera, idx: torch.Tensor) -> Camera:
    """Rows `idx` (a device index tensor) of stacked cameras."""
    return dataclasses.replace(stacked, **{f: getattr(stacked, f).index_select(0, idx)
                                           for f in CAMERA_TENSORS})


def _by_name(params, flame, color) -> dict:
    out = {k: getattr(params, k) for k in reference.GAUSS_LEAVES}
    out.update({k: getattr(flame, k) for k in reference.FLAME_LEAVES})
    if color is not None:
        out.update({f"color_w{i}": w for i, w in enumerate(color.weights)})
        out.update({f"color_b{i}": b for i, b in enumerate(color.biases)})
    return out


def state_leaves(state) -> dict:
    """The trained leaves of a program state by the reference's names."""
    return _by_name(state.params, state.flame, state.color_net)


def adam_mu(state) -> dict:
    return _by_name(state.adam.mu, state.flame_adam.mu,
                    None if state.color_adam is None else state.color_adam.mu)


def reference_state(state) -> dict:
    """A program state's leaves, Adam moments and count, densification
    statistics and thumbnail cache, by the reference's names."""
    nu = _by_name(state.adam.nu, state.flame_adam.nu,
                  None if state.color_adam is None else state.color_adam.nu)
    out = dict(leaves=state_leaves(state), mu=adam_mu(state), nu=nu, step=state.adam.step,
               grad_accum=state.aux.grad_accum, denom=state.aux.denom)
    if state.contrastive is not None:
        out["cache"] = dict(images=state.contrastive.images, count=state.contrastive.count,
                            head=state.contrastive.head)
    return out
