"""Offline avatar viewer core (UI-agnostic).

The port of the JAX package's `viewers/local.py`, the logic of
`local_viewer.py:97-678` of the reference without its GUI: load a trained
PLY (+ flame_param sidecar), scrub timesteps, drive FLAME joints and
expressions live, render the splats and/or a mesh overlay. It runs
headless (frame export, the FPS benchmarks, tests).

The splats go through the sorted pipeline and the forward pair
compositor, whose CUDA kernel a card's tensors launch (and CPU tensors its
plain version), or with `use_pallas=False` through the table pipeline
(`ops/rasterize_tiled.composite_tiles`). `use_pallas=None` keeps the
kernel path on every device, where the JAX core picks the table path off
the TPU.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.binding import face_frames
from ..models.flame.assets import load_assets
from ..models.flame.flame_model import FlameConfig, FlameModel, FlameParams
from ..models.gaussians import world_gaussians
from ..models.io import load_avatar
from ..ops.mesh_raster import render_mesh_preview
from ..ops.rasterize_tiled import TileConfig, render_tiled
from ..render import probe_tile_config
from .orbit import OrbitCamera

def blend_mesh(image: Optional[np.ndarray], rgba: np.ndarray, opacity: float) -> np.ndarray:
    """The mesh preview's RGBA blended over a splat image at `opacity`
    (the mesh alone when there is no image)."""
    rgb, alpha = rgba[..., :3], rgba[..., 3:]
    if image is None:
        return rgb
    return rgb * alpha * opacity + image * (alpha * (1 - opacity) + (1 - alpha))


class AvatarViewerCore:
    def __init__(
        self,
        ply_path: str,
        flame_assets: str = "",
        motion_path: str = "",
        width: int = 802,
        height: int = 550,
        use_pallas: Optional[bool] = None,
        tile: Optional[dict] = None,
        disable_fid: Optional[np.ndarray] = None,
        device="cuda",
    ):
        """`tile`: TileConfig fields (tile size, tier budgets, table
        budgets); without tier budgets they are probed from the orbit
        camera's view at timestep 0 (`probe_tiles`), and with
        `use_pallas=False` the table's budgets too. `disable_fid`: face ids whose Gaussians are hidden
        (`models/io.load_avatar`). `use_pallas=False` renders through the
        table pipeline; None or True through the sorted one."""
        self.use_pallas = use_pallas is not False
        self.device = resolve_device(device)
        self.params, self.aux, self.flame_table = load_avatar(
            ply_path, motion_path=motion_path, disable_fid=disable_fid, device=self.device
        )
        self.model = None
        self.num_timesteps = 1
        if self.flame_table is not None:
            # Prefer the model dir's saved topology (two levels up from the PLY).
            model_dir = os.path.dirname(os.path.dirname(os.path.dirname(ply_path)))
            cand = [flame_assets, os.path.join(model_dir, "flame_assets.npz")]
            path = next((c for c in cand if c and os.path.exists(c)), None)
            if path is None:
                raise FileNotFoundError(
                    "bound avatar needs FLAME assets (flame_assets.npz beside the "
                    "model or --flame_assets)"
                )
            assets = load_assets(path)
            self.model = FlameModel(assets, FlameConfig(
                n_shape=assets.n_shape,
                n_expr=assets.shapedirs.shape[-1] - assets.n_shape,
                add_teeth=False,  # saved assets already include the teeth
            ), device=self.device)
            self.num_timesteps = self.flame_table["expr"].shape[0]
        center, extent = self._bounds()
        self.cam = OrbitCamera(width=width, height=height,
                               radius=3.5 * extent, center=center)
        self.tile = TileConfig(**(tile or {}))
        self.overrides: Dict[str, np.ndarray] = {}  # live slider values
        # Reference "enable control" semantics (`local_viewer.py:534-611`):
        # when on, ALL driven params come from `control` (zeros + slider
        # deltas) instead of the timestep table.
        self.control_enabled = False
        self.control: Dict[str, np.ndarray] = {}
        self.reset_flame()
        if not self.tile.tiers:
            self.probe_tiles()

    def probe_tiles(self, camera=None, timestep: int = 0) -> TileConfig:
        """Size the tier budgets from `camera`'s footprints (default: the
        orbit camera) at `timestep` (`render.probe_tile_config`, with its
        headroom for motion), so that no Gaussian's tiles are cut; for the
        table path (`use_pallas=False`) the tile capacity and the tiles a
        Gaussian as well. The JAX core keeps the default budgets, which cut
        an avatar whose Gaussians span more than 64 tiles (the table: more
        than 32, or more than 1,024 Gaussians in a tile)."""
        cam = camera if camera is not None else self.cam.to_camera(device=self.device)
        fp = self.flame_params_at(timestep) if self.model is not None else None
        probed = probe_tile_config(self.model, self.params, self.aux, fp, cam,
                                   self.tile.tile_h, self.tile.tile_w,
                                   table=not self.use_pallas)
        table = {} if self.use_pallas else dict(
            capacity=probed.capacity, max_tiles_per_gaussian=probed.max_tiles_per_gaussian)
        self.tile = dataclasses.replace(self.tile, base_budget=probed.base_budget,
                                        tiers=probed.tiers, **table)
        return self.tile

    def reset_flame(self) -> None:
        """`reset_flame_param` (`local_viewer.py:291-299`)."""
        n_expr = self.model.cfg.n_expr if self.model is not None else 0
        self.control = {
            "expr": np.zeros(n_expr, np.float32),
            "rotation": np.zeros(3, np.float32),
            "neck": np.zeros(3, np.float32),
            "jaw": np.zeros(3, np.float32),
            "eyes": np.zeros(6, np.float32),
            "translation": np.zeros(3, np.float32),
        }

    def set_pose(self, joint: str, axis: int, value: float) -> None:
        """Joint slider (`callback_set_pose`, `local_viewer.py:536-547`);
        the eyes slider drives both eyes' matching axis."""
        self.control[joint][axis] = value
        if joint == "eyes":
            self.control[joint][3 + axis] = value
        self.control_enabled = True

    def set_expr(self, i: int, value: float) -> None:
        self.control["expr"][i] = value
        self.control_enabled = True

    def _bounds(self):
        if self.model is not None:
            v = np.asarray(self.model.assets.v_template)
        else:
            alive = self.aux.alive.cpu().numpy()
            v = self.params.means.cpu().numpy()[alive]
        center = v.mean(0)
        extent = float(np.abs(v - center).max()) or 1.0
        return center, extent

    def flame_params_at(self, timestep: int) -> FlameParams:
        """FLAME inputs for one timestep, with live overrides applied
        (`update_mesh_by_param_dict`, `scene/flame_gaussian_model.py:90-114`)."""
        t = int(np.clip(timestep, 0, self.num_timesteps - 1))
        tab = self.flame_table

        def tensor(x) -> torch.Tensor:
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        def get(name, wire):
            if self.control_enabled:
                return tensor(self.control[name])[None]
            if name in self.overrides:
                return tensor(self.overrides[name])[None]
            return tensor(tab[wire][t])[None]

        n_verts = self.model.num_verts
        so = np.asarray(tab.get("static_offset", np.zeros((n_verts, 3)))).reshape(-1, 3)
        if so.shape[0] != n_verts:
            so = np.pad(so, ((0, max(0, n_verts - so.shape[0])), (0, 0)))[:n_verts]
        return FlameParams(
            shape=tensor(tab["shape"])[: self.model.cfg.n_shape],
            expr=get("expr", "expr")[:, : self.model.cfg.n_expr],
            rotation=get("rotation", "rotation"),
            neck=get("neck", "neck_pose"),
            jaw=get("jaw", "jaw_pose"),
            eyes=get("eyes", "eyes_pose"),
            translation=get("translation", "translation"),
            static_offset=tensor(so),
        )

    @torch.inference_mode()
    def render_tensor(
        self,
        fp: Optional[FlameParams],
        camera,
        sh_degree: int = 3,
        bg: Optional[torch.Tensor] = None,
        scaling_modifier: float = 1.0,
    ) -> torch.Tensor:
        """One splat frame [H, W, 3] on the core's device, unclamped: the
        FLAME update for `fp` (None for an unbound avatar), binding, and
        the sorted pipeline with the forward compositor (the table
        pipeline when `use_pallas` is False)."""
        frames = None
        if self.model is not None:
            frames = face_frames(self.model(fp)[0], self.model.faces)
        wg = world_gaussians(self.params, self.aux, frames)
        if bg is None:
            bg = torch.zeros(3, device=self.device)
        return render_tiled(
            wg.means, wg.scales, wg.quats, wg.opacity, camera, bg,
            sh=wg.sh, sh_degree=sh_degree, alive=wg.alive,
            scale_modifier=scaling_modifier, cfg=self.tile, use_pallas=self.use_pallas,
        ).color

    @torch.inference_mode()
    def render(
        self,
        timestep: int = 0,
        camera=None,
        show_splatting: bool = True,
        show_mesh: bool = False,
        mesh_opacity: float = 0.5,
        scaling_modifier: float = 1.0,
        sh_degree: int = 3,
        bg=(0.0, 0.0, 0.0),
    ) -> np.ndarray:
        """The viewer's frame [H, W, 3] as host float32 in [0, 1]."""
        cam = camera if camera is not None else self.cam.to_camera(device=self.device)
        bg = torch.as_tensor(bg, dtype=torch.float32, device=self.device)
        fp = self.flame_params_at(timestep) if self.model is not None else None
        image = None
        if show_splatting:
            image = torch.clamp(self.render_tensor(fp, cam, sh_degree, bg, scaling_modifier),
                                0, 1).cpu().numpy()
        if show_mesh and self.model is not None:
            verts = self.model(fp)[0]
            out = render_mesh_preview(verts, self.model.faces, cam, background=bg)
            image = blend_mesh(image, out["rgba"].cpu().numpy(), mesh_opacity)
        if image is None:
            image = np.zeros((cam.height, cam.width, 3), np.float32)
        return image

    @property
    def num_points(self) -> int:
        return int(self.aux.alive.sum())
