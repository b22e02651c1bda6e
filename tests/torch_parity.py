"""Shared helpers for the PyTorch port's parity tests: numpy scenes handed to
both packages, and JAX state carried across as numpy."""
import dataclasses

import numpy as np
import torch

from gaussianavatars_tpu.data.cameras import look_at_camera as jax_look_at_camera
from gaussianavatars_torch.convert import camera_from_numpy

H, W = 64, 96
TILE_H, TILE_W = 8, 16


def np_scene(n=200, seed=0, opac_lo=0.2, opac_hi=0.9, spread=(0.8, 0.6, 0.3)):
    """A random splat scene as float32 numpy arrays (the raster_fixtures
    statistics, drawn with numpy so both packages get the same inputs)."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    means = (rng.randn(n, 3) * np.array(spread) + np.array([0.0, 0.0, 2.5])).astype(f32)
    scales = rng.uniform(0.01, 0.12, (n, 3)).astype(f32)
    quats = rng.randn(n, 4).astype(f32)
    opacity = rng.uniform(opac_lo, opac_hi, (n,)).astype(f32)
    colors = rng.uniform(0.0, 1.0, (n, 3)).astype(f32)
    return means, scales, quats, opacity, colors


def jax_camera(width=W, height=H, fovy=1.0):
    return jax_look_at_camera(
        eye=np.zeros(3), target=np.array([0.0, 0.0, 2.5]), fovy=fovy,
        width=width, height=height,
    )


def camera_dict(cam) -> dict:
    """A JAX Camera as numpy arrays plus its metadata."""
    return {
        f.name: (np.asarray(v) if hasattr(v, "shape") else v)
        for f in dataclasses.fields(cam)
        for v in [getattr(cam, f.name)]
    }


def torch_camera(cam):
    return camera_from_numpy(camera_dict(cam), device="cpu")


def dataclass_dict(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def t(x, dtype=None):
    """numpy (or JAX) array → CPU tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def n(x):
    """Tensor → numpy."""
    return x.detach().cpu().numpy()


# --- a trained model directory written by the JAX package --------------------

N_TIERS_TILES = 24   # 64×48 in 8×16 tiles: one tier as wide as the frame


def clamped_sphere_assets(tmpdir):
    """`fixtures_avatar`'s tiny sphere assets with the bottom-cap faces
    clamped to the pole, which both packages then index in range (ROADMAP
    queue C)."""
    import os

    import fixtures_avatar as fa
    from gaussianavatars_tpu.models.flame import synthetic_assets

    obj = os.path.join(str(tmpdir), "sphere.obj")
    fa.tiny_sphere_obj(obj)
    assets = synthetic_assets(n_shape=fa.N_SHAPE, n_expr=fa.N_EXPR, seed=0, template_obj=obj)
    return assets._replace(faces=np.minimum(assets.faces, assets.num_verts - 1))


def write_port_dataset(root, assets, params, aux, timesteps=2, cams=2):
    """`fixtures_avatar.write_rendered_dataset`'s DynamicNerf dataset (the
    same FLAME files, cameras, JSON and 64×48 views), its images rendered
    by the port on the CPU: the JAX package's table pipeline would first
    compile for ~25 s."""
    import json
    import os

    import fixtures_avatar as fa
    from PIL import Image

    from gaussianavatars_torch.convert import flame_assets_from_numpy, gaussian_state_from_numpy
    from gaussianavatars_torch.data.cameras import look_at_camera
    from gaussianavatars_torch.models.binding import face_frames
    from gaussianavatars_torch.models.flame import flame_model as tfm
    from gaussianavatars_torch.models.gaussians import world_gaussians
    from gaussianavatars_torch.ops.rasterize_tiled import TileConfig, render_tiled

    tmodel = tfm.FlameModel(flame_assets_from_numpy(assets._asdict()),
                            tfm.FlameConfig(fa.N_SHAPE, fa.N_EXPR, add_teeth=False),
                            device="cpu")
    tp, ta = gaussian_state_from_numpy(dataclass_dict(params), dataclass_dict(aux), device="cpu")
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "flame_param"), exist_ok=True)
    v = np.asarray(assets.v_template)
    center = v.mean(0)
    extent = float(np.abs(v - center).max())
    tcfg = TileConfig(tile_h=TILE_H, tile_w=TILE_W, tiers=((tp.capacity, N_TIERS_TILES),))
    frames_meta = []
    for ts in range(timesteps):
        jaw = np.zeros((1, 3), np.float32)
        jaw[0, 0] = 0.1 * ts
        np.savez(
            os.path.join(root, "flame_param", f"{ts}.npz"),
            shape=np.zeros(fa.N_SHAPE, np.float32), expr=np.zeros((1, fa.N_EXPR), np.float32),
            rotation=np.zeros((1, 3), np.float32), neck_pose=np.zeros((1, 3), np.float32),
            jaw_pose=jaw, eyes_pose=np.zeros((1, 6), np.float32),
            translation=np.zeros((1, 3), np.float32),
            static_offset=np.zeros((1, tmodel.num_verts, 3), np.float32),
        )
        fl = tfm.zero_params(fa.N_SHAPE, fa.N_EXPR, batch=1, device="cpu")._replace(
            jaw=torch.from_numpy(jaw))
        with torch.no_grad():
            wg = world_gaussians(tp, ta, face_frames(tmodel(fl)[0], tmodel.faces))
            for c in range(cams):
                dx = -0.4 + 0.8 * c / max(cams - 1, 1)
                cam = look_at_camera(eye=center + np.array([dx * extent, 0.0, -4 * extent]),
                                     target=center, fovy=0.6, width=fa.W, height=fa.H,
                                     device="cpu")
                out = render_tiled(wg.means, wg.scales, wg.quats, wg.opacity, cam,
                                   torch.zeros(3), sh=wg.sh, sh_degree=0, alive=wg.alive,
                                   cfg=tcfg)
                img = torch.clamp(out.color, 0, 1).numpy()
                name = f"images/t{ts}_c{c}.png"
                Image.fromarray((img * 255).astype(np.uint8)).save(os.path.join(root, name))
                w2c = np.eye(4)
                w2c[:3, :] = cam.world_view.numpy().astype(np.float64)[:3, :]
                c2w = np.linalg.inv(w2c)
                c2w[:3, 1:3] *= -1
                frames_meta.append({
                    "file_path": name, "transform_matrix": c2w.tolist(),
                    "timestep_index": ts, "camera_index": c,
                    "camera_angle_x": float(cam.fovx),
                    "flame_param_path": f"flame_param/{ts}.npz", "w": fa.W, "h": fa.H,
                })
    for split in ("train", "val", "test"):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"frames": frames_meta}, f)
    return root


def write_jax_model_dir(root_dir, model_dir, capacity=1024, iteration=777):
    """A trained model directory as the JAX package writes one: the rendered
    tiny-avatar dataset, `cfg_args.json` (sorted pipeline, Pallas
    compositor, one tier as wide as the frame), `flame_assets.npz`, and
    `point_cloud/iteration_<iteration>/` from `Scene.save`. The avatar is
    `fixtures_avatar.reference_avatar` with seeded offsets, rotations and
    SH bands, so every leaf carries data. Returns (model_dir, jax model,
    assets, params, aux)."""
    import os

    import jax.numpy as jnp

    import fixtures_avatar as fa
    from gaussianavatars_tpu import config as jconfig
    from gaussianavatars_tpu.data.scene import Scene
    from gaussianavatars_tpu.models.flame import flame_model as jfm
    from gaussianavatars_tpu.models.flame.assets import save_assets

    os.makedirs(root_dir, exist_ok=True)
    assets = clamped_sphere_assets(root_dir)
    model = jfm.FlameModel(assets, jfm.FlameConfig(n_shape=fa.N_SHAPE, n_expr=fa.N_EXPR,
                                                   add_teeth=False))
    params, aux = fa.reference_avatar(model, capacity=capacity)
    write_port_dataset(str(root_dir), assets, params, aux)
    rng = np.random.RandomState(3)
    cap = params.means.shape[0]
    params = dataclasses.replace(
        params,
        means=jnp.asarray((rng.randn(cap, 3) * 0.05).astype(np.float32)),
        quats=jnp.asarray(rng.randn(cap, 4).astype(np.float32)),
        sh_rest=jnp.asarray((rng.randn(*params.sh_rest.shape) * 0.05).astype(np.float32)),
    )
    cfg = jconfig.Config(
        model=jconfig.ModelConfig(source_path=str(root_dir), model_path=str(model_dir),
                                  bind_to_mesh=True, capacity=capacity, n_shape=fa.N_SHAPE,
                                  n_expr=fa.N_EXPR, add_teeth=False, sh_degree=3, eval=True),
        pipeline=jconfig.PipelineConfig(tile_h=TILE_H, tile_w=TILE_W,
                                        tiers=((capacity, N_TIERS_TILES),)),
    )
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "cfg_args.json"), "w") as f:
        f.write(jconfig.to_json(cfg))
    save_assets(assets, os.path.join(model_dir, "flame_assets.npz"))
    scene = Scene(str(root_dir), model_path=str(model_dir), num_verts_hint=model.num_verts)
    scene.save(iteration, params, aux, flame_param=scene.flame_table)
    return str(model_dir), model, assets, params, aux
