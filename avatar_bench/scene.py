"""The benchmark's inputs, made from the seed: FLAME's arrays on a stand-in
topology, the bound Gaussians of a trained avatar, the camera rig, smooth
FLAME trajectories and the ground-truth images.

Everything random comes from one `torch.Generator` on the run's device,
seeded with the run's seed, in a few large calls; the same seed gives the
same inputs. The arrays are plain tensors and numpy arrays: `program.py`
hands them to the program in its own types, and the reference reads them
as they are.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# FLAME's kinematic chain: global, neck, jaw, left eye, right eye.
PARENTS = np.array([-1, 0, 1, 1, 1])


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def uv_sphere(n_verts: int):
    """A UV sphere of radius 0.1 with `n_verts` vertices: the stand-in for
    FLAME's licensed head mesh (5,023 vertices)."""
    rows = int(np.sqrt(n_verts / 2))
    cols = -(-n_verts // rows)
    th, ph = np.meshgrid(np.linspace(1e-3, np.pi - 1e-3, rows),
                         np.linspace(0, 2 * np.pi, cols, endpoint=False), indexing="ij")
    verts = np.stack([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], -1)
    verts = (verts.reshape(-1, 3)[:n_verts] * 0.1).astype(np.float32)
    faces = []
    for i in range(rows - 1):
        for j in range(cols):
            a, b = i * cols + j, i * cols + (j + 1) % cols
            c, d = a + cols, b + cols
            if d < n_verts and c < n_verts:
                faces += [[a, b, c], [b, d, c]]
    return verts, np.asarray(faces, np.int64)


def smooth_fields(verts: np.ndarray, n: int, scale, gen: torch.Generator) -> torch.Tensor:
    """`n` smooth displacement fields over the vertices [V, 3, n]: each axis
    a sine of a random direction (wavelength about the head's size) with a
    random phase, `scale` (a number or [n]) times a N(0, 1) amplitude, as
    FLAME's PCA bases deform the whole head smoothly."""
    dev = gen.device
    v = torch.as_tensor(verts, device=dev)
    k = torch.randn((3, 3, n), generator=gen, device=dev) * (2 * math.pi / 0.2)
    phase = 2 * math.pi * torch.rand((3, n), generator=gen, device=dev)
    amp = torch.randn((3, n), generator=gen, device=dev) * torch.as_tensor(scale, device=dev)
    return amp * torch.sin(torch.einsum("vi,ijn->vjn", v, k) + phase)


def flame_arrays(cfg: dict, gen: torch.Generator) -> dict:
    """FLAME's arrays at the configuration's widths: smooth shape and
    expression bases whose spread falls with the component's index (a PCA
    basis: component c at 3e-3/√(c+1), in head units of radius 0.1), smooth
    pose correctives (1e-4), a soft joint regressor at plausible joints,
    skinning weights blending the global and neck joints from top to
    bottom."""
    verts, faces = uv_sphere(cfg["num_verts"])
    v = verts.shape[0]
    n_pose = (len(PARENTS) - 1) * 9
    ns, ne = cfg["n_shape"], cfg["n_expr"]
    spread = 3e-3 / np.sqrt(1.0 + np.concatenate([np.arange(ns), np.arange(ne)]))
    shapedirs = smooth_fields(verts, ns + ne, spread.astype(np.float32), gen)
    posedirs = smooth_fields(verts, n_pose, 1e-4, gen).permute(2, 0, 1).reshape(n_pose, v * 3)
    center = verts.mean(0)
    lo, hi = verts[:, 1].min(), verts[:, 1].max()
    joints = np.array([center, center + [0.0, -0.3 * (hi - lo), 0.0],
                       center + [0.0, -0.15 * (hi - lo), 0.02], center + [-0.03, 0.05, 0.05],
                       center + [0.03, 0.05, 0.05]], np.float32)
    d2 = ((verts[None] - joints[:, None]) ** 2).sum(-1)
    jreg = np.exp(-d2 / (0.02 + d2.min(1, keepdims=True) * 4))
    jreg = (jreg / jreg.sum(1, keepdims=True)).astype(np.float32)
    t = np.clip((verts[:, 1] - lo) / (hi - lo + 1e-9), 0, 1)
    w = np.stack([t, (1 - t) * 0.7, (1 - t) * 0.3, 0 * t, 0 * t], -1)
    w = (w / w.sum(1, keepdims=True)).astype(np.float32)
    return dict(v_template=verts, faces=faces, shapedirs=shapedirs.cpu().numpy(),
                posedirs=posedirs.contiguous().cpu().numpy(), j_regressor=jreg, lbs_weights=w,
                parents=PARENTS.copy(), n_shape=ns, add_teeth=cfg["add_teeth"])


def num_faces(cfg: dict) -> int:
    """Faces of the topology, the teeth's 168 included."""
    return uv_sphere(cfg["num_verts"])[1].shape[0] + (168 if cfg["add_teeth"] else 0)


def gaussians(cfg: dict, gen: torch.Generator) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """A trained avatar's Gaussians, `per_face` bound to each face: local
    means near the triangle, sub-triangle scales, random rotations, random
    colours with a view-dependent part, high opacity. Padded to `capacity`.
    Returns (leaves by name, binding [N], alive [N])."""
    dev = gen.device
    cap, n = cfg["capacity"], num_faces(cfg) * cfg["per_face"]
    if n != cfg["gaussians"] or n > cap:
        raise ValueError(f"{n} Gaussians do not match the configuration ({cfg['gaussians']}, "
                         f"capacity {cap})")
    u = torch.rand((cap, 3 + 3), generator=gen, device=dev)
    z = torch.randn((cap, 3 + 4 + 15 * 3), generator=gen, device=dev)
    leaves = dict(
        means=z[:, :3] * 0.1,
        log_scales=torch.log(0.25 + 0.45 * u[:, :3]),
        quats=z[:, 3:7].contiguous(),
        sh_dc=((u[:, 3:6] - 0.5) / 0.28209479177387814)[:, None, :],
        sh_rest=(z[:, 7:] * 0.05).reshape(cap, 15, 3),
        logit_opacity=torch.full((cap, 1), math.log(0.92 / 0.08), device=dev),
    )
    idx = torch.arange(cap, device=dev)
    binding = torch.where(idx < n, idx % num_faces(cfg), torch.zeros_like(idx))
    return leaves, binding, idx < n


def color_net(cfg: dict, gen: torch.Generator) -> dict:
    """Innovation 4's colour MLP, 3 → hidden → … → 3: He-normal weights
    [in, out], zero biases, as `color_w<i>`, `color_b<i>`."""
    opt = cfg["opt"]
    dims = [3] + [opt["color_net_hidden_dim"]] * (opt["color_net_layers"] - 1) + [3]
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"color_w{i}"] = torch.randn((a, b), generator=gen, device=gen.device) * math.sqrt(2 / a)
        out[f"color_b{i}"] = torch.zeros((b,), device=gen.device)
    return out


def look_at(eye, target, fovy: float, width: int, height: int, device) -> dict:
    """A pinhole camera (OpenCV axes: x right, y down, z forward) at `eye`
    looking at `target`, with the 3DGS projection (near 0.01, far 100)."""
    eye, target = np.asarray(eye, np.float64), np.asarray(target, np.float64)
    fwd = (target - eye) / np.linalg.norm(target - eye)
    right = np.cross([0.0, -1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    rot = np.stack([right, down, fwd], 1)
    w2v = np.eye(4)
    w2v[:3, :3], w2v[:3, 3] = rot.T, -rot.T @ eye
    fovx = 2 * math.atan(math.tan(fovy / 2) * width / height)
    near, far = 0.01, 100.0
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = 1 / math.tan(fovx / 2), 1 / math.tan(fovy / 2)
    proj[2, 2], proj[2, 3], proj[3, 2] = far / (far - near), -far * near / (far - near), 1.0
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    world_view, projection = f32(w2v), f32(proj)
    return dict(world_view=world_view, proj=projection, full_proj=projection @ world_view,
                camera_center=f32(eye), fovx=fovx, fovy=fovy, width=width, height=height)


def rig(cfg: dict, width: int, height: int, device) -> list[dict]:
    """`cameras` cameras on a horizontal arc of `arc_deg` in front of the
    head, at 4.5 times its extent, one shared intrinsic matrix. Camera 0 is
    the middle of the arc's front view when there is one camera."""
    verts, _ = uv_sphere(cfg["num_verts"])
    center = verts.mean(0)
    dist = 4.5 * float(np.abs(verts - center).max())
    k = cfg["cameras"]
    yaws = [0.0] if k == 1 else np.radians(np.linspace(-cfg["arc_deg"] / 2,
                                                       cfg["arc_deg"] / 2, k))
    return [look_at(center + dist * np.array([math.sin(y), 0.0, -math.cos(y)]), center,
                    cfg["fovy"], width, height, device) for y in yaws]


FLAME_POSE = (("expr", None), ("rotation", 3), ("neck", 3), ("jaw", 3), ("eyes", 6),
              ("translation", 3))


def trajectory(cfg: dict, traffic: dict, n: int, gen: torch.Generator) -> dict:
    """`n` poses along a smooth path: each coordinate a sum of three sines
    with random frequencies (`cycles` per pose, low to high), phases and
    weights, scaled to its range in `traffic["ranges"]` (0: held at 0).
    Returns {name: [n, dim]} on the generator's device."""
    dev = gen.device
    dims = [(k, cfg["n_expr"] if d is None else d) for k, d in FLAME_POSE]
    total = sum(d for _, d in dims)
    lo, hi = traffic["cycles"]
    r = torch.rand((3, 3, total), generator=gen, device=dev)
    freq = lo + (hi - lo) * r[0]
    phase = 2 * math.pi * r[1]
    weight = r[2] / r[2].sum(0, keepdim=True)
    t = torch.arange(n, dtype=torch.float32, device=dev)[:, None, None]
    path = (weight * torch.sin(2 * math.pi * freq * t + phase)).sum(1)      # [n, total]
    out, i = {}, 0
    for k, d in dims:
        out[k] = (path[:, i:i + d] * traffic["ranges"][k]).contiguous()
        i += d
    return out


def shape_coeffs(cfg: dict, gen: torch.Generator) -> torch.Tensor:
    """The avatar's FLAME shape [n_shape], N(0, 1)."""
    return torch.randn((cfg["n_shape"],), generator=gen, device=gen.device)


def ground_truth(n_images: int, height: int, width: int, gen: torch.Generator,
                 batch: int = 64) -> torch.Tensor:
    """`n_images` uint8 images [n, H, W, 3] on the device: smooth random
    colour fields (bilinear from a 1/32 grid)."""
    dev = gen.device
    out = torch.empty((n_images, height, width, 3), dtype=torch.uint8, device=dev)
    for i in range(0, n_images, batch):
        b = min(batch, n_images - i)
        low = torch.randn((b, 3, -(-height // 32) + 1, -(-width // 32) + 1), generator=gen,
                          device=dev)
        img = torch.nn.functional.interpolate(low, size=(height, width), mode="bilinear",
                                              align_corners=False)
        out[i:i + b] = (torch.sigmoid(1.5 * img) * 255).round().to(torch.uint8).permute(
            0, 2, 3, 1)
    return out
