"""The unbound scene's inputs, made from the seed: the Gaussians of a fitted
Mip-NeRF 360 outdoor scene, its camera ring and its ground-truth images.

The Gaussians lie in four groups, each with the share of `cfg["groups"]`,
on spatially coherent surfaces (independent noise gives many times the
tile pairs of a fitted scene):

  * ground: a smooth height field over a disc;
  * objects: `objects` ellipsoids with axes in `object_axes`, centred in a
    ball (`object_ball`) over the middle of the disc, the scene's subject;
  * shell: the far background, on spheres of radius `shell_radius`;
  * floaters: free Gaussians in a ball (`floater_radius`).

A Gaussian's scale is its group's point spacing (the square root of the
area a point covers; for floaters the cube root of the volume) times
U(0.5, 1.5) a axis; a surface Gaussian is flattened to a tenth along the
surface's normal and turned to it. Opacity is sigmoid(N(1, 2)), the colour
a smooth field over position, the SH rest N(0, 0.05).

World axes are the rig's (`scene.look_at`): y points down, so heights are
negative y. The cameras are fixed by the configuration, not the seed:
`images` views on a ring around the middle, `llffhold` holding out every
such view, each looking at the middle with a small fixed offset. Random
values come from one `torch.Generator` on the run's device, in a few
large calls; the same seed gives the same inputs.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import scene
from .reference import quat_rotate

SH_C0 = 0.28209479177387814
GROUPS = ("ground", "objects", "shell", "floaters")


def group_sizes(cfg: dict) -> dict:
    """Gaussians a group: the shares of `cfg["groups"]` of `gaussians`, the
    floaters taking what rounding leaves."""
    n = cfg["gaussians"]
    sizes = {g: int(round(cfg["groups"][g] * n)) for g in GROUPS[:-1]}
    sizes["floaters"] = n - sum(sizes.values())
    return sizes


def _height(x: torch.Tensor, z: torch.Tensor, waves: torch.Tensor) -> torch.Tensor:
    """The ground's height field (up is −y): a sum of sines [K, 4] rows of
    (kx, kz, phase, amplitude)."""
    arg = x[:, None] * waves[:, 0] + z[:, None] * waves[:, 1] + waves[:, 2]
    return (waves[:, 3] * torch.sin(arg)).sum(1)


def _frame_quats(normal: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Unit quaternions (wxyz) of rotations whose third axis is `normal`
    [N, 3] (unit), turned by a random angle about it."""
    dev = normal.device
    helper = torch.where((normal[:, 0].abs() < 0.9)[:, None],
                         torch.tensor([1.0, 0.0, 0.0], device=dev),
                         torch.tensor([0.0, 1.0, 0.0], device=dev))
    t1 = torch.nn.functional.normalize(torch.linalg.cross(helper, normal), dim=1)
    t2 = torch.linalg.cross(normal, t1)
    a = 2 * math.pi * torch.rand(normal.shape[0], generator=gen, device=dev)
    c, s = torch.cos(a)[:, None], torch.sin(a)[:, None]
    u, v = c * t1 + s * t2, -s * t1 + c * t2
    return _mat_to_quat(torch.stack([u, v, normal], -1))


def _mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (wxyz) of rotation matrices [N, 3, 3] (Shepperd)."""
    tr = m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]
    d = torch.stack([1 + tr, 1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
                     1 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2],
                     1 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2]], -1)
    big = torch.sqrt(torch.clamp_min(d, 1e-12)) / 2
    s21, s02, s10 = m[:, 2, 1] - m[:, 1, 2], m[:, 0, 2] - m[:, 2, 0], m[:, 1, 0] - m[:, 0, 1]
    a01, a02, a12 = m[:, 0, 1] + m[:, 1, 0], m[:, 0, 2] + m[:, 2, 0], m[:, 1, 2] + m[:, 2, 1]
    w, x, y, z = big.unbind(-1)
    cands = torch.stack([
        torch.stack([w, s21 / (4 * w), s02 / (4 * w), s10 / (4 * w)], -1),
        torch.stack([s21 / (4 * x), x, a01 / (4 * x), a02 / (4 * x)], -1),
        torch.stack([s02 / (4 * y), a01 / (4 * y), y, a12 / (4 * y)], -1),
        torch.stack([s10 / (4 * z), a02 / (4 * z), a12 / (4 * z), z], -1)], 1)
    q = cands[torch.arange(m.shape[0], device=m.device), big.argmax(-1)]
    return torch.nn.functional.normalize(q, dim=1)


def _ground(cfg: dict, n: int, gen: torch.Generator):
    dev = gen.device
    r_max = cfg["ground_radius"]
    u = torch.rand((n, 2), generator=gen, device=dev)
    r, th = r_max * torch.sqrt(u[:, 0]), 2 * math.pi * u[:, 1]
    x, z = r * torch.cos(th), r * torch.sin(th)
    w = torch.rand((6, 4), generator=gen, device=dev)
    waves = torch.stack([(w[:, 0] - 0.5) * 2.0, (w[:, 1] - 0.5) * 2.0, w[:, 2] * 2 * math.pi,
                         0.02 + 0.08 * w[:, 3]], 1)
    h = _height(x, z, waves)
    # The surface y = −h(x, z); its normal from the height's gradient.
    arg = x[:, None] * waves[:, 0] + z[:, None] * waves[:, 1] + waves[:, 2]
    dh = waves[:, 3] * torch.cos(arg)
    hx, hz = (dh * waves[:, 0]).sum(1), (dh * waves[:, 1]).sum(1)
    normal = torch.nn.functional.normalize(torch.stack([hx, -torch.ones_like(hx), hz], 1), dim=1)
    spacing = torch.full((n,), math.sqrt(math.pi * r_max ** 2 / n), device=dev)
    return torch.stack([x, -h, z], 1), normal, spacing


def _objects(cfg: dict, n: int, gen: torch.Generator):
    dev = gen.device
    k = cfg["objects"]
    lo, hi = cfg["object_axes"]
    centre = torch.tensor(cfg["centre"], device=dev)
    u = torch.rand((k, 7), generator=gen, device=dev)
    d = torch.nn.functional.normalize(torch.randn((k, 3), generator=gen, device=dev), dim=1)
    centres = centre + d * cfg["object_ball"] * u[:, :1] ** (1 / 3)
    axes = lo + (hi - lo) * u[:, 1:4]
    rot = _mat_to_quat(torch.linalg.qr(torch.randn((k, 3, 3), generator=gen, device=dev))[0])
    # An ellipsoid's area (Knud Thomsen's formula); points in proportion.
    p = 1.6075
    a, b, c = axes.unbind(1)
    area = 4 * math.pi * (((a * b) ** p + (a * c) ** p + (b * c) ** p) / 3) ** (1 / p)
    counts = torch.floor(area / area.sum() * n).long()
    counts[: n - int(counts.sum())] += 1
    obj = torch.repeat_interleave(torch.arange(k, device=dev), counts)
    s = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen, device=dev), dim=1)
    local = axes[obj] * s
    pos = quat_rotate(rot[obj], local) + centres[obj]
    normal = torch.nn.functional.normalize(quat_rotate(rot[obj], s / axes[obj]), dim=1)
    spacing = torch.sqrt(area[obj] / counts[obj].float())
    return pos, normal, spacing


def _shell(cfg: dict, n: int, gen: torch.Generator):
    dev = gen.device
    lo, hi = cfg["shell_radius"]
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen, device=dev), dim=1)
    r = lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)
    centre = torch.tensor(cfg["centre"], device=dev)
    # A point covers its share of the sphere it lies on, seen from the centre.
    return centre + d * r[:, None], d, r * math.sqrt(4 * math.pi / n)


def _floaters(cfg: dict, n: int, gen: torch.Generator):
    dev = gen.device
    rad = cfg["floater_radius"]
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen, device=dev), dim=1)
    r = rad * torch.rand(n, generator=gen, device=dev) ** (1 / 3)
    centre = torch.tensor(cfg["centre"], device=dev)
    spacing = torch.full((n,), (4 / 3 * math.pi * rad ** 3 / max(n, 1)) ** (1 / 3), device=dev)
    return centre + d * r[:, None], None, spacing


def gaussians(cfg: dict, gen: torch.Generator) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """The fitted scene's Gaussians in world space, padded to `capacity`:
    (leaves by name, binding [N] zeros, alive [N]); the groups in the order
    of `GROUPS`."""
    dev = gen.device
    cap, n = cfg["capacity"], cfg["gaussians"]
    if n > cap:
        raise ValueError(f"{n} Gaussians exceed the capacity {cap}")
    sizes = group_sizes(cfg)
    parts = [fn(cfg, sizes[g], gen) for g, fn in zip(GROUPS, (_ground, _objects, _shell,
                                                                _floaters))]
    means = torch.cat([p[0] for p in parts])
    spacing = torch.cat([p[2] for p in parts])
    u = 0.5 + torch.rand((n, 3), generator=gen, device=dev)
    scales = spacing[:, None] * u
    quats = []
    for (pos, normal, _s), g in zip(parts, GROUPS):
        if normal is None:
            quats.append(torch.nn.functional.normalize(
                torch.randn((pos.shape[0], 4), generator=gen, device=dev), dim=1))
        else:
            quats.append(_frame_quats(normal, gen))
    quats = torch.cat(quats)
    surface = torch.cat([torch.full((sizes[g],), g != "floaters", device=dev) for g in GROUPS])
    scales[:, 2] = torch.where(surface, scales[:, 2] * 0.1, scales[:, 2])
    # Colour: a smooth field over position (three sines of random
    # directions a channel, wavelengths of a few units), squashed to (0, 1).
    k = torch.randn((3, 3, 3), generator=gen, device=dev) * 1.5
    phase = 2 * math.pi * torch.rand((3, 3), generator=gen, device=dev)
    field = torch.sin(torch.einsum("ni,ijc->njc", means, k) + phase).sum(1)
    rgb = torch.sigmoid(1.5 * field)
    logit = 1.0 + 2.0 * torch.randn((n, 1), generator=gen, device=dev)
    sh_rest = 0.05 * torch.randn((n, 15, 3), generator=gen, device=dev)

    def pad(x, fill=0.0):
        out = torch.full((cap, *x.shape[1:]), fill, dtype=torch.float32, device=dev)
        out[:n] = x
        return out

    quats_p = pad(quats)
    quats_p[n:, 0] = 1.0
    leaves = dict(means=pad(means), log_scales=pad(torch.log(scales), math.log(0.01)),
                  quats=quats_p, sh_dc=pad(((rgb - 0.5) / SH_C0)[:, None, :]),
                  sh_rest=pad(sh_rest), logit_opacity=pad(logit, -10.0))
    idx = torch.arange(cap, device=dev)
    return leaves, torch.zeros(cap, dtype=torch.int64, device=dev), idx < n


def rig(cfg: dict, device) -> list[dict]:
    """The training cameras: `images` eyes on a ring of `ring_radius` around
    the middle at heights in `ring_heights` (a smooth wave along the ring),
    each looking at the middle moved by a small fixed offset; every
    `llffhold`-th view held out (the reference's `--eval` split). One
    pinhole of horizontal field of view `fovx_deg` at `width`×`height`."""
    w, h = cfg["width"], cfg["height"]
    fovy = 2 * math.atan(math.tan(math.radians(cfg["fovx_deg"]) / 2) * h / w)
    lo, hi = cfg["ring_heights"]
    centre = np.asarray(cfg["centre"], np.float64)
    out = []
    for i in range(cfg["images"]):
        if i % cfg["llffhold"] == 0:
            continue
        th = 2 * math.pi * i / cfg["images"]
        height = lo + (hi - lo) * (0.5 + 0.5 * math.sin(3 * th))
        eye = np.array([cfg["ring_radius"] * math.cos(th), -height,
                        cfg["ring_radius"] * math.sin(th)])
        target = centre + 0.2 * np.array([math.sin(5 * th), 0.5 * math.cos(7 * th),
                                          math.cos(5 * th)])
        out.append(scene.look_at(eye, target, fovy, w, h, device))
    if len(out) != cfg["cameras"]:
        raise ValueError(f"{len(out)} training views, the configuration says {cfg['cameras']}")
    return out


def camera_extent(cams: list[dict]) -> float:
    """`getNerfppNorm`'s radius: 1.1 × the largest distance of a camera
    centre from their mean, the reference's `spatial_lr_scale`."""
    c = np.stack([cam["camera_center"].double().cpu().numpy() for cam in cams])
    return 1.1 * float(np.linalg.norm(c - c.mean(0), axis=1).max())


def ground_truth(cfg: dict, gen: torch.Generator) -> torch.Tensor:
    """A uint8 image [V, H, W, 3] a training view: smooth colour fields."""
    return scene.ground_truth(cfg["cameras"], cfg["height"], cfg["width"], gen)
