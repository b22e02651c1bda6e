"""The plain reference of the avatar's frame and training step.

Plain PyTorch, written from the published method (FLAME, the GaussianAvatars
binding, 3D Gaussian splatting with its tile culling and alpha rule, the
L1 + D-SSIM loss and Adam) and independent of the program under test: it
imports nothing of it. Its inputs are the benchmark's own arrays (`scene.py`);
everything the program derives from them (the teeth, the face frames, the
projection, the tile lists, the image, the gradients) is worked out here
again.

Every matrix product goes through `Precision.mm`, so the control of the correctness
check can run the same reference in TF32 (`precision="tf32"`: each operand
rounded to TF32's 10-bit mantissa, in the backward too), the precision a
later change might be tempted to switch on. The default is float32 with
TF32 off, as the program computes.

The compositing follows the 3DGS rasteriser: a Gaussian reaches the pixels
of the tiles its box covers (the alpha-cutoff ellipse's box cut by the 3σ
circle), in front-to-back depth order within a tile; alpha = min(0.99,
o·exp(power)), skipped where power > 0 or alpha < 1/255; a Gaussian that
would take the transmittance below 1e-4 ends the pixel's ray and is not
composited. Tiles are composited in blocks, each padded to its longest
list, so that a frame at full size fits.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

ALPHA_CUTOFF = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
COV2D_FILTER = 0.3
NEAR_CLIP = 0.2
# Pair-pixels a compositing block holds at most (the tensors of one block
# are a few of this many floats).
BLOCK_PAIR_PIXELS = 1 << 25

# FLAME 2023's outer lip contours (vertex ids of the public topology), from
# which the GaussianAvatars teeth are built.
LIP_UPPER = np.array([1713, 1715, 1716, 1735, 1696, 1694, 1657, 3543, 2774, 2811, 2813,
                      2850, 2833, 2832, 2830])
LIP_LOWER = np.array([1576, 1577, 1773, 1774, 1795, 1802, 1865, 3503, 2948, 2905, 2898,
                      2881, 2880, 2713, 2712])
TEETH_ROWS = 15
# FLAME 2023's vertex ranges of the regions the region-adaptive loss weighs
# (GaussianAvatars innovations, `region_adaptive_loss.py`), by the weight
# that applies to each group.
REGION_RANGES = {"eyes_left": (3997, 4067), "eyes_right": (3930, 3997), "mouth": (2812, 3025),
                 "nose": (3325, 3450)}
REGION_WEIGHTS = (("eyes", ("eyes_left", "eyes_right")), ("mouth", ("mouth",)),
                  ("nose", ("nose",)))

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


class _RoundTF32(torch.autograd.Function):
    """Rounds to TF32 (10 mantissa bits, to nearest) forward and backward."""

    @staticmethod
    def forward(ctx, x):
        return _tf32(x)

    @staticmethod
    def backward(ctx, g):
        return _tf32(g)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.detach().float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Precision:
    """`tf32` rounds every matrix product's operands to TF32."""

    tf32: bool = False

    def op(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundTF32.apply(x) if self.tf32 else x

    def mm(self, eq: str, *xs: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *(self.op(x) for x in xs))


def precision(name: str) -> Precision:
    if name not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {name!r}")
    return Precision(tf32=name == "tf32")


# ---------------------------------------------------------------------------
# FLAME with the GaussianAvatars teeth
# ---------------------------------------------------------------------------

def _strip(a, b, flip=False):
    tris = []
    for i in range(len(a) - 1):
        tris += [(a[i], b[i + 1], b[i]), (a[i], a[i + 1], b[i + 1])]
    tris = np.asarray(tris, np.int64)
    return tris[:, ::-1] if flip else tris


def with_teeth(flame: dict) -> dict:
    """FLAME's arrays with the 120 teeth vertices and their faces added, as
    GaussianAvatars adds them (`flame_model/flame.py`, `add_teeth`): eight
    rows of 15 behind the lips, shape offsets of the lip rings' mean, no
    pose or expression offsets, upper teeth skinned to the neck and lower
    to the jaw."""
    vt = flame["v_template"]
    v_up, v_lo = vt[LIP_UPPER], vt[LIP_LOWER]
    mean_dist = np.linalg.norm(v_up - v_lo, axis=-1, keepdims=True).mean()
    mid = (v_up + v_lo) / 2
    mid[:, 1] = mid[:, 1].mean()
    mid[:, 2] -= mean_dist * 1.5
    dy = np.array([[0.0, mean_dist, 0.0]], np.float32)
    dz = np.array([[0.0, 0.0, mean_dist]], np.float32)
    up_edge, lo_edge = mid + dy * 0.1, mid - dy * 0.1 - dz * 0.4
    up_root, lo_root = up_edge + dy * 2, lo_edge - dy * 2
    rows = [up_root, lo_root, up_edge, lo_edge, up_root - dz, up_edge - dz,
            lo_root - dz, lo_edge - dz]
    v0 = vt.shape[0]
    teeth = np.concatenate(rows).astype(np.float32)
    ids = [np.arange(r * TEETH_ROWS, (r + 1) * TEETH_ROWS) + v0 for r in range(8)]
    upper = np.concatenate([ids[0], ids[2], ids[4], ids[5]])
    lower = np.concatenate([ids[1], ids[3], ids[6], ids[7]])
    faces = np.concatenate([
        flame["faces"], _strip(ids[0], ids[2]), _strip(ids[4], ids[5], True),
        _strip(ids[5], ids[2]), _strip(ids[1], ids[3], True), _strip(ids[6], ids[7]),
        _strip(ids[7], ids[3], True)])
    n_teeth = teeth.shape[0]
    sd = np.concatenate([flame["shapedirs"], np.zeros_like(flame["shapedirs"][:n_teeth])])
    s = flame["n_shape"]
    sd[v0:, :, :s] = np.tile((sd[LIP_UPPER, :, :s] + sd[LIP_LOWER, :, :s]) / 2, (8, 1, 1))
    n_pose = flame["posedirs"].shape[0]
    pd = flame["posedirs"].reshape(n_pose, v0, 3)
    pd = np.concatenate([pd, np.zeros((n_pose, n_teeth, 3), np.float32)], 1)
    jreg = np.concatenate([flame["j_regressor"],
                           np.zeros((flame["j_regressor"].shape[0], n_teeth), np.float32)], 1)
    w = np.concatenate([flame["lbs_weights"],
                        np.zeros((n_teeth, flame["lbs_weights"].shape[1]), np.float32)])
    w[upper, 1] = 1.0
    w[lower, 2] = 1.0
    return {**flame, "v_template": np.concatenate([vt, teeth]), "shapedirs": sd,
            "posedirs": pd.reshape(n_pose, -1), "j_regressor": jreg, "lbs_weights": w,
            "faces": faces}


class Flame:
    """FLAME's forward (shape and expression blend shapes, pose correctives,
    a kinematic chain of five joints, linear blend skinning) on `device`."""

    def __init__(self, flame: dict, device, prec: Precision = Precision()):
        if flame.get("add_teeth", True):
            flame = with_teeth(flame)
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
        self.v_template = t(flame["v_template"])
        self.shapedirs = t(flame["shapedirs"])
        self.posedirs = t(flame["posedirs"])
        self.j_regressor = t(flame["j_regressor"])
        self.weights = t(flame["lbs_weights"])
        self.parents = [int(p) for p in flame["parents"]]
        self.faces = torch.as_tensor(np.asarray(flame["faces"], np.int64), device=device)
        self.prec = prec

    def rodrigues(self, aa: torch.Tensor) -> torch.Tensor:
        angle = torch.linalg.norm(aa + 1e-8, dim=-1, keepdim=True)
        k = aa / angle
        kx, ky, kz = k.unbind(-1)
        z = torch.zeros_like(kx)
        km = torch.stack([z, -kz, ky, kz, z, -kx, -ky, kx, z], -1).reshape(*aa.shape[:-1], 3, 3)
        eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
        s, c = torch.sin(angle)[..., None], torch.cos(angle)[..., None]
        return eye + s * km + (1 - c) * self.prec.mm("...ij,...jk->...ik", km, km)

    def __call__(self, shape, expr, rotation, neck, jaw, eyes, translation):
        """Posed vertices [B, V, 3] and the shaped template [B, V, 3]."""
        mm = self.prec.mm
        b = expr.shape[0]
        betas = torch.cat([shape[None].expand(b, -1), expr], 1)
        v_shaped = self.v_template + mm("bl,vkl->bvk", betas, self.shapedirs)
        pose = torch.cat([rotation, neck, jaw, eyes], 1).reshape(b, -1, 3)
        rot = self.rodrigues(pose)
        joints = mm("jv,bvk->bjk", self.j_regressor, v_shaped)
        eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
        feat = (rot[:, 1:] - eye).reshape(b, -1)
        v_posed = v_shaped + mm("bp,pq->bq", feat, self.posedirs).reshape(b, -1, 3)
        # World transform of each joint along the chain, then relative to the
        # rest pose: x ↦ R_j x + (t_j − R_j joint_j).
        rs, ts = [rot[:, 0]], [joints[:, 0]]
        for j in range(1, len(self.parents)):
            p = self.parents[j]
            rs.append(mm("bik,bkj->bij", rs[p], rot[:, j]))
            ts.append(ts[p] + mm("bik,bk->bi", rs[p], joints[:, j] - joints[:, p]))
        r = torch.stack(rs, 1)
        t = torch.stack(ts, 1) - mm("bjik,bjk->bji", r, joints)
        rv = mm("vj,bjik->bvik", self.weights, r)
        tv = mm("vj,bji->bvi", self.weights, t)
        verts = mm("bvik,bvk->bvi", rv, v_posed) + tv + translation[:, None]
        return verts, v_shaped


# ---------------------------------------------------------------------------
# Binding, projection, colour
# ---------------------------------------------------------------------------

def _normalize(v, eps=1e-20):
    return v / torch.sqrt(torch.clamp_min((v * v).sum(-1, keepdim=True), eps))


def quat_normalize(q):
    return q / torch.sqrt(torch.clamp_min((q * q).sum(-1, keepdim=True), 1e-12))


def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def quat_rotate(q, v):
    u = q[..., 1:]
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (q[..., :1] * uv + torch.linalg.cross(u, uv))


def rotmat_to_quat(m):
    """Unit quaternion (w ≥ 0) of rotation matrices [..., 3, 3], by the
    largest of the four candidate components (Shepperd)."""
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    d = torch.stack([1 + tr, 1 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                     1 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
                     1 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]], -1)
    big = torch.sqrt(torch.clamp_min(d, 1e-12)) / 2
    s21, s02, s10 = (m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                     m[..., 1, 0] - m[..., 0, 1])
    a01, a02, a12 = (m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0],
                     m[..., 1, 2] + m[..., 2, 1])
    qw, qx, qy, qz = big.unbind(-1)
    cands = torch.stack([
        torch.stack([qw, s21 / (4 * qw), s02 / (4 * qw), s10 / (4 * qw)], -1),
        torch.stack([s21 / (4 * qx), qx, a01 / (4 * qx), a02 / (4 * qx)], -1),
        torch.stack([s02 / (4 * qy), a01 / (4 * qy), qy, a12 / (4 * qy)], -1),
        torch.stack([s10 / (4 * qz), a02 / (4 * qz), a12 / (4 * qz), qz], -1)], -2)
    best = torch.argmax(big, -1)
    q = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def face_frames(verts, faces):
    """Each triangle's centre, orientation quaternion and scale: axes the
    first edge, the normal and their cross; scale the mean of the first
    edge's length and the height over it."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    a0 = _normalize(v1 - v0)
    a1 = _normalize(torch.linalg.cross(a0, v2 - v0))
    a2 = -_normalize(torch.linalg.cross(a1, a0))
    rot = torch.stack([a0, a1, a2], -1)
    scale = (torch.linalg.norm(v1 - v0, dim=-1, keepdim=True)
             + torch.abs((a2 * (v2 - v0)).sum(-1, keepdim=True))) / 2
    return (v0 + v1 + v2) / 3, rotmat_to_quat(rot), scale


def world_gaussians(g: dict, binding, frames):
    """Activated Gaussians in world space: the triangle's frame composed with
    each Gaussian's local mean, rotation and scale."""
    center, fq, fs = (x[binding] for x in frames)
    q = quat_mul(fq, quat_normalize(g["quats"]))
    means = quat_rotate(fq, g["means"]) * fs + center
    scales = torch.exp(g["log_scales"]) * fs
    opacity = torch.sigmoid(g["logit_opacity"][:, 0])
    sh = torch.cat([g["sh_dc"], g["sh_rest"]], 1)
    return means, scales, q, opacity, sh


def project(means, scales, quats, cam: dict, alive):
    """EWA projection: pixel means, depth, conic, 2D covariance, 3σ radius,
    the mask of Gaussians in front of the near plane with a positive 2D
    determinant."""
    w2v, full = cam["world_view"], cam["full_proj"]
    x, y, z = means.unbind(-1)
    row = lambda m, r: x * m[r, 0] + y * m[r, 1] + z * m[r, 2] + m[r, 3]  # noqa: E731
    tx0, ty0, depth = row(w2v, 0), row(w2v, 1), row(w2v, 2)
    hw = 1.0 / (row(full, 3) + 1e-7)
    w, h = cam["width"], cam["height"]
    mean2d = torch.stack([((row(full, 0) * hw + 1.0) * w - 1.0) * 0.5,
                          ((row(full, 1) * hw + 1.0) * h - 1.0) * 0.5], -1)
    tanx, tany = math.tan(cam["fovx"] / 2), math.tan(cam["fovy"] / 2)
    fx, fy = w / (2 * tanx), h / (2 * tany)
    tz = torch.where(torch.abs(depth) < 1e-6, torch.full_like(depth, 1e-6), depth)
    txc = torch.clamp(tx0 / tz, -1.3 * tanx, 1.3 * tanx) * tz
    tyc = torch.clamp(ty0 / tz, -1.3 * tany, 1.3 * tany) * tz
    # J·W, two rows of three, and Σ = R S² Rᵀ, elementwise.
    rw = w2v[:3, :3]
    j0 = [fx / tz * rw[0, k] - fx * txc / (tz * tz) * rw[2, k] for k in range(3)]
    j1 = [fy / tz * rw[1, k] - fy * tyc / (tz * tz) * rw[2, k] for k in range(3)]
    qw, qx, qy, qz = quat_normalize(quats).unbind(-1)
    r = [[1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
         [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
         [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)]]
    s2 = [scales[:, k] * scales[:, k] for k in range(3)]
    cov = [[sum(r[i][k] * r[j][k] * s2[k] for k in range(3)) for j in range(3)] for i in range(3)]
    t0 = [sum(j0[k] * cov[k][m] for k in range(3)) for m in range(3)]
    t1 = [sum(j1[k] * cov[k][m] for k in range(3)) for m in range(3)]
    a = sum(t0[m] * j0[m] for m in range(3)) + COV2D_FILTER
    b = sum(t0[m] * j1[m] for m in range(3))
    c = sum(t1[m] * j1[m] for m in range(3)) + COV2D_FILTER
    det = a * c - b * b
    ok = det > 0
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    mid = 0.5 * (a + c)
    radius = torch.ceil(3.0 * torch.sqrt(mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))))
    mask = (depth > NEAR_CLIP) & ok & (radius > 0) & alive
    radius = torch.where(mask, radius, torch.zeros_like(radius))
    return dict(mean2d=mean2d, depth=depth, conic=conic, cov_a=a, cov_c=c, radius=radius,
                mask=mask)


def sh_colors(means, sh, cam_center):
    """RGB of SH degree 3 along the view direction, +0.5 and clamped at 0."""
    d = means - cam_center
    d = d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-12)
    x, y, z = d[:, :1], d[:, 1:2], d[:, 2:]
    xx, yy, zz = x * x, y * y, z * z
    basis = [torch.full_like(x, SH_C0), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
             SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy),
             SH_C2[3] * x * z, SH_C2[4] * (xx - yy),
             SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
             SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
             SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
             SH_C3[6] * x * (xx - 3 * yy)]
    out = sum(bk * sh[:, k] for k, bk in enumerate(basis))
    return torch.clamp_min(out + 0.5, 0.0)


# ---------------------------------------------------------------------------
# Tiles and compositing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TileLists:
    """Each tile's Gaussians, front to back: `gauss` [P] in tile-major order,
    `start` and `count` [NT] (host)."""

    gauss: torch.Tensor
    start: np.ndarray
    count: np.ndarray
    nty: int
    ntx: int


def tile_lists(proj: dict, opacity, height, width, tile) -> TileLists:
    """The (tile, Gaussian) pairs: every tile of a Gaussian's box, the box of
    its alpha-cutoff ellipse cut by its 3σ circle, sorted by tile and then
    by depth."""
    nty, ntx = -(-height // tile), -(-width // tile)
    m = proj["mask"]
    r = proj["radius"]
    tau = 2.0 * torch.log(torch.clamp_min(opacity, ALPHA_CUTOFF) / ALPHA_CUTOFF)
    hx = torch.minimum(r, torch.sqrt(tau * torch.clamp_min(proj["cov_a"], 0.0)))
    hy = torch.minimum(r, torch.sqrt(tau * torch.clamp_min(proj["cov_c"], 0.0)))
    mx, my = proj["mean2d"][:, 0], proj["mean2d"][:, 1]
    x0 = torch.clamp(torch.floor((mx - hx) / tile), 0, ntx).long()
    x1 = torch.clamp(torch.floor((mx + hx) / tile) + 1, 0, ntx).long()
    y0 = torch.clamp(torch.floor((my - hy) / tile), 0, nty).long()
    y1 = torch.clamp(torch.floor((my + hy) / tile) + 1, 0, nty).long()
    bw = x1 - x0
    n = torch.where(m, bw * (y1 - y0), torch.zeros_like(bw))
    g = torch.repeat_interleave(torch.arange(n.shape[0], device=n.device), n)
    first = torch.cumsum(n, 0) - n
    j = torch.arange(g.shape[0], device=n.device) - first[g]
    bwg = torch.clamp_min(bw[g], 1)
    t = (y0[g] + j // bwg) * ntx + x0[g] + j % bwg
    rank = torch.empty_like(n)
    rank[torch.argsort(proj["depth"], stable=True)] = torch.arange(n.shape[0], device=n.device)
    order = torch.argsort(t * n.shape[0] + rank[g])
    count = torch.bincount(t, minlength=nty * ntx).cpu().numpy()
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    return TileLists(gauss=g[order], start=start, count=count, nty=nty, ntx=ntx)


def _blocks(lists: TileLists, tile_pixels: int):
    """Tiles in blocks of similar list length (longest first), each block's
    padded size under the budget: arrays of tile ids and the block's longest
    list."""
    order = np.argsort(-lists.count, kind="stable")
    i = 0
    while i < order.shape[0]:
        kmax = max(int(lists.count[order[i]]), 1)
        n = max(1, BLOCK_PAIR_PIXELS // (kmax * tile_pixels))
        yield order[i:i + n], kmax
        i += n


def composite_block(lists: TileLists, ids, kmax, tile, screen, bg, prec: Precision):
    """Colour [B, P, 3] of tiles `ids` and the pairs each pixel walks."""
    mean2d, conic, colors, opacity = screen
    dev = mean2d.device
    tiles = torch.as_tensor(ids, device=dev)
    lin = torch.arange(tile * tile, device=dev)
    px = ((tiles % lists.ntx) * tile)[:, None].float() + (lin % tile).float()[None]
    py = ((tiles // lists.ntx) * tile)[:, None].float() + (lin // tile).float()[None]
    start = torch.as_tensor(lists.start[ids], device=dev)
    count = torch.as_tensor(lists.count[ids], device=dev)
    slot = torch.arange(kmax, device=dev)
    valid = slot[None] < count[:, None]                                  # [B, K]
    idx = lists.gauss[torch.clamp_max(start[:, None] + slot[None],
                                      max(lists.gauss.shape[0] - 1, 0))] if lists.gauss.numel() \
        else torch.zeros((len(ids), kmax), dtype=torch.long, device=dev)
    mx, my = mean2d[idx, 0][:, None], mean2d[idx, 1][:, None]            # [B, 1, K]
    a, b, c = (conic[idx, i][:, None] for i in range(3))
    dx = px[:, :, None] - mx
    dy = py[:, :, None] - my
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp_max(opacity[idx][:, None] * torch.exp(power), ALPHA_MAX)
    use = (power <= 0) & (alpha >= ALPHA_CUTOFF) & valid[:, None]
    one_minus = torch.where(use, 1.0 - alpha, torch.ones_like(alpha))
    t_before = torch.cat([torch.ones_like(one_minus[..., :1]),
                          torch.cumprod(one_minus, -1)[..., :-1]], -1)
    trigger = use & (t_before * one_minus < T_EPS)
    stopped = torch.cumsum(trigger.to(torch.int32), -1) > 0
    contrib = use & ~stopped
    weight = torch.where(contrib, alpha * t_before, torch.zeros_like(alpha))
    t_final = torch.prod(torch.where(contrib, 1.0 - alpha, torch.ones_like(alpha)), -1)
    rgb = prec.mm("bpk,bkc->bpc", weight, colors[idx]) + t_final[..., None] * bg
    # Pairs walked by each pixel: through its stopping pair, else its list.
    walked = torch.where(stopped.any(-1), torch.argmax(trigger.to(torch.int8), -1) + 1,
                         count[:, None].expand(-1, lin.shape[0]))
    return rgb, walked


def _tiles_to_image(x: torch.Tensor, lists: TileLists, tile: int) -> torch.Tensor:
    """[NT, P, ...] in tile order → [rows, cols, ...] of the tile grid."""
    rest = x.shape[2:]
    x = x.reshape(lists.nty, lists.ntx, tile, tile, *rest).transpose(1, 2)
    return x.reshape(lists.nty * tile, lists.ntx * tile, *rest)


def _image_to_tiles(x: torch.Tensor, lists: TileLists, tile: int) -> torch.Tensor:
    rest = x.shape[2:]
    x = x.reshape(lists.nty, tile, lists.ntx, tile, *rest).transpose(1, 2)
    return x.reshape(lists.nty * lists.ntx, tile * tile, *rest)


@dataclasses.dataclass
class Frame:
    """What one rendered view leaves for the gradient and the work count."""

    image: torch.Tensor
    lists: TileLists
    screen: tuple
    work: dict


def render_screen(screen, lists: TileLists, cam: dict, bg, tile, prec: Precision) -> Frame:
    """The image of screen-space Gaussians, without autograd, and the work the
    alpha rule leaves to a compositor: pair-pixels walked and pairs read in
    the image, live pairs, pixels."""
    h, w = cam["height"], cam["width"]
    nt = lists.count.shape[0]
    dev = screen[0].device
    rgb = torch.zeros((nt, tile * tile, 3), device=dev)
    walked = torch.zeros((nt, tile * tile), dtype=torch.int64, device=dev)
    with torch.no_grad():
        for ids, k in _blocks(lists, tile * tile):
            t = torch.as_tensor(ids, device=dev)
            rgb[t], walked[t] = composite_block(lists, ids, k, tile, screen, bg, prec)
        image = _tiles_to_image(rgb, lists, tile)[:h, :w]
        inside = torch.zeros((lists.nty * tile, lists.ntx * tile), dtype=torch.int64,
                             device=dev)
        inside[:h, :w] = 1
        walked = walked * _image_to_tiles(inside, lists, tile)
    work = dict(pair_pixels=int(walked.sum()), pairs_read=int(walked.amax(1).sum()),
                pairs=int(lists.count.sum()), pixels=h * w, tiles=nt)
    return Frame(image=image, lists=lists, screen=screen, work=work)


def backward_screen(frame: Frame, g_image, cam: dict, bg, tile, prec: Precision):
    """Accumulate ∂loss/∂(screen-space leaves) given ∂loss/∂image, block by
    block (each block composited again under autograd)."""
    h, w = cam["height"], cam["width"]
    lists = frame.lists
    g = g_image.new_zeros((lists.nty * tile, lists.ntx * tile, 3))
    g[:h, :w] = g_image
    g = _image_to_tiles(g, lists, tile)
    for ids, k in _blocks(lists, tile * tile):
        rgb, _ = composite_block(lists, ids, k, tile, frame.screen, bg, prec)
        torch.autograd.backward(rgb, g[torch.as_tensor(ids, device=g.device)])


# ---------------------------------------------------------------------------
# The frame and the training step
# ---------------------------------------------------------------------------

def geometry(flame: Flame, flame_params: dict, g: dict, binding, alive, cam: dict):
    """FLAME → face frames → world Gaussians → projection and colour."""
    verts, v_shaped = flame(**flame_params)
    frames = face_frames(verts[0], flame.faces)
    means, scales, quats, opacity, sh = world_gaussians(g, binding, frames)
    proj = project(means, scales, quats, cam, alive)
    colors = sh_colors(means, sh, cam["camera_center"])
    opac = torch.where(proj["mask"], opacity, torch.zeros_like(opacity))
    return proj, colors, opac, verts, v_shaped


def render(flame: Flame, flame_params: dict, g: dict, binding, alive, cam: dict, bg,
           tile: int, prec: Precision = Precision()) -> Frame:
    """One frame, no gradient."""
    with torch.no_grad():
        proj, colors, opac, _, _ = geometry(flame, flame_params, g, binding, alive, cam)
        lists = tile_lists(proj, opac, cam["height"], cam["width"], tile)
        screen = (proj["mean2d"], proj["conic"], colors, opac)
    return render_screen(screen, lists, cam, bg, tile, prec)


def ssim(x, y, prec: Precision):
    """Mean SSIM of [C, H, W] images: 11-tap Gaussian window (σ 1.5), zero
    padding, C1 = 0.01², C2 = 0.03²."""
    k = torch.exp(-(torch.arange(11, dtype=torch.float32, device=x.device) - 5) ** 2 / 4.5)
    k = k / k.sum()

    def blur(z):
        # Separable: rows then columns, each a banded product.
        hh, ww = z.shape[-2:]
        def band(n):
            i = torch.arange(n, device=z.device)
            d = i[None, :] - i[:, None] + 5
            return torch.where((d >= 0) & (d <= 10), k[d.clamp(0, 10)], torch.zeros(()))
        return prec.mm("ij,cjw,vw->civ", band(hh), z, band(ww))
    mu1, mu2 = blur(x), blur(y)
    s1 = blur(x * x) - mu1 * mu1
    s2 = blur(y * y) - mu2 * mu2
    s12 = blur(x * y) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))).mean()


def _snorm(x):
    sq = (x * x).sum(1)
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def region_weight_map(verts, cam: dict, opt: dict):
    """Innovation 1's weight map [H, W]: each weighted region's vertices
    projected to a pixel ((ndc/2 + 1/2)·(size − 1), clipped, truncated), a
    box of half-width max(H, W) // 60 around each, the region's weight
    there, the largest weight where boxes meet, 1 elsewhere."""
    h, w = cam["height"], cam["width"]
    full = cam["full_proj"]
    hom = verts @ full[:, :3].T + full[:, 3]
    px = torch.clamp((hom[:, 0] / (hom[:, 3] + 1e-7) * 0.5 + 0.5) * (w - 1), 0, w - 1).long()
    py = torch.clamp((hom[:, 1] / (hom[:, 3] + 1e-7) * 0.5 + 0.5) * (h - 1), 0, h - 1).long()
    r = max(h, w) // 60
    wmap = torch.ones((h, w), device=verts.device)
    for name, regions in REGION_WEIGHTS:
        ids = torch.cat([torch.arange(*REGION_RANGES[g], device=verts.device) for g in regions])
        ids = ids[ids < verts.shape[0]]
        hit = torch.zeros((1, 1, h, w), device=verts.device)
        hit[0, 0, py[ids], px[ids]] = 1.0
        hit = torch.nn.functional.max_pool2d(hit, 2 * r + 1, stride=1, padding=r)[0, 0]
        wmap = torch.where(hit > 0, torch.clamp_min(wmap, opt[f"region_weight_{name}"]), wmap)
    return wmap


def color_net(leaves: dict, image, prec: Precision):
    """Innovation 4: a per-pixel MLP, ReLU between layers, sigmoid out."""
    n = sum(k.startswith("color_w") for k in leaves)
    x = image
    for i in range(n):
        x = prec.mm("hwi,io->hwo", x, leaves[f"color_w{i}"]) + leaves[f"color_b{i}"]
        x = torch.relu(x) if i < n - 1 else torch.sigmoid(x)
    return x


def pooled(image, size: int):
    """[size, size, 3] bin averages of an image (innovation 5's thumbnail)."""
    return torch.nn.functional.adaptive_avg_pool2d(image.permute(2, 0, 1)[None], size)[0] \
        .permute(1, 2, 0)


def contrastive(cache: dict, image, size: int):
    """mean(1 − cosine) of the image's thumbnail against the cache's valid
    entries (innovation 5)."""
    if cache["count"] == 0:
        return image.sum() * 0.0
    small = pooled(image, size).reshape(-1)
    flat = cache["images"][:cache["count"]].reshape(cache["count"], -1)
    cos = (flat @ small) / (torch.linalg.norm(flat, dim=1) * torch.linalg.norm(small) + 1e-8)
    return (1.0 - cos).sum() / cache["count"]


def cache_update(cache: dict, image, size: int) -> dict:
    images = cache["images"].clone()
    images[cache["head"]] = pooled(image.detach(), size)
    n = images.shape[0]
    return dict(images=images, count=min(cache["count"] + 1, n), head=(cache["head"] + 1) % n)


GAUSS_LEAVES = ("means", "log_scales", "quats", "sh_dc", "sh_rest", "logit_opacity")
FLAME_LEAVES = ("expr", "rotation", "neck", "jaw", "eyes", "translation")


@dataclasses.dataclass
class TrainState:
    """Leaves by name (the Gaussians', the per-timestep FLAME ones and, with
    innovation 4, the colour net's `color_w<i>`, `color_b<i>`), the Adam
    moments of each, the step count, the densification stats, and with
    innovation 5 the thumbnail cache (images, count, head)."""

    leaves: dict
    mu: dict
    nu: dict
    step: int
    binding: torch.Tensor
    alive: torch.Tensor
    shape: torch.Tensor
    grad_accum: torch.Tensor
    denom: torch.Tensor
    cache: dict | None = None


def learning_rates(opt: dict, step: int, spatial_lr_scale: float) -> dict:
    """Per-leaf learning rates of the recipe: the means' exponential decay,
    constant rates elsewhere."""
    t = min(max(step / opt["position_lr_max_steps"], 0.0), 1.0)
    lr_means = math.exp(math.log(opt["position_lr_init"] * spatial_lr_scale) * (1 - t)
                        + math.log(opt["position_lr_final"] * spatial_lr_scale) * t)
    return dict(means=lr_means, log_scales=opt["scaling_lr"], quats=opt["rotation_lr"],
                sh_dc=opt["feature_lr"], sh_rest=opt["feature_lr"] / 20.0,
                logit_opacity=opt["opacity_lr"], expr=opt["flame_expr_lr"],
                rotation=opt["flame_pose_lr"], neck=opt["flame_pose_lr"],
                jaw=opt["flame_pose_lr"], eyes=opt["flame_pose_lr"],
                translation=opt["flame_trans_lr"], color=opt.get("color_net_lr", 0.0))


def train_step(flame: Flame, st: TrainState, gt, cam: dict, timestep: int, bg, opt: dict,
               tile: int, prec: Precision = Precision(), fault: str = "") -> tuple:
    """One step: (new state, loss, gradients by leaf, the frame's compositor
    work). `fault` plants a fault
    for the check's own tests: "half_image" takes the loss over the top half
    of the rows only."""
    leaves = {k: v.detach().clone().requires_grad_() for k, v in st.leaves.items()}
    g = {k: leaves[k] for k in GAUSS_LEAVES}
    fp = dict(shape=st.shape, **{k: leaves[k][timestep:timestep + 1] for k in FLAME_LEAVES})
    proj, colors, opac, verts, v_shaped = geometry(flame, fp, g, st.binding, st.alive, cam)
    screen = tuple(x.detach().requires_grad_() for x in
                   (proj["mean2d"], proj["conic"], colors, opac))
    lists = tile_lists({k: v.detach() for k, v in proj.items()}, opac.detach(),
                       cam["height"], cam["width"], tile)
    frame = render_screen(screen, lists, cam, bg, tile, prec)
    img = frame.image.detach().requires_grad_()
    color = {k: v for k, v in leaves.items() if k.startswith("color_")}
    out_img = color_net(color, img, prec) if color else img
    lam = opt["lambda_dssim"]
    pred, target = (out_img, gt) if fault != "half_image" else (out_img[: img.shape[0] // 2],
                                                                gt[: img.shape[0] // 2])
    if opt.get("use_region_adaptive_loss"):
        wmap = region_weight_map(verts[0].detach(), cam, opt)[: pred.shape[0], :, None]
        l1 = (wmap * (pred - target).abs()).sum() / torch.clamp_min(wmap.sum() * 3, 1e-8)
    else:
        l1 = (pred - target).abs().mean()
    loss = (1 - lam) * l1 + lam * (1 - ssim(pred.permute(2, 0, 1), target.permute(2, 0, 1), prec))
    if color and opt["lambda_color_reg"] > 0:
        loss = loss + opt["lambda_color_reg"] * sum((v * v).sum() for k, v in color.items()
                                                    if k.startswith("color_w"))
    if st.cache is not None and opt["lambda_contrastive"] > 0:
        loss = loss + opt["lambda_contrastive"] * contrastive(st.cache, out_img,
                                                              opt["contrastive_downsample"])
    g_color = torch.autograd.grad(loss, list(color.values()), retain_graph=True) if color else ()
    grads_color = dict(zip(color, g_color))
    (g_img,) = torch.autograd.grad(loss, img)
    backward_screen(frame, g_img, cam, bg, tile, prec)
    visible = proj["radius"] > 0
    nvis = torch.clamp_min(visible.sum(), 1)
    zero = torch.zeros((), device=img.device)
    xyz = torch.relu(_snorm(g["means"]) - opt["threshold_xyz"])
    reg = torch.where(visible, xyz, zero).sum() / nvis * opt["lambda_xyz"]
    sc = _snorm(torch.relu(torch.exp(g["log_scales"]) - opt["threshold_scale"]))
    reg = reg + torch.where(visible, sc, zero).sum() / nvis * opt["lambda_scale"]
    torch.autograd.backward([*(proj["mean2d"], proj["conic"], colors, opac), reg],
                            [*(s.grad for s in screen), torch.ones_like(reg)])
    grads = {k: (torch.zeros_like(v) if v.grad is None else v.grad) for k, v in leaves.items()}
    grads.update(grads_color)
    # Densification stats: the screen-space gradient scaled to half the image.
    gm = screen[0].grad * torch.tensor([cam["width"] * 0.5, cam["height"] * 0.5],
                                       device=img.device)
    grad_accum = st.grad_accum + torch.where(visible, torch.linalg.norm(gm, dim=-1), zero)
    denom = st.denom + visible.float()
    step = st.step + 1
    lrs = learning_rates(opt, step, opt.get("spatial_lr_scale", 1.0))
    lrs.update({k: lrs["color"] for k in leaves if k.startswith("color_")})
    c1, c2 = 1 - 0.9 ** step, 1 - 0.999 ** step
    mu, nu, new = {}, {}, {}
    with torch.no_grad():
        for k, p in st.leaves.items():
            mu[k] = 0.9 * st.mu[k] + 0.1 * grads[k]
            nu[k] = 0.999 * st.nu[k] + 0.001 * grads[k] * grads[k]
            new[k] = p - lrs[k] * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + 1e-15)
    total = (loss + reg).detach()
    cache = st.cache
    if cache is not None:
        cache = cache_update(cache, out_img, opt["contrastive_downsample"])
    out = dataclasses.replace(st, leaves=new, mu=mu, nu=nu, step=step, grad_accum=grad_accum,
                              denom=denom, cache=cache)
    return out, float(total), grads, frame.work
