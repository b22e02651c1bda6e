"""The yardstick: the card's published peaks and the work that a frame and
a training step need, counted from the configuration's shapes and from
what the reference found in the compared frames (the pair-pixels that the
alpha rule reaches), whatever code computes it.

Peaks: NVIDIA H100 SXM5 data sheet, dense, without sparsity: 67 TFLOP/s
FP32 on the CUDA cores (the port computes in float32 outside the tensor
cores) and 3.35 TB/s of HBM3.
"""
from __future__ import annotations

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Float32 operations a (pair, pixel) of the compositor: dx/dy (2), the
# quadratic form (7), exp (~4), the clamp and cutoff tests (4), the stop
# and contribution selects (5), weight and transmittance (4), three
# colour multiply-adds (6); the backward 33.
FWD_PER_PAIR_PIXEL = 32
BWD_PER_PAIR_PIXEL = 33
# Per-element operations of the other stages (forward), by shape.
PER_FACE_FRAME = 80          # two cross products, three normalisations, the quaternion
PER_GAUSSIAN_BIND = 80       # normalise, quaternion product and rotation, scale, sigmoid
PER_GAUSSIAN_PROJECT = 190   # view and clip transforms, Σ from scale and rotation, J·W·Σ, conic, radius
PER_GAUSSIAN_SH3 = 157       # direction, 16 basis values, 16 × 3 multiply-adds, shift and clamp
PER_PIXEL_LOSS = 730         # L1 (3 × 3) and SSIM: five 11-tap separable blurs of 3 channels and the map
PER_GAUSSIAN_REG = 20        # the xyz and scale regularisers
PER_GAUSSIAN_STATS = 10      # the densification statistics
PER_ELEMENT_ADAM = 12
GAUSSIAN_FLOATS = 3 + 3 + 4 + 3 + 45 + 1


def mean(works: list) -> dict:
    """The mean of work counts (dicts of one shape), key by key."""
    return {k: sum(w[k] for w in works) / len(works) for k in works[0]}


def least_s(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time for the work on the card and what bounds it."""
    f, b = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (f, "operations") if f >= b else (b, "bytes")


def compositor_fwd(w: dict) -> tuple[float, float]:
    """(operations, bytes) of the forward compositor on a frame's work `w`:
    each pair walked read once (9 floats), each tile's bounds, and each
    pixel's colour, transmittance and stop written once."""
    return (FWD_PER_PAIR_PIXEL * w["pair_pixels"],
            4.0 * (9 * w["pairs_read"] + 2 * w["tiles"] + 5 * w["pixels"]))


def compositor_bwd(w: dict) -> tuple[float, float]:
    """(operations, bytes) of the backward compositor: the walked pairs and
    each pixel's saved state and incoming gradients (9 floats) read once,
    a gradient row (9 floats) written for every live pair."""
    return (BWD_PER_PAIR_PIXEL * w["pair_pixels"],
            4.0 * (9 * w["pairs_read"] + 9 * w["pixels"] + 9 * w["pairs"]))


def flame_flops(cfg: dict, verts: int) -> float:
    """Blend shapes, joints, pose correctives and skinning of one pose."""
    j, comps = 5, cfg["n_shape"] + cfg["n_expr"]
    return 2.0 * verts * 3 * (comps + j + (j - 1) * 9) + 2.0 * verts * (j * 12 + 12)


def geometry_flops(cfg: dict, verts: int, faces: int) -> float:
    """A pose's FLAME, face frames, world Gaussians, projection and SH."""
    n = cfg["gaussians"]
    return (flame_flops(cfg, verts) + PER_FACE_FRAME * faces
            + n * (PER_GAUSSIAN_BIND + PER_GAUSSIAN_PROJECT + PER_GAUSSIAN_SH3))


def frame_flops(cfg: dict, verts: int, faces: int, w: dict) -> float:
    return geometry_flops(cfg, verts, faces) + FWD_PER_PAIR_PIXEL * w["pair_pixels"]


def step_flops(cfg: dict, verts: int, faces: int, w: dict, timesteps: int) -> float:
    """The forward and backward (twice the forward) of the geometry and the
    loss, both compositors, the regularisers, the statistics and Adam over
    every live leaf element."""
    n = cfg["gaussians"]
    pose = timesteps * (cfg["n_expr"] + 18)
    return (3 * geometry_flops(cfg, verts, faces) + 3 * PER_PIXEL_LOSS * w["pixels"]
            + (FWD_PER_PAIR_PIXEL + BWD_PER_PAIR_PIXEL) * w["pair_pixels"]
            + n * (PER_GAUSSIAN_REG + PER_GAUSSIAN_STATS)
            + PER_ELEMENT_ADAM * (n * GAUSSIAN_FLOATS + pose))
