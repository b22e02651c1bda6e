"""Real spherical harmonics evaluation, degrees 0-4 (PyTorch).

The colour accumulates as Σ_k basis_k(dir)·sh_k with the basis values kept
as separate [N] tensors, in the same order and constants as the JAX package.
"""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)
C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
      -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
      0.47308734787878004, -1.7701307697799304, 0.6258357354491761)

MAX_SH_DEGREE = 4


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def basis_columns(dirs: torch.Tensor, degree: int) -> list:
    """Real SH basis values at unit directions, as a list of [...] tensors."""
    if not 0 <= degree <= MAX_SH_DEGREE:
        raise ValueError(f"sh degree must be in [0, {MAX_SH_DEGREE}], got {degree}")
    ones = torch.ones(dirs.shape[:-1], dtype=dirs.dtype, device=dirs.device)
    cols = [C0 * ones]
    if degree >= 1:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        cols += [-C1 * y, C1 * z, -C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        cols += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if degree >= 3:
        cols += [
            C3[0] * y * (3 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4 * zz - xx - yy),
            C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            C3[4] * x * (4 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3 * yy),
        ]
    if degree >= 4:
        # Unit-direction form (xx + yy + zz = 1), like the C2/C3 rows.
        cols += [
            C4[0] * xy * (xx - yy),
            C4[1] * yz * (3 * xx - yy),
            C4[2] * xy * (7 * zz - 1.0),
            C4[3] * yz * (7 * zz - 3.0),
            C4[4] * (zz * (35 * zz - 30.0) + 3.0),
            C4[5] * xz * (7 * zz - 3.0),
            C4[6] * (xx - yy) * (7 * zz - 1.0),
            C4[7] * xz * (xx - 3 * yy),
            C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return cols


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """[..., (degree+1)**2] stacked basis matrix."""
    return torch.stack(basis_columns(dirs, degree), dim=-1)


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """SH coefficients [..., C, K_total] (K_total >= (degree+1)**2) → values
    [..., C] along unit directions [..., 3] (no +0.5 shift; see
    `eval_sh_color`)."""
    cols = basis_columns(dirs, degree)
    out = cols[0][..., None] * sh[..., 0]
    for i in range(1, len(cols)):
        out = out + cols[i][..., None] * sh[..., i]
    return out


def eval_sh_color(sh: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """SH coefficients stored [..., C, K] (the reference's layout) → RGB with
    the 3DGS +0.5 shift and clamp from below at 0
    (`gaussian_renderer/__init__.py:69-83`); `eval_sh_color_kc` takes the
    port's [..., K, C] storage."""
    return torch.clamp_min(eval_sh(sh, dirs, degree) + 0.5, 0.0)


def eval_sh_color_kc(sh_kc: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """SH coefficients stored [..., K, C] → RGB with the 3DGS +0.5 shift and
    clamp from below at 0."""
    cols = basis_columns(dirs, degree)
    out = cols[0][..., None] * sh_kc[..., 0, :]
    for i in range(1, len(cols)):
        out = out + cols[i][..., None] * sh_kc[..., i, :]
    return torch.clamp_min(out + 0.5, 0.0)


def rgb_to_sh0(rgb: torch.Tensor) -> torch.Tensor:
    """Inverse of the DC term: colour → degree-0 coefficient."""
    return (rgb - 0.5) / C0


def sh0_to_rgb(sh: torch.Tensor) -> torch.Tensor:
    """The DC term → colour (inverse of `rgb_to_sh0`)."""
    return sh * C0 + 0.5
