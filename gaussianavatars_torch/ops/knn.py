"""3-nearest-neighbour mean squared distance (simple-knn equivalent).

The port of the JAX package's `ops/knn.py`: it replaces the CUDA
``simple_knn._C.distCUDA2`` the reference uses once at init
(`scene/gaussian_model.py:23,196-198`) to seed Gaussian scales. Exact and
blockwise: row blocks of ‖a‖² − 2a·b + ‖b‖² against every point, the
point itself excluded, then the three smallest by `torch.topk` of the
negated distances; the N×N matrix is never formed. The products are
taken one coordinate at a time (elementwise, not a matmul), so the card
and the CPU round them alike.
"""
from __future__ import annotations

import torch


def mean_sq_dist_3nn(points: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """Mean of squared distances to the 3 nearest neighbours, per point.

    Args:
      points: [N, 3], N >= 4.
    Returns: [N] float32, on the device of `points`.
    """
    pts = points.to(torch.float32)
    n = pts.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=pts.device)
    for start in range(0, n, block):
        stop = min(start + block, n)
        out[start:stop] = rows_mean_sq_dist_3nn(
            pts, torch.arange(start, stop, device=pts.device))
    return out


def rows_mean_sq_dist_3nn(pts: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """`mean_sq_dist_3nn` of the points `rows` indexes (each against all of
    `pts` [N, 3] float32, itself excluded): one block of the loop, which a
    check can also run for a sample of rows."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    sq = x * x + y * y + z * z
    r = pts[rows]
    dot = r[:, 0:1] * x + r[:, 1:2] * y + r[:, 2:3] * z
    d2 = sq[rows, None] - 2.0 * dot + sq[None, :]
    d2[torch.arange(len(rows), device=pts.device), rows] = float("inf")   # not its own neighbour
    top3 = torch.topk(-d2, 3, dim=1).values
    return torch.mean(-top3, dim=1)
