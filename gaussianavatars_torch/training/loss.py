"""Image losses: L1, windowed SSIM, PSNR, and the safe norm of the binding
regularisers (PyTorch).

Equivalents of the JAX package's `training/loss.py`. SSIM uses the same
11×11 Gaussian window (σ = 1.5) as the reference, as two banded-matrix
matmuls in float32 (the JAX package runs them at `Precision.HIGHEST`
outside any kernel), or with `amp` on operands rounded to bf16 and float32
accumulation. Nothing here switches TF32 on: a float32 `matmul` on the card
stays float32 unless the caller enables TF32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SSIM_WINDOW = 11
SSIM_SIGMA = 1.5
_C1 = 0.01**2
_C2 = 0.03**2
# Above this edge length the banded matrices are mostly zeros and the
# depthwise convolution is used instead.
_BLUR_MATMUL_MAX = 2048


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error. No caller, in the port as in the JAX package:
    kept for parity with it."""
    return torch.mean((pred - target) ** 2)


def weighted_l1_loss(pred, target, weight) -> torch.Tensor:
    """Σ w·|pred − gt| / Σ w (innovation 1, `region_adaptive_loss.py:107-110`)."""
    diff = torch.abs(pred - target)
    return torch.sum(weight * diff) / torch.clamp_min(torch.sum(weight) * diff.shape[-1], 1e-8)


@functools.lru_cache(maxsize=4)
def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float32) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return np.asarray(g / g.sum(), np.float32)


def _band_matrix_np(n: int, window: int, sigma: float) -> np.ndarray:
    """Banded blur matrix [n, n]: row i holds the window centred at i
    (zero-padded borders, the semantics of a SAME convolution)."""
    g = _gaussian_window(window, sigma)
    pad = window // 2
    m = np.zeros((n, n), np.float32)
    for j, v in enumerate(g):
        off = j - pad
        d = np.arange(max(0, -off), min(n, n - off))
        m[d, d + off] = v
    return m


@functools.lru_cache(maxsize=16)
def _band_matrix(n: int, window: int, sigma: float, device: torch.device) -> torch.Tensor:
    """The band matrix as a tensor on `device`, built once per size."""
    return torch.as_tensor(_band_matrix_np(n, window, sigma), device=device)


@functools.lru_cache(maxsize=4)
def _window_tensor(window: int, sigma: float, device: torch.device) -> torch.Tensor:
    """The 1-D window as a tensor on `device`, built once (a copy from the
    host every call would synchronise)."""
    return torch.as_tensor(_gaussian_window(window, sigma), device=device)


def _depthwise_blur(img: torch.Tensor, window: int, sigma: float,
                    amp: bool = False) -> torch.Tensor:
    """Separable Gaussian blur of [C, H, W] with SAME (zero) padding.

    `amp` follows the JAX package's mixed-precision blur (`loss.py:97-102`):
    both banded matmuls take operands rounded to bf16 (the band matrices,
    the image and the first product) and accumulate in float32. The
    rounding is `x.to(bfloat16).float()`, so autograd rounds the operands'
    gradients to bf16 too, as JAX's casts do."""
    c, h, w = img.shape
    if max(h, w) > _BLUR_MATMUL_MAX:
        g = _window_tensor(window, sigma, img.device)
        pad = window // 2
        x = F.conv2d(img[None], g.reshape(1, 1, window, 1).expand(c, 1, window, 1),
                     padding=(pad, 0), groups=c)
        x = F.conv2d(x, g.reshape(1, 1, 1, window).expand(c, 1, 1, window),
                     padding=(0, pad), groups=c)
        return x[0]
    gh = _band_matrix(h, window, sigma, img.device)
    gw = _band_matrix(w, window, sigma, img.device)
    if amp:
        bf = torch.bfloat16
        y = torch.matmul(gh.to(bf).float(), img.to(bf).float())
        return torch.matmul(y.to(bf).float(), gw.T.to(bf).float())
    return torch.matmul(torch.matmul(gh, img), gw.T)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window: int = SSIM_WINDOW,
         sigma: float = SSIM_SIGMA, amp: bool = False) -> torch.Tensor:
    """Mean SSIM of two [C, H, W] images in [0, 1] (`utils/loss_utils.py:33-63`);
    the five blurs are one pair of banded matmuls over the channel stack
    (bf16 operands, float32 accumulation with `amp`)."""
    stack = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=0)
    b = _depthwise_blur(stack, window, sigma, amp=amp)
    mu1, mu2, s1r, s2r, s12r = torch.chunk(b, 5, dim=0)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = s1r - mu1_sq
    s2 = s2r - mu2_sq
    s12 = s12r - mu12
    m = ((2 * mu12 + _C1) * (2 * s12 + _C2)) / ((mu1_sq + mu2_sq + _C1) * (s1 + s2 + _C2))
    return torch.mean(m)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12)))


def safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm with a zero (not NaN) gradient at x = 0.

    Bound Gaussians start at the origin of their triangle frame, and
    x/‖x‖ = 0/0 there; the regularisers need the zero sub-gradient.
    """
    sq = torch.sum(x * x, dim=dim)
    positive = sq > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))
