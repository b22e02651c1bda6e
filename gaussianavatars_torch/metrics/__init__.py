"""Image metrics: PSNR/SSIM re-exports and LPIPS."""
from ..training.loss import psnr, ssim
from .lpips import LpipsParams, load_lpips_weights, lpips, synthetic_lpips_params

__all__ = ["psnr", "ssim", "lpips", "LpipsParams", "load_lpips_weights",
           "synthetic_lpips_params"]
