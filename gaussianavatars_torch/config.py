"""Typed configuration of the training step: the part of the JAX package's
`config.py` that the port reads.

Same dataclass and knob names and the same defaults (those of the
reference's argparse groups, `arguments/__init__.py:69-144`), as frozen
dataclasses. Only knobs that `training.trainer` reads are here: the
learning rates, the loss weights and the regularisers' thresholds and
metric flags, `use_amp`, plus the pipeline and innovation flags that
`make_train_step` rejects when set. The model's sizes (`n_shape`,
`n_expr`, SH degree) are arguments of `init_train_state` and of the step,
and the tile geometry is the step's `TileConfig`; the knobs of parts not
yet ported (densification events, the innovations' own settings, the
device mesh) come with those parts.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """`PipelineParams` equivalent (`arguments/__init__.py:69-74`): the
    sorted pipeline with the compositor kernels is the only one ported;
    any other setting raises in `make_train_step`."""

    use_pallas: bool = True
    use_sorted: bool = True


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    """`OptimizationParams` equivalent (`arguments/__init__.py:76-144`):
    the canonical 600k-iteration recipe."""

    position_lr_init: float = 0.005
    position_lr_final: float = 0.00005
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 600_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.017
    rotation_lr: float = 0.001

    flame_expr_lr: float = 1e-3
    flame_trans_lr: float = 1e-6
    flame_pose_lr: float = 1e-5
    lambda_dssim: float = 0.2
    lambda_xyz: float = 1e-2
    threshold_xyz: float = 1.0
    metric_xyz: bool = False
    lambda_scale: float = 1.0
    threshold_scale: float = 0.6
    metric_scale: bool = False
    lambda_dynamic_offset: float = 0.0
    lambda_laplacian: float = 0.0
    lambda_dynamic_offset_std: float = 0.0
    # Mixed precision: the compositor backward's bf16 contraction and SSIM's
    # bf16 blur operands (float32 accumulation in both).
    use_amp: bool = False

    # Not ported: `make_train_step` raises when any of these is set.
    use_region_adaptive_loss: bool = False
    use_color_calibration: bool = False
    use_contrastive_reg: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    pipeline: PipelineConfig = PipelineConfig()
    opt: OptimizationConfig = OptimizationConfig()
