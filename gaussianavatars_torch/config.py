"""Typed configuration: the part of the JAX package's `config.py` that the
port reads.

Same dataclass and knob names and the same defaults (those of the
reference's argparse groups, `arguments/__init__.py:47-144`), as frozen
dataclasses, serialisable to and from JSON (`cfg_args.json`). Here are the
model and dataset knobs (`ModelConfig`, without the JAX package's
`data_device`), the tile geometry and tier budgets (`PipelineConfig`), the
training step's learning rates, loss weights and regularisers, the
host loop's schedule (iterations, densification, opacity resets), and the
five training innovations' flags and settings, and the rank mesh's
layout (`ParallelConfig`).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """`ModelParams` equivalent (`arguments/__init__.py:47-67`)."""

    source_path: str = ""
    model_path: str = ""
    sh_degree: int = 3
    bind_to_mesh: bool = True
    white_background: bool = False
    resolution: int = -1
    eval: bool = True
    target_path: str = ""
    select_camera_id: int = -1
    capacity: int = 131072          # padded Gaussian capacity
    n_shape: int = 300
    n_expr: int = 100
    add_teeth: bool = True


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """`PipelineParams` equivalent (`arguments/__init__.py:69-74`).

    `use_sorted` and `use_pallas` (both on) select the sorted pipeline with
    the compositor kernels; either off selects the padded-table pipeline
    (`ops/rasterize_tiled.bin_gaussians` and `composite_tiles`), which
    composites at most `capacity_per_tile` Gaussians a tile and bins at
    most `max_tiles_per_gaussian` tiles a Gaussian. Tier budgets of the
    sorted pipeline: every Gaussian gets `base_budget` expansion slots;
    each (count, budget) tier gives the `count` footprint-heaviest
    Gaussians slots up to `budget`. Empty tiers are probed from the first
    training frame (`training.loop.probe_tier_budgets`). The loop grows
    whichever budget overflows.
    """

    tile_h: int = 32
    tile_w: int = 32
    capacity_per_tile: int = 1024
    max_tiles_per_gaussian: int = 16
    use_pallas: bool = True
    use_sorted: bool = True
    base_budget: int = 2
    tiers: Tuple[Tuple[int, int], ...] = ()


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    """`OptimizationParams` equivalent (`arguments/__init__.py:76-144`):
    the canonical 600k-iteration recipe."""

    iterations: int = 600_000
    position_lr_init: float = 0.005
    position_lr_final: float = 0.00005
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 600_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.017
    rotation_lr: float = 0.001
    densification_interval: int = 2_000
    opacity_reset_interval: int = 60_000
    densify_from_iter: int = 10_000
    densify_until_iter: int = 600_000
    densify_grad_threshold: float = 0.0002

    flame_expr_lr: float = 1e-3
    flame_trans_lr: float = 1e-6
    flame_pose_lr: float = 1e-5
    percent_dense: float = 0.01
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

    # The five training innovations (`training/innovations.py`).
    # 1: region-adaptive loss.
    use_region_adaptive_loss: bool = False
    region_weight_eyes: float = 2.0
    region_weight_mouth: float = 2.0
    region_weight_nose: float = 1.5
    region_weight_face: float = 1.2
    # 2: smart densification.
    use_smart_densification: bool = False
    densify_percentile_clone: float = 75.0
    densify_percentile_split: float = 90.0
    # 3: progressive resolution.
    use_progressive_resolution: bool = False
    resolution_schedule: Tuple[float, ...] = (0.5, 0.75, 1.0)
    resolution_milestones: Tuple[int, ...] = (100_000, 300_000)
    # 4: colour calibration network.
    use_color_calibration: bool = False
    color_net_hidden_dim: int = 16
    color_net_layers: int = 3
    color_net_lr: float = 1e-3      # reference: Adam(lr=1e-3), train.py:94
    lambda_color_reg: float = 1e-4
    # 5: contrastive regularisation.
    use_contrastive_reg: bool = False
    lambda_contrastive: float = 0.01
    contrastive_cache_size: int = 2
    contrastive_downsample: int = 8


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The mesh's layout (no reference equivalent): cameras a step over
    `data`, image row bands over `tile` (`parallel/mesh.make_rank_mesh`).
    `gauss_axis` is kept for the JAX package's `cfg_args.json`: the
    Gaussian shards ride the `tile` axis (`--gauss_shard`)."""

    data_axis: int = 1
    gauss_axis: int = 1
    tile_axis: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    pipeline: PipelineConfig = PipelineConfig()
    opt: OptimizationConfig = OptimizationConfig()
    parallel: ParallelConfig = ParallelConfig()


def to_json(cfg: Config) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def from_json(text: str) -> Config:
    """A Config from `to_json` text (the JAX package's too: sections and
    keys the port does not have are skipped)."""
    raw = json.loads(text)

    def build(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in d.items():
            if k not in names:
                continue
            if isinstance(v, list):
                v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
            kw[k] = v
        return cls(**kw)

    return Config(
        model=build(ModelConfig, raw.get("model", {})),
        pipeline=build(PipelineConfig, raw.get("pipeline", {})),
        opt=build(OptimizationConfig, raw.get("opt", {})),
        parallel=build(ParallelConfig, raw.get("parallel", {})),
    )
