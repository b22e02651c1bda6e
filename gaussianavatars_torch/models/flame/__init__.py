"""FLAME 2023 head model in PyTorch: assets, LBS, teeth."""

from .assets import FlameAssets, load_assets, synthetic_assets  # noqa: F401
from .flame_model import FlameConfig, FlameModel, FlameParams  # noqa: F401
