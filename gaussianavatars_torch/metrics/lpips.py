"""LPIPS perceptual metric in PyTorch (VGG16 and AlexNet backbones).

The port of the JAX package's `metrics/lpips.py`, the equivalent of the
reference's `lpipsPyTorch/` (`lpipsPyTorch/modules/lpips.py:8-36`,
`networks.py:12-96`): backbone feature stages, per-channel unit
normalisation, learned 1×1 linear heads, spatial mean, sum over stages.

Points the two packages must share to agree:

  * images go in **[0, 1] without a remap** (`metrics.py:25-31` of the
    reference feeds `to_tensor` output), and the shift/scale buffers apply
    to that range as they are;
  * the eps of the unit normalisation sits outside the square root;
  * VGG's convolutions pad by 1 (JAX's `SAME` for 3×3, stride 1);
    AlexNet's have explicit padding, and its 3×3 stride-2 max-pools follow
    stages 0 and 1 only; every pool drops a partial window (floor).

Weights are licensed artifacts that the reference downloads; here they are
read from a local `.npz` in the JAX package's layout (HWIO convolutions,
`conv_w_i`, `conv_b_i`, `lin_w_i`, `net_type`), so one converted file
serves both packages, and transposed to OIHW once, at load:

  * `convert_torch_weights(backbone_pth, lpips_pth, out_npz, net_type)` —
    one-time import of the torch checkpoints;
  * `load_lpips_weights(npz)` and `maybe_load_default()`
    (`$GSAVATARS_LPIPS_WEIGHTS`);
  * `synthetic_lpips_params(generator, net_type)` — random but fixed
    weights, so tests and smoke runs drive the same graph without the
    artifacts (`python -m gaussianavatars_torch.metrics.lpips OUT.npz`
    writes them as a weights file). Their values say nothing of image
    quality.

The convolutions run in float32 (TF32 off) on every device, and the metric
is differentiable.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

# VGG16 conv layout: (out_channels, n_convs) per stage; stages end before pool.
VGG16_STAGES: Tuple[Tuple[int, int], ...] = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

# AlexNet features (torchvision layout): per conv (cout, kernel, stride, pad);
# a stage ends after each conv+ReLU (`networks.py:78-86`, target_layers
# [2, 5, 8, 10, 12]).
ALEX_CONVS: Tuple[Tuple[int, int, int, int], ...] = (
    (64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1),
)
_ALEX_POOL_AFTER = (0, 1)  # max-pool 3x3/2 after these stages (not the last)

# ImageNet normalisation as LPIPS applies it ("shift"/"scale" buffers), to
# [0, 1] inputs as the reference does (`networks.py:40-51`).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


@dataclasses.dataclass(frozen=True)
class LpipsParams:
    conv_w: Tuple[torch.Tensor, ...]   # each [cout, cin, kh, kw] (OIHW)
    conv_b: Tuple[torch.Tensor, ...]   # each [cout]
    lin_w: Tuple[torch.Tensor, ...]    # per stage [c] (1×1 conv weights, non-negative)
    net_type: str = "vgg"              # 'vgg' | 'alex'


def _stage_channels(net_type: str = "vgg") -> List[int]:
    if net_type == "alex":
        return [c for c, _k, _s, _p in ALEX_CONVS]
    return [c for c, _ in VGG16_STAGES]


def _n_convs(net_type: str) -> int:
    return len(ALEX_CONVS) if net_type == "alex" else sum(n for _, n in VGG16_STAGES)


def params_from_hwio(conv_w: Sequence, conv_b: Sequence, lin_w: Sequence, net_type: str,
                     device="cuda") -> LpipsParams:
    """LpipsParams from arrays in the JAX package's layout (HWIO
    convolutions), transposed to OIHW."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x, np.float32, order="C"), device=dev)

    return LpipsParams(
        conv_w=tuple(t(np.transpose(np.asarray(w), (3, 2, 0, 1))) for w in conv_w),
        conv_b=tuple(t(b) for b in conv_b),
        lin_w=tuple(t(w) for w in lin_w),
        net_type=str(net_type),
    )


def _normalise_input(x: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] in [0, 1] → the network's [1, 3, H, W] input."""
    shift = torch.as_tensor(_SHIFT, device=x.device)
    scale = torch.as_tensor(_SCALE, device=x.device)
    return ((x - shift) / scale).permute(2, 0, 1)[None]


def _tap(h: torch.Tensor) -> torch.Tensor:
    """[1, C, H, W] activation → [H, W, C], the JAX package's layout."""
    return h[0].permute(1, 2, 0)


def vgg16_features(params: LpipsParams, x: torch.Tensor) -> List[torch.Tensor]:
    """x: [H, W, 3] in [0, 1]. Returns the 5 stage activations (post-ReLU,
    pre-pool), each [H_s, W_s, C_s]."""
    h = _normalise_input(x)
    feats = []
    i = 0
    for stage, (_cout, n_convs) in enumerate(VGG16_STAGES):
        for _ in range(n_convs):
            h = F.relu(F.conv2d(h, params.conv_w[i], params.conv_b[i], padding=1))
            i += 1
        feats.append(_tap(h))
        if stage < len(VGG16_STAGES) - 1:
            h = F.max_pool2d(h, 2, 2)
    return feats


def alexnet_features(params: LpipsParams, x: torch.Tensor) -> List[torch.Tensor]:
    """torchvision `alexnet().features` stages (post-ReLU taps,
    `networks.py:78-86`), each [H_s, W_s, C_s]."""
    h = _normalise_input(x)
    feats = []
    for i, (_cout, _k, s, p) in enumerate(ALEX_CONVS):
        h = F.relu(F.conv2d(h, params.conv_w[i], params.conv_b[i], stride=s, padding=p))
        feats.append(_tap(h))
        if i in _ALEX_POOL_AFTER:
            h = F.max_pool2d(h, 3, 2)
    return feats


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / (torch.sqrt(torch.sum(f * f, dim=-1, keepdim=True)) + eps)


def lpips(params: LpipsParams, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """LPIPS distance (a 0-dim tensor) between two [H, W, 3] images in
    [0, 1], fed to the network as they are (see the module docstring)."""
    features = alexnet_features if params.net_type == "alex" else vgg16_features
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    benchmark=torch.backends.cudnn.benchmark,
                                    deterministic=torch.backends.cudnn.deterministic,
                                    allow_tf32=False):
        fx = features(params, img1)
        fy = features(params, img2)
    total = torch.zeros((), device=img1.device)
    for f1, f2, w in zip(fx, fy, params.lin_w):
        d = (_unit_normalize(f1) - _unit_normalize(f2)) ** 2
        total = total + torch.mean(torch.sum(d * w, dim=-1))
    return total


def synthetic_lpips_params(generator: Optional[torch.Generator] = None,
                           net_type: str = "vgg", device="cuda") -> LpipsParams:
    """Deterministic random weights with the backbone's shapes (tests and
    smoke runs only), drawn on the CPU from `generator` (default: seeded
    with 0). Convolutions N(0, 1/fan_in), zero biases, heads U(0, 0.1)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    conv_w, conv_b = [], []
    cin = 3
    if net_type == "alex":
        specs = [(cout, k) for cout, k, _s, _p in ALEX_CONVS]
    else:
        specs = [(cout, 3) for cout, n in VGG16_STAGES for _ in range(n)]
    for cout, k in specs:
        w = torch.randn((k, k, cin, cout), generator=gen) * (1.0 / np.sqrt(k * k * cin))
        conv_w.append(w.numpy())
        conv_b.append(np.zeros((cout,), np.float32))
        cin = cout
    lin = [(torch.rand((c,), generator=gen) * 0.1).numpy() for c in _stage_channels(net_type)]
    return params_from_hwio(conv_w, conv_b, lin, net_type, device=device)


def save_lpips_weights(params: LpipsParams, out_npz: str) -> str:
    """Write `params` in the shared `.npz` layout (HWIO), which both
    packages' `load_lpips_weights` read."""
    out = {"net_type": np.array(params.net_type)}
    for i, (w, b) in enumerate(zip(params.conv_w, params.conv_b)):
        out[f"conv_w_{i}"] = np.transpose(w.detach().cpu().numpy(), (2, 3, 1, 0))
        out[f"conv_b_{i}"] = b.detach().cpu().numpy()
    for i, w in enumerate(params.lin_w):
        out[f"lin_w_{i}"] = w.detach().cpu().numpy()
    np.savez(out_npz, **out)
    return out_npz


def convert_torch_weights(
    backbone_pth: str, lpips_pth: str, out_npz: str, net_type: str = "vgg"
) -> str:
    """One-time conversion: torchvision backbone state dict + LPIPS linear
    checkpoint → one `.npz` in the shared layout.

    `lpips_pth` keys follow the richzhang release (`lin{i}.model.1.weight`,
    `lpipsPyTorch/modules/utils.py:11-30`); plain `{i}.weight` (post-rename)
    is accepted too."""
    sd = torch.load(backbone_pth, map_location="cpu", weights_only=True)
    lin = torch.load(lpips_pth, map_location="cpu", weights_only=True)
    out = {"net_type": np.array(net_type)}
    conv_keys = sorted(
        (k for k in sd if k.startswith("features.") and k.endswith(".weight")),
        key=lambda k: int(k.split(".")[1]),
    )
    for i, k in enumerate(conv_keys):
        w = sd[k].numpy()  # [cout, cin, kh, kw] → HWIO
        out[f"conv_w_{i}"] = np.transpose(w, (2, 3, 1, 0))
        out[f"conv_b_{i}"] = sd[k.replace("weight", "bias")].numpy()
    for i in range(len(_stage_channels(net_type))):
        for key in (f"lin{i}.model.1.weight", f"{i}.weight", f"lin{i}.weight"):
            if key in lin:
                out[f"lin_w_{i}"] = np.maximum(lin[key].numpy().reshape(-1), 0.0)
                break
        else:
            raise KeyError(f"no linear-head weight for stage {i} in {lpips_pth}")
    np.savez(out_npz, **out)
    return out_npz


def load_lpips_weights(npz_path: str, device="cuda") -> LpipsParams:
    data = np.load(npz_path)
    net_type = str(data["net_type"]) if "net_type" in data else "vgg"
    n = _n_convs(net_type)
    return params_from_hwio(
        [data[f"conv_w_{i}"] for i in range(n)],
        [data[f"conv_b_{i}"] for i in range(n)],
        [data[f"lin_w_{i}"] for i in range(len(_stage_channels(net_type)))],
        net_type, device=device,
    )


def maybe_load_default(device="cuda") -> Optional[LpipsParams]:
    """Load from $GSAVATARS_LPIPS_WEIGHTS if it is set and the file exists."""
    path = os.environ.get("GSAVATARS_LPIPS_WEIGHTS", "")
    if path and os.path.exists(path):
        return load_lpips_weights(path, device=device)
    return None


def main(argv=None) -> str:
    """Write `synthetic_lpips_params` to a weights file, for smoke runs
    that score LPIPS without the licensed weights:

        python -m gaussianavatars_torch.metrics.lpips OUT.npz [--net vgg] [--seed 0]
    """
    import argparse

    p = argparse.ArgumentParser(description="write synthetic LPIPS weights")
    p.add_argument("out_npz")
    p.add_argument("--net", default="vgg", choices=("vgg", "alex"))
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    os.makedirs(os.path.dirname(a.out_npz) or ".", exist_ok=True)
    return save_lpips_weights(synthetic_lpips_params(torch.Generator().manual_seed(a.seed),
                                                     a.net, device="cpu"), a.out_npz)


if __name__ == "__main__":
    print(main())
