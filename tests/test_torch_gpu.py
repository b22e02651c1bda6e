"""Tests of the port that need the card (marker `gpu`; they skip elsewhere).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from gaussianavatars_torch.data.cameras import look_at_camera
from gaussianavatars_torch.ops import composite_pairs as tcp
from gaussianavatars_torch.ops.projection import project_from_params
from gaussianavatars_torch.ops.rasterize_sorted import depth_key, sort_gather
from gaussianavatars_torch.ops.sort_binning import TierSpec, bbox_tiles
from gaussianavatars_torch.render import AvatarRenderer, build_scene, probe_tile_config

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    """The card; decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _table(seed, n, h, w, th, tw, opac_lo, opac_hi, spread, device):
    g = torch.Generator().manual_seed(seed)
    means = torch.randn((n, 3), generator=g) * torch.tensor(spread) + torch.tensor([0.0, 0.0, 2.5])
    scales = torch.empty((n, 3)).uniform_(0.01, 0.12, generator=g)
    quats = torch.randn((n, 4), generator=g)
    opacity = torch.empty((n,)).uniform_(opac_lo, opac_hi, generator=g)
    colors = torch.rand((n, 3), generator=g)
    cam = look_at_camera(eye=np.zeros(3), target=np.array([0.0, 0.0, 2.5]), fovy=1.0,
                         width=w, height=h, device=device)
    means, scales, quats, opacity, colors = (
        x.to(device) for x in (means, scales, quats, opacity, colors))
    proj = project_from_params(means, scales, quats, cam)
    opac = torch.where(proj.mask, opacity, torch.zeros_like(opacity))
    tminx, tminy, bw, ntiles, nty, ntx = bbox_tiles(proj, h, w, th, tw, opacity=opac)
    ntiles_eff = torch.where(proj.mask, ntiles, torch.zeros_like(ntiles))
    spec = TierSpec(base=2, tiers=((-(-n // 128) * 128, int(ntiles_eff.max()) + 1),))
    dataT, plan = sort_gather((nty * ntx, ntx, spec), proj.mean2d, proj.conic, colors, opac,
                              (tminx, tminy, bw, ntiles_eff, depth_key(proj.depth)))
    assert int(plan.budget_overflow) == 0
    return dataT, plan.tile_starts, plan.counts, ntx


CASES = {
    "sparse_8x16": (0, 200, 64, 96, 8, 16, 0.2, 0.9, (0.8, 0.6, 0.3)),
    "long_walks_8x16": (1, 1500, 64, 96, 8, 16, 0.02, 0.08, (0.08, 0.06, 0.3)),
    "saturating_32x32": (2, 4096, 128, 256, 32, 32, 0.3, 0.98, (0.8, 0.6, 0.3)),
    "empty_tiles_16x16": (3, 300, 100, 150, 16, 16, 0.5, 0.9, (0.1, 0.1, 0.3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain(case, cuda_device):
    """The kernel against its plain version on the same card tensors. Both
    do the same float32 operations in the same order (the kernel is built
    without fused multiply-adds), so `stop` is compared exactly and
    acc/t_final at atol 1e-5."""
    dataT, starts, counts, ntx = _table(*CASES[case], device=cuda_device)
    th, tw = CASES[case][4:6]
    before = tcp.fwd_call_pairs.launches
    acc, tfin, stop = tcp.fwd_call_pairs(dataT, starts, counts, th, tw, ntx)
    torch.cuda.synchronize()
    assert tcp.fwd_call_pairs.launches == before + 1
    r_acc, r_tfin, r_stop = tcp.fwd_call_pairs_reference(dataT, starts, counts, th, tw, ntx)
    torch.testing.assert_close(acc, r_acc, atol=1e-5, rtol=0)
    torch.testing.assert_close(tfin, r_tfin, atol=1e-5, rtol=0)
    assert torch.equal(stop, r_stop)


def test_cuda_wrapper_rejects_oversized_tiles(cuda_device):
    dataT, starts, counts, ntx = _table(*CASES["sparse_8x16"], device=cuda_device)
    with pytest.raises(ValueError):
        tcp.fwd_call_pairs(dataT, starts, counts, 64, 32, ntx)
    with pytest.raises(ValueError):
        tcp.fwd_call_pairs(dataT[:, ::2], starts, counts, 8, 16, ntx)


def test_renderer_on_card_matches_cpu(cuda_device):
    """One small bench-scene frame on the card and on the CPU. atol 5e-4:
    the devices' float32 libm and matmul rounding differ by ulps, which can
    move a pixel's T < 1e-4 stop by one splat, changing that pixel by at
    most about 1e-4 per channel."""
    out = {}
    for dev in ("cpu", cuda_device):
        model, params, aux, fl, cam, _n = build_scene(per_face=1, width=160, height=96,
                                                      device=dev)
        cfg = probe_tile_config(model, params, aux, fl, cam)
        out[str(dev)] = AvatarRenderer(model, params, aux, cam, cfg, device=dev).render(fl)
    a, b = out["cpu"], out[str(cuda_device)]
    torch.testing.assert_close(b.color.cpu(), a.color, atol=5e-4, rtol=0)
    torch.testing.assert_close(b.alpha.cpu(), a.alpha, atol=5e-4, rtol=0)
