"""Tests of the port that need the card (marker `gpu`; they skip elsewhere).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from gaussianavatars_torch.config import Config
from gaussianavatars_torch.data.cameras import look_at_camera
from gaussianavatars_torch.models.flame.flame_model import zero_params
from gaussianavatars_torch.ops import binding_gather as tbg
from gaussianavatars_torch.ops import composite_pairs as tcp
from gaussianavatars_torch.ops.projection import project_from_params
from gaussianavatars_torch.ops.rasterize_sorted import depth_key, sort_gather
from gaussianavatars_torch.ops.sort_binning import TierSpec, bbox_tiles
from gaussianavatars_torch.render import AvatarRenderer, build_scene, probe_tile_config
from gaussianavatars_torch.training.trainer import init_train_state, make_train_step

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
    # 96 pixels a tile: not a multiple of the kernels' 128 pixels a warp.
    "partial_warp_8x12": (4, 400, 64, 96, 8, 12, 0.3, 0.95, (0.3, 0.2, 0.3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain(case, cuda_device):
    """The kernel against its plain version on the same card tensors. Both
    do the same float32 operations in the same order (the kernel is built
    without fused multiply-adds), so `stop` is compared exactly and
    acc/t_final at atol 1e-5."""
    dataT, starts, counts, ntx = _table(*CASES[case], device=cuda_device)
    th, tw = CASES[case][4:6]
    before = tcp.LAUNCHES["composite_pairs_fwd"]
    acc, tfin, stop = tcp.fwd_call_pairs(dataT, starts, counts, th, tw, ntx)
    torch.cuda.synchronize()
    assert tcp.LAUNCHES["composite_pairs_fwd"] == before + 1
    r_acc, r_tfin, r_stop = tcp.fwd_call_pairs_reference(dataT, starts, counts, th, tw, ntx)
    torch.testing.assert_close(acc, r_acc, atol=1e-5, rtol=0)
    torch.testing.assert_close(tfin, r_tfin, atol=1e-5, rtol=0)
    assert torch.equal(stop, r_stop)


def test_cuda_wrapper_rejects_oversized_tiles(cuda_device):
    dataT, starts, counts, ntx = _table(*CASES["sparse_8x16"], device=cuda_device)
    with pytest.raises(ValueError):
        tcp.fwd_call_pairs(dataT, starts, counts, 64, 32, ntx)
    with pytest.raises(ValueError, match="multiple of 4"):   # rows of a multiple of 4
        tcp.fwd_call_pairs(dataT, starts, counts, 8, 10, ntx)
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


@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_bwd_kernel_matches_plain(case, cuda_device):
    """The backward kernel against its plain version on the same card
    tensors, with fixed-seed cotangents. Per-pixel values are the same
    float32 operations in the same order; the sums over a tile's pixels are
    added in another order, so each row is held at max |kernel - plain| <=
    1e-4 · max |plain| of the row. Rows 9..15 and every slot that is zero
    in the plain version (nothing reached it) are exact zeros."""
    dataT, starts, counts, ntx = _table(*CASES[case], device=cuda_device)
    th, tw = CASES[case][4:6]
    acc, tfin, stop = tcp.fwd_call_pairs(dataT, starts, counts, th, tw, ntx)
    g = torch.Generator().manual_seed(7)
    nt, p = starts.shape[0], th * tw
    g_acc_t = torch.randn((nt, p, 3), generator=g).to(cuda_device)
    g_t = torch.randn((nt, p), generator=g).to(cuda_device)
    args = (dataT, starts, counts, acc, tfin, stop, g_acc_t, g_t, th, tw, ntx)
    before = tcp.LAUNCHES["composite_pairs_bwd"]
    d = tcp.bwd_call_pairs(*args)
    torch.cuda.synchronize()
    assert tcp.LAUNCHES["composite_pairs_bwd"] == before + 1
    r = tcp.bwd_call_pairs_reference(*args)
    err = (d[:9] - r[:9]).abs().amax(dim=1)
    assert (err <= 1e-4 * r[:9].abs().amax(dim=1)).all(), err
    assert not d[9:].any()
    assert not d[:, (r == 0).all(dim=0)].any()


@pytest.mark.parametrize("impl", ["v2", "v3", "v4"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_variant_kernels_match_plain(case, impl, cuda_device, monkeypatch):
    """Each implementation's entry points against the plain versions on the
    same card tensors: the forward of `impl` equal to the plain forward bit
    for bit (acc, t_final, stop); the backward of `impl` in float32 and in
    `amp` mode at the float32 kernel's bound (per row max |kernel - plain|
    <= 1e-4 · max |plain|, exact zeros). Under `amp` each pixel's float32
    values, and so their bf16 roundings, are the plain version's; only the
    order of the sums over a tile's pixels differs."""
    dataT, starts, counts, ntx = _table(*CASES[case], device=cuda_device)
    th, tw = CASES[case][4:6]
    monkeypatch.setattr(tcp, "_FWD_IMPL", impl)
    monkeypatch.setattr(tcp, "_BWD_IMPL", impl)
    fwd_entry = tcp.fwd_entry(impl)[1]
    before = tcp.LAUNCHES[fwd_entry]
    acc, tfin, stop = tcp.fwd_call_pairs(dataT, starts, counts, th, tw, ntx)
    torch.cuda.synchronize()
    assert tcp.LAUNCHES[fwd_entry] == before + 1
    r_acc, r_tfin, r_stop = tcp.fwd_call_pairs_reference(dataT, starts, counts, th, tw, ntx)
    assert torch.equal(acc, r_acc) and torch.equal(tfin, r_tfin) and torch.equal(stop, r_stop)
    g = torch.Generator().manual_seed(7)
    nt, p = starts.shape[0], th * tw
    g_acc_t = torch.randn((nt, p, 3), generator=g).to(cuda_device)
    g_t = torch.randn((nt, p), generator=g).to(cuda_device)
    args = (dataT, starts, counts, acc, tfin, stop, g_acc_t, g_t, th, tw, ntx)
    for amp in (False, True):
        entry = tcp.bwd_entry(impl, amp)[1]
        before = tcp.LAUNCHES[entry]
        d = tcp.bwd_call_pairs(*args, amp=amp)
        torch.cuda.synchronize()
        assert tcp.LAUNCHES[entry] == before + 1
        r = tcp.bwd_call_pairs_reference(*args, amp=amp)
        err = (d[:9] - r[:9]).abs().amax(dim=1)
        assert (err <= 1e-4 * r[:9].abs().amax(dim=1)).all(), (amp, err)
        assert not d[9:].any()
        assert not d[:, (r == 0).all(dim=0)].any()


@pytest.mark.parametrize("rows", [9, 16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_row2_kernels_take_9_and_16_rows(case, rows, cuda_device, monkeypatch):
    """The v3 and v4 backward kernels (one source) and the v2 kernel, float32
    and `amp`, on the port's 9-row table and on the JAX package's 16-row
    layout of it, long walks included: each row within 1e-4 of its largest
    plain value, the plain version's zero slots and rows 9..15 exact zeros,
    every column's rows 0..8 written by the kernel (a launch into a
    NaN-filled output gives the wrapper's result), the 16-row gradient's
    rows 0..8 equal to the 9-row one's bit for bit."""
    dataT, starts, counts, ntx = _table(*CASES[case], device=cuda_device)
    assert dataT.shape[0] == 9
    if rows == 16:
        dataT = torch.cat([dataT, torch.zeros((7, dataT.shape[1]), device=cuda_device)])
    th, tw = CASES[case][4:6]
    acc, tfin, stop = tcp.fwd_call_pairs(dataT, starts, counts, th, tw, ntx)
    g = torch.Generator().manual_seed(9)
    nt, p = starts.shape[0], th * tw
    g_acc_t = torch.randn((nt, p, 3), generator=g).to(cuda_device)
    g_t = torch.randn((nt, p), generator=g).to(cuda_device)
    rest = (starts, counts, acc, tfin, stop, g_acc_t, g_t, th, tw, ntx)
    for impl in ("v3", "v4", "v2"):
        monkeypatch.setattr(tcp, "_BWD_IMPL", impl)
        for amp in (False, True):
            entry = tcp.bwd_entry(impl, amp)[1]
            before = tcp.LAUNCHES[entry]
            d = tcp.bwd_call_pairs(dataT, *rest, amp=amp)
            torch.cuda.synchronize()
            assert tcp.LAUNCHES[entry] == before + 1 and d.shape == dataT.shape
            r = tcp.bwd_call_pairs_reference(dataT, *rest, amp=amp)
            err = (d[:9] - r[:9]).abs().amax(dim=1)
            assert (err <= 1e-4 * r[:9].abs().amax(dim=1)).all(), (impl, amp, err)
            assert not d[9:].any() and not d[:, (r == 0).all(dim=0)].any()
            # The kernel writes rows 0..8 of every column, its zeros too.
            out = torch.full_like(dataT, float("nan"))
            tcp._launch_bwd_cuda(out, dataT, *rest, amp=amp)
            assert torch.equal(out[:9], d[:9])
            if rows == 16:
                d9 = tcp.bwd_call_pairs(dataT[:9].contiguous(), *rest, amp=amp)
                assert torch.equal(d[:9], d9)


def test_amp_train_step_on_card_matches_cpu(cuda_device):
    """One `use_amp` train step of a small bench-scene avatar on the card and
    on the CPU, from the same state, towards a textured target (seeded
    uniform noise, where the bf16 SSIM is well conditioned). The loss at
    rtol 1e-3 and each gradient leaf within 1e-2 · max |CPU| of the leaf:
    the float32 tolerances of the float32 test, with the loss loosened
    because a one-ulp difference between the devices can flip a bf16
    rounding of an SSIM moment."""
    out, cfg_tile = {}, None
    noise = torch.rand((96, 160, 3), generator=torch.Generator().manual_seed(3))
    for dev in ("cpu", cuda_device):
        model, params, aux, fl, cam, _n = build_scene(per_face=1, width=160, height=96,
                                                      device=dev)
        cfg_tile = cfg_tile or probe_tile_config(model, params, aux, fl, cam)
        cfg = Config(opt=dataclasses.replace(Config().opt, use_amp=True))
        state = init_train_state(params, aux, cfg, num_timesteps=2, n_expr=fl.expr.shape[1],
                                 n_shape=fl.shape.shape[0], num_verts=model.num_verts)
        step = make_train_step(model, cfg, cfg_tile)
        before = tcp.LAUNCHES["composite_pairs_bwd_amp"]
        out[str(dev)] = step(state, noise.to(dev), cam, 1, torch.zeros(3, device=dev), 3)
        assert tcp.LAUNCHES["composite_pairs_bwd_amp"] == before + (dev != "cpu")
    a, b = out["cpu"], out[str(cuda_device)]
    torch.testing.assert_close(b.metrics["loss"].cpu(), a.metrics["loss"], rtol=1e-3, atol=0)
    for mu_a, mu_b in ((a.state.adam.mu, b.state.adam.mu),
                       (a.state.flame_adam.mu, b.state.flame_adam.mu)):
        for name, x in vars(mu_a).items():
            if x is None:
                continue
            y = getattr(mu_b, name).cpu()
            assert float((y - x).abs().max()) <= 1e-2 * float(x.abs().max()), name


def test_train_step_on_card_matches_cpu(cuda_device):
    """One FLAME-bound train step of a small bench-scene avatar on the card
    and on the CPU, from the same state. The loss at rtol 1e-4; each
    gradient leaf (Adam's first moment after one step, 0.1·g) within
    1e-2 · max |CPU| of the leaf: the devices' float32 libm and summation
    orders differ by ulps, which can move a pixel's T < 1e-4 stop by one
    splat and so the gradients of the splats at that pixel."""
    out, cfg_tile = {}, None
    for dev in ("cpu", cuda_device):
        model, params, aux, fl, cam, _n = build_scene(per_face=1, width=160, height=96,
                                                      device=dev)
        cfg_tile = cfg_tile or probe_tile_config(model, params, aux, fl, cam)
        cfg = Config()
        gt = torch.full((cam.height, cam.width, 3), 0.3, device=dev)
        state = init_train_state(params, aux, cfg, num_timesteps=2, n_expr=fl.expr.shape[1],
                                 n_shape=fl.shape.shape[0], num_verts=model.num_verts)
        step = make_train_step(model, cfg, cfg_tile)
        before = tcp.LAUNCHES["composite_pairs_bwd"]
        out[str(dev)] = step(state, gt, cam, 1, torch.zeros(3, device=dev), 3)
        assert tcp.LAUNCHES["composite_pairs_bwd"] == before + (dev != "cpu")
    a, b = out["cpu"], out[str(cuda_device)]
    torch.testing.assert_close(b.metrics["loss"].cpu(), a.metrics["loss"], rtol=1e-4, atol=0)
    for mu_a, mu_b in ((a.state.adam.mu, b.state.adam.mu),
                       (a.state.flame_adam.mu, b.state.flame_adam.mu)):
        for name, x in vars(mu_a).items():
            if x is None:
                continue
            y = getattr(mu_b, name).cpu()
            assert float((y - x).abs().max()) <= 1e-2 * float(x.abs().max()), name


@pytest.mark.parametrize("values", ["uniform", "log_uniform"])
@pytest.mark.parametrize("nt", [1, 5, 468])
@pytest.mark.parametrize("name", ["a", "b", "c", "d"])
def test_micro_reduce_kernel_matches_plain(name, nt, values, cuda_device):
    """Each micro-reduce kernel against its plain version, at 1, 5 and the
    benchmark's 468 tiles (the block mappings take any tile count), on
    U(0, 1) and on 10 ** U(-3, 3) (mixed magnitudes for C's and D's 3xTF32
    split): every slot within relative 1e-5 (A and B in float32 on the CUDA
    cores, C and D on the tensor cores in 3xTF32)."""
    from gaussianavatars_torch.tools import micro_reduce_bench as mr

    g = torch.Generator().manual_seed(1)
    x = torch.rand((nt, mr.C, 1), generator=g)
    if values == "log_uniform":
        x = 10.0 ** (6.0 * x - 3.0)
    x = x.to(cuda_device)
    sym = f"micro_reduce_{name}"
    before = mr.LAUNCHES[sym]
    got = mr.reduce_slots(name, x)
    torch.cuda.synchronize()
    assert mr.LAUNCHES[sym] == before + 1
    assert mr.relative_error(got, mr.PLAIN[name](x)) <= 1e-5
    assert mr.relative_error(got, 46080.0 * x) <= 1e-5


def test_train_synthetic_loop_on_the_card(cuda_device, tmp_path):
    """A short run of the host loop on the card: a densify event (the
    recipe densifies from iteration 500 every 250, so at 750), eval, PLY
    save and checkpoints, the backward compositor once per training step.

    The split at 750 makes the loss jump for some 20 steps in the JAX
    package's loop too: `scripts/train_synthetic.py` with these flags on
    a CPU, on the port's dataset, logs 0.0129 at 750 and 0.0724 at 760,
    and over 800-850 a mean loss 1.23x its mean over 700-750. The port is
    held to 2x there, and to the loss of the log at 170 at the end."""
    from gaussianavatars_torch.tools import train_synthetic

    tcp.LAUNCHES.update(dict.fromkeys(tcp.LAUNCHES, 0))
    harness, result = train_synthetic.run(train_synthetic.parse_args([
        "--workdir", str(tmp_path / "syn"), "--width", "256", "--height", "192",
        "--timesteps", "3", "--cameras", "3", "--iterations", "850", "--capacity", "32768",
        "--log_every", "10", "--eval_every", "425", "--checkpoint_every", "425"]))
    loss = {r["iteration"]: r["loss"] for r in result["logs"]}
    points = {r["iteration"]: r["num_points"] for r in result["logs"]}
    assert sorted(loss) == list(range(10, 851, 10))
    assert all(np.isfinite(v) for v in loss.values())
    before = np.mean([loss[i] for i in range(700, 751, 10)])
    after = np.mean([loss[i] for i in range(800, 851, 10)])
    assert after <= 2.0 * before and loss[850] < loss[170], (before, after, loss)
    densify = [e for e in harness.events if e["kind"] == "densify"]
    assert [e["iteration"] for e in densify] == [750]
    assert densify[0]["cloned"] + densify[0]["split"] > 0
    assert points[760] != points[750]
    assert tcp.LAUNCHES["composite_pairs_bwd"] == 850
    assert result["eval_val"]["psnr"] > result["eval_untrained_val"]["psnr"]
    model = tmp_path / "syn" / "model"
    for f in ("chkpnt425.npz", "chkpnt850.npz", "point_cloud/iteration_850/point_cloud.ply"):
        assert (model / f).exists(), f


def test_adam_update_makes_no_host_sync(cuda_device):
    """Adam's step on the card reads nothing back and copies nothing from
    the host: its bias corrections are computed from the device step (a
    base built from a Python number was a synchronising copy, two an
    update, and so two a step more with the colour net's Adam)."""
    import warnings

    from gaussianavatars_torch.training import innovations as inn
    from gaussianavatars_torch.training.optim import adam_init, adam_update, tree_map

    net = inn.color_net_init(16, 3, generator=torch.Generator().manual_seed(0),
                             device=cuda_device)
    state = adam_init(net)
    grads = tree_map(torch.ones_like, net)
    lr = tree_map(lambda _: 1e-3, net)
    adam_update(net, grads, state, lr)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            new, state = adam_update(net, grads, state, lr)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in caught if "synchroniz" in str(w.message)]
    assert int(state.step) == 1 and not torch.equal(new.weights[0], net.weights[0])


def test_knn_on_card_matches_cpu(cuda_device):
    """`ops/knn.mean_sq_dist_3nn` on the card against the CPU on 20,000
    points (20 blocks, duplicates included): rtol 1e-4. The products are
    elementwise, so the two devices round them alike."""
    from gaussianavatars_torch.ops.knn import mean_sq_dist_3nn

    g = torch.Generator().manual_seed(3)
    pts = torch.rand((20_000, 3), generator=g) * 2.6 - 1.3
    pts[10_000:10_050] = pts[:50]
    cpu = mean_sq_dist_3nn(pts)
    card = mean_sq_dist_3nn(pts.to(cuda_device)).cpu()
    torch.testing.assert_close(card, cpu, rtol=1e-4, atol=1e-7)


def test_unbound_step_kernel_matches_plain_backward(cuda_device):
    """One unbound (point-cloud) step on the card with the backward kernel
    and with the plain backward compositor, from one state: each gradient
    leaf (Adam's first moment, 0.1·g) within 1e-4 of the leaf's largest,
    as phase 6 of chip_smoke.py holds the FLAME-bound step."""
    from gaussianavatars_torch.models.gaussians import init_from_points
    from gaussianavatars_torch.ops import rasterize_sorted as rs

    rng = np.random.RandomState(5)
    pts = rng.randn(4000, 3).astype(np.float32) * np.array([0.5, 0.4, 0.2], np.float32)
    params, aux = init_from_points(pts, rng.uniform(0, 1, (4000, 3)), capacity=4096,
                                   device=cuda_device)
    # Visible, anisotropic and rotated (an isotropic splat has no rotation
    # gradient).
    g = torch.Generator().manual_seed(4)
    params = dataclasses.replace(
        params, logit_opacity=torch.where(aux.alive[:, None],
                                          torch.ones_like(params.logit_opacity),
                                          params.logit_opacity),
        log_scales=params.log_scales + (torch.rand((4096, 3), generator=g) - 0.5).to(
            cuda_device),
        quats=torch.randn((4096, 4), generator=g).to(cuda_device))
    cam = look_at_camera(eye=np.array([0.2, 0.1, -2.5]), target=np.zeros(3), fovy=0.8,
                         width=320, height=240, device=cuda_device)
    cfg = Config()
    state = init_train_state(params, aux, cfg)
    tile = probe_tile_config(None, params, aux, None, cam)
    step = make_train_step(None, cfg, tile)
    gt = torch.rand((240, 320, 3), generator=torch.Generator().manual_seed(6)).to(cuda_device)
    bg = torch.ones(3, device=cuda_device)
    before = tcp.LAUNCHES["composite_pairs_bwd"]
    out_k = step(state, gt, cam, 0, bg, 1)
    assert tcp.LAUNCHES["composite_pairs_bwd"] == before + 1
    rs.bwd_call_pairs = tcp.bwd_call_pairs_reference
    try:
        out_r = step(state, gt, cam, 0, bg, 1)
    finally:
        rs.bwd_call_pairs = tcp.bwd_call_pairs
    assert out_k.state.flame is None and int(out_k.metrics["budget_overflow"]) == 0
    torch.testing.assert_close(out_k.metrics["loss"], out_r.metrics["loss"], rtol=1e-6, atol=0)
    for name, x in vars(out_r.state.adam.mu).items():
        y = getattr(out_k.state.adam.mu, name)
        assert float((y - x).abs().max()) <= 1e-4 * float(x.abs().max()), name
        assert float(x.abs().max()) > 0 or name == "sh_rest", name


def _chunk_case(cuda_device, k: int):
    """A small bench-scene avatar on the card, its state, a two-view uint8
    cache and k steps' views (two cameras in turns, timesteps 0 and 1)."""
    from gaussianavatars_torch.training.trainer import stack_cameras

    model, params, aux, fl, cam, _n = build_scene(per_face=1, width=160, height=96,
                                                  device=cuda_device)
    tile = probe_tile_config(model, params, aux, fl, cam)
    cfg = Config()
    state = init_train_state(params, aux, cfg, num_timesteps=2, n_expr=fl.expr.shape[1],
                             n_shape=fl.shape.shape[0], num_verts=model.num_verts)
    g = torch.Generator().manual_seed(5)
    cache = torch.randint(0, 256, (2, cam.height, cam.width, 3), generator=g,
                          dtype=torch.uint8).to(cuda_device)
    other = dataclasses.replace(cam, world_view=cam.world_view.clone(),
                                full_proj=cam.full_proj.clone())
    other.world_view[0, 3] += 0.01
    other.full_proj.copy_(other.proj @ other.world_view)
    cams = [cam if i % 2 == 0 else other for i in range(k)]
    views, ts = [i % 2 for i in range(k)], [(i // 2) % 2 for i in range(k)]
    return model, cfg, tile, state, cache, cams, stack_cameras(cams), views, ts


def test_graph_chunk_matches_eager_steps(cuda_device):
    """A chunk of 12 (3 eager warm-up steps, a capture, 9 replays), then a
    chunk of 5 that only replays, against 17 `make_train_step` calls on the
    same views: every state leaf and metric within 1e-5 of its largest
    magnitude; rows 1 and 2 counted once a step."""
    from gaussianavatars_torch.data.pipeline import gt_to_float
    from gaussianavatars_torch.training.checkpoint import flatten_state
    from gaussianavatars_torch.training.trainer import make_train_chunk

    model, cfg, tile, state, cache, cams, stacked, views, ts = _chunk_case(cuda_device, 17)
    bg = torch.zeros(3, device=cuda_device)
    step = make_train_step(model, cfg, tile)
    st, losses = state, []
    for i in range(17):
        out = step(st, gt_to_float(cache[views[i]]), cams[i], ts[i], bg, 3)
        st = out.state
        losses.append(out.metrics["loss"])
    chunk = make_train_chunk(model, cfg, tile)
    before = dict(tcp.LAUNCHES)
    sc, m1 = chunk(state, cache, views[:12], stacked, ts[:12], bg, 3)
    tail = dataclasses.replace(stacked, **{f: getattr(stacked, f)[12:] for f in
                                           ("world_view", "proj", "full_proj", "camera_center")})
    sc, m2 = chunk(sc, cache, views[12:], tail, ts[12:], bg, 3)
    torch.cuda.synchronize()
    assert chunk.captures == 1
    assert tcp.LAUNCHES["composite_pairs_fwd"] - before["composite_pairs_fwd"] == 17
    assert tcp.LAUNCHES["composite_pairs_bwd"] - before["composite_pairs_bwd"] == 17
    got, want = flatten_state(sc), flatten_state(st)
    for k, v in want.items():
        err = float((got[k].double() - v.double()).abs().max())
        assert err <= 1e-5 * max(float(v.double().abs().max()), 1e-30), k
    loss = torch.cat([m1["loss"], m2["loss"]])
    torch.testing.assert_close(loss, torch.stack(losses), rtol=1e-5, atol=0)


def test_chunk_replays_make_no_host_sync(cuda_device):
    """Once captured, a chunk's replays read nothing back: under the sync
    debug mode "error" a chunk runs through; reading its loss then
    synchronises (and raises)."""
    from gaussianavatars_torch.training.trainer import make_train_chunk

    model, cfg, tile, state, cache, _c, stacked, views, ts = _chunk_case(cuda_device, 8)
    bg = torch.zeros(3, device=cuda_device)
    chunk = make_train_chunk(model, cfg, tile)
    st, _m = chunk(state, cache, views, stacked, ts, bg, 3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, m = chunk(st, cache, views, stacked, ts, bg, 3)
        with pytest.raises(RuntimeError):
            float(m["loss"][-1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert chunk.captures == 1 and bool(torch.isfinite(m["loss"]).all())


def test_chunk_capture_error_raises(cuda_device, monkeypatch):
    """A step that reads a device value on the host cannot be captured: the
    chunk raises and does not fall back to eager steps."""
    from gaussianavatars_torch.training import trainer as ttrainer

    model, cfg, tile, state, cache, _c, stacked, views, ts = _chunk_case(cuda_device, 6)
    psnr = ttrainer.psnr
    monkeypatch.setattr(ttrainer, "psnr", lambda a, b: psnr(a, b) + float(a.sum()) * 0.0)
    chunk = ttrainer.make_train_chunk(model, cfg, tile)
    before = tcp.LAUNCHES["composite_pairs_bwd"]
    with pytest.raises(RuntimeError):
        chunk(state, cache, views, stacked, ts, torch.zeros(3, device=cuda_device), 3)
    assert chunk.captured is None and chunk.captures == 0
    # The three eager warm-up steps ran; nothing after the failed capture.
    assert tcp.LAUNCHES["composite_pairs_bwd"] == before + 3


def _frame_case(cuda_device):
    """A small bench-scene avatar on the card, a render state with three
    timesteps of different jaw poses, and two cameras of one size."""
    from gaussianavatars_torch.training.trainer import init_train_state as init

    model, params, aux, fl, cam, _n = build_scene(per_face=1, width=160, height=96,
                                                  device=cuda_device)
    tile = probe_tile_config(model, params, aux, fl, cam)
    cfg = Config()
    state = init(params, aux, cfg, num_timesteps=3, n_expr=fl.expr.shape[1],
                 n_shape=fl.shape.shape[0], num_verts=model.num_verts)
    state.flame.jaw[:, 0] = torch.tensor([0.0, 0.15, 0.3], device=cuda_device)
    other = dataclasses.replace(cam, world_view=cam.world_view.clone(),
                                full_proj=cam.full_proj.clone())
    other.world_view[0, 3] += 0.02
    other.full_proj.copy_(other.proj @ other.world_view)
    return model, cfg, tile, state, fl, (cam, other)


def test_graph_frames_match_eager_frames(cuda_device):
    """`make_render_fn` over 3 FLAME poses × 2 cameras of one size, and
    `AvatarRenderer.render` over 3 poses: each returned frame equals its
    eager frame bit for bit, with one capture each; row 1 counted once a
    frame."""
    from gaussianavatars_torch.training.loop import make_render_fn

    model, cfg, tile, state, fl, cams = _frame_case(cuda_device)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda_device)
    render = make_render_fn(model, cfg, tile)
    before = tcp.LAUNCHES["composite_pairs_fwd"]
    frames = [(render(state, c, ts, bg, 3), c, ts) for ts in range(3) for c in cams]
    assert render.captures == 1
    assert tcp.LAUNCHES["composite_pairs_fwd"] - before == 6
    images = []
    for img, c, ts in frames:
        assert torch.equal(img, render.eager(state, c, ts, bg, 3))
        images.append(img)
    assert not torch.equal(images[0], images[2]) and not torch.equal(images[0], images[1])
    renderer = AvatarRenderer(model, state.params, state.aux, cams[0], tile, device=cuda_device)
    for jaw in (0.0, 0.15, 0.3):
        fp = fl._replace(jaw=torch.tensor([[jaw, 0.0, 0.0]], device=cuda_device))
        out, want = renderer.render(fp), renderer.render_eager(fp)
        for a, b in zip(out, want):
            assert torch.equal(a, b)
    assert renderer.captures == 1


def test_frame_graph_key_change_recaptures(cuda_device):
    """Another SH degree or another image size is another graph; the same
    key again replays (no capture)."""
    from gaussianavatars_torch.training.loop import make_render_fn

    model, cfg, tile, state, _fl, (cam, _other) = _frame_case(cuda_device)
    bg = torch.zeros(3, device=cuda_device)
    render = make_render_fn(model, cfg, tile)
    for _ in range(3):
        render(state, cam, 0, bg, 3)
    assert render.captures == 1
    for _ in range(2):
        img = render(state, cam, 0, bg, 1)
    assert render.captures == 2 and torch.equal(img, render.eager(state, cam, 0, bg, 1))
    small = look_at_camera(eye=np.array([0.0, 0.0, -1.0]), target=np.zeros(3), fovy=0.4,
                           width=96, height=64, device=cuda_device)
    for _ in range(2):
        img = render(state, small, 0, bg, 3)
    assert render.captures == 3 and img.shape == (64, 96, 3)


def test_frame_replays_make_no_host_sync(cuda_device):
    """Once captured, `AvatarRenderer.render` and `make_render_fn` replay
    under the sync debug mode "error" (device FLAME parameters; a host
    timestep is a fill, not a copy)."""
    from gaussianavatars_torch.training.loop import make_render_fn

    model, cfg, tile, state, fl, cams = _frame_case(cuda_device)
    bg = torch.zeros(3, device=cuda_device)
    render = make_render_fn(model, cfg, tile)
    renderer = AvatarRenderer(model, state.params, state.aux, cams[0], tile, device=cuda_device)
    poses = [fl._replace(jaw=torch.tensor([[0.01 * i, 0.0, 0.0]], device=cuda_device))
             for i in range(4)]
    for i in range(2):
        render(state, cams[i], i, bg, 3)
        renderer.render(poses[i])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(2, 4):
            img = render(state, cams[i % 2], i % 3, bg, 3)
            out = renderer.render(poses[i])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert render.captures == renderer.captures == 1
    assert bool(torch.isfinite(img).all()) and bool(torch.isfinite(out.color).all())


def test_table_chunk_matches_eager_table_steps(cuda_device):
    """The table pipeline (`use_pallas=False`, a table sized to the frame)
    in a chunk of 5 (3 warm-up steps, a capture, 2 replays; the fixed
    walk) against 5 eager table steps (the planned walk): every state leaf
    and metric within 1e-5 of its largest magnitude; rows 1 and 2 never
    launched."""
    from gaussianavatars_torch.data.pipeline import gt_to_float
    from gaussianavatars_torch.training.checkpoint import flatten_state
    from gaussianavatars_torch.training.trainer import make_train_chunk

    model, cfg, _tile, state, cache, cams, stacked, views, ts = _chunk_case(cuda_device, 5)
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline, use_pallas=False))
    fl = zero_params(state.flame_static.shape.shape[0], state.flame.expr.shape[1],
                     device=cuda_device)
    tile = probe_tile_config(model, state.params, state.aux, fl, cams[0], table=True)
    bg = torch.zeros(3, device=cuda_device)
    step = make_train_step(model, cfg, tile)
    st, rows = state, []
    for i in range(5):
        out = step(st, gt_to_float(cache[views[i]]), cams[i], ts[i], bg, 3)
        st, rows = out.state, rows + [out.metrics]
    before = dict(tcp.LAUNCHES)
    chunk = make_train_chunk(model, cfg, tile)
    sc, m = chunk(state, cache, views, stacked, ts, bg, 3)
    torch.cuda.synchronize()
    assert chunk.captures == 1 and tcp.LAUNCHES == before
    got, want = flatten_state(sc), flatten_state(st)
    for k, v in want.items():
        err = float((got[k].double() - v.double()).abs().max())
        assert err <= 1e-5 * max(float(v.double().abs().max()), 1e-30), k
    for k in rows[0]:
        w = torch.stack([r[k] for r in rows]).double()
        assert float((m[k].double() - w).abs().max()) <= 1e-5 * max(float(w.abs().max()),
                                                                   1e-30), k


def test_frame_capture_error_raises(cuda_device, monkeypatch):
    """A frame that reads a device value on the host cannot be captured:
    the second call raises, no graph is kept, and nothing falls back."""
    from gaussianavatars_torch import render as trender

    model, _cfg, tile, state, fl, cams = _frame_case(cuda_device)
    wg = trender.world_gaussians

    def world_gaussians_read(*a):
        out = wg(*a)
        float(out.means.sum())   # a host read
        return out

    monkeypatch.setattr(trender, "world_gaussians", world_gaussians_read)
    renderer = trender.AvatarRenderer(model, state.params, state.aux, cams[0], tile,
                                      device=cuda_device)
    renderer.render(fl)   # the eager warm-up reads the host freely
    with pytest.raises(RuntimeError):
        renderer.render(fl)
    assert renderer.captures == 0 and renderer.graph.slot.captured is None


def _stamp_kernels(prof) -> int:
    from gaussianavatars_torch.utils import profiling

    return sum(profiling.STAMP_KERNEL in e.name for e in prof.events())


def _outer_adds_up(kind: dict, outer: str) -> None:
    """Every row of the kind holds every span once; the outer span's direct
    children and its self time add up to it."""
    spans = kind["spans"]
    assert all(s["count"] == kind["units"] for s in spans.values()), spans
    assert all(s["self_ms"] >= 0 for s in spans.values()), spans
    top = sum(s["mean_ms"] for s in spans.values() if s["parent"] == outer)
    assert top + spans[outer]["self_ms"] == pytest.approx(spans[outer]["mean_ms"], rel=1e-9)


def test_stage_clock_frames_keep_their_bits(cuda_device):
    """`AvatarRenderer.render` with the stage clock off, on and off again:
    the same image bits; switching re-captures. Off, a profiled replay
    launches no stamp kernel. On, each replay writes one complete row with
    the frame's stages, and a profiled stretch aligns with the ring (every
    stamp kernel matched)."""
    from gaussianavatars_torch.utils import profiling

    model, _cfg, tile, state, fl, cams = _frame_case(cuda_device)
    renderer = AvatarRenderer(model, state.params, state.aux, cams[0], tile, device=cuda_device)
    poses = [fl._replace(jaw=torch.tensor([[j, 0.0, 0.0]], device=cuda_device))
             for j in (0.0, 0.1, 0.2)]
    renderer.render(poses[0])
    off = [renderer.render(fp).color for fp in poses]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        renderer.render(poses[0])
        torch.cuda.synchronize()
    assert _stamp_kernels(prof) == 0 and renderer.captures == 1
    profiling.enable_stage_clock(cuda_device, rows=64)
    try:
        renderer.render(poses[0])
        assert renderer.captures == 2
        profiling.stage_report()
        on = [renderer.render(fp).color for fp in poses]
        rep = profiling.stage_report()
        with torch.profiler.profile(activities=acts) as prof:
            for fp in poses:
                renderer.render(fp)
            torch.cuda.synchronize()
        aligned = profiling.stage_report(trace_events=profiling.trace_events(prof))
    finally:
        profiling.disable_stage_clock()
    again = [renderer.render(fp).color for fp in poses]
    assert renderer.captures == 3
    for a, b, c in zip(off, on, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    frame = rep["kinds"]["frame"]
    assert rep["rows"] == 3 and frame["units"] == 3 and frame["gaps"] == 2
    assert {"frame", "frame/flame_bind", "frame/project_sh", "sort_gather/fwd",
            "frame/composite"} == set(frame["spans"])
    _outer_adds_up(frame, "frame")
    assert rep["resolution_ns"] is not None and rep["repeats"] == {}
    al = aligned["align"]
    assert "error" not in al, al
    assert al["stamps"] == 3 * 2 * 5 and al["offset_iqr_ns"] < 1e6, al
    assert al["gaps"]["frame"]["gaps"] == 2, al


def test_stage_clock_chunks_keep_their_bits(cuda_device):
    """A chunk of 8 steps then one of 8 replays, with the stage clock off
    and on: the same state and metric bits. On, the replays write a
    complete row a step with every stage of the step."""
    from gaussianavatars_torch.training.checkpoint import flatten_state
    from gaussianavatars_torch.training.trainer import make_train_chunk
    from gaussianavatars_torch.utils import profiling

    def run(clock: bool):
        model, cfg, tile, state, cache, _c, stacked, views, ts = _chunk_case(cuda_device, 8)
        bg = torch.zeros(3, device=cuda_device)
        chunk = make_train_chunk(model, cfg, tile)
        if clock:
            profiling.enable_stage_clock(cuda_device, rows=64)
        try:
            st, _m = chunk(state, cache, views, stacked, ts, bg, 3)
            rep = profiling.stage_report() if clock else None
            st, m = chunk(st, cache, views, stacked, ts, bg, 3)
            rep = profiling.stage_report() if clock else None
        finally:
            profiling.disable_stage_clock()
        return {k: v.clone() for k, v in flatten_state(st).items()}, m, rep

    s_off, m_off, _ = run(False)
    s_on, m_on, rep = run(True)
    for k, v in s_off.items():
        assert torch.equal(v, s_on[k]), k
    for k, v in m_off.items():
        assert torch.equal(v, m_on[k]), k
    step = rep["kinds"]["train/step"]
    assert rep["rows"] == 8 and step["units"] == 8 and step["gaps"] == 7
    assert {"train/step", "train/geometry_fwd", "train/image_fwd", "sort_gather/fwd",
            "frame/composite", "train/image_bwd", "sort_gather/bwd", "train/densify_stats",
            "train/geometry_bwd", "train/adam"} == set(step["spans"])
    assert step["spans"]["sort_gather/bwd"]["parent"] == "train/image_bwd"
    _outer_adds_up(step, "train/step")


# Binding layouts of the segment-sum kernel: (slots, faces, live Gaussians a
# face), every padding slot on face 0 as in the fixed-capacity state. The
# benchmark's base-train and innov-train avatars (face 0's run 8,223 and
# 4,589) and a fit's initial state (10,010 live of 131,072: a run of
# 121,063).
BINDING_LAYOUTS = {
    "base_train": (98_304, 10_010, 9),
    "innov_train": (114_688, 10_010, 11),
    "initial_state": (131_072, 10_010, 1),
}


@pytest.mark.parametrize("layout", sorted(BINDING_LAYOUTS))
def test_binding_segment_sum_matches_plain_and_index_put(layout, cuda_device):
    """The kernel against its plain version (the same additions in the same
    order: bit for bit), against the backward it replaces,
    `index_put_(accumulate=True)` on the three tables, and against the
    exact sums, with random gradients on every slot, padding included.
    Faces with runs of at most 32 entries match `index_put_` bit for bit.
    Every face is within the kernel's own rounding of the sums taken in
    float64: a face of n entries is summed in S = ceil(n / 32) slices of at
    most 32 terms, then S partial sums, so its error is at most
    (32 + S) · 2^-24 · Σ|g| over its entries."""
    cap, n_faces, per_face = BINDING_LAYOUTS[layout]
    idx = torch.arange(cap, device=cuda_device)
    binding = torch.where(idx < n_faces * per_face, idx % n_faces, 0)
    g = torch.Generator().manual_seed(31)
    grads = [torch.randn((cap, w), generator=g).to(cuda_device) for w in (3, 4, 1)]
    index = tbg.build_face_index(binding, n_faces)
    runs = index.offsets[1:] - index.offsets[:-1]
    assert int(runs[0]) == cap - n_faces * per_face + per_face
    before = tbg.LAUNCHES["binding_segment_sum"]
    got = tbg.segment_sum(grads, index)
    torch.cuda.synchronize()
    assert tbg.LAUNCHES["binding_segment_sum"] == before + 1
    short = runs <= tbg.SLICE
    assert not bool(short[0]) and bool(short[1:].all())
    slices = (runs + tbg.SLICE - 1) // tbg.SLICE
    for a, p, x in zip(got, tbg.segment_sum_reference(grads, index), grads):
        assert torch.equal(a, p)
        want = torch.zeros_like(a).index_put_((binding,), x, accumulate=True)
        assert torch.equal(a[short], want[short])
        exact = torch.zeros(a.shape, dtype=torch.float64, device=cuda_device).index_add_(
            0, binding, x.double())
        abs_sum = torch.zeros_like(exact).index_add_(0, binding, x.double().abs())
        bound = (tbg.SLICE + slices[:, None]) * 2.0 ** -24 * abs_sum
        assert bool(((a.double() - exact).abs() <= bound).all())


def test_chunk_launches_the_segment_sum_once_a_step(cuda_device):
    """A chunk of 12 (3 eager warm-up steps, a capture, 9 replays), then one
    of 5 that only replays: the kernel and the index build once a step (the
    capture holds the build, so a replay builds the index of the binding it
    is given)."""
    from gaussianavatars_torch.training.trainer import make_train_chunk

    model, cfg, tile, state, cache, _c, stacked, views, ts = _chunk_case(cuda_device, 17)
    bg = torch.zeros(3, device=cuda_device)
    chunk = make_train_chunk(model, cfg, tile)
    launches, builds = tbg.LAUNCHES["binding_segment_sum"], tbg.INDEX["builds"]
    sc, _m = chunk(state, cache, views[:12], stacked, ts[:12], bg, 3)
    assert tbg.LAUNCHES["binding_segment_sum"] - launches == 12
    assert tbg.INDEX["builds"] - builds == 12
    tail = dataclasses.replace(stacked, **{f: getattr(stacked, f)[12:] for f in
                                           ("world_view", "proj", "full_proj", "camera_center")})
    chunk(sc, cache, views[12:], tail, ts[12:], bg, 3)
    torch.cuda.synchronize()
    assert chunk.captures == 1
    assert tbg.LAUNCHES["binding_segment_sum"] - launches == 17
    assert tbg.INDEX["builds"] - builds == 17
