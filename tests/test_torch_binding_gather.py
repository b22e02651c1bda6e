"""The binding gathers and their segment-sum backward (`ops/binding_gather.py`)
on the CPU: values and gradients against autograd's backward of
`table[binding]`, the kernel's plain version, and the face-sorted index.

Here the backward is the plain sum (`index_add_`), which adds each face's
rows in order of position from 0.0; the kernel runs on the card
(`tests/test_torch_gpu.py`). Autograd's index backward may add them in
another order, so the two agree to float32 rounding: |a - b| <=
2 · n · 2^-24 · Σ|g| for a sum of n terms g (each order's error is at most
(n - 1) · 2^-24 · Σ|g|).
"""
import pytest
import torch

from gaussianavatars_torch.models.gaussians import (
    FaceFrames, GaussianAux, GaussianParams, world_gaussians,
)
from gaussianavatars_torch.ops import binding_gather as bg
from gaussianavatars_torch.utils import profiling

WIDTHS = (3, 4, 1)   # the frames' centre, orientation quaternion and scaling


def padded_binding(n_faces: int, per_face: int, capacity: int) -> torch.Tensor:
    """The fixed-capacity state's binding (`init_bound`): `per_face` live
    Gaussians a face, every padding slot on face 0."""
    idx = torch.arange(capacity)
    return torch.where(idx < n_faces * per_face, idx % n_faces, 0)


def random_binding(n_faces: int, n: int, seed: int) -> torch.Tensor:
    """Random faces out of the first half of `n_faces` (the rest empty)."""
    return torch.randint(0, n_faces // 2, (n,), generator=torch.Generator().manual_seed(seed))


def tables(n_faces: int, seed: int) -> list:
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((n_faces, w), generator=g).requires_grad_() for w in WIDTHS]


def sequential_sums(g: torch.Tensor, binding: torch.Tensor, n_faces: int,
                    slice_len: int = bg.SLICE) -> torch.Tensor:
    """The kernel's additions, written as a loop: a face's rows in order of
    position, cut into S = ceil(n / slice_len) interleaved slices (slice k:
    rows k, k + S, ...), each summed from 0.0 in order, the slices added
    from 0.0 in order. A `slice_len` of at least n: the rows in order."""
    out = torch.zeros((n_faces, g.shape[1]))
    for f in range(n_faces):
        rows = g[binding == f]
        n_slices = -(-rows.shape[0] // slice_len)
        total = torch.zeros(g.shape[1])
        for k in range(n_slices):
            part = torch.zeros(g.shape[1])
            for row in rows[k::n_slices]:
                part = part + row
            total = total + part
        out[f] = total
    return out


def assert_face_grads(got, want, g, binding, n_faces):
    """`got` is the rows added in order of position, bit for bit; `want`
    (another order) within the rounding bound (top)."""
    assert torch.equal(got, sequential_sums(g, binding, n_faces, binding.shape[0]))
    runs = torch.bincount(binding, minlength=n_faces)
    abs_sum = torch.zeros_like(want).index_add_(0, binding, g.abs())
    bound = 2 * runs[:, None] * 2.0 ** -24 * abs_sum
    assert bool(((got - want).abs() <= bound).all())


LAYOUTS = {
    # 90 live Gaussians on 10 faces, 934 padding slots on face 0.
    "padding_on_face_0": lambda: (padded_binding(10, 9, 1024), 10),
    "random_with_empty_faces": lambda: (random_binding(64, 1500, 3), 64),
    # A `gauss_shard` slice: the second of four slices of the padded binding.
    "gauss_shard_slice": lambda: (padded_binding(40, 9, 2048)[512:1024], 40),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_values_and_gradients_match_autograd(layout):
    binding, n_faces = LAYOUTS[layout]()
    tabs = tables(n_faces, seed=1)
    outs = bg.binding_gather(binding, *tabs)
    for o, t in zip(outs, tabs):
        assert torch.equal(o, t[binding])
    g = torch.Generator().manual_seed(2)
    cots = [torch.randn(o.shape, generator=g) for o in outs]
    torch.autograd.backward(outs, cots)
    got = [t.grad.clone() for t in tabs]
    for t in tabs:
        t.grad = None
    torch.autograd.backward([t[binding] for t in tabs], cots)
    for a, t, c in zip(got, tabs, cots):
        assert_face_grads(a, t.grad, c, binding, n_faces)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_version_makes_the_kernels_additions(layout):
    binding, n_faces = LAYOUTS[layout]()
    g = torch.randn((binding.shape[0], 8), generator=torch.Generator().manual_seed(4))
    (got,) = bg.segment_sum_reference([g], bg.build_face_index(binding, n_faces))
    assert torch.equal(got, sequential_sums(g, binding, n_faces))


def test_segment_sum_is_the_kernel_and_runs_on_cuda_only():
    binding, n_faces = padded_binding(10, 9, 1024), 10
    with pytest.raises(ValueError, match="runs on CUDA"):
        bg.segment_sum([torch.zeros((1024, 3))], bg.build_face_index(binding, n_faces))


def test_face_index_offsets_order_and_longest_run():
    binding = torch.tensor([3, 0, 3, 1, 0, 3, 5, 0, 3])
    before = bg.INDEX["builds"]
    perm, offsets = bg.build_face_index(binding, 7)
    assert bg.INDEX["builds"] == before + 1
    assert perm.dtype == offsets.dtype == torch.int32
    assert offsets.tolist() == [0, 3, 4, 4, 8, 8, 9, 9]
    # Stable: each face's positions in increasing order.
    assert perm.tolist() == [1, 4, 7, 3, 0, 2, 5, 8, 6]
    assert profiling.setup_report()["probes"][bg.LONGEST_RUN] == 4
    long_run = torch.zeros(6000, dtype=torch.int64)
    bg.build_face_index(long_run, 2)
    assert profiling.setup_report()["probes"][bg.LONGEST_RUN] == 6000


def test_setup_report_takes_the_probes_readings_when_called():
    """A probe is read at each report, not when it is registered; the
    longest run reads None once the binding it was built from is gone."""
    box = {"n": 1}
    profiling.probe("test/reading", lambda: box["n"])
    box["n"] = 7
    assert profiling.setup_report()["probes"]["test/reading"] == 7
    bg.build_face_index(torch.zeros(10, dtype=torch.int64), 2)
    assert profiling.setup_report()["probes"][bg.LONGEST_RUN] is None


def test_no_index_without_a_gradient():
    binding, n_faces = padded_binding(10, 9, 1024), 10
    tabs = tables(n_faces, seed=5)
    before = bg.INDEX["builds"]
    with torch.no_grad():
        outs = bg.binding_gather(binding, *tabs)
    plain = bg.binding_gather(binding, *[t.detach() for t in tabs])
    assert all(o.grad_fn is None for o in (*outs, *plain))
    assert bg.INDEX["builds"] == before


def test_gradients_follow_a_changed_binding():
    """A binding changed in place between two backward passes, or a new
    one (a densify event): each pass's gradients are its binding's."""
    binding, n_faces = padded_binding(10, 9, 1024), 10
    tabs = tables(n_faces, seed=6)

    def grads(b):
        for t in tabs:
            t.grad = None
        outs = bg.binding_gather(b, *tabs)
        torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])
        return [t.grad.clone() for t in tabs]

    first = grads(binding)
    binding[:100] = 7
    in_place = grads(binding)
    densified = binding.clone()
    densified[100:200] = 9
    new = grads(densified)
    assert not torch.equal(first[0], in_place[0])
    for b, got in ((binding, in_place), (densified, new)):
        runs = torch.bincount(b, minlength=n_faces).float()
        for g in got:
            assert torch.equal(g, runs[:, None].expand_as(g))


def grad_fn_names(t: torch.Tensor) -> set:
    """The names of the autograd nodes behind `t`."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is not None and node not in seen:
            seen.add(node)
            todo += [n for n, _ in node.next_functions]
    return {type(n).__name__ for n in seen}


def test_world_gaussians_backward_goes_through_the_segment_sum(monkeypatch):
    """`world_gaussians` reads the frames by the op (one backward node for
    the three tables), with the values and, to rounding, the gradients of
    the plain gathers `frames.X[binding]` it replaced."""
    from gaussianavatars_torch.models import gaussians

    n_faces, cap = 10, 1024
    binding = padded_binding(n_faces, 9, cap)
    g = torch.Generator().manual_seed(7)
    params = GaussianParams(
        means=torch.randn((cap, 3), generator=g), log_scales=torch.randn((cap, 3), generator=g),
        quats=torch.randn((cap, 4), generator=g), sh_dc=torch.zeros((cap, 1, 3)),
        sh_rest=torch.zeros((cap, 15, 3)), logit_opacity=torch.zeros((cap, 1)))
    aux = GaussianAux(alive=torch.arange(cap) < 90, binding=binding,
                      grad_accum=torch.zeros(cap), denom=torch.zeros(cap),
                      max_radii2d=torch.zeros(cap))
    center, quat, scaling = tabs = tables(n_faces, seed=8)
    frames = FaceFrames(center=center, orien_mat=torch.eye(3).expand(n_faces, 3, 3),
                        orien_quat=quat, scaling=scaling)
    wg = world_gaussians(params, aux, frames)
    assert "_BindingGatherBackward" in grad_fn_names(wg.means)
    (wg.means.sum() + wg.scales.sum() + wg.quats.sum()).backward()
    got = [t.grad.clone() for t in tabs]
    for t in tabs:
        t.grad = None
    rows = []

    def plain_gathers(b, *ts):
        rows[:] = [t[b] for t in ts]
        for r in rows:
            r.retain_grad()
        return tuple(rows)

    monkeypatch.setattr(gaussians, "binding_gather", plain_gathers)
    ref = world_gaussians(params, aux, frames)
    assert "_BindingGatherBackward" not in grad_fn_names(ref.means)
    with torch.no_grad():
        assert torch.equal(ref.means, wg.means) and torch.equal(ref.quats, wg.quats)
    (ref.means.sum() + ref.scales.sum() + ref.quats.sum()).backward()
    # `rows` (scaling, orientation, centre) now hold the per-Gaussian
    # gradients that both backward passes summed.
    for a, t, r in zip(got, tabs, (rows[2], rows[1], rows[0])):
        assert_face_grads(a, t.grad, r.grad, binding, n_faces)
