"""The binding gathers: face tables [F, w] read once a Gaussian by its bound
face, and their transpose, a segment sum over a face-sorted index of the
binding.

`binding_gather(binding, *tables)` returns `table.index_select(0, binding)`
for each table, the same values as `table[binding]`. When a gradient is
wanted (`torch.is_grad_enabled()` and a table that requires grad) the
gathers are one `torch.autograd.Function`, whose backward sums each face's
gradient rows. On a CUDA tensor it builds the face-sorted index and makes
one launch of the kernel `csrc/binding_segment_sum.cu` (`segment_sum`),
which raises rather than fall back. On a CPU tensor it is the plain sum,
one `index_add_` a table, which adds a face's rows in order of position
from 0.0 (the kernel's order for a run of at most `SLICE` entries).
`segment_sum_reference` makes the kernel's own additions in its order, for
the checks that hold the kernel bit for bit. The JAX package leaves this
transpose to XLA's scatter-add; it has no TPU kernel.

The index (`build_face_index`): the permutation that sorts the binding
stably by face, int32, and the faces' offsets [F + 1], int32, built on the
binding's device with a stable sort and a binary search, never read on the
host. A backward builds it from the binding it saved (inside a captured
step, once a replay); nothing is built when no gradient is wanted
(serving, eval, the viewers).

Counts (`utils/profiling.setup_report`): the kernel's launches
(`LAUNCHES`) and the index builds (`INDEX`), grown once a replay of a
captured graph that holds them; and, read on demand, the longest run of
the binding the last index was built from (`LONGEST_RUN`).
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from .. import cuda_build
from ..utils import profiling

# Entries a thread sums in order; a longer run of n entries is cut into
# ceil(n / SLICE) interleaved slices, whose sums are added in slice order
# (csrc/binding_segment_sum.cu).
SLICE = 32
# Tables a launch takes, and the columns of the widest.
MAX_TABLES = 3
MAX_WIDTH = 4

LAUNCHES = profiling.counter("binding_gather", ("binding_segment_sum",))
INDEX = profiling.counter("binding_index", ("builds",))
LONGEST_RUN = "binding_index/longest_run"
# The binding the last index was built from (a weak reference) and its
# number of faces.
_LAST = [None, 0]


class FaceIndex(NamedTuple):
    """A binding sorted by face: face f's Gaussians are
    perm[offsets[f]:offsets[f + 1]], in increasing position."""

    perm: torch.Tensor     # [N] int32
    offsets: torch.Tensor  # [F + 1] int32


def build_face_index(binding: torch.Tensor, num_faces: int) -> FaceIndex:
    """The face-sorted index of `binding` [N] (face ids in [0, num_faces)),
    on its device, with no host read."""
    keys = binding.to(torch.int32)
    sorted_keys, order = torch.sort(keys, stable=True)
    faces = torch.arange(num_faces + 1, dtype=torch.int32, device=binding.device)
    offsets = torch.searchsorted(sorted_keys, faces, out_int32=True)
    profiling.count(INDEX, "builds")
    _LAST[:] = [weakref.ref(binding), num_faces]
    return FaceIndex(order.to(torch.int32), offsets)


def longest_run() -> Optional[int]:
    """The most Gaussians on one face of the binding the last index was
    built from (the run autograd's index backward summed in one thread),
    read on the host now; None when that binding is gone."""
    ref, num_faces = _LAST
    binding = None if ref is None else ref()
    if binding is None or binding.numel() == 0:
        return None
    return int(torch.bincount(binding, minlength=num_faces).max())


profiling.probe(LONGEST_RUN, longest_run)


@functools.cache
def _kernel_fn():
    fn = cuda_build.load("binding_segment_sum").binding_segment_sum
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   *[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] * MAX_TABLES,
                   ctypes.c_void_p]
    return fn


def segment_sum(grads, index: FaceIndex) -> list:
    """Per face f and gradient g [N, w] of `grads` (1 to 3 of them, float32,
    w at most 4): the sum of the rows of g at face f's positions, as
    [F, w] (zeros for an empty face), by one launch of the kernel. CUDA
    tensors only."""
    dev, n = index.perm.device, index.perm.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"the segment-sum kernel runs on CUDA, not {dev}")
    if not 1 <= len(grads) <= MAX_TABLES:
        raise ValueError(f"the kernel takes 1 to {MAX_TABLES} tables, got {len(grads)}")
    if index.perm.dtype != torch.int32 or index.offsets.dtype != torch.int32:
        raise ValueError("the face index must be int32")
    if not (index.perm.is_contiguous() and index.offsets.is_contiguous()):
        raise ValueError("the face index must be contiguous")
    for g in grads:
        if (g.dim() != 2 or g.shape[0] != n or g.dtype != torch.float32
                or not 1 <= g.shape[1] <= MAX_WIDTH or g.device != dev):
            raise ValueError(f"the kernel takes float32 [{n}, 1..{MAX_WIDTH}] on {dev}, got "
                             f"{g.dtype} {tuple(g.shape)} on {g.device}")
    nf = index.offsets.shape[0] - 1
    grads = [g.contiguous() for g in grads]
    outs = [torch.empty((nf, g.shape[1]), dtype=torch.float32, device=dev) for g in grads]
    tables = []
    for i in range(MAX_TABLES):
        tables += ([grads[i].data_ptr(), outs[i].data_ptr(), grads[i].shape[1]]
                   if i < len(grads) else [None, None, 0])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn()(index.perm.data_ptr(), index.offsets.data_ptr(), nf, *tables, stream)
    if err != 0:
        raise RuntimeError(f"binding_segment_sum launch failed with CUDA error {err}")
    profiling.count(LAUNCHES, "binding_segment_sum")
    return outs


def segment_sum_reference(grads, index: FaceIndex) -> list:
    """Plain PyTorch version of the kernel, on any device: the same
    additions in the same order, for the checks that hold the kernel bit
    for bit (a Python loop over a face's slices: slow). A face's run of n
    entries is cut into S = ceil(n / SLICE) interleaved slices (one for a
    short run): slice k holds its entries k, k + S, k + 2S, ... A slice is
    summed in order from 0.0, and a face's slices from 0.0 in slice
    order."""
    widths = [g.shape[1] for g in grads]
    dev = index.perm.device
    rows = torch.cat([g.to(torch.float32) for g in grads], dim=1)[index.perm.long()]
    offsets = index.offsets.long()
    nf = offsets.shape[0] - 1
    out = torch.zeros((nf, rows.shape[1]), dtype=torch.float32, device=dev)
    runs = offsets[1:] - offsets[:-1]
    n_slices = (runs + SLICE - 1) // SLICE
    face = torch.repeat_interleave(torch.arange(nf, device=dev), n_slices)   # [S]
    if face.shape[0] == 0:
        return [x.contiguous() for x in torch.split(out, widths, dim=1)]
    k = torch.arange(face.shape[0], device=dev) - (torch.cumsum(n_slices, 0) - n_slices)[face]
    step, run = n_slices[face], runs[face]
    part = torch.zeros((face.shape[0], rows.shape[1]), dtype=torch.float32, device=dev)
    for j in range(SLICE):
        entry = k + j * step
        row = rows[torch.clamp_max(offsets[face] + entry, rows.shape[0] - 1)]
        part = torch.where((entry < run)[:, None], part + row, part)
    for r in range(int(n_slices.max())):
        sel = k == r
        f = face[sel]
        out[f] = out[f] + part[sel]
    return [x.contiguous() for x in torch.split(out, widths, dim=1)]


class _BindingGather(torch.autograd.Function):
    """The gathers of `binding_gather`, with the segment sum as backward."""

    @staticmethod
    def forward(ctx, binding, *tables):
        ctx.save_for_backward(binding)
        ctx.num_faces = tables[0].shape[0]
        return tuple(t.index_select(0, binding) for t in tables)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        (binding,) = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        wanted = [g for g, n in zip(grads, need) if n]
        if binding.is_cuda:
            sums = segment_sum(wanted, build_face_index(binding, ctx.num_faces))
        else:
            sums = [torch.zeros((ctx.num_faces, g.shape[1]), dtype=g.dtype).index_add_(
                0, binding, g) for g in wanted]
        sums = iter(sums)
        return (None, *(next(sums) if n else None for n in need))


def binding_gather(binding: torch.Tensor, *tables: torch.Tensor) -> tuple:
    """Each table [F, w] at the rows `binding` [N] names: a tuple of [N, w]
    (see the module's docstring)."""
    if len({t.shape[0] for t in tables}) != 1:
        raise ValueError("the tables must have the same number of faces")
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in tables)):
        return tuple(t.index_select(0, binding) for t in tables)
    return _BindingGather.apply(binding, *tables)
