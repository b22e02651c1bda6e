"""gaussianavatars_torch — the PyTorch/CUDA port of gaussianavatars_tpu.

Mirrors the JAX package's module paths (`ops/projection.py` here is the
counterpart of `gaussianavatars_tpu/ops/projection.py`, and so on). Plain
tensor code is PyTorch; each Pallas kernel of the JAX package becomes a
hand-written CUDA kernel under `csrc/`, built at first use into
`build/torch_kernels/` and bound with ctypes (`cuda_build.py`).

The package imports nothing of JAX and nothing of `gaussianavatars_tpu`.
Entry points default to ``device="cuda"`` and raise when there is no card;
CPU tensors run each kernel's plain PyTorch version.

This slice covers the forward render path: FLAME → binding → world
Gaussians → projection + SH → sorted binning → pair compositor
(`render.AvatarRenderer`).
"""

__version__ = "0.1.0"
