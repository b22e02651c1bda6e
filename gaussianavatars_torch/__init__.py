"""gaussianavatars_torch — the PyTorch/CUDA port of gaussianavatars_tpu.

Mirrors the JAX package's module paths (`ops/projection.py` here is the
counterpart of `gaussianavatars_tpu/ops/projection.py`, and so on). Plain
tensor code is PyTorch; each Pallas kernel of the JAX package becomes a
hand-written CUDA kernel under `csrc/`, built at first use into
`build/torch_kernels/` and bound with ctypes (`cuda_build.py`).

The package imports nothing of JAX and nothing of `gaussianavatars_tpu`.
Entry points default to ``device="cuda"`` and raise when there is no card;
CPU tensors run each kernel's plain PyTorch version.

Ported so far: the render path, FLAME → binding → world Gaussians →
projection + SH → sorted binning → pair compositor (`render.AvatarRenderer`),
and the training step over it, FLAME-bound or unbound (a point cloud),
with the backward compositor kernel (`training.trainer.make_train_step`),
in float32 or with `use_amp`;
every implementation of the compositor kernels (v2, v3, v4) and the A/B of
them (`tools.kernel_ab`); the host loop that fits an avatar
(`tools.train_synthetic`) and the training CLI over it (`tools.train`,
with the viewer server of `viewers.network_gui` and the debug hooks of
`utils.debug`; Blender, DynamicNerf and COLMAP datasets); and the replay of a trained avatar: loading
(`models.io`), offline render and metrics with LPIPS (`tools.render`,
`tools.metrics`, `metrics`), the viewer core
(`viewers.local.AvatarViewerCore`), the viewers over it and over the
training server (`tools.local_viewer`, `tools.remote_viewer`) and the FPS
benchmarks; the table pipeline (`use_pallas=False`: the padded-table
binning and compositor of `ops.rasterize_tiled`) through the render, the
step, the loop and the tools; the profiling tools
(`utils.profiling`, `utils.roofline`, `tools.stage_timings`); and on the
card, chunks of training steps and rendered frames as CUDA graphs, one
captured graph replayed once a step or a frame (`utils.graphs`).
"""

__version__ = "0.1.0"
