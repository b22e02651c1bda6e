"""A cell cut to a size the CPU runs in seconds: a 200-vertex sphere without
teeth, one Gaussian a face, 8 shape and 4 expression components, 64×48
images in 16×16 tiles, two cameras and three timesteps. Everything else
(the traffic's mode, the limits) is the real cell's."""
from __future__ import annotations

import json

import torch

from avatar_bench import run as bench

TINY = dict(num_verts=200, n_shape=8, n_expr=4, add_teeth=False, per_face=1, gaussians=360,
            capacity=384, width=64, height=48, tile=16, cameras=2, timesteps=3)
TRAFFIC = {"reenact": dict(poses=64, probe=4, warmup=2, settle_s=0.2, compare=3,
                           compare_within=20, trace_frames=4),
           "fit-steady": dict(steps_per_call=4, settle_s=0.2, probe_timesteps=2, trace_calls=1),
           "fit-progressive": dict(steps_per_call=4, settle_s=0.2, probe_timesteps=2,
                                   trace_calls=1)}


# A frame large enough for TF32's error to show against the serving limits
# (at TINY's 360 Gaussians it stays under them): 2,400 Gaussians at 128×88.
SMALL = dict(TINY, num_verts=1250, n_shape=300, n_expr=100, gaussians=2400, capacity=2560,
             width=128, height=88)


def tiny_run(workload: str, seed: int = 123456789012, seconds: float = 3.0,
             size: dict = TINY) -> bench.Run:
    # One intra-op thread: test workers share the cores.
    torch.set_num_threads(1)
    spec = bench.Spec()
    w = spec.workload(workload)
    cfg = dict(spec.config(w["config"]), **size)
    traffic = dict(spec.traffic(w["traffic"]), **TRAFFIC[w["traffic"]])
    return bench.Run(workload, w["chips"], cfg, traffic, spec.limits(workload), seed, seconds,
                     False, torch.device("cpu"))


def cell_config(workload: str) -> dict:
    spec = bench.Spec()
    return json.loads(json.dumps(spec.config(spec.workload(workload)["config"])))
