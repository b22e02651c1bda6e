"""Offline metrics over rendered splits.

The port of the JAX package's `scripts/metrics.py` (the reference's
`metrics.py:36-103`), with the same flags plus `--device`: walks
`<model>/<split>/<method>/{renders,gt}`, computes PSNR, SSIM and LPIPS
(LPIPS only when a weights file is given: `--lpips_weights` or
`$GSAVATARS_LPIPS_WEIGHTS`, see `metrics/lpips.py`; none is in the
repository), and writes `results.json` and `per_view.json` in each model
directory.

    python -m gaussianavatars_torch.tools.metrics -m MODEL_DIR [--splits val test] \\
        [--lpips_weights FILE.npz] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..metrics import load_lpips_weights, lpips as lpips_fn, psnr, ssim


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_paths", "-m", nargs="+", required=True)
    p.add_argument("--splits", nargs="+", default=["test"])
    p.add_argument("--lpips_weights", type=str,
                   default=os.environ.get("GSAVATARS_LPIPS_WEIGHTS", ""))
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _load_dir(path):
    from PIL import Image

    names = sorted(n for n in os.listdir(path) if n.endswith(".png"))
    for n in names:
        yield n, np.asarray(Image.open(os.path.join(path, n)).convert("RGB"),
                            np.float32) / 255.0


@torch.no_grad()
def evaluate_model(model_path: str, splits, lpips_params=None, device="cuda") -> dict:
    """{"results": {split/method: {metric: mean}}, "per_view": {split/method:
    {metric: {png name: value}}}} over the PNG pairs of the splits."""
    dev = resolve_device(device)
    results, per_view = {}, {}
    for split in splits:
        split_dir = os.path.join(model_path, split)
        if not os.path.isdir(split_dir):
            continue
        for method in sorted(os.listdir(split_dir)):
            rdir = os.path.join(split_dir, method, "renders")
            gdir = os.path.join(split_dir, method, "gt")
            if not (os.path.isdir(rdir) and os.path.isdir(gdir)):
                continue
            rows = {"psnr": {}, "ssim": {}, "lpips": {}}
            gts = dict(_load_dir(gdir))
            for name, img in _load_dir(rdir):
                if name not in gts:
                    continue
                x = torch.from_numpy(img).to(dev)
                y = torch.from_numpy(gts[name]).to(dev)
                rows["psnr"][name] = float(psnr(x, y))
                rows["ssim"][name] = float(ssim(x.permute(2, 0, 1), y.permute(2, 0, 1)))
                if lpips_params is not None:
                    rows["lpips"][name] = float(lpips_fn(lpips_params, x, y))
            key = f"{split}/{method}"
            results[key] = {m: float(np.mean(list(v.values()))) for m, v in rows.items() if v}
            per_view[key] = rows
            print(f"{model_path} {key}: " + "  ".join(
                f"{m.upper()}={v:.4f}" for m, v in results[key].items()))
    return {"results": results, "per_view": per_view}


def main(argv=None) -> dict:
    """Evaluate every model directory, each written out before the next;
    returns {model path: evaluate_model's result}. A model directory that
    fails is reported and the rest still run; then the failure is raised."""
    a = parse_args(argv)
    dev = resolve_device(a.device)
    lp = None
    if a.lpips_weights and os.path.exists(a.lpips_weights):
        lp = load_lpips_weights(a.lpips_weights, device=dev)
    else:
        print("[info] no LPIPS weights (set --lpips_weights or "
              "$GSAVATARS_LPIPS_WEIGHTS) — reporting PSNR/SSIM only")
    out, failed = {}, {}
    for mp in a.model_paths:
        try:
            out[mp] = evaluate_model(mp, a.splits, lp, device=dev)
            with open(os.path.join(mp, "results.json"), "w") as f:
                json.dump(out[mp]["results"], f, indent=2)
            with open(os.path.join(mp, "per_view.json"), "w") as f:
                json.dump(out[mp]["per_view"], f, indent=2)
        except Exception as e:  # report, finish the other models, then raise
            print(f"[error] {mp}: {e}")
            failed[mp] = e
    if failed:
        raise RuntimeError(f"metrics failed for {sorted(failed)}") from next(iter(failed.values()))
    return out


if __name__ == "__main__":
    main()
