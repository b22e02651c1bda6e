"""Turn a `tools/train_synthetic --quality --json_out` result into a
Markdown quality report.

The port of the JAX package's `scripts/quality_report.py` (no framework
import): the operating point, the train-view trajectory (loss, PSNR,
splat count, wall clock, image scale), the final held-out evaluation and
the sustained rate.

    python -m gaussianavatars_torch.tools.train_synthetic --quality --json_out q.json
    python -m gaussianavatars_torch.tools.quality_report q.json report.md
"""
from __future__ import annotations

import json
import sys


def fmt_eval(m: dict) -> str:
    extra = f" · LPIPS {m['lpips']:.4f}" if "lpips" in m else ""
    return f"PSNR **{m['psnr']:.2f} dB** · SSIM **{m['ssim']:.4f}**{extra} ({m['n']} views)"


def report(r: dict) -> str:
    """The report's Markdown for a `train_synthetic` result dict."""
    a, logs = r["args"], r["logs"]
    its = a["iterations"]
    amp = " --use_amp" if a.get("use_amp") else ""
    lines = [
        "# Quality: end-to-end recipe run at the reference operating point",
        "",
        "Self-reconstruction of a randomised synthetic avatar (synthetic FLAME",
        "topology with teeth) with the full recipe: densification, opacity",
        "resets, SH warm-up and, under `--quality`, all five innovations.",
        "Reference context: the baseline ladder in `INNOVATIONS_5.md:9-17`",
        "(PSNR 32.1, 92k splats, 600k iterations).",
        "",
        "## Operating point",
        "",
        f"- image {a['width']}×{a['height']}, {a['cameras']} cameras × "
        f"{a['timesteps']} timesteps",
        f"- {its} iterations, densify every 250 from 500, opacity reset every "
        f"{a['opacity_reset_interval']}, SH warm-up",
        "- innovations: " + ("all 5 (region-adaptive loss, smart densification, "
                             "progressive resolution, colour calibration, contrastive reg)"
                             if a.get("all_innovations") else "none")
        + (", bf16 AMP" if a.get("use_amp") else ""),
        f"- reproduce: `python -m gaussianavatars_torch.tools.train_synthetic --quality{amp}"
        " --json_out q.json && python -m gaussianavatars_torch.tools.quality_report q.json"
        " report.md`",
        "",
        "## Trajectory (train-view PSNR / splat count)",
        "",
        "| iteration | loss | PSNR (dB) | #Gaussians | scale | wall (min) |",
        "|---|---|---|---|---|---|",
    ]
    # ~12 evenly spaced rows plus the last.
    rows = logs[::max(1, len(logs) // 12)]
    if rows[-1] is not logs[-1]:
        rows.append(logs[-1])
    for rec in rows:
        lines.append(
            f"| {rec['iteration']} | {rec['loss']:.4f} | {rec['psnr']:.2f} "
            f"| {rec['num_points']} | {rec.get('resolution_scale', 1.0)} "
            f"| {rec['elapsed_s'] / 60:.1f} |")
    lines += [
        "", "## Final held-out evaluation", "",
        "**test** holds out a middle timestep across the training cameras",
        "(self-reenactment with dataset FLAME parameters the optimiser never",
        "touched); **val** holds out camera 0 entirely (a novel view).", "",
    ]
    if "eval_val" in r:
        lines.append(f"- **val (novel view)**: {fmt_eval(r['eval_val'])}")
    if "eval_test" in r:
        lines.append(f"- **test (novel timestep, self-reenactment)**: {fmt_eval(r['eval_test'])}")
    wall_s = logs[-1]["elapsed_s"]
    lines += [
        "",
        f"Final splat count **{logs[-1]['num_points']}**, training wall clock "
        f"**{wall_s / 60:.1f} min** for {its} iterations "
        f"({its / max(wall_s, 1e-9):.1f} it/s sustained, host events included).",
        "",
    ]
    return "\n".join(lines)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        raise SystemExit("usage: quality_report RESULT.json REPORT.md")
    with open(argv[0]) as f:
        text = report(json.load(f))
    with open(argv[1], "w") as f:
        f.write(text)
    print(f"wrote {argv[1]}")


if __name__ == "__main__":
    main()
