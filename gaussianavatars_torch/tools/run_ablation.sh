#!/usr/bin/env bash
# Ablation runner (reference `run_ablation.sh:20-100`): trains the baseline,
# each innovation alone, and the all-innovations config, then evaluates all,
# through the PyTorch port's train, render and metrics tools.
#
# Usage: gaussianavatars_torch/tools/run_ablation.sh <source_path> <output_root> \
#            [extra train flags...]
# Extra flags go to the trainer; a `--device D` among them also goes to the
# render and metrics tools. $PYTHON picks the interpreter. Run from a
# directory where `gaussianavatars_torch` imports (the repository root).
set -euo pipefail

SRC="${1:?source_path}"
OUT="${2:?output_root}"
shift 2
EXTRA=("$@")
PY=${PYTHON:-python}
DEVICE=()
for ((i = 0; i < ${#EXTRA[@]}; i++)); do
  case "${EXTRA[$i]}" in
    --device) DEVICE=(--device "${EXTRA[$((i + 1))]:?--device needs a value}") ;;
    --device=*) DEVICE=("${EXTRA[$i]}") ;;
  esac
done

declare -A CONFIGS=(
  [baseline]=""
  [innov1_region]="--use_region_adaptive_loss"
  [innov2_smartdens]="--use_smart_densification"
  [innov3_progressive]="--use_progressive_resolution"
  [innov4_colorcal]="--use_color_calibration"
  [innov5_contrastive]="--use_contrastive_reg"
  [all_innovations]="--all_innovations"
)

for name in baseline innov1_region innov2_smartdens innov3_progressive \
            innov4_colorcal innov5_contrastive all_innovations; do
  flags=${CONFIGS[$name]}
  model="$OUT/$name"
  echo "=== training $name ==="
  # shellcheck disable=SC2086
  "$PY" -m gaussianavatars_torch.tools.train -s "$SRC" -m "$model" --bind_to_mesh --eval \
      $flags ${EXTRA[@]+"${EXTRA[@]}"}
  echo "=== rendering $name ==="
  "$PY" -m gaussianavatars_torch.tools.render -m "$model" --skip_train --quiet \
      ${DEVICE[@]+"${DEVICE[@]}"}
  echo "=== metrics $name ==="
  "$PY" -m gaussianavatars_torch.tools.metrics -m "$model" ${DEVICE[@]+"${DEVICE[@]}"}
done

echo "=== summary ==="
for name in "${!CONFIGS[@]}"; do
  f="$OUT/$name/results.json"
  [ -f "$f" ] && echo "$name: $(cat "$f")"
done
