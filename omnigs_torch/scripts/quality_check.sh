#!/bin/bash
# Quality gate of the PyTorch port: TWO short training runs (seeds 1 and 2)
# on the PINNED 512x256 synthetic scene through the port's own CLIs; the
# MEDIAN of their held-out PSNRs must be at least GATE_PSNR - 0.5 dB.
#
#   Pinned scene:  omnigs_torch.scripts.make_synthetic_scene --seed 1234
#                  (512x256, 12 train / 4 test views)
#   Training:      cfg/lonlat/synthetic_medium.yaml, 1,500 iterations
#   GATE_PSNR:     the JAX package's bar (scripts/quality_check.sh), a mean
#                  held-out PSNR measured on a TPU
#   Bar:           GATE_PSNR - 0.5 dB on the median of the 2 runs
#
# An unpinned scene (an explicit SCENE_DIR) falls back to the collapse
# floor 15.0: absolute PSNR is scene-dependent.
# Usage: omnigs_torch/scripts/quality_check.sh [SCENE_DIR] [OUT_DIR]
# DEVICE=cpu runs it on the CPU (slow at this size).
set -u -o pipefail
GATE_PSNR=17.07
DEVICE=${DEVICE:-cuda}
REPO=$(cd "$(dirname "$0")/../.." && pwd)
OUT=${2:-$REPO/build/quality_check}
SCENE=${1:-$OUT/scene_pinned}
if [ $# -ge 1 ]; then
  BAR=15.0
else
  BAR=$(python3 -c "print($GATE_PSNR - 0.5)")
fi
cd "$REPO"
CFG=cfg/lonlat/synthetic_medium.yaml
[ -d "$SCENE" ] || python3 -m omnigs_torch.scripts.make_synthetic_scene "$SCENE" \
  --seed 1234 --device "$DEVICE" || exit 1
dirs=""
for seed in 1 2; do
  RUN="$OUT/run$seed"
  rm -rf "$RUN"; mkdir -p "$RUN"
  python3 -m omnigs_torch.examples.train_openmvg_lonlat "$CFG" \
    "$RUN" "$SCENE/sfm_data_train.json" "$SCENE/points.ply" \
    --image-root "$SCENE/images" --iters 1500 --log-every 500 \
    --seed $seed --device "$DEVICE" 2>&1 | tee "$RUN/train.log" || exit 1
  ply=$(ls -d "$RUN"/*/ply/point_cloud.ply 2>/dev/null | tail -1)
  python3 -m omnigs_torch.examples.test_openmvg_lonlat "$CFG" \
    "$RUN/test" "$SCENE/sfm_data_test.json" "$ply" --device "$DEVICE" \
    2>&1 | tee "$RUN/test.log" || exit 1
  dirs="$dirs $RUN/test"
done
python3 -m omnigs_torch.scripts.psnr_gate "$BAR" $dirs
