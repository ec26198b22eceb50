#!/bin/bash
# The full training protocol through the port's CLIs on the full-res
# synthetic scene, as scripts/protocol_run.sh: train 32,010 iterations of
# cfg/lonlat/synthetic_protocol.yaml with eval + PLY every 8,000, then the
# held-out test eval of the 8,000 and 32,000 checkpoints.
# Usage: omnigs_torch/scripts/protocol_run.sh [SCENE_DIR] [RESULT_DIR] [EXTRA_TRAIN_ARGS...]
#   e.g. a short cut: protocol_run.sh "" "" --iters 50
#
# A missing SCENE_DIR is made with the pinned draw of the JAX script:
#   python -m omnigs_torch.scripts.make_synthetic_scene SCENE_DIR \
#     --width 1920 --height 960 --gaussians 32768 --train-views 16
# DEVICE=cpu runs on the CPU (far too slow at this size); CFG overrides
# the YAML.
set -u -o pipefail
REPO=$(cd "$(dirname "$0")/../.." && pwd)
SCENE=${1:-$REPO/build/scene_fullres}
OUT=${2:-$REPO/build/proto_out}
[ -n "$SCENE" ] || SCENE=$REPO/build/scene_fullres
[ -n "$OUT" ] || OUT=$REPO/build/proto_out
[ $# -ge 1 ] && shift
[ $# -ge 1 ] && shift
DEVICE=${DEVICE:-cuda}
CFG=${CFG:-cfg/lonlat/synthetic_protocol.yaml}
cd "$REPO"
[ -d "$SCENE" ] || python3 -m omnigs_torch.scripts.make_synthetic_scene "$SCENE" \
  --width 1920 --height 960 --gaussians 32768 --train-views 16 \
  --device "$DEVICE" || exit 1
mkdir -p "$OUT"
python3 -m omnigs_torch.examples.train_openmvg_lonlat \
  "$CFG" "$OUT" \
  "$SCENE/sfm_data_train.json" "$SCENE/points.ply" \
  --image-root "$SCENE/images" --device "$DEVICE" "$@" 2>&1 | tee -a "$OUT/train.log"
rc=$?
echo "[protocol] train rc=$rc"
for it in 8000 32000; do
  ply="$OUT/$it/ply/point_cloud.ply"
  if [ -f "$ply" ]; then
    python3 -m omnigs_torch.examples.test_openmvg_lonlat \
      "$CFG" "$OUT/${it}_test" \
      "$SCENE/sfm_data_test.json" "$ply" --image-root "$SCENE/images" \
      --device "$DEVICE" 2>&1 | tee -a "$OUT/test_${it}.log"
    echo "[protocol] test@$it rc=$?"
  else
    echo "[protocol] no checkpoint for iter $it"
  fi
done
exit $rc
