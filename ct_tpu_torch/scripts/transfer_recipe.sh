#!/bin/bash
# The transfer protocol's full recipe on one card, the port's counterpart
# of the JAX package's scripts/r5_tpu_queue2.sh: build3 (COCO-60 1,800 +
# 128 images, the few-shot VOC fixture), phase 1 (COCO-60, 9,000
# iterations at batch 64, bf16), its COCO eval, phase 2 (transfer, 5-shot,
# 600 iterations), its VOC eval, then each eval's detections against the
# JAX package's tracked ones (a reading: the random streams differ).
#
#   bash ct_tpu_torch/scripts/transfer_recipe.sh OUT LOGS [PHASE1_ITERS]
#
# OUT holds the fixtures, phase1.pth, ref_model.pth and the evals; LOGS
# gets one log a step (no weights). Run from the repository root.
set -o pipefail
OUT=${1:?output folder}
LOGS=${2:?log folder}
ITERS1=${3:-9000}
RP="python -m ct_tpu_torch.scripts.real_parity"
DIFF="python -m ct_tpu_torch.tools.diff_detections"
mkdir -p "$OUT" "$LOGS"
step() {
    local name=$1
    shift
    local t0=$SECONDS
    "$@" > "$LOGS/$name.txt" 2>&1
    local rc=$?
    echo "$name: exit $rc, $((SECONDS - t0)) s"
    tail -n 3 "$LOGS/$name.txt"
    return $rc
}
step build3 $RP build3 --out "$OUT" --images 1800 --test-images 128 \
  && step train $RP train --out "$OUT" --dataset COCO --iters "$ITERS1" \
      --batch 64 --export-name phase1.pth \
  && step eval_coco $RP eval-ours --out "$OUT" --dataset COCO --phase 1 \
      --setting transfer --load-name phase1.pth \
  && step train2 $RP train2 --out "$OUT" --setting transfer --shot 5 \
      --iters 600 --batch 64 \
  && step eval $RP eval-ours --out "$OUT" --phase 2 --setting transfer \
  && step diff_coco $DIFF "$OUT/ours_eval_coco/inference/detections.pkl" \
      .parity_tr/ours_eval_coco/inference/detections.pkl \
  && step diff $DIFF "$OUT/ours_eval/inference/detections.pkl" \
      .parity_tr/ours_eval/inference/detections.pkl
rc=$?
cp "$OUT"/*.json "$LOGS"/ 2>/dev/null
exit $rc
