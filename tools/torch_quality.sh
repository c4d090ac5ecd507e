#!/usr/bin/env bash
# Quality rehearsal of the PyTorch port: the expert CLI -> cli.distill ->
# cli.eval_distilled over an offline fixture written by
# tools/torch_make_fixtures.py, on one of two annotation paths:
#   roco  cli.buffer_roco on the reference's ROCOv2 CSV (id,name,caption,
#         256 rows; one truncated JPEG and one missing file, so the
#         black-image fallback runs inside every training job);
#   coco  cli.buffer on the reference's Karpathy JSON containers (train
#         rows with repeated image_ids, 5-caption val/test rows, images
#         under val2014/; 256 train images, 32 eval).
#
# The recipe is tools/quality_{roco,coco}.sh's: ConvNet at 32², BERT tiny
# with the hashing tokenizer, 3 experts, nq=16, syn_steps=4,
# lr_img=lr_txt=10, lr_lr=1e-6.  The distilled set is scored against its
# own iteration-0 init and a random-pixel control; the last lines give
# r_mean, mean ± std over the NEVAL students, for each set.  Knobs
# (defaults as in the JAX recipes): TEPOCHS (expert epochs), MSE (max
# start epoch), ITERS (outer steps), NEVAL (eval students), EEPOCHS (eval
# epochs), WORK (work dir, default $TMPDIR/torch_quality_<dataset>); SEED
# (default 0), the CLIs' --seed: expert and student inits, shuffles.
#
# Runs on the CUDA card (the port's default device; without one the CLIs
# raise):
#   TEPOCHS=16 MSE=12 ITERS=600 NEVAL=5 bash tools/torch_quality.sh roco
# tools/torch_quality_roco.sh and tools/torch_quality_coco.sh call it so.

set -euo pipefail
DATASET=${1:?usage: torch_quality.sh roco|coco}
cd "$(dirname "$0")/.."
REPO=$(pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
PKG=multimodal_dataset_distillation_tpu_torch.cli
WORK=${WORK:-${TMPDIR:-/tmp}/torch_quality_$DATASET}
ITERS=${ITERS:-300}
case $DATASET in
  roco) FIXTURE=(roco "$WORK/fixture" 256)
        ANN=$WORK/fixture/radiologytraindata.csv
        BUFFER_CLI=buffer_roco ;;
  coco) FIXTURE=(coco "$WORK/fixture" 256 32)
        ANN=$WORK/fixture/ann
        BUFFER_CLI=buffer ;;
  *) echo "usage: torch_quality.sh roco|coco" >&2; exit 2 ;;
esac
rm -rf "$WORK" && mkdir -p "$WORK"
now() { date +%s.%N; }
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$WORK/card.txt" \
  || echo "no nvidia-smi" > "$WORK/card.txt"
T0=$(now)

python "$REPO/tools/torch_make_fixtures.py" "${FIXTURE[@]}"
cd "$WORK"

COMMON="--dataset=$DATASET --image_root=$WORK/fixture/images \
  --ann_root=$ANN \
  --text_encoder=bert --text_encoder_config=tiny --image_size=32 \
  --batch_size_test=32 --disable_wandb True --seed=${SEED:-0}"

echo "== phase 1: $DATASET expert buffers (cli.$BUFFER_CLI, convnet tower) =="
T1=$(now)
python -m $PKG.$BUFFER_CLI $COMMON --image_encoder=convnet \
  --num_experts=3 --train_epochs=${TEPOCHS:-8} --batch_size_train=32 \
  --buffer_path=./buffers --lr_teacher_img=0.1 --lr_teacher_txt=0.1

echo "== phase 2: distill on the $DATASET loader =="
T2=$(now)
python -m $PKG.distill $COMMON --image_encoder=convnet \
  --num_queries=16 --mini_batch_size=16 --syn_steps=4 --expert_epochs=2 \
  --max_start_epoch=${MSE:-6} --Iteration=$ITERS --eval_it=$ITERS --num_eval=1 \
  --epoch_eval_train=4 --batch_train=16 \
  --buffer_path=./buffers/$DATASET/convnet/bert \
  --save_dir=./logged_files --draw True \
  --lr_img=10 --lr_txt=10 --lr_lr=1e-6 | tee distill.log

NPZ=$(ls ./logged_files/$DATASET/*/distilled_$ITERS.npz | head -1)
INIT=$(ls ./logged_files/$DATASET/*/distilled_0.npz | head -1)
echo "== distilled: $NPZ  init: $INIT =="

python - "$NPZ" <<'PY'
import sys, numpy as np
z = np.load(sys.argv[1])
rng = np.random.RandomState(0)
np.savez("random_control.npz",
         image_syn=rng.randn(*z["image_syn"].shape).astype(np.float32),
         text_syn=rng.randn(*z["text_syn"].shape).astype(np.float32),
         syn_lr_img=z["syn_lr_img"], syn_lr_txt=z["syn_lr_txt"])
PY

T3=$(now)
for SET in distilled:"$NPZ" init:"$INIT" random:./random_control.npz; do
  echo "== eval: ${SET#*:} =="
  python -m $PKG.eval_distilled $COMMON --image_encoder=convnet \
    --distilled_npz="${SET#*:}" --num_eval=${NEVAL:-3} --epoch_eval_train=${EEPOCHS:-4} \
    --batch_train=16 --std True --parallel_eval False | tee "eval_${SET%%:*}.log"
done
T4=$(now)

python "$REPO/tools/torch_quality_summary.py" "$WORK" \
  fixture=$T0 buffer=$T1 distill=$T2 eval=$T3 end=$T4
echo "== done; artifacts in $WORK =="
