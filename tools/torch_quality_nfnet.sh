#!/usr/bin/env bash
# Headline-scale quality rehearsal of the PyTorch port: the JAX recipe
# tools/quality_nfnet.sh (NFNet-L0 at 224^2, tiny BERT at random init, the
# offline synthetic dataset, nq=100, mb=100, syn_steps=8, bf16 inner,
# forward-HVP) through the port's three CLIs on the CUDA card, with the
# hand-written grouped-conv kernels on.  The JAX recipe's flags are kept as
# they are (the port warns about --scan_unroll and ignores it); on top:
#   --pallas_gconv $PALLAS  the kernels (the JAX runs used XLA's conv);
#   --seed=$SEED            the CLIs' seed: expert and student inits,
#                           shuffles, the real-pair init;
#   --eval_it / --num_eval  eval blocks every EVAL_IT iterations, NUM_EVAL
#                           students each;
#   --draw True --ipc=50    the distill CLI writes distilled_{it}.npz only
#                           under --draw; ipc >= 50 skips its two image
#                           grids, as the reference gates them.
# Then cli.eval_distilled scores the distilled set, its iteration-0 init
# and a random-pixel control with NEVAL students each.  The distill CLI
# runs in process under a wrapper that prints, last, the grouped-conv
# kernel launches (ops/gconv.py LAUNCHES), the host time of each outer
# step's call and the NaN bail-out; MDD_DEBUG_HBM=1 (the default here)
# prints the allocator's peak around each eval block.
#
# Knobs: SEED (0); WORK (default $TMPDIR/torch_quality_nfnet, wiped
# first); NEXP (experts, 1), TEPOCHS (expert epochs, 4); ITERS (100),
# EVAL_IT (50), NUM_EVAL (2), CKPT_IT (--ckpt_it, unset); PALLAS (True);
# NEVAL (eval_distilled students per set, 3; 0 skips the scoring);
# BUFFERS (another run's work dir: its experts are reused and none are
# trained); RESUME (a distill_ckpt_{it}.pt: --resume_from; its run has no
# iteration-0 set, so set NEVAL=0); LOAD_ALL (1: --load_all True, every
# buffer file read once and each trajectory's device copy kept, where the
# default re-reads a file at each change of file).  PRINT_ARGS=1 prints
# the buffer and distill command lines and exits.  Exits non-zero on a crash, a NaN
# bail-out or a missing artifact; a quality miss is printed, not fatal.
#
# On the card, the JAX recipe's run:
#   SEED=0 CKPT_IT=50 bash tools/torch_quality_nfnet.sh
# and its 400-iteration soak (tools/quality_soak2000.sh's shape, its
# trajectories resident as the JAX soak's):
#   NEXP=3 ITERS=400 EVAL_IT=100 CKPT_IT=100 NEVAL=0 LOAD_ALL=1 \
#     bash tools/torch_quality_nfnet.sh
# tools/torch_quality_summary.py reads the work directories (--rule: the
# decision rule across the runs).

set -euo pipefail
for v in MDD_PALLAS_GCONV MDD_FUSED_JVP MDD_STEM_S2D; do
  if [[ -n ${!v+set} ]]; then
    echo "torch_quality_nfnet.sh: $v is set; it would override the" \
         "recipe's route: unset it" >&2
    exit 4
  fi
done
cd "$(dirname "$0")/.."
REPO=$(pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
export MDD_DEBUG_HBM=${MDD_DEBUG_HBM:-1}
PKG=multimodal_dataset_distillation_tpu_torch.cli
WORK=$(realpath -m "${WORK:-${TMPDIR:-/tmp}/torch_quality_nfnet}")
BUFFERS=$(realpath -m "${BUFFERS:-$WORK}")/buffers
ITERS=${ITERS:-100}
PALLAS=${PALLAS:-True}
NEVAL=${NEVAL:-3}

COMMON=(--dataset=synthetic --image_encoder=nfnet --text_encoder=bert
  --text_encoder_config=tiny --image_size=224 --synthetic_size=512
  --synthetic_test_size=64 --seed="${SEED:-0}")
BUFFER_ARGS=("${COMMON[@]}" --num_experts="${NEXP:-1}"
  --train_epochs="${TEPOCHS:-4}" --batch_size_train=64 --batch_size_test=64
  --buffer_path="$BUFFERS" --lr_teacher_img=0.05 --lr_teacher_txt=0.05
  --train_dtype=bfloat16)
DISTILL_ARGS=("${COMMON[@]}" --num_queries=100 --mini_batch_size=100
  --syn_steps=8 --expert_epochs=1 --max_start_epoch=3 --Iteration="$ITERS"
  --eval_it="${EVAL_IT:-50}" --num_eval="${NUM_EVAL:-2}" --epoch_eval_train=4
  --batch_train=50 --batch_size_test=64
  --buffer_path="$BUFFERS/synthetic/nfnet/bert" --save_dir=./logged_files
  --lr_img=100 --lr_txt=100 --lr_lr=1e-5 --lr_teacher_img=0.1
  --lr_teacher_txt=0.1 --inner_dtype=bfloat16 --scan_unroll=2
  --hvp_mode=forward --std True --pallas_gconv "$PALLAS" --draw True --ipc=50)
[[ -n ${CKPT_IT:-} ]] && DISTILL_ARGS+=(--ckpt_it="$CKPT_IT")
[[ -n ${RESUME:-} ]] && DISTILL_ARGS+=(--resume_from="$(realpath "$RESUME")")
[[ ${LOAD_ALL:-0} == 1 ]] && DISTILL_ARGS+=(--load_all True)
if [[ -n ${PRINT_ARGS:-} ]]; then
  echo "buffer ${BUFFER_ARGS[*]}"
  echo "distill ${DISTILL_ARGS[*]}"
  exit 0
fi

rm -rf "$WORK" && mkdir -p "$WORK"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$WORK/card.txt" \
  || echo "no nvidia-smi" > "$WORK/card.txt"
cd "$WORK"
now() { date +%s.%N; }
T1=$(now)
if [[ $BUFFERS == "$WORK/buffers" ]]; then
  echo "== phase 1: ${NEXP:-1} NFNet-L0 expert(s) at 224^2, bf16 (cli.buffer) =="
  python -m $PKG.buffer "${BUFFER_ARGS[@]}" 2>&1 | tee buffer.log
fi
FILES=("$BUFFERS"/synthetic/nfnet/bert/img_replay_buffer_*.npz)
if [[ ! -e ${FILES[0]} ]]; then
  echo "no expert buffers under $BUFFERS" >&2
  exit 1
fi

echo "== phase 2: distill, $ITERS iterations, pallas_gconv $PALLAS =="
T2=$(now)
python - "${DISTILL_ARGS[@]}" <<'PY' 2>&1 | tee distill.log
import json, sys, time

from multimodal_dataset_distillation_tpu_torch.cli import distill as cli
from multimodal_dataset_distillation_tpu_torch.config import Config, parse_config
from multimodal_dataset_distillation_tpu_torch.engine.distill import Distiller
from multimodal_dataset_distillation_tpu_torch.ops import gconv

calls, step = [], Distiller.step_traj


def timed(self, *a, **k):
    calls.append(time.perf_counter())
    return step(self, *a, **k)


Distiller.step_traj = timed
cfg = parse_config(sys.argv[1:], defaults=Config(image_encoder="nfnet",
                                                 Iteration=5000))
gconv.reset_launches()
t0 = time.perf_counter()
distiller, _ = cli.main(cfg)
print("distill wrapper: " + json.dumps({
    "launches": dict(gconv.LAUNCHES), "wall_s": time.perf_counter() - t0,
    "step_calls_s": [t - t0 for t in calls],
    "nan_bailout_it": distiller.nan_bailout_it}), flush=True)
sys.exit(1 if distiller.nan_bailout_it is not None else 0)
PY

NPZ=$(ls ./logged_files/synthetic/*/distilled_"$ITERS".npz)
T3=$(now)
if (( NEVAL > 0 )); then
  INIT=$(ls ./logged_files/synthetic/*/distilled_0.npz)
  python - "$NPZ" <<'PY'
import sys, numpy as np
z = np.load(sys.argv[1])
rng = np.random.RandomState(0)
np.savez("random_control.npz",
         image_syn=rng.randn(*z["image_syn"].shape).astype(np.float32),
         text_syn=rng.randn(*z["text_syn"].shape).astype(np.float32),
         syn_lr_img=z["syn_lr_img"], syn_lr_txt=z["syn_lr_txt"])
PY
  for SET in distilled:"$NPZ" init:"$INIT" random:./random_control.npz; do
    echo "== eval: ${SET#*:} =="
    python -m $PKG.eval_distilled "${COMMON[@]}" --distilled_npz="${SET#*:}" \
      --num_eval="$NEVAL" --epoch_eval_train=4 --batch_train=50 \
      --batch_size_test=64 --std True --parallel_eval False \
      --pallas_gconv "$PALLAS" 2>&1 | tee "eval_${SET%%:*}.log"
  done
fi
T4=$(now)

python "$REPO/tools/torch_quality_summary.py" "$WORK" \
  buffer="$T1" distill="$T2" eval="$T3" end="$T4"
echo "== done; artifacts in $WORK =="
