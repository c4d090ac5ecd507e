#!/usr/bin/env bash
# Quality rehearsal of the PyTorch port on the ROCO fixture: tools/torch_quality.sh
# roco, which gives the recipe and its knobs.  On the CUDA card:
#   TEPOCHS=16 MSE=12 ITERS=600 NEVAL=5 bash tools/torch_quality_roco.sh
exec bash "$(dirname "$0")/torch_quality.sh" roco "$@"
