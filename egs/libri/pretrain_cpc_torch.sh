#!/bin/bash
# CPC pretraining (pretrain_cpc.sh) with the PyTorch port, on the GPU; extra arguments after the
# config go to the CLI (--continue-training, --device cpu).
#   bash pretrain_cpc_torch.sh configs/pretrain_100h.yaml [--continue-training]
set -e
source path.sh
config=${1:-configs/pretrain_100h.yaml}
shift $(( $# < 1 ? $# : 1 ))
python -m openasr_torch.bin.train_cpc --type pretrain $config "$@"
