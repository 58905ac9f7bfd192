#!/bin/bash
# CPC pretraining (train_cpc.sh) with the PyTorch port, on the GPU; extra arguments after the
# config go to the CLI (--continue-training, --device cpu).
#   bash train_cpc_torch.sh configs/cpc_pretrain.yaml [--continue-training]
set -e
source path.sh
config=${1:-configs/cpc_pretrain.yaml}
shift $(( $# < 1 ? $# : 1 ))
python -m openasr_torch.bin.train_cpc --type pretrain $config "$@"
