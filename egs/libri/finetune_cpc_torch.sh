#!/bin/bash
# GRU-CTC finetuning (finetune_cpc.sh) with the PyTorch port, on the GPU; extra arguments after the
# config go to the CLI (--continue-training, --device cpu).
#   bash finetune_cpc_torch.sh configs/finetune_char.yaml [--continue-training]
set -e
source path.sh
config=${1:-configs/finetune_char.yaml}
shift $(( $# < 1 ? $# : 1 ))
python -m openasr_torch.bin.train_cpc --type finetune $config "$@"
