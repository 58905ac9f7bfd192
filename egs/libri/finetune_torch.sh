#!/bin/bash
# GRU-CTC finetuning (finetune.sh) with the PyTorch port, on the GPU; extra arguments after the
# config go to the CLI (--continue-training, --device cpu).
#   bash finetune_torch.sh configs/gru_ctc_finetune.yaml [--continue-training]
set -e
source path.sh
config=${1:-configs/gru_ctc_finetune.yaml}
shift $(( $# < 1 ? $# : 1 ))
python -m openasr_torch.bin.train_cpc --type finetune $config "$@"
