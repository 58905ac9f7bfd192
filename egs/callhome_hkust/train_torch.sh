#!/bin/bash
# Train (train.sh) with the PyTorch port, on the GPU; extra arguments after the
# config go to the CLI (--continue-training, --device cpu).
#   bash train_torch.sh configs/cif_mix.yaml [--continue-training]
set -e
source path.sh
config=${1:-configs/cif_mix.yaml}
shift $(( $# < 1 ? $# : 1 ))
python -m openasr_torch.bin.train $config "$@"
