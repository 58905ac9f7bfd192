#!/bin/bash
# Average the last N epoch checkpoints with the PyTorch port (avg.sh):
# writes <exp_dir>/avgN.pkg.
#   bash avg_torch.sh exp/conv-ctc-transformer 10
set -e
source path.sh
exp_dir=${1:-exp/conv-ctc-transformer}
num=${2:-10}
python -m openasr_torch.bin.avg_last_ckpts $exp_dir $num
