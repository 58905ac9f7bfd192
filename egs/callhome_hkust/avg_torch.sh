#!/bin/bash
# Average the last N epoch checkpoints with the PyTorch port (avg.sh):
# writes <exp_dir>/avgN.pkg.
#   bash avg_torch.sh exp/cif_mix 10
set -e
source path.sh
exp_dir=${1:-exp/cif_mix}
num=${2:-10}
python -m openasr_torch.bin.avg_last_ckpts $exp_dir $num
