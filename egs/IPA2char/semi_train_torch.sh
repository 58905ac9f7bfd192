#!/bin/bash
# Semi-supervised WGAN-GP phone->char training with the PyTorch port, on
# the GPU (training.G_path warm-starts G from an Embed_Decoder_CTC
# package of either package); "--device cpu" after the config for the CPU.
#   bash semi_train_torch.sh configs/semi_callhome_ma_IPA.yaml [--continue-training]
set -e
source path.sh
config=$1
shift
python -m openasr_torch.bin.semi_train_phone2char $config "$@"
