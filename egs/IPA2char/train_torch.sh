#!/bin/bash
# Train a phone->char model (Embed_Decoder or Embed_Decoder_CTC, by the
# config's model.type) with the PyTorch port, on the GPU; pass
# "--device cpu" after the config to train on the CPU.
#   bash train_torch.sh configs/callhome_ma_IPA.yaml [--continue-training]
set -e
source path.sh
config=$1
shift
python -m openasr_torch.bin.train_phone2char $config "$@"
