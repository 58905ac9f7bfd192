#!/bin/bash
# Build a LibriSpeech json manifest with the PyTorch port (gen_json.py's
# counterpart, openasr_torch.bin.gen_libri_json).
#   bash gen_json_torch.sh LibriSpeech/train-clean-100 data/train.json
set -e
source path.sh
python -m openasr_torch.bin.gen_libri_json "$@"
