#!/bin/bash
# Decode char-target models with the PyTorch port (infer_char.sh); extra
# arguments go to the infer CLI (e.g. --device cpu).
#   bash infer_char_torch.sh exp/conv-transformer_ma avg10.pkg [--device cpu]
set -e
source path.sh
exp_dir=${1:-exp/conv-transformer_ma}
pkg=${2:-avg10.pkg}
shift $(( $# < 2 ? $# : 2 ))
python -m openasr_torch.bin.infer \
    --model_type conv-transformer \
    --model_pkg $exp_dir/$pkg \
    --vocab_path data/chars_ma.txt \
    --json_file data/test_ma.json \
    --output $exp_dir/decode_test/hyp.txt \
    --batch_frames 8000 \
    --nbest 5 \
    --maxlen 80 \
    --offline "$@"
python -m openasr_torch.bin.wer --cer \
    --hyp $exp_dir/decode_test/hyp.txt --ref data/test_ma_text.txt
