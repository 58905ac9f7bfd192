#!/bin/bash
# Decode and score with the PyTorch port (infer.sh: the attention beam of
# conv-ctc-transformer, then the CER); extra arguments go to the infer
# CLI (e.g. --device cpu, --dtype bfloat16).
#   bash infer_torch.sh exp/conv-ctc-transformer avg10.pkg [--device cpu]
set -e
source path.sh
exp_dir=${1:-exp/conv-ctc-transformer}
pkg=${2:-avg10.pkg}
shift $(( $# < 2 ? $# : 2 ))
python -m openasr_torch.bin.infer \
    --model_type conv-ctc-transformer \
    --model_pkg $exp_dir/$pkg \
    --vocab_path data/aishell1_train_chars.txt \
    --json_file data/test.json \
    --output $exp_dir/decode_test/hyp.txt \
    --batch_frames 8000 \
    --nbest 5 \
    --maxlen 60 \
    --offline \
    --add_blk "$@"
python -m openasr_torch.bin.wer --cer \
    --hyp $exp_dir/decode_test/hyp.txt \
    --ref data/test_text.txt
