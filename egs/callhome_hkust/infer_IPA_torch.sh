#!/bin/bash
# Decode IPA-target CTC models with the PyTorch port (infer_IPA.sh);
# extra arguments go to the infer CLI (e.g. --device cpu).
#   bash infer_IPA_torch.sh exp/ctc_IPA avg10.pkg [--device cpu]
set -e
source path.sh
exp_dir=${1:-exp/ctc_IPA}
pkg=${2:-avg10.pkg}
shift $(( $# < 2 ? $# : 2 ))
python -m openasr_torch.bin.infer \
    --model_type conv-ctc \
    --model_pkg $exp_dir/$pkg \
    --vocab_path data/phones.txt \
    --json_file data/test_IPA.json \
    --output $exp_dir/decode_test/hyp.txt \
    --batch_frames 8000 \
    --label_type phones \
    --offline \
    --add_blk "$@"
python -m openasr_torch.bin.wer \
    --hyp $exp_dir/decode_test/hyp.txt --ref data/test_IPA_text.txt
