#!/bin/bash
# CTC prefix-beam decode with the PyTorch port (infer_ctc.sh), on the
# card's device beam; drop --ctc_beam_device for the native host beam.
# Extra arguments go to the infer CLI (e.g. --device cpu).
#   bash infer_ctc_torch.sh exp/ctc avg10.pkg [--device cpu]
set -e
source path.sh
exp_dir=${1:-exp/ctc}
pkg=${2:-avg10.pkg}
shift $(( $# < 2 ? $# : 2 ))
python -m openasr_torch.bin.infer \
    --model_type conv-ctc \
    --model_pkg $exp_dir/$pkg \
    --vocab_path data/vocab.char \
    --json_file data/test.json \
    --output $exp_dir/decode_test/hyp.txt \
    --batch_frames 8000 \
    --ctc_beam 10 \
    --ctc_beam_device \
    --offline \
    --add_blk "$@"
python -m openasr_torch.bin.wer --cer \
    --hyp $exp_dir/decode_test/hyp.txt \
    --ref data/test_text.txt
