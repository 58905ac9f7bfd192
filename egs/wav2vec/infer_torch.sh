#!/bin/bash
# Decode a raw-wave CTC package with the PyTorch port (infer.sh: the host
# CTC prefix beam of 10); extra arguments go to the infer CLI (e.g.
# --device cpu, --ctc_beam_device).
#   bash infer_torch.sh exp/wav2vec_ctc wav2vec_ctc [--device cpu]
set -e
source path.sh
expdir=$1
model_type=${2:-wav2vec_ctc}
shift $(( $# < 2 ? $# : 2 ))
python -m openasr_torch.bin.infer \
    --batch_frames 1000000 \
    --nbest 5 \
    --label_type tokens \
    --model_type $model_type \
    --model_pkg $expdir/last.pkg \
    --vocab_path data/train_chars.txt \
    --json_file data/test_wav.json \
    --output $expdir/hyp.txt \
    --add_blk \
    --ctc_beam 10 "$@"
