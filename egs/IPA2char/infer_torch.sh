#!/bin/bash
# Decode a phone->char package with the PyTorch port: CTC greedy for
# Embed_Decoder_CTC, the attention beam (--nbest, --maxlen) for
# Embed_Decoder; writes <exp_dir>/decode_test/{hyp,ref}.txt and prints the
# WER.  Extra arguments go to the CLI (e.g. --device cpu).
#   bash infer_torch.sh exp/callhome_ma_IPA last.pkg Embed_Decoder_CTC
set -e
source path.sh
exp_dir=${1:-exp/callhome_ma_IPA}
pkg=${2:-last.pkg}
model_type=${3:-Embed_Decoder_CTC}
shift $(( $# < 3 ? $# : 3 ))
blk=""
[ "$model_type" = "Embed_Decoder_CTC" ] && blk="--add_blk"
python -m openasr_torch.bin.infer_phone2char \
    --model_type $model_type \
    --model_pkg $exp_dir/$pkg \
    --vocab_phone data/callhome.IPA \
    --vocab_char data/vocab.char \
    --json_file data/test.json \
    --output_dir $exp_dir/decode_test \
    $blk "$@"
