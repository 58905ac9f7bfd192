#!/bin/bash
# Recipe-path CER gate of the PyTorch port: the steps of
# run_recipe_gate_tpu.sh through the port's commands, none of which
# imports jax.  Corpus and vocabulary prep (the jax-free generator) ->
# train CLI (online fbank kernel, SpecAug, bf16, bob lr, nonfinite skip,
# bucketing; zero1 is a no-op on one card) -> infer CLI (bf16, the device
# CTC prefix beam) -> scorer, gated on CER == 0 over the held-in test set.
# The committed real AISHELL-1 utterance then runs through the trained
# pipeline as an unscored decode smoke.  It runs on the card.
#
# Usage: cd egs/aishell1 && bash run_recipe_gate_torch.sh
# Writes exp/recipe_gate/RESULT.json with the scored CER, the train steps,
# the seconds per epoch and the decode's wall seconds.
#
# Cuts for a smaller run, all unset for the gate itself:
#   GATE_NUM_UTTS (256), GATE_REPEAT (train rows repeated, 32),
#   GATE_EPOCHS and GATE_DTYPE (training.num_epoch / compute_dtype; when
#   either is set the YAML is copied into exp_dir with them changed),
#   GATE_DEVICE (cuda; cpu runs the plain versions of the kernels).
set -e
source path.sh

num_utts=${GATE_NUM_UTTS:-256}
repeat=${GATE_REPEAT:-32}
device=${GATE_DEVICE:-cuda}
config=configs/conv-ctc-recipe-gate.yaml
exp_dir=exp/recipe_gate
data=data/gate
mkdir -p $exp_dir/decode_gate
rm -f $exp_dir/*.pkg $exp_dir/metrics.jsonl

# --- corpus + vocab prep: the train rows repeated, a small dev set
rm -rf $data
python -m openasr_torch.bin.gen_mini_corpus --out $data --wave --num_utts $num_utts
REPEAT=$repeat python - <<'PYEOF'
import json
import os

rows = json.load(open("data/gate/dev_wav.json"))
json.dump(rows[:8], open("data/gate/dev_wav.json", "w"))
tr = json.load(open("data/gate/train_wav.json"))
out = []
for rep in range(int(os.environ["REPEAT"])):
    for r in tr:
        q = dict(r)
        q["uttid"] = f"{r['uttid']}_r{rep}"
        out.append(q)
json.dump(out, open("data/gate/train_wav.json", "w"))
PYEOF

if [ -n "${GATE_EPOCHS:-}${GATE_DTYPE:-}" ]; then
    EPOCHS=${GATE_EPOCHS:-} DTYPE=${GATE_DTYPE:-} CONFIG=$config python - <<'PYEOF'
import os

import yaml

cfg = yaml.safe_load(open(os.environ["CONFIG"]))
if os.environ["EPOCHS"]:
    cfg["training"]["num_epoch"] = int(os.environ["EPOCHS"])
if os.environ["DTYPE"]:
    cfg["training"]["compute_dtype"] = os.environ["DTYPE"]
yaml.safe_dump(cfg, open("exp/recipe_gate/gate.yaml", "w"))
PYEOF
    config=$exp_dir/gate.yaml
fi

# --- train (the train.sh path)
t0=$(date +%s.%N)
python -m openasr_torch.bin.train $config --device $device
t1=$(date +%s.%N)

# --- decode the held-in test set (the infer.sh path: bf16 + device beam)
python -m openasr_torch.bin.infer \
    --model_type conv-ctc \
    --model_pkg $exp_dir/last.pkg \
    --vocab_path $data/train_chars.txt \
    --json_file $data/test_wav.json \
    --output $exp_dir/decode_gate/hyp.txt \
    --batch_frames 1000000 \
    --ctc_beam 4 --ctc_beam_device \
    --add_blk --split_token \
    --dtype bfloat16 --device $device
t2=$(date +%s.%N)

# --- score and gate on CER == 0
python -m openasr_torch.bin.wer --cer \
    --hyp $exp_dir/decode_gate/hyp.txt \
    --ref $data/test_text.txt | tee $exp_dir/decode_gate/score.txt

# --- real-audio decode smoke: the committed real AISHELL-1 utterance
# through the same trained pipeline (unscored: its transcript is not in
# this corpus)
python - <<'PYEOF'
import json
import os

from openasr_torch.data.audio import load_wave

wav = os.path.join(os.environ["MAIN_ROOT"], "tests/data/BAC009S0764W0121.wav")
sr, x = load_wave(wav)
if sr != 16000:
    raise SystemExit(f"{wav}: sample rate {sr}, not 16000")
with open("data/gate/real_smoke.json", "w") as f:
    json.dump([{"uttid": "BAC009S0764W0121", "feat": wav,
                "feat_length": int(x.shape[0]), "tokens": "a",
                "token_length": 1}], f)
PYEOF
python -m openasr_torch.bin.infer \
    --model_type conv-ctc \
    --model_pkg $exp_dir/last.pkg \
    --vocab_path $data/train_chars.txt \
    --json_file $data/real_smoke.json \
    --output $exp_dir/decode_gate/real_smoke_hyp.txt \
    --batch_frames 1000000 \
    --ctc_beam 4 --ctc_beam_device \
    --add_blk --split_token \
    --dtype bfloat16 --device $device

NUM_UTTS=$num_utts T0=$t0 T1=$t1 T2=$t2 DEVICE=$device python - <<'PYEOF'
import json
import os
import re
import subprocess

score = open("exp/recipe_gate/decode_gate/score.txt").read()
m = re.search(r"(?:CER|WER)[^\d]*([\d.]+)", score)
if not m:
    raise SystemExit(f"no CER in scorer output:\n{score}")
cer = float(m.group(1))
smoke = open("exp/recipe_gate/decode_gate/real_smoke_hyp.txt").read().strip()
epochs = [json.loads(line) for line in open("exp/recipe_gate/metrics.jsonl")]
epochs = [r for r in epochs if r["phase"] == "epoch"]
card = "cpu"
if os.environ["DEVICE"] == "cuda":
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
result = {
    "gate": "recipe_path_cer",
    "cer": cer,
    "corpus": "openasr_torch.bin.gen_mini_corpus --wave (16 kHz PCM, "
              f"{os.environ['NUM_UTTS']} utts)",
    "stack": "openasr_torch train CLI (online fbank kernel + SpecAug + bf16 + "
             "skip_nonfinite + bucketing) -> infer CLI (bf16, device CTC prefix "
             "beam) -> openasr_torch.bin.wer",
    "real_audio_smoke": smoke,
    "card": card,
    "train_steps": epochs[-1]["step"],
    "epoch_seconds": [round(r["minutes"] * 60.0, 2) for r in epochs],
    "train_wall_seconds": float(os.environ["T1"]) - float(os.environ["T0"]),
    "decode_wall_seconds": float(os.environ["T2"]) - float(os.environ["T1"]),
}
with open("exp/recipe_gate/RESULT.json", "w") as f:
    json.dump(result, f, indent=1)
print(json.dumps(result))
if cer != 0.0:
    raise SystemExit(f"recipe-path gate FAILED: CER {cer} != 0")
print("recipe-path CER gate PASSED: CER 0.0 through the full stack")
PYEOF
