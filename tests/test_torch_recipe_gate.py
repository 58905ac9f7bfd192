"""The recipe gate's jax-free pieces against the JAX package's tools, and
its command chain on the CPU.

- `python -m openasr_torch.bin.gen_mini_corpus` writes byte for byte the
  files of tools/gen_mini_corpus.py, in both modes, for the same
  arguments and seed;
- `python -m openasr_torch.bin.sclite_score` prints and writes the report
  of tools/sclite_score.py, character for character;
- egs/aishell1/run_recipe_gate_torch.sh, at a tiny cut on the CPU (16
  utterances, the train rows once, 1 epoch, f32, `GATE_DEVICE=cpu`),
  runs corpus prep, the train CLI, the infer CLI with the device beam, the
  scorer and the real-utterance decode, and writes one hyp line per test
  utterance, a score and RESULT.json.  A model of one step does not reach
  CER 0, so the test reads the CER and does not gate on it.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from openasr_torch.bin import gen_mini_corpus, sclite_score

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "egs", "aishell1")


def tool(name):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for fn in files:
            path = os.path.join(d, fn)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("args", [
    [],
    ["--num_utts", "12", "--seed", "3", "--feat_dim", "24"],
    ["--wave", "--num_utts", "16"],
    ["--wave", "--num_utts", "9", "--seed", "5"],
])
def test_generator_is_byte_identical_to_the_tool(tmp_path, args):
    out = str(tmp_path / "corpus")
    with contextlib.redirect_stdout(io.StringIO()):
        tool("gen_mini_corpus").main(["--out", out, *args])
    want = tree_bytes(out)
    shutil.rmtree(out)
    with contextlib.redirect_stdout(io.StringIO()):
        gen_mini_corpus.main(["--out", out, *args])
    got = tree_bytes(out)
    assert sorted(got) == sorted(want) and len(want) >= 5
    for name, data in want.items():
        assert got[name] == data, name


def score_files(tmp_path):
    ref = tmp_path / "ref.trn"
    hyp = tmp_path / "hyp.txt"
    ref.write_text("今天 天气 好 (spk1-utt1)\n"
                   "a b c d (spk1-utt2)\n"
                   "spk2_utt3 我们 去 ABC 公园\n"
                   "spk2_utt4 x y\n\n", encoding="utf-8")
    hyp.write_text("spk1-utt1 今天 天汽 好 好\n"
                   "b c d e (spk1-utt2)\n"
                   "我们 ABC 公园 (spk2_utt3)\n", encoding="utf-8")
    return str(ref), str(hyp)


@pytest.mark.parametrize("flags", [[], ["--cer"], ["--cer", "--per-spk"]])
def test_sclite_score_output_is_the_tools(tmp_path, flags):
    ref, hyp = score_files(tmp_path)
    outputs = []
    for module in (tool("sclite_score"), sclite_score):
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            err = module.main(["-r", ref, "-h2", hyp, *flags])
        report = tmp_path / "report.txt"
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            module.main(["-r", ref, "-h2", hyp, "-o", str(report), *flags])
        outputs.append((err, stdout.getvalue(), report.read_text(encoding="utf-8"),
                        printed.getvalue()))
    assert outputs[1] == outputs[0]
    assert "SYSTEM SUMMARY" in outputs[0][1] and "spk2_utt4" in outputs[0][1]


def test_gate_chain_runs_on_the_cpu_at_a_tiny_cut(tmp_path):
    work = tmp_path / "aishell1"
    os.makedirs(work / "configs")
    for name in ("run_recipe_gate_torch.sh", "path.sh"):
        shutil.copy(os.path.join(RECIPE, name), work / name)
    shutil.copy(os.path.join(RECIPE, "configs", "conv-ctc-recipe-gate.yaml"),
                work / "configs" / "conv-ctc-recipe-gate.yaml")
    env = dict(os.environ, MAIN_ROOT=ROOT, GATE_DEVICE="cpu", GATE_NUM_UTTS="16",
               GATE_REPEAT="1", GATE_EPOCHS="1", GATE_DTYPE="float32",
               PATH=os.path.dirname(sys.executable) + os.pathsep + os.environ["PATH"])
    run = subprocess.run(["bash", "run_recipe_gate_torch.sh"], cwd=work, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         timeout=300)
    exp = work / "exp" / "recipe_gate"
    assert (exp / "RESULT.json").exists(), run.stdout[-3000:]
    result = json.loads((exp / "RESULT.json").read_text())
    assert (run.returncode == 0) == (result["cer"] == 0.0), run.stdout[-3000:]
    hyp = (exp / "decode_gate" / "hyp.txt").read_text().splitlines()
    ref = (work / "data" / "gate" / "test_text.txt").read_text().splitlines()
    assert sorted(line.split()[0] for line in hyp) == sorted(line.split()[0] for line in ref)
    assert len(ref) == 8
    assert (exp / "decode_gate" / "score.txt").read_text().startswith("CER ")
    assert result["card"] == "cpu" and result["train_steps"] >= 1
    assert len(result["epoch_seconds"]) == 1
    assert result["real_audio_smoke"].startswith("BAC009S0764W0121")
