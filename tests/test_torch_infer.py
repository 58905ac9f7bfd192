"""The port's decode CLI against the JAX CLI, end to end on the CPU.

A mini ark corpus (numpy features written with the port's kaldi_io) and a
JAX-saved conv-ctc-transformer package go through both
`openasr_tpu.bin.infer.main` and `openasr_torch.bin.infer.main --device
cpu` with `--offline --add_blk`: the `utt hyp` files must be identical and
every n-best score must agree to 1e-3 (f32 on both sides; differences are
summation order only).  With `--dtype bfloat16` on both sides the files
must still be identical and the scores agree to 0.1.
"""

import json
import logging
import re

import numpy as np
import pytest
import torch

from openasr_tpu.models import get_model_class as jax_model_class
from openasr_tpu.utils.checkpoint import save_package as jax_save_package
from openasr_torch.data.kaldi_io import write_ark_scp

from test_torch_models import small_config

SCORE_TOL = 1e-3
# bf16 on both sides: the two round activations at different places (bf16
# eps 2^-8, relative), and a score sums ~10 steps of log-probs reaching ~8
# in magnitude; the two CLIs differ by 4.8e-2 at most on this corpus.
SCORE_TOL_BF16 = 0.1
CHARS = [chr(ord("a") + i) for i in range(16)]  # 16 + 4 specials = vocab 20


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_infer")
    rng = np.random.RandomState(11)
    vocab = d / "chars.txt"
    vocab.write_text("".join(c + "\n" for c in CHARS))
    feats = {
        f"utt{i}": rng.randn(int(n), 20).astype(np.float32)
        for i, n in enumerate(rng.randint(30, 90, size=5))
    }
    write_ark_scp(str(d / "feats"), feats.items())
    rows = []
    for line in (d / "feats.scp").read_text().splitlines():
        utt, path = line.split()
        toks = " ".join(rng.choice(CHARS, size=4))
        rows.append({"uttid": utt, "feat": path, "feat_length": feats[utt].shape[0],
                     "tokens": toks, "token_length": 4})
    manifest = d / "test.json"
    manifest.write_text(json.dumps(rows))
    model = jax_model_class("conv-ctc-transformer").create_model(small_config())
    pkg = d / "model.pkg"
    jax_save_package(model.package(), str(pkg))
    return d, str(vocab), str(manifest), str(pkg)


def _argv(corpus, out):
    d, vocab, manifest, pkg = corpus
    return ["--model_type", "conv-ctc-transformer", "--model_pkg", pkg,
            "--vocab_path", vocab, "--json_file", manifest,
            "--output", str(d / out), "--offline", "--add_blk",
            "--nbest", "3", "--maxlen", "10", "--batch_frames", "150"]


def _nbest_scores(text):
    return [float(s) for s in re.findall(r"score: (-?[0-9.]+)", text)]


def _check_cli_pair(corpus, caplog, dtype, tol):
    from openasr_tpu.bin.infer import main as jax_infer
    from openasr_torch.bin.infer import main as torch_infer

    d = corpus[0]
    caplog.set_level(logging.INFO)
    jax_infer(_argv(corpus, f"hyp_jax_{dtype}.txt") + ["--dtype", dtype])
    jax_log = caplog.text
    caplog.clear()
    torch_infer(_argv(corpus, f"hyp_torch_{dtype}.txt")
                + ["--dtype", dtype, "--device", "cpu"])
    torch_log = caplog.text

    hyp_jax = (d / f"hyp_jax_{dtype}.txt").read_text()
    hyp_torch = (d / f"hyp_torch_{dtype}.txt").read_text()
    assert len(hyp_jax.splitlines()) == 5
    assert hyp_torch == hyp_jax
    s_jax, s_torch = _nbest_scores(jax_log), _nbest_scores(torch_log)
    assert len(s_jax) == 15 and len(s_torch) == 15
    assert np.abs(np.array(s_jax) - np.array(s_torch)).max() <= tol


def test_port_cli_matches_jax_cli(corpus, caplog):
    _check_cli_pair(corpus, caplog, "float32", SCORE_TOL)


def test_port_cli_matches_jax_cli_bfloat16(corpus, caplog):
    _check_cli_pair(corpus, caplog, "bfloat16", SCORE_TOL_BF16)


@pytest.mark.parametrize("extra,item", [
    (["--ctc_beam", "4"], "item 7"),
    (["--lm_pkg", "lm.pkg", "--lm_weight", "0.3"], "item 10"),
    (["--context_file", "hot.txt"], "item 7"),
])
def test_unported_flags_exit_naming_roadmap_item(corpus, extra, item):
    from openasr_torch.bin.infer import main as torch_infer

    with pytest.raises(SystemExit, match=item):
        torch_infer(_argv(corpus, "unused.txt") + ["--device", "cpu"] + extra)


def test_online_input_and_other_families_exit(corpus):
    """Online wave input (no --offline) is ported: it passes the checks
    (tests/test_torch_online.py decodes it); the other families exit."""
    from openasr_torch.bin.infer import check_ported, get_args
    from openasr_torch.bin.infer import main as torch_infer

    online = [a for a in _argv(corpus, "unused.txt") if a != "--offline"]
    check_ported(get_args(online + ["--device", "cpu"]))
    other = _argv(corpus, "unused.txt") + ["--device", "cpu"]
    other[other.index("conv-ctc-transformer")] = "ctc_cif"
    with pytest.raises(SystemExit, match="items 9 \\(CIF\\)"):
        torch_infer(other)


def test_cuda_is_the_default_and_never_falls_back(corpus):
    from openasr_torch.bin.infer import get_args, resolve_device

    assert get_args(_argv(corpus, "unused.txt")).device == "cuda"
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            resolve_device("cuda")
