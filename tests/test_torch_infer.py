"""The port's decode CLI against the JAX CLI, end to end on the CPU.

A mini ark corpus (numpy features written with the port's kaldi_io) and
JAX-saved conv-ctc-transformer and conv-ctc packages go through both
`openasr_tpu.bin.infer.main` and `openasr_torch.bin.infer.main --device
cpu` with `--offline --add_blk`: the `utt hyp` files must be identical and
every n-best score must agree to 1e-3 (f32 on both sides; differences are
summation order only).  With `--dtype bfloat16` on both sides the files
must still be identical and the scores agree to 0.1.  conv-ctc decodes
greedily, with the host prefix beam, with the device prefix beam, and with
the device beam biased by a hotword file.  In bf16 the CTC beams may keep
other runners-up (the packages round bf16 at other places, and a beam of
4 over 20 symbols prunes near-tied prefixes either way), so there each
hypothesis that both n-best lists hold is held to 0.1, with the 1-best.
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
    for model_type, name in (("conv-ctc-transformer", "model.pkg"), ("conv-ctc", "ctc.pkg")):
        model = jax_model_class(model_type).create_model(small_config(model_type))
        jax_save_package(model.package(), str(d / name))
    (d / "hot.txt").write_text("a b\nc d e\nf f\n")
    return d, str(vocab), str(manifest), str(d / "model.pkg")


def _argv(corpus, out, model_type="conv-ctc-transformer"):
    d, vocab, manifest, pkg = corpus
    if model_type == "conv-ctc":
        pkg = str(d / "ctc.pkg")
    return ["--model_type", model_type, "--model_pkg", pkg,
            "--vocab_path", vocab, "--json_file", manifest,
            "--output", str(d / out), "--offline", "--add_blk",
            "--nbest", "3", "--maxlen", "10", "--batch_frames", "150"]


def _nbest_scores(text):
    return [float(s) for s in re.findall(r"score: (-?[0-9.]+)", text)]


def _nbest(text):
    """{utt: [(hyp, score), ...]} of the n-best log."""
    return {utt: [(h, float(sc)) for h, sc in re.findall(r"top\d+: (\S*) score: (-?[0-9.]+)",
                                                         block)]
            for utt, block in re.findall(r"Results for (\S+):\n((?:top.*\n)+)", text)}


def _check_cli_pair(corpus, caplog, dtype, tol, model_type="conv-ctc-transformer",
                    extra=(), n_scores=15, same_nbest=True):
    from openasr_tpu.bin.infer import main as jax_infer
    from openasr_torch.bin.infer import main as torch_infer

    d = corpus[0]
    tag = f"{model_type}_{dtype}_{'_'.join(a.strip('-') for a in extra[::2])}"
    caplog.set_level(logging.INFO)
    jax_infer(_argv(corpus, f"hyp_jax_{tag}.txt", model_type) + list(extra)
              + ["--dtype", dtype])
    jax_log = caplog.text
    caplog.clear()
    torch_infer(_argv(corpus, f"hyp_torch_{tag}.txt", model_type) + list(extra)
                + ["--dtype", dtype, "--device", "cpu"])
    torch_log = caplog.text

    hyp_jax = (d / f"hyp_jax_{tag}.txt").read_text()
    hyp_torch = (d / f"hyp_torch_{tag}.txt").read_text()
    assert len(hyp_jax.splitlines()) == 5
    assert hyp_torch == hyp_jax
    s_jax, s_torch = _nbest_scores(jax_log), _nbest_scores(torch_log)
    assert len(s_jax) == n_scores and len(s_torch) == n_scores
    if same_nbest:
        assert np.abs(np.array(s_jax) - np.array(s_torch)).max() <= tol
        return
    nb_jax, nb_torch = _nbest(jax_log), _nbest(torch_log)
    assert sorted(nb_jax) == sorted(nb_torch) and len(nb_jax) == 5
    for utt, want in nb_jax.items():
        got = dict(nb_torch[utt])
        assert nb_torch[utt][0][0] == want[0][0]
        assert all(abs(got[h] - sc) <= tol for h, sc in want if h in got)


def test_port_cli_matches_jax_cli(corpus, caplog):
    _check_cli_pair(corpus, caplog, "float32", SCORE_TOL)


def test_port_cli_matches_jax_cli_bfloat16(corpus, caplog):
    _check_cli_pair(corpus, caplog, "bfloat16", SCORE_TOL_BF16)


CTC_MODES = {
    "greedy": [],
    "host beam": ["--ctc_beam", "4"],
    "device beam": ["--ctc_beam", "4", "--ctc_beam_device"],
    "device beam, hotwords": ["--ctc_beam", "4", "--ctc_beam_device", "--context_file",
                              "hot.txt", "--context_weight", "1.5"],
}


@pytest.mark.parametrize("dtype,tol", [("float32", SCORE_TOL),
                                       ("bfloat16", SCORE_TOL_BF16)])
@pytest.mark.parametrize("mode", sorted(CTC_MODES))
def test_conv_ctc_cli_matches_jax_cli(corpus, caplog, mode, dtype, tol):
    """Greedy logs one score a utterance (0), the beams their 4-best."""
    extra = [str(corpus[0] / a) if a == "hot.txt" else a for a in CTC_MODES[mode]]
    _check_cli_pair(corpus, caplog, dtype, tol, "conv-ctc", extra,
                    n_scores=5 if mode == "greedy" else 20,
                    same_nbest=dtype == "float32" or mode == "greedy")


@pytest.mark.parametrize("model_type,extra,item", [
    # the JAX CLI's own exits: the device beam without --ctc_beam, and
    # fusing an LM into or biasing a CTC model off the device beam
    ("conv-ctc", ["--ctc_beam_device"], "needs a CTC model type AND --ctc_beam"),
    ("conv-ctc", ["--lm_pkg", "lm.pkg", "--lm_weight", "0.3"], "no fusion hook"),
    ("conv-ctc", ["--ctc_beam", "4", "--context_file", "hot.txt"],
     "add --ctc_beam N --ctc_beam_device"),
])
def test_unported_flags_exit_naming_roadmap_item(corpus, model_type, extra, item):
    from openasr_tpu.bin.infer import main as jax_infer
    from openasr_torch.bin.infer import main as torch_infer

    argv = _argv(corpus, "unused.txt", model_type) + extra
    with pytest.raises(SystemExit, match=item):
        torch_infer(argv + ["--device", "cpu"])
    # the same exit, word for word, as the JAX CLI's
    with pytest.raises(SystemExit, match=item) as jax_exit:
        jax_infer(argv)
    with pytest.raises(SystemExit) as port_exit:
        torch_infer(argv + ["--device", "cpu"])
    assert str(port_exit.value) == str(jax_exit.value)


def test_online_input_and_other_families_exit(corpus):
    """Online wave input (no --offline) is ported: it passes the checks
    (tests/test_torch_online.py decodes it); the text families exit naming
    their own CLI, bin/infer_phone2char.py."""
    from openasr_torch.bin.infer import check_ported, get_args
    from openasr_torch.bin.infer import main as torch_infer

    online = [a for a in _argv(corpus, "unused.txt") if a != "--offline"]
    check_ported(get_args(online + ["--device", "cpu"]))
    other = _argv(corpus, "unused.txt") + ["--device", "cpu"]
    other[other.index("conv-ctc-transformer")] = "embed_decoder"
    with pytest.raises(SystemExit, match="openasr_torch.bin.infer_phone2char"):
        torch_infer(other)


def test_cuda_is_the_default_and_never_falls_back(corpus):
    from openasr_torch.bin.infer import get_args, resolve_device

    assert get_args(_argv(corpus, "unused.txt")).device == "cuda"
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            resolve_device("cuda")
