"""Shallow fusion in the port's three beams against the JAX package, on the
CPU.

The models are small (d 32, one or two layers, vocabulary 10 with the
blank, the LMs' 9 or 10): the port draws the weights, and the JAX models
take the port's packages (flax's eager init is skipped).  The same
seeded features or log-probs go through the JAX function (jitted) and the
port's:

- the attention beam (conv-ctc-transformer, beam 3) with the LSTM LM and
  with the Transformer LM;
- the CIF beam (beam 3, 6 steps, no EOS) with the Transformer LM;
- the device CTC prefix beam (beam 4, an utterance shorter than the
  batch, the LM's vocabulary one short of the model's: no blank) with the
  Transformer LM, and with the LSTM LM and a hotword table;

each with n-best tokens equal and scores within 1e-4, and at lm_weight 0
equal to the search without an LM.  Then the CLIs: from one acoustic and
one Transformer LM package that the JAX package saved, the port's infer
CLI with `--lm_pkg` writes the JAX CLI's hyp file (attention beam; n-best
scores within 1e-4), and a CTC model with `--lm_pkg` off the device beam
exits as the JAX CLI does.
"""

import contextlib
import json
import logging
import re

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openasr_tpu.models import get_model_class as jax_model_class
from openasr_torch.data.kaldi_io import write_ark_scp
from openasr_torch.models import get_model_class
from openasr_torch.ops.ctc_beam_device import build_context_tables

SCORE_TOL = 1e-4
W = 0.6
V = 10                                  # 6 characters + 3 specials + <blk>
CHARS = [f"c{i}" for i in range(6)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def acoustic_config(model_type):
    enc = {"type": "Transformer", "sub": {"type": "ConvV2", "layer_num": 1},
           "input_dim": 20, "d_model": 32, "nhead": 2, "dim_feedforward": 48,
           "activation": "glu", "num_layers": 1, "dropout_rate": 0.1}
    dec = {"type": "TransformerDecoder", "vocab_size": V, "d_model": 32, "nhead": 2,
           "num_layers": 1, "encoder_dim": 32, "dim_feedforward": 48, "activation": "glu",
           "dropout_rate": 0.1}
    cfg = {"type": model_type, "add_eos": True, "add_blk": True,
           "signal": {"feature_type": "offline"}, "encoder": enc, "decoder": dec}
    if model_type == "CIF":
        cfg.update(add_eos=False, add_blk=False,
                   assigner={"d_model": 32, "n_layers": 2, "w_context": 3, "dropout": 0.1})
        cfg["decoder"] = dict(dec, type="CIF_Decoder", num_layers=2)
    return cfg


def lm_config(model_type, vocab=V):
    if model_type == "lstm_lm":
        return {"type": "lstm_lm", "vocab_size": vocab, "d_model": 24, "n_layers": 2}
    return {"type": "transformer_lm", "vocab_size": vocab, "d_model": 32, "nhead": 2,
            "num_layers": 2, "dim_feedforward": 48, "dropout_rate": 0.1}


def pair(cfg, seed):
    """(the port model of `cfg` from `seed`, the JAX model holding its weights)."""
    port = get_model_class(cfg["type"]).create_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    params = jax.tree_util.tree_map(jnp.asarray, port.package()["components"])
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn.Module, "init", lambda self, *a, **k: {"params": params})
        return port, jax_model_class(cfg["type"]).create_model(cfg)


@pytest.fixture(scope="module")
def lms():
    return {("transformer_lm", V): pair(lm_config("transformer_lm"), 5),
            ("lstm_lm", V): pair(lm_config("lstm_lm"), 6),
            ("transformer_lm", V - 1): pair(lm_config("transformer_lm", V - 1), 7),
            ("lstm_lm", V - 1): pair(lm_config("lstm_lm", V - 1), 8)}


def features(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(2, 41, 20).astype(np.float32), np.array([41, 29], np.int32)


def check_nbest(got, want, with_lengths=True):
    g_preds, g_lens, g_scores = (a.numpy() for a in got)
    w_preds, w_lens, w_scores = (np.asarray(a) for a in want)
    assert (g_preds == w_preds).all()
    if with_lengths:
        assert (g_lens == w_lens).all()
    assert np.abs(g_scores - w_scores).max() <= SCORE_TOL


def check_weight_zero(decode, lm):
    plain = decode(None, 0.0)
    for a, b in zip(decode(lm, 0.0), plain):
        assert torch.equal(a, b)
    assert not torch.equal(decode(lm, W)[2], plain[2])


# ------------------------------------------------------------------ beams

@pytest.mark.parametrize("lm_type", ["lstm_lm", "transformer_lm"])
def test_attention_beam_fuses_like_jax(lms, lm_type):
    port, jm = pair(acoustic_config("conv-ctc-transformer"), 3)
    lm, jlm = lms[(lm_type, V)]
    x, lens = features(9)
    want = jax.jit(lambda p, lp, x_, l_: jm.batch_beam_decode(
        p, x_, l_, beam_size=3, max_decode_len=6, lm=jlm, lm_params=lp, lm_weight=W))(
            jm.params, jlm.params, x, lens)

    def decode(lm_, w):
        return port.batch_beam_decode(_t(x), _t(lens), beam_size=3, max_decode_len=6,
                                      lm=lm_, lm_weight=w)

    check_nbest(decode(lm, W), want)
    check_weight_zero(decode, lm)


def test_cif_beam_fuses_like_jax(lms):
    port, jm = pair(acoustic_config("CIF"), 4)
    lm, jlm = lms[("transformer_lm", V)]
    x, lens = features(10)
    want = jax.jit(lambda p, lp, x_, l_: jm.batch_beam_decode(
        p, x_, l_, beam_size=3, max_decode_len=6, lm=jlm, lm_params=lp, lm_weight=W))(
            jm.params, jlm.params, x, lens)

    def decode(lm_, w):
        return port.batch_beam_decode(_t(x), _t(lens), beam_size=3, max_decode_len=6,
                                      lm=lm_, lm_weight=w)

    check_nbest(decode(lm, W), want)
    check_weight_zero(decode, lm)


@pytest.mark.parametrize("lm_type,hotwords", [("transformer_lm", False), ("lstm_lm", True)])
def test_device_ctc_beam_fuses_like_jax(lms, lm_type, hotwords):
    from openasr_tpu.models.lm import make_lm_step_spec as jax_spec
    from openasr_tpu.ops.ctc_beam_device import ctc_prefix_beam_device as jax_beam
    from openasr_torch.models.lm import make_lm_step_spec
    from openasr_torch.ops.ctc_beam_device import ctc_prefix_beam_device

    lm, jlm = lms[(lm_type, V - 1)]
    rng = np.random.RandomState(12)
    b, t, beam = 2, 14, 4
    x = rng.randn(b, t, V).astype(np.float32)
    x[:, :, V - 1] += 1.5 * rng.rand(b, t)           # blank-heavy, as CTC frames are
    log_probs = np.asarray(jax.nn.log_softmax(x, axis=-1))
    lens = np.array([t, 9], np.int32)
    ctx = {}
    if hotwords:
        ctx = {"context_tables": build_context_tables(
            np.array([[3, 4, -1], [5, 5, 6]], np.int32), V), "context_weight": 1.5}
    js = jax_spec(jlm)
    want = jax_beam(log_probs, lens, blank=V - 1, beam=beam, lm_step_fn=js["step_fn"],
                    init_lm_cache=js["init_cache_fn"](b * beam, t + 1), lm_weight=W,
                    lm_params=js["params"], **ctx)
    spec = make_lm_step_spec(lm)

    def decode(lm_, w):
        kw = {} if lm_ is None else {"lm_step_fn": spec["step_fn"], "lm_weight": w,
                                     "init_lm_cache": spec["init_cache_fn"](b * beam, t + 1)}
        with torch.inference_mode():
            return ctc_prefix_beam_device(_t(log_probs), _t(lens), blank=V - 1, beam=beam,
                                          **ctx, **kw)

    got = decode(lm, W)
    g_toks, g_lens, g_scores = (a.numpy() for a in got)
    w_toks, w_lens, w_scores = (np.asarray(a) for a in want)
    live = w_scores > -1e29
    assert (g_scores > -1e29).tolist() == live.tolist() and live[:, 0].all()
    assert (g_lens == w_lens)[live].all()
    for i, n in zip(*np.nonzero(live)):
        assert g_toks[i, n, : g_lens[i, n]].tolist() == w_toks[i, n, : w_lens[i, n]].tolist()
    assert np.abs(g_scores - w_scores)[live].max() <= SCORE_TOL
    check_weight_zero(decode, lm)


# ------------------------------------------------------------------- CLIs

@pytest.fixture(scope="module")
def cli_corpus(tmp_path_factory, lms):
    """Five utterances of seeded features, a conv-ctc-transformer and a
    Transformer LM package saved by the JAX package, and a conv-ctc one."""
    from openasr_tpu.utils.checkpoint import save_package as jax_save_package

    d = tmp_path_factory.mktemp("lm_fusion_cli")
    rng = np.random.RandomState(13)
    (d / "chars.txt").write_text("".join(c + "\n" for c in CHARS))
    feats = {f"utt{i}": rng.randn(int(n), 20).astype(np.float32)
             for i, n in enumerate(rng.randint(30, 70, size=5))}
    write_ark_scp(str(d / "feats"), feats.items())
    rows = []
    for line in (d / "feats.scp").read_text().splitlines():
        utt, path = line.split()
        rows.append({"uttid": utt, "feat": path, "feat_length": feats[utt].shape[0],
                     "tokens": " ".join(rng.choice(CHARS, size=4)), "token_length": 4})
    (d / "test.json").write_text(json.dumps(rows))
    for cfg, seed, name in ((acoustic_config("conv-ctc-transformer"), 3, "am.pkg"),
                            (acoustic_config("conv-ctc"), 3, "ctc.pkg")):
        jax_save_package(pair(cfg, seed)[1].package(), str(d / name))
    jax_save_package(lms[("transformer_lm", V)][1].package(), str(d / "lm.pkg"))
    return d


def cli_argv(d, out, model_type="conv-ctc-transformer", pkg="am.pkg"):
    return ["--model_type", model_type, "--model_pkg", str(d / pkg),
            "--vocab_path", str(d / "chars.txt"), "--json_file", str(d / "test.json"),
            "--output", str(d / out), "--offline", "--add_blk", "--nbest", "3",
            "--maxlen", "8", "--batch_frames", "1000", "--lm_pkg", str(d / "lm.pkg"),
            "--lm_weight", str(W)]


@contextlib.contextmanager
def jitted_flax_init():
    """flax's own init, jitted, for the JAX CLI's models (eager, it compiles
    op by op)."""
    init = flax_nn.Module.init
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn.Module, "init", lambda self, rngs, *a: jax.jit(
            lambda r, *x: init(self, r, *x))(rngs, *a))
        yield


def nbest_log(text):
    return [(h, float(s)) for h, s in re.findall(r"top\d+: (.*) score: (-?[0-9.]+)", text)]


def test_port_infer_cli_with_an_lm_writes_the_jax_cli_hyp_file(cli_corpus, caplog):
    from openasr_tpu.bin.infer import main as jax_infer
    from openasr_torch.bin.infer import main as torch_infer

    caplog.set_level(logging.INFO)
    with jitted_flax_init():
        jax_infer(cli_argv(cli_corpus, "hyp_jax.txt"))
    want_log = nbest_log(caplog.text)
    caplog.clear()
    torch_infer(cli_argv(cli_corpus, "hyp_torch.txt") + ["--device", "cpu"])
    got_log = nbest_log(caplog.text)
    want = (cli_corpus / "hyp_jax.txt").read_text()
    assert len(want.splitlines()) == 5
    assert (cli_corpus / "hyp_torch.txt").read_text() == want
    assert len(got_log) == len(want_log) == 15
    assert [h for h, _ in got_log] == [h for h, _ in want_log]
    assert max(abs(g - w) for (_, g), (_, w) in zip(got_log, want_log)) <= SCORE_TOL
    assert "Shallow fusion with" in caplog.text


def test_ctc_fusion_off_the_device_beam_exits_as_the_jax_cli(cli_corpus):
    from openasr_tpu.bin.infer import main as jax_infer
    from openasr_torch.bin.infer import main as torch_infer

    for extra in ([], ["--ctc_beam", "4"]):
        argv = cli_argv(cli_corpus, "unused.txt", "conv-ctc", "ctc.pkg") + extra
        with pytest.raises(SystemExit, match="no fusion hook") as jax_exit, \
                jitted_flax_init():
            jax_infer(argv)
        with pytest.raises(SystemExit) as port_exit:
            torch_infer(argv + ["--device", "cpu"])
        assert str(port_exit.value) == str(jax_exit.value)
