"""The port's decoders against the JAX package's, on the CPU.

Each test gives the same NumPy inputs (made from seeds) to a function of
`openasr_tpu` (jitted where it is JAX) and to its counterpart in
`openasr_torch`:

  * the CTC greedy ops: ids and lengths equal, soft logits and their
    gradients within 1e-6;
  * the NumPy prefix beam: tokens equal, scores within 1e-5; the port's
    native binding against its NumPy oracle within 1e-4, as
    tests/test_native_decoder.py holds the JAX package's;
  * `build_context_tables`: every array equal;
  * the device prefix beam: every row's tokens and lengths equal (the
    sentinel rows too), scores within 1e-4, and the uint32 hash pairs bit
    for bit;
  * the attention beam with hotword biasing: preds and lengths equal,
    scores within 1e-4;
  * `load_context_phrases`, `utils.metrics` and the scorer
    (`openasr_torch.bin.wer` against tools/wer.py): identical results.
"""

import importlib.util
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openasr_tpu.ops import ctc_beam_device as jax_beam
from openasr_tpu.ops import ctc_decode as jax_ctc
from openasr_tpu.ops import prefix_beam as jax_prefix
from openasr_torch.ops import ctc_beam_device as port_beam
from openasr_torch.ops import ctc_decode as port_ctc
from openasr_torch.ops import prefix_beam as port_prefix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOFT_TOL = 1e-6
PY_BEAM_TOL = 1e-5
NATIVE_TOL = 1e-4
DEVICE_BEAM_TOL = 1e-4
ATTN_BEAM_TOL = 1e-4


def log_probs(b, t, v, seed, peaky=0.0):
    """Random log-softmax frames; `peaky` sharpens each toward a random
    symbol so that prefixes separate."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, t, v).astype(np.float32) * (1.0 + peaky)
    if peaky:
        idx = rng.randint(0, v, (b, t))
        logits[np.arange(b)[:, None], np.arange(t)[None, :], idx] += 4.0
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ CTC greedy

def greedy_inputs(seed=0):
    """Logits with long runs of repeats and blanks (blank = V-1), lengths
    full, partial and 0."""
    rng = np.random.RandomState(seed)
    b, t, v = 4, 23, 7
    path = rng.choice([0, 3, 3, 5, v - 1, v - 1], size=(b, t))
    logits = rng.randn(b, t, v).astype(np.float32)
    logits[np.arange(b)[:, None], np.arange(t)[None, :], path] += 3.0
    return logits, np.array([23, 17, 1, 0], np.int32)


def test_ctc_greedy_ops_match_jax():
    logits, lens = greedy_inputs()
    ids_j, n_j = jax.jit(jax_ctc.ctc_greedy_decode)(logits, lens)
    ids_t, n_t = port_ctc.ctc_greedy_decode(_t(logits), _t(lens))
    assert np.array_equal(np.asarray(ids_j), ids_t.numpy())
    assert np.array_equal(np.asarray(n_j), n_t.numpy())

    path = np.asarray(jax_ctc.greedy_path(logits, lens))
    assert np.array_equal(path, port_ctc.greedy_path(_t(logits), _t(lens)).numpy())
    shrink_j = jax.jit(jax_ctc.ctc_shrink_ids, static_argnums=(2, 3))(path, lens, 3, 9)
    shrink_t = port_ctc.ctc_shrink_ids(_t(path), _t(lens), 3, 9)
    for a, b in zip(shrink_j, shrink_t):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_ctc_shrink_soft_and_its_gradient_match_jax():
    logits, lens = greedy_inputs(1)
    w = np.random.RandomState(2).randn(*logits.shape).astype(np.float32)

    def jax_obj(x):
        out, _ = jax_ctc.ctc_shrink_soft(x, lens)
        return jnp.sum(out * w)

    soft_j, n_j = jax.jit(jax_ctc.ctc_shrink_soft)(logits, lens)
    grad_j = jax.jit(jax.grad(jax_obj))(logits)
    x = _t(logits).requires_grad_()
    soft_t, n_t = port_ctc.ctc_shrink_soft(x, _t(lens))
    (soft_t * _t(w)).sum().backward()
    assert np.array_equal(np.asarray(n_j), n_t.numpy())
    assert np.abs(np.asarray(soft_j) - soft_t.detach().numpy()).max() <= SOFT_TOL
    assert np.abs(np.asarray(grad_j) - x.grad.numpy()).max() <= SOFT_TOL


# ------------------------------------------------------------ host beams

@pytest.mark.parametrize("kw", [
    dict(beam_width=8, cutoff_top_n=12, cutoff_logp=-100.0),
    dict(beam_width=5, cutoff_top_n=4, cutoff_logp=-3.0),
])
def test_numpy_prefix_beam_matches_jax(kw):
    lp = log_probs(3, 20, 12, seed=5, peaky=0.5)
    lengths = np.array([20, 13, 4], np.int32)
    want = jax_prefix.CTCPrefixBeamDecoder(blank_id=11, **kw).decode_batch(lp, lengths)
    got = port_prefix.CTCPrefixBeamDecoder(blank_id=11, **kw).decode_batch(lp, lengths)
    for w, g in zip(want, got):
        assert [h.tokens for h in g] == [h.tokens for h in w]
        assert np.allclose([h.score for h in g], [h.score for h in w], atol=PY_BEAM_TOL,
                           rtol=0)


@pytest.mark.parametrize("b,t,v,kw,lengths", [
    (4, 30, 12, dict(beam_width=8, cutoff_top_n=12, cutoff_logp=-100.0), [30, 25, 20, 10]),
    (2, 20, 30, dict(beam_width=5, cutoff_top_n=8, cutoff_logp=-12.0), [20, 15]),
])
def test_native_binding_matches_numpy_oracle(b, t, v, kw, lengths):
    lp = log_probs(b, t, v, seed=t)
    lengths = np.array(lengths, np.int32)
    want = port_prefix.CTCPrefixBeamDecoder(blank_id=v - 1, **kw).decode_batch(lp, lengths)
    dec = port_prefix.make_decoder(blank_id=v - 1, **kw)
    assert isinstance(dec, port_prefix.NativeCTCPrefixBeamDecoder)
    got = dec.decode_batch(lp, lengths)
    for w, g in zip(want, got):
        assert len(g) == len(w)
        for hw, hg in zip(w, g):
            assert hw.tokens == hg.tokens
            assert abs(hw.score - hg.score) <= NATIVE_TOL


def test_native_binding_keeps_hypotheses_longer_than_256():
    """A hypothesis can hold a token per frame: 300 distinct-token frames
    decode to 300 tokens, as the NumPy oracle gives them.  The runners-up
    tie (each drops one token), so only their scores are compared, to 1e-3:
    the native decoder sums 300 frames in f32, the oracle in float64
    (1.1e-4 apart here)."""
    v, t = 6, 300
    lp = np.full((1, t, v), -12.0, np.float32)
    lp[0, np.arange(t), np.arange(t) % (v - 1)] = 0.0
    lp -= np.log(np.exp(lp).sum(-1, keepdims=True))
    want = port_prefix.CTCPrefixBeamDecoder(beam_width=3, blank_id=v - 1).decode(lp[0])
    got = port_prefix.make_decoder(beam_width=3, blank_id=v - 1).decode(lp[0])
    assert len(got[0].tokens) == t and got[0].tokens == want[0].tokens
    assert np.allclose([h.score for h in got], [h.score for h in want], atol=1e-3, rtol=0)


def test_native_library_builds_outside_native_and_raises_on_failure(tmp_path, monkeypatch):
    from openasr_torch.kernels import BUILD_DIR

    so = port_prefix.build_native()
    assert so.parent == BUILD_DIR and so.name.startswith("libctc_decoder-")
    bad = tmp_path / "broken.cc"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(port_prefix, "NATIVE_SOURCE", bad)
    with pytest.raises(RuntimeError, match="broken.cc"):
        port_prefix.build_native()


# ------------------------------------------------------------ biasing

PHRASE_SETS = {
    "plain": [[1, 2, 3], [4, 5]],
    "self-overlapping": [[1, 2, 1, 2], [3, 3]],
    "reduplicated and nested": [[1, 1, 1], [2, 1, 2, 1, 2], [5]],
}


def phrase_table(phrases):
    pad = np.full((len(phrases), max(map(len, phrases))), -1, np.int32)
    for i, ph in enumerate(phrases):
        pad[i, : len(ph)] = ph
    return pad


@pytest.mark.parametrize("name", sorted(PHRASE_SETS))
def test_build_context_tables_matches_jax(name):
    pad = phrase_table(PHRASE_SETS[name])
    want = jax_beam.build_context_tables(pad, 8)
    got = port_beam.build_context_tables(pad, 8)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_load_context_phrases_matches_jax_and_rejects_oov(tmp_path):
    from openasr_tpu.data.tokenizer import CharTokenizer as JaxTokenizer
    from openasr_tpu.data.tokenizer import load_context_phrases as jax_load
    from openasr_torch.data.tokenizer import CharTokenizer, load_context_phrases

    vocab = tmp_path / "chars.txt"
    vocab.write_text("a\nb\nc\n")
    hot = tmp_path / "hot.txt"
    hot.write_text("a b\n\nc\nb a c a\n")
    got = load_context_phrases(CharTokenizer(str(vocab), add_blk=True), str(hot))
    want = jax_load(JaxTokenizer(str(vocab), add_blk=True), str(hot))
    assert got.dtype == np.int32 and np.array_equal(got, want)

    hot.write_text("a b\nc zz a\n")
    with pytest.raises(ValueError, match=r"hot.txt:2: .*\['zz'\]"):
        load_context_phrases(CharTokenizer(str(vocab), add_blk=True), str(hot))
    hot.write_text("\n\n")
    with pytest.raises(ValueError, match="no usable context phrases"):
        load_context_phrases(CharTokenizer(str(vocab), add_blk=True), str(hot))


# ------------------------------------------------------------ device beam

def all_tied(b, t, v):
    return np.full((b, t, v), np.log(1.0 / v), np.float32)


def all_blank(b, t, v):
    lp = np.full((b, t, v), -12.0, np.float32)
    lp[..., v - 1] = 0.0
    return lp - np.log(np.exp(lp).sum(-1, keepdims=True))


def overlapping_frames():
    """Frames favouring 1 2 1 2 1 2 then 3 3 3 (blanks between)."""
    v, blank = 6, 5
    seq = [1, blank, 2, blank, 1, blank, 2, blank, 1, blank, 2, blank, 3, blank, 3,
           blank, 3]
    lp = np.full((2, len(seq), v), -9.0, np.float32)
    lp[:, np.arange(len(seq)), seq] = -0.05
    lp[1] += log_probs(1, len(seq), v, seed=9)[0]
    return lp - np.log(np.exp(lp).sum(-1, keepdims=True))


DEVICE_CASES = {
    # name: (log-probs, lengths, beam, keyword arguments)
    "flat": (log_probs(3, 24, 12, seed=1), [24, 17, 9], 6, {}),
    "peaky": (log_probs(3, 24, 12, seed=11, peaky=1.0), [24, 17, 9], 6, {}),
    "cutoffs": (log_probs(2, 20, 30, seed=7, peaky=0.5), [20, 13], 5,
                {"cutoff_top_n": 8, "cutoff_logp": -8.0}),
    "ties": (all_tied(2, 3, 10), [3, 1], 4, {"cutoff_top_n": 3, "cutoff_logp": -50.0}),
    "truncated, empty and long": (log_probs(4, 16, 10, seed=3, peaky=1.0), [9, 0, 16, 1], 4,
                                  {}),
    "sentinel rows": (all_blank(2, 4, 6), [4, 2], 8, {"cutoff_logp": -6.0}),
    "biasing": (log_probs(2, 10, 8, seed=21, peaky=0.5), [10, 7], 5,
                {"context_phrases": phrase_table(PHRASE_SETS["plain"]),
                 "context_weight": 0.8}),
    "biasing, self-overlapping": (overlapping_frames(), [17, 17], 5,
                                  {"context_phrases": phrase_table(
                                      PHRASE_SETS["self-overlapping"]),
                                   "context_weight": 1.0}),
    "biasing weight 0": (log_probs(2, 10, 8, seed=21, peaky=0.5), [10, 7], 5,
                         {"context_phrases": phrase_table(PHRASE_SETS["plain"]),
                          "context_weight": 0.0}),
}


@pytest.mark.parametrize("name", sorted(DEVICE_CASES))
def test_device_beam_matches_jax(name):
    lp, lengths, beam, kw = DEVICE_CASES[name]
    lengths = np.array(lengths, np.int32)
    v = lp.shape[-1]
    want = [np.asarray(a) for a in jax_beam.ctc_prefix_beam_device(
        lp, lengths, blank=v - 1, beam=beam, **kw)]
    got = [a.numpy() for a in port_beam.ctc_prefix_beam_device(
        _t(lp), _t(lengths), blank=v - 1, beam=beam, **kw)]
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert np.abs(got[2] - want[2]).max() <= DEVICE_BEAM_TOL
    if name == "sentinel rows":
        assert (got[2] <= -1e29).any() and (got[2] > -1e29).any()
    if name == "ties":   # one frame: exactly symbols 0, 1, 2 (+ blank) extend
        live = got[2][1] > -1e29
        assert {tuple(got[0][1, n, : got[1][1, n]]) for n in range(beam) if live[n]} == {
            (), (0,), (1,), (2,)}


def test_device_beam_hash_pairs_bit_equal_jax():
    """The state after the last frame, slot by slot: the uint32 hash pairs
    bit for bit, the tokens and masses as the n-best test holds them."""
    lp = log_probs(1, 18, 9, seed=4, peaky=1.0)
    beam, blank = 5, 8
    step = partial(jax_beam._step, blank=blank, beam=beam, cutoff_top_n=40,
                   cutoff_logp=-20.0)
    h1, h2 = jax_beam._init_hashes(beam)
    init = (jnp.zeros((beam, 18), jnp.int32), jnp.zeros((beam,), jnp.int32),
            jnp.full((beam,), -1, jnp.int32), h1, h2,
            jnp.full((beam,), jax_beam.NEG_INF).at[0].set(0.0),
            jnp.full((beam,), jax_beam.NEG_INF), (), jnp.zeros((beam, 0), jnp.float32),
            jnp.zeros((beam, 0), jnp.int32))
    final, _ = jax.jit(lambda s, x: jax.lax.scan(step, s, x))(
        init, (lp[0], jnp.ones((18,), bool)))
    toks, lens, _, h1_j, h2_j, pb, pnb = (np.asarray(a) for a in final[:7])
    state = port_beam.beam_search_state(_t(lp), _t(np.array([18])), blank, beam)
    assert np.array_equal(state["h1"][0].numpy(), h1_j.astype(np.int64))
    assert np.array_equal(state["h2"][0].numpy(), h2_j.astype(np.int64))
    assert np.array_equal(state["toks"][0].numpy(), toks)
    assert np.array_equal(state["lens"][0].numpy(), lens)
    for got, want in ((state["pb"][0], pb), (state["pnb"][0], pnb)):
        assert np.abs(got.numpy() - want).max() <= DEVICE_BEAM_TOL
    init_j = jax_beam._init_hashes(beam)
    for got, want in zip(port_beam.init_hashes(beam), init_j):
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_hash_step_is_uint32_arithmetic():
    """Against NumPy's wrapping uint32 multiply-add, at the edges of the
    range (h up to 2^32 - 1, tokens up to a large vocabulary)."""
    rng = np.random.RandomState(0)
    h = np.concatenate([[0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                        rng.randint(0, 2**32, size=200, dtype=np.uint64)]).astype(np.uint32)
    c = rng.randint(0, 100000, size=h.shape).astype(np.uint32)
    for mult in (port_beam.HASH_MULT1, port_beam.HASH_MULT2):
        with np.errstate(over="ignore"):
            want = h * np.uint32(mult) + c + np.uint32(1)
        got = port_beam.hash_step(_t(h.astype(np.int64)), mult, _t(c.astype(np.int64)))
        assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_device_beam_lm_fusion_names_its_roadmap_item():
    """LM fusion, ROADMAP queue 1 item 10, is ported: the device beam takes
    an LM step (tests/test_torch_lm_fusion.py holds it against the JAX
    package); at weight 0 it is the search without an LM."""
    from openasr_torch.models import get_model_class
    from openasr_torch.models.lm import make_lm_step_spec

    lp = log_probs(1, 4, 6, seed=0)
    lm = get_model_class("lstm_lm").create_model(
        {"type": "lstm_lm", "vocab_size": 5, "d_model": 8}, device="cpu")
    spec = make_lm_step_spec(lm)
    plain = port_beam.ctc_prefix_beam_device(_t(lp), _t(np.array([4])), blank=5)
    for w in (0.0, 0.5):
        fused = port_beam.ctc_prefix_beam_device(
            _t(lp), _t(np.array([4])), blank=5, lm_step_fn=spec["step_fn"],
            init_lm_cache=spec["init_cache_fn"](10, 5), lm_weight=w)
        assert all(torch.equal(a, b) for a, b in zip(fused, plain)) == (w == 0.0)
        # the LM's parameters record no graph across the frames
        assert not fused[2].requires_grad


# ------------------------------------------------------------ attention beam

@pytest.mark.parametrize("phrases,weight", [
    ([[5, 6, 7], [9, 9]], 1.5),
    ([[4, 5, 4, 5], [11]], 3.0),
])
def test_attention_beam_biasing_matches_jax(phrases, weight):
    from test_torch_models import build_pair, inputs

    jax_model, port = build_pair()
    x, lens, _ = inputs(3)
    tables = jax_beam.build_context_tables(phrase_table(phrases), 20)
    decode = jax.jit(partial(jax_model.batch_beam_decode, beam_size=4, max_decode_len=9,
                             context_tables=tables, context_weight=weight))
    preds_j, lens_j, scores_j = decode(jax_model.params, x, lens)
    preds_t, lens_t, scores_t = port.batch_beam_decode(
        _t(x), _t(lens), beam_size=4, max_decode_len=9,
        context_tables=port_beam.build_context_tables(phrase_table(phrases), 20),
        context_weight=weight)
    plain = port.batch_beam_decode(_t(x), _t(lens), beam_size=4, max_decode_len=9)
    assert np.array_equal(np.asarray(preds_j), preds_t.numpy())
    assert np.array_equal(np.asarray(lens_j), lens_t.numpy())
    assert np.abs(np.asarray(scores_j) - scores_t.numpy()).max() <= ATTN_BEAM_TOL
    assert not torch.equal(plain[2], scores_t)   # the biasing took effect


# ------------------------------------------------------------ scoring

HYP = "u1 今天 天气 好\nu2 hello 世界 ok\nu3 abc\nu5 多余\n"
REF = "u1 今天天气很好\nu2 hello world ok\nu3 abd [NOISE]\nu4 缺失\n"


def tools_wer():
    spec = importlib.util.spec_from_file_location("tools_wer", os.path.join(ROOT, "tools",
                                                                            "wer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flags", [[], ["--cer"], ["--cer", "--ignore", "[NOISE],好"]])
def test_port_scorer_prints_what_tools_wer_prints(tmp_path, capsys, monkeypatch, flags):
    from openasr_torch.bin import wer as port_wer

    (tmp_path / "hyp.txt").write_text(HYP, encoding="utf-8")
    (tmp_path / "ref.txt").write_text(REF, encoding="utf-8")
    argv = ["--hyp", str(tmp_path / "hyp.txt"), "--ref", str(tmp_path / "ref.txt"), *flags]
    monkeypatch.setattr(sys, "argv", ["wer.py", *argv])
    tools_wer().main()
    want = capsys.readouterr().out
    port_wer.main(argv)
    got = capsys.readouterr().out
    assert got == want and "snt" in got


def test_metrics_match_jax_package():
    from openasr_tpu.utils import metrics as jax_metrics
    from openasr_torch.utils import metrics as port_metrics

    rng = np.random.RandomState(3)
    refs = [list(rng.randint(0, 5, size=n)) for n in (0, 1, 7, 12, 9)]
    hyps = [list(rng.randint(0, 5, size=n)) for n in (3, 0, 7, 10, 13)]
    assert port_metrics.wer(refs, hyps) == jax_metrics.wer(refs, hyps)
    assert port_metrics.batch_distance(refs, hyps) == jax_metrics.batch_distance(refs, hyps)
    for r, h in zip(refs, hyps):
        assert port_metrics.align_stats(r, h) == jax_metrics.align_stats(r, h)
