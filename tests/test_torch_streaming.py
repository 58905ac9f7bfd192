"""Streaming in the port against the JAX package, on the CPU.

- `chunk_bias` equal to JAX's, and the chunk mode of the attention's plain
  version (forward and gradients) against JAX's dense attention under the
  same bias, on the rows that see a key (a padded query whose window
  starts past the length gets O = 0 in the port, softmax over NEG_INF in
  JAX; nothing reads it);
- each speech family's batch forward and loss gradients at a streaming
  config against the JAX model holding the same weights (the port draws
  them; flax's eager init is skipped): 1e-5 and 1e-4, as
  tests/test_torch_train_model.py holds the non-streaming ones;
- `StreamingRecognizer` against JAX's, tick by tick (offline features and
  waves, left context 0 and 2): enc, valid, logits and every layer's KV
  cache within 1e-5; the stream against the port's own batch forward
  within JAX's own 2e-5 / 1e-5; the bounded left context, the positional
  capacity and the config errors;
- the streaming device CTC beam over two chunkings against the one-shot
  device beam and JAX's stream step, without an LM, with a Transformer LM
  and with an LSTM LM and hotwords (n-best equal, scores 1e-4), and its
  capacity guard.

Models are d32, 2 layers, dropout 0 (the JAX package's own streaming
tests' size); every JAX function is jitted once a module.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openasr_tpu.models import get_model_class as jax_model_class
from openasr_tpu.models.layers import dot_product_attention as jax_attention
from openasr_tpu.ops import masks as jax_masks
from openasr_torch.kernels.flash_attention import flash_attention
from openasr_torch.models import get_model_class
from openasr_torch.ops.masks import ChunkMask, chunk_bias
from openasr_torch.streaming import StreamingRecognizer

from test_torch_train_model import assert_grads_match, make_batch, mix, port_loss_and_grads

ENC_TOL = 1e-5
SCORE_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def scaled_err(got, want) -> float:
    """Max abs error over max(1, the reference's largest magnitude)."""
    got, want = np.asarray(got), np.asarray(want)
    if want.size == 0:
        return 0.0
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def speech_config(streaming, online=False, model_type="conv-ctc", sub="ConvV1",
                  activation="relu"):
    """tests/test_streaming.py's `_speech_cfg` (d32, 2 heads, 2 layers,
    dropout 0, vocab 8), with the subsampler chosen."""
    signal = ({"feature_type": "fbank", "sample_rate": 16000, "num_mel_bins": 20}
              if online else {"feature_type": "offline"})
    return {
        "type": model_type, "add_eos": True, "add_blk": True, "signal": signal,
        "encoder": {"type": "Transformer", "sub": {"type": sub, "layer_num": 2},
                    "input_dim": 20, "d_model": 32, "nhead": 2, "dim_feedforward": 64,
                    "activation": activation, "num_layers": 2, "dropout_rate": 0.0,
                    "streaming": streaming},
        "decoder": {"type": "TransformerDecoder", "vocab_size": 8, "d_model": 32,
                    "nhead": 2, "num_layers": 1, "encoder_dim": 32, "dim_feedforward": 64,
                    "activation": activation, "dropout_rate": 0.0},
    }


def pair(cfg, seed=0):
    """(the port model of `cfg` from `seed`, the JAX model holding its weights)."""
    port = get_model_class(cfg["type"]).create_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    params = jax.tree_util.tree_map(jnp.asarray, port.package()["components"])
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn.Module, "init", lambda self, *a, **k: {"params": params})
        return port, jax_model_class(cfg["type"]).create_model(cfg)


# ----------------------------------------------------------------- masks

@pytest.mark.parametrize("length,chunk,left,phase", [
    (10, 4, 0, 2), (10, 4, 1, 2), (10, 4, -1, 2), (23, 3, 2, 1), (9, 16, 4, 1), (17, 5, 0, 0),
])
def test_chunk_bias_matches_jax(length, chunk, left, phase):
    want = np.asarray(jax_masks.chunk_bias(length, chunk, left, phase))
    got = chunk_bias(length, chunk, left, phase).numpy()
    assert got.shape == want.shape == (1, 1, length, length)
    assert (got == want).all()


@pytest.mark.parametrize("mask", [ChunkMask(4, 1, 1), ChunkMask(5, -1, 2), ChunkMask(4, 0, 0)])
def test_chunk_mode_plain_attention_matches_jax_dense(mask):
    """The plain version under the chunk mask and key padding against the
    JAX package's dense attention under combine_bias(padding_bias,
    chunk_bias): outputs 1e-5 and gradients 1e-4, of a loss over the rows
    below each length."""
    rng = np.random.RandomState(3)
    b, t, h, d = 2, 23, 2, 8
    q, k, v = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(3))
    lens = np.array([23, 14], np.int32)
    w = rng.randn(b, t, h, d).astype(np.float32) * (np.arange(t)[None, :] < lens[:, None])[
        ..., None, None]
    bias = jax_masks.combine_bias(jax_masks.padding_bias(jnp.asarray(lens), t),
                                  jax_masks.chunk_bias(t, *mask))

    def jax_loss(q_, k_, v_):
        out = jax_attention(q_, k_, v_, bias)
        return jnp.sum(out * w), out

    (_, out_j), grads_j = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                                     has_aux=True))(q, k, v)
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out_t, _ = flash_attention(qt, kt, vt, kv_lengths=_t(lens), chunk_mask=mask)
    (out_t * _t(w)).sum().backward()
    valid = np.arange(t)[None, :] < lens[:, None]
    assert np.abs(out_t.detach().numpy() - np.asarray(out_j))[valid].max() <= ENC_TOL
    for got, want in zip((qt, kt, vt), grads_j):
        assert np.abs(got.grad.numpy() - np.asarray(want)).max() <= SCORE_TOL


def test_chunk_mode_rows_without_keys_are_zero():
    """A padded query whose chunk window starts past the length sees no
    key: O = 0, lse = +inf, and its gradient 0, never NaN; causal and the
    chunk mask together raise."""
    rng = np.random.RandomState(4)
    q, k, v = (_t(rng.randn(1, 12, 1, 8).astype(np.float32)).requires_grad_()
               for _ in range(3))
    out, lse = flash_attention(q, k, v, kv_lengths=_t(np.array([3])),
                               chunk_mask=ChunkMask(4, 0, 1))
    # chunks: 0-2 | 3-6 | 7-10 | 11; keys 0-2 valid, so rows 3-11 see none
    assert (out[0, 3:] == 0).all() and torch.isinf(lse[0, 0, 3:]).all()
    assert torch.isfinite(lse[0, 0, :3]).all()
    out.sum().backward()
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))
    assert (q.grad[0, 3:] == 0).all() and (k.grad[0, 3:] == 0).all()
    with pytest.raises(ValueError, match="do not combine"):
        flash_attention(q, k, v, causal=True, chunk_mask=ChunkMask(4, 0, 1))


# ---------------------------------------------------------- batch models

@pytest.mark.parametrize("model_type,left", [("conv-ctc-transformer", 0),
                                             ("conv-transformer", 1), ("conv-ctc", -1)])
def test_streaming_batch_forward_and_grads_match_jax(model_type, left):
    """tests/test_torch_train_model.py's loss and gradient check at
    encoder.streaming {chunk 4, left_chunks `left`} (left 0 leaves padded
    rows without a visible key), and the encoder output on valid rows."""
    from test_torch_models import small_config

    cfg = small_config(model_type)
    cfg["encoder"]["streaming"] = {"chunk": 4, "left_chunks": left}
    port, jm = pair(cfg, 1)
    batch = make_batch(2, lengths=(41, 30, 19))

    def run(params, batch):
        def f(p):
            losses = jm.loss(p, batch, {}, train=False, label_smooth=0.1)
            return mix(losses, model_type), losses

        (total, losses), grads = jax.value_and_grad(f, has_aux=True)(params)
        enc = jm.module.apply({"params": params}, batch["feats"], batch["feat_lengths"],
                              method=type(jm.module).encode)
        return total, losses, grads, enc

    tot_j, losses_j, grads_j, (enc_j, elens_j) = jax.jit(run)(jm.params, batch)
    tot_t, losses_t, grads_t = port_loss_and_grads(port, batch, model_type)
    for key, want in losses_j.items():
        assert abs(losses_t[key] - float(want)) <= 1e-5 * max(abs(float(want)), 1.0), key
    assert abs(tot_t - float(tot_j)) <= 1e-5 * abs(float(tot_j))
    assert_grads_match(grads_j, grads_t, model_type)
    with torch.no_grad():
        x, lens = _t(batch["feats"]), _t(batch["feat_lengths"])
        enc_t, elens_t = port.module.encoder(*port.module.splayer(x, lens))
    assert elens_t.tolist() == np.asarray(elens_j).tolist()
    valid = np.arange(enc_t.shape[1])[None, :] < elens_t.numpy()[:, None]
    assert np.abs(enc_t.numpy() - np.asarray(enc_j))[valid].max() <= ENC_TOL


# ----------------------------------------------------------- the executor

def stream_inputs(rec, online, seed):
    rng = np.random.RandomState(seed)
    if online:
        lens = np.array([3 * rec.chunk_samples + 1000, 2 * rec.chunk_samples - 700])
        x = (rng.randn(2, int(lens.max())) * 0.1).astype(np.float32)
    else:
        lens = np.array([37, 21])
        x = (rng.randn(2, 37, 20) * 0.5).astype(np.float32)
    for i, n in enumerate(lens):
        x[i, n:] = 0.0
    return x, lens


@pytest.mark.parametrize("online,left", [(False, 0), (False, 2), (True, 0), (True, 2)])
def test_recognizer_ticks_match_jax_and_the_batch_forward(online, left):
    """Every tick of the port's executor against JAX's on the same chunks
    (enc, valid, logits, each layer's K/V cache: 1e-5 of max(1, the
    largest magnitude); the K/V of the wave model reach 10), then
    decode_waves against the port's batch forward (encoder states on
    valid frames 2e-5 / 1e-5, lengths and greedy hypotheses equal).
    Offline: conv-ctc-transformer with ConvV2 (the flagship's
    subsampler); waves: conv-ctc with ConvV1."""
    from openasr_tpu.streaming import StreamingRecognizer as JaxRecognizer
    from openasr_torch.ops.ctc_decode import ctc_greedy_decode

    cfg = (speech_config({"chunk": 8, "left_chunks": left}, online=True) if online else
           speech_config({"chunk": 4, "left_chunks": left}, model_type="conv-ctc-transformer",
                         sub="ConvV2", activation="glu"))
    port, jm = pair(cfg, 2)
    rec, jrec = StreamingRecognizer(port), JaxRecognizer(jm)
    assert (rec.phase, rec.offline) == (jrec.phase, jrec.offline) == ((1, True) if not online
                                                                      else (2, False))
    x, lens = stream_inputs(rec, online, 5 + left)
    unit = rec.chunk_feats if rec.offline else rec.chunk_samples
    n_chunks = -(-x.shape[1] // unit)
    xp = np.pad(x, [(0, 0), (0, n_chunks * unit - x.shape[1])] + [(0, 0)] * (x.ndim - 2))
    state, jstate = rec.init_state(2), jrec.init_state(2)
    for n in range(n_chunks):
        piece = xp[:, n * unit:(n + 1) * unit]
        clens = np.clip(lens - n * unit, 0, unit).astype(np.int32)
        state, out = rec.step(state, piece, clens)
        jstate, jout = jrec.step(jstate, piece, clens)
        assert (out["valid"].numpy() == np.asarray(jout["valid"])).all()
        for key in ("enc", "logits"):
            assert scaled_err(out[key], jout[key]) <= ENC_TOL, (n, key)
        for name, kv in state["kv"].items():
            for key in ("k", "v"):
                assert scaled_err(kv[key], jstate["kv"][name][key]) <= ENC_TOL, (n, name, key)
        assert state["fed"].tolist() == np.asarray(jstate["fed"]).tolist()

    hyps, enc_s, enc_lens = rec.decode_waves(x, lens)
    with torch.no_grad():
        enc_b, elens_b = port.module.encoder(*port.module.splayer(_t(x), _t(lens)))
        logits = (port.get_logits(_t(x), _t(lens)) if online else
                  port.module(_t(x), _t(lens), _t(np.ones((2, 1), np.int64)))[:2])
        ids, idlens = ctc_greedy_decode(*logits)
    assert enc_lens.tolist() == elens_b.tolist()
    for i, n in enumerate(enc_lens.tolist()):
        np.testing.assert_allclose(enc_s[i, :n].numpy(), enc_b[i, :n].numpy(),
                                   atol=2e-5, rtol=1e-5)
        assert hyps[i] == ids[i, : idlens[i]].tolist()


def test_left_context_is_bounded():
    """Input older than the attention window leaves later encoder frames
    as they were (tests/test_streaming.py:155)."""
    port, _ = pair(speech_config({"chunk": 4, "left_chunks": 1}), 3)
    rec = StreamingRecognizer(port)
    feats = (np.random.RandomState(2).randn(1, 256, 20) * 0.5).astype(np.float32)
    feats2 = feats.copy()
    feats2[0, :8] += 3.0
    lens = np.array([256])
    _, enc_a, _ = rec.decode_waves(feats, lens)
    _, enc_b, _ = rec.decode_waves(feats2, lens)
    far = 8 * 4
    np.testing.assert_allclose(enc_a[0, far:].numpy(), enc_b[0, far:].numpy(), atol=1e-6)
    assert (enc_a[0, :8] - enc_b[0, :8]).abs().max() > 1e-3


def test_capacity_and_config_errors_match_jax():
    """The positional-encoding capacity (decode_waves up front, step at the
    chunk past it), a config without encoder.streaming, unlimited left
    context and a subsampler that is not x4 raise JAX's errors; a wider
    table takes the same stream, exact against the batch forward."""
    from openasr_tpu.streaming import StreamingRecognizer as JaxRecognizer

    port, jm = pair(speech_config({"chunk": 4, "left_chunks": 1}), 4)
    rec = StreamingRecognizer(port, max_frames=8)
    feats = np.random.RandomState(0).randn(1, 4 * rec.chunk_feats, 20).astype(np.float32)
    lens = np.array([feats.shape[1]])
    with pytest.raises(ValueError, match="positional-encoding capacity"):
        rec.decode_waves(feats, lens)
    state = rec.init_state(1)
    piece = feats[:, : rec.chunk_feats]
    state, _ = rec.step(state, piece)
    state, _ = rec.step(state, piece)
    with pytest.raises(ValueError, match="positional-encoding capacity") as port_err:
        rec.step(state, piece)
    jrec = JaxRecognizer(jm, max_frames=8)
    jstate = jrec.init_state(1)
    for _ in range(2):
        jstate, _ = jrec.step(jstate, piece)
    with pytest.raises(ValueError) as jax_err:
        jrec.step(jstate, piece)
    assert str(port_err.value) == str(jax_err.value)

    _, enc_s, enc_lens = StreamingRecognizer(port, max_frames=64).decode_waves(feats, lens)
    with torch.no_grad():
        enc_b, elens_b = port.module.encoder(_t(feats), _t(lens))
    n = int(enc_lens[0])
    assert n == int(elens_b[0])
    np.testing.assert_allclose(enc_s[0, :n].numpy(), enc_b[0, :n].numpy(), atol=2e-5, rtol=1e-5)

    for streaming, sub, match in ((None, "ConvV1", "encoder.streaming"),
                                  ({"chunk": 4, "left_chunks": -1}, "ConvV1", "left_chunks"),
                                  ({"chunk": 4, "left_chunks": 1}, "Stack", "x4 time")):
        cfg = speech_config(streaming, sub=sub)
        if streaming is None:
            del cfg["encoder"]["streaming"]
        port, jm = pair(cfg, 5)
        with pytest.raises(ValueError, match=match) as port_err:
            StreamingRecognizer(port)
        with pytest.raises(ValueError) as jax_err:
            JaxRecognizer(jm)
        assert str(port_err.value) == str(jax_err.value)


# ------------------------------------------------------ the device beam

V = 8


def lm_pair(lm_type, seed):
    cfg = ({"type": "lstm_lm", "vocab_size": V - 1, "d_model": 16, "n_layers": 1}
           if lm_type == "lstm_lm" else
           {"type": "transformer_lm", "vocab_size": V - 1, "d_model": 16, "nhead": 2,
            "num_layers": 1, "dim_feedforward": 32, "dropout_rate": 0.0})
    return pair(cfg, seed)


def random_log_probs(b, t, seed):
    """tests/test_ctc_beam_device.py's peaky random log-probs."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, t, V).astype(np.float32) * 2.0
    logits[np.arange(b)[:, None], np.arange(t)[None, :], rng.randint(0, V, (b, t))] += 4.0
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


def check_nbest(got, want, what):
    g_toks, g_lens, g_scores = (np.asarray(a) for a in got)
    w_toks, w_lens, w_scores = (np.asarray(a) for a in want)
    live = w_scores > -1e29
    assert ((g_scores > -1e29) == live).all(), what
    assert (g_lens == w_lens)[live].all(), what
    for i, n in zip(*np.nonzero(live)):
        assert g_toks[i, n, : g_lens[i, n]].tolist() == w_toks[i, n, : w_lens[i, n]].tolist(), \
            what
    assert np.abs(g_scores - w_scores)[live].max() <= SCORE_TOL, what


@pytest.mark.parametrize("lm_type,hotwords", [(None, False), ("transformer_lm", False),
                                              ("lstm_lm", True)])
def test_stream_beam_equals_one_shot_and_jax(lm_type, hotwords):
    """Chunks of 5 frames and one chunk of all 18: the streamed n-best
    after the last chunk equals the port's one-shot device beam and JAX's
    stream step (tokens and lengths, scores 1e-4), and the chunked state's
    hash pairs and lengths equal the one-shot search's."""
    from openasr_tpu.models.lm import make_lm_step_spec as jax_spec
    from openasr_tpu.ops import ctc_beam_device as jbeam
    from openasr_torch.models.lm import make_lm_step_spec
    from openasr_torch.ops.ctc_beam_device import (
        build_context_tables,
        ctc_beam_stream_init,
        ctc_beam_stream_step,
        ctc_prefix_beam_device,
    )

    b, t, beam, blank, w_lm = 2, 18, 4, V - 1, 0.5
    lp = random_log_probs(b, t, 41)
    lengths = np.array([t, t - 5])
    tables = build_context_tables(np.array([[1, 2, 1, -1], [4, 4, -1, -1]], np.int32), V) \
        if hotwords else None
    ctx = {"context_tables": tables, "context_weight": 0.7} if hotwords else {}
    init_kw, step_kw, jinit_kw, jstep_kw, one_kw = {}, {}, {}, {}, {}
    if hotwords:
        init_kw["num_phrases"] = jinit_kw["num_phrases"] = 2
    if lm_type is not None:
        port_lm, jax_lm = lm_pair(lm_type, 9)
        spec, js = make_lm_step_spec(port_lm), jax_spec(jax_lm)
        init_kw.update(lm_step_fn=spec["step_fn"])
        step_kw.update(lm_step_fn=spec["step_fn"], lm_weight=w_lm)
        jinit_kw.update(lm_step_fn=js["step_fn"], init_lm_cache=js["init_cache_fn"](b * beam, t + 1),
                        lm_params=js["params"])
        jstep_kw.update(lm_step_fn=js["step_fn"], lm_weight=w_lm, lm_params=js["params"])
        one_kw.update(lm_step_fn=spec["step_fn"], lm_weight=w_lm)

    with torch.inference_mode():
        if lm_type is not None:
            one_kw["init_lm_cache"] = spec["init_cache_fn"](b * beam, t + 1)
        want = ctc_prefix_beam_device(_t(lp), _t(lengths), blank=blank, beam=beam, **ctx,
                                      **one_kw)
    for chunk in (5, t):
        if lm_type is not None:
            init_kw["init_lm_cache"] = spec["init_cache_fn"](b * beam, t + 1)
        state = ctc_beam_stream_init(b, beam, t, **init_kw)
        jstate = jbeam.ctc_beam_stream_init(b, beam, t, **jinit_kw)
        for start in range(0, t, chunk):
            sl = lp[:, start:start + chunk]
            valid = np.arange(start, start + sl.shape[1])[None, :] < lengths[:, None]
            state, got = ctc_beam_stream_step(state, _t(sl), _t(valid), blank, beam, **ctx,
                                              **step_kw)
            jstate, jgot = jbeam.ctc_beam_stream_step(jstate, sl, valid, blank, beam,
                                                      **ctx, **jstep_kw)
        check_nbest(got, want, f"chunk {chunk} vs one-shot")
        check_nbest(got, jgot, f"chunk {chunk} vs JAX")
        assert state["fed"].tolist() == lengths.tolist()
        for key in ("h1", "h2", "lens"):
            assert state[key].tolist() == np.asarray(jstate[key]).tolist(), key


def test_stream_beam_capacity_guard_is_loud():
    """Feeding more valid frames than the token buffer holds raises JAX's
    error before any frame is decoded."""
    from openasr_tpu.ops import ctc_beam_device as jbeam
    from openasr_torch.ops.ctc_beam_device import ctc_beam_stream_init, ctc_beam_stream_step

    lp = random_log_probs(1, 6, 7)
    valid = np.ones((1, 6), bool)
    state = ctc_beam_stream_init(1, 3, max_frames=8)
    state, _ = ctc_beam_stream_step(state, _t(lp[:, :4]), _t(valid[:, :4]), V - 1, 3)
    with pytest.raises(ValueError, match="beam token buffer") as port_err:
        ctc_beam_stream_step(state, _t(lp[:, :6]), _t(valid), V - 1, 3)
    jstate = jbeam.ctc_beam_stream_init(1, 3, max_frames=8)
    jstate, _ = jbeam.ctc_beam_stream_step(jstate, lp[:, :4], valid[:, :4], V - 1, 3)
    with pytest.raises(ValueError) as jax_err:
        jbeam.ctc_beam_stream_step(jstate, lp[:, :6], valid, V - 1, 3)
    assert str(port_err.value) == str(jax_err.value)
