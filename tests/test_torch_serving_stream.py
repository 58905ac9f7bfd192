"""The port's streaming serving artifacts and its export CLI against the JAX
package's, on the CPU.

- `export_streaming_step`, offline features and waves (the fbank operator
  in the tick): every tick of the port's artifact against the JAX
  artifact's from the same package weights and chunks (enc and logits
  within 1e-5 of max(1, the largest magnitude), as
  tests/test_torch_streaming.py holds the live executors; valid and the
  state's frame counts equal) and equal to the port's live tick;
- `export_stream_beam` with the LSTM LM and a hotword: each tick's n-best
  equal to the JAX artifact's (scores within 1e-5) and to the live
  `ctc_beam_stream_step`'s, the last equal to the one-shot device beam;
- the loaders' refusals of tests/test_serving.py;
- `openasr_torch.bin.export_decode` against tools/export_decode.py on one
  package: the streaming tick, and the int8 attention beam with hotwords.
"""

import os
import sys

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openasr_tpu import serving as jax_serving
from openasr_tpu.models import get_model_class as jax_model_class
from openasr_torch import serving
from openasr_torch.models import get_model_class
from openasr_torch.streaming import StreamingRecognizer

from test_torch_streaming import scaled_err, speech_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENC_TOL = 1e-5
SCORE_TOL = 1e-5
MAX_FRAMES = 12          # 3 ticks of chunk 4 at phase 1; the 4th is refused


def pair(cfg, seed):
    """(the port model of `cfg` from `seed`, the JAX model holding its weights)."""
    port = get_model_class(cfg["type"]).create_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    params = jax.tree_util.tree_map(jnp.asarray, port.package()["components"])
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn.Module, "init", lambda self, *a, **k: {"params": params})
        return port, jax_model_class(cfg["type"]).create_model(cfg)


@pytest.fixture(scope="module", params=["offline", "online"])
def streamers(request, tmp_path_factory):
    online = request.param == "online"
    port, jm = pair(speech_config({"chunk": 4, "left_chunks": 2}, online=online), 7)
    tmp = tmp_path_factory.mktemp("stream")
    kw = dict(batch_sizes=[2], platforms=("cpu",), max_frames=MAX_FRAMES)
    serving.export_streaming_step(port, path=str(tmp / "port"), **kw)
    jax_serving.export_streaming_step(jm, path=str(tmp / "jax"), **kw)
    return {"online": online, "port": port, "jax": jm, "path": str(tmp / "port"),
            "s": serving.ExportedStreamer(str(tmp / "port")),
            "js": jax_serving.ExportedStreamer(str(tmp / "jax"))}


def test_streaming_step_matches_jax_and_the_live_tick(streamers):
    st, js, port = streamers["s"], streamers["js"], streamers["port"]
    params = st.prepare_params(port.package())
    rec = StreamingRecognizer(port, max_frames=MAX_FRAMES)
    state, jstate, live = st.init_state(2), js.init_state(2), rec.init_state(2)
    assert set(st.meta["state"]["2"]) == set(js.meta["state"]["2"])
    rng = np.random.RandomState(3)
    n = st.meta["chunk_input"]
    assert n == js.meta["chunk_input"]
    for tick in range(3):
        chunk = (rng.randn(2, *n) * (0.1 if streamers["online"] else 1.0)).astype(np.float32)
        lens = np.asarray([n[0], n[0] - 3 if tick == 2 else n[0]], np.int32)
        state, out = st.step(params, state, chunk, lens)
        jstate, jout = js.step(streamers["jax"].params, jstate, chunk, lens)
        live, lout = rec.step(live, chunk, lens)
        np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(jout["valid"]))
        for key in ("enc", "logits"):
            assert scaled_err(out[key].numpy(), jout[key]) <= ENC_TOL, (tick, key)
            assert torch.equal(out[key], lout[key]), (tick, key)
        assert state["fed"].tolist() == np.asarray(jstate["fed"]).tolist()
        assert int(state["chunk_idx"]) == int(jstate["chunk_idx"]) == tick + 1
        for name, kv in state["kv"].items():
            for key in ("k", "v"):
                assert scaled_err(kv[key].numpy(), jstate["kv"][name][key]) <= ENC_TOL
                assert torch.equal(kv[key], live["kv"][name][key])

    # the positional-encoding capacity: max_frames 12 takes 3 chunks of 4
    with pytest.raises(ValueError, match="capacity"):
        st.step(params, state, chunk)


def test_streamer_refusals(streamers):
    st = streamers["s"]
    params = st.prepare_params(streamers["port"].package())
    with pytest.raises(ValueError, match="batch_size"):
        st.init_state(3)
    state = st.init_state(2)
    n = st.meta["chunk_input"]
    with pytest.raises(ValueError, match="chunk shape"):
        st.step(params, state, np.zeros([2, n[0] - 1] + n[1:], np.float32))
    with pytest.raises(ValueError, match="batch_size"):
        st.step(params, state, np.zeros([4] + n, np.float32))
    with pytest.raises(ValueError, match="not a stream_beam artifact"):
        serving.ExportedStreamBeam(streamers["path"])


def test_stream_beam_matches_jax_and_the_live_beam(tmp_path):
    """tests/test_serving.py:test_export_stream_beam_roundtrip (LSTM LM,
    one hotword phrase), at chunk 4 over 12 frames."""
    from openasr_torch.models.lm import make_lm_step_spec
    from openasr_torch.ops.ctc_beam_device import (
        build_context_tables,
        ctc_beam_stream_init,
        ctc_beam_stream_step,
        ctc_prefix_beam_device,
    )

    b, chunk, v, beam, t = 2, 4, 10, 4, 12
    blank, w_lm, w_ctx = v - 1, 0.5, 1.0
    lm, jlm = pair({"type": "lstm_lm", "vocab_size": v - 1, "d_model": 16, "n_layers": 1,
                    "dropout_rate": 0.0}, 8)
    phrases = np.asarray([[1, 2, 1, -1]], np.int32)
    kw = dict(batch=b, beam=beam, chunk=chunk, max_frames=t, vocab_size=v, blank=blank,
              platforms=("cpu",), lm_weight=w_lm, context_phrases=phrases,
              context_weight=w_ctx)
    serving.export_stream_beam(str(tmp_path / "port"), lm=lm, **kw)
    jax_serving.export_stream_beam(str(tmp_path / "jax"), lm=jlm, **kw)
    sb = serving.ExportedStreamBeam(str(tmp_path / "port"))
    jsb = jax_serving.ExportedStreamBeam(str(tmp_path / "jax"))
    assert sb.meta["context_num_phrases"] == 1 and sb.meta["lm"]["model_type"] == "lstm_lm"

    rng = np.random.RandomState(9)
    logits = rng.randn(b, t, v).astype(np.float32) * 2.0
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lengths = np.asarray([t, t - 3], np.int32)
    lm_params = sb.prepare_lm_params(lm.package())
    spec = make_lm_step_spec(lm)
    tables = build_context_tables(phrases, v)
    state, jstate = sb.init_state(lm_params), jsb.init_state(lm_params=jlm.params)
    live = ctc_beam_stream_init(b, beam, t, spec["step_fn"], spec["init_cache_fn"](b * beam, t + 1),
                                num_phrases=1)
    for start in range(0, t, chunk):
        sl = lp[:, start: start + chunk]
        valid = np.arange(start, start + chunk)[None, :] < lengths[:, None]
        state, out = sb.step(state, sl, valid, lm_params)
        jstate, jout = jsb.step(jstate, sl, valid, lm_params=jlm.params)
        live, lout = ctc_beam_stream_step(live, torch.from_numpy(sl), torch.from_numpy(valid),
                                          blank, beam, lm_step_fn=spec["step_fn"],
                                          lm_weight=w_lm, context_tables=tables,
                                          context_weight=w_ctx)
        for ref in ([np.asarray(x) for x in jout], [x.numpy() for x in lout]):
            toks, lens, scores = (x.numpy() for x in out)
            np.testing.assert_array_equal(lens, ref[1])
            np.testing.assert_allclose(scores, ref[2], rtol=SCORE_TOL, atol=SCORE_TOL)
            for i in range(b):
                for k in range(beam):
                    np.testing.assert_array_equal(toks[i, k, : lens[i, k]],
                                                  ref[0][i, k, : lens[i, k]])

    one = ctc_prefix_beam_device(
        torch.from_numpy(lp), torch.from_numpy(lengths), blank=blank, beam=beam,
        lm_step_fn=spec["step_fn"], init_lm_cache=spec["init_cache_fn"](b * beam, t + 1),
        lm_weight=w_lm, context_tables=tables, context_weight=w_ctx)
    assert torch.equal(out[1], one[1])
    np.testing.assert_allclose(out[2].numpy(), one[2].numpy(), atol=SCORE_TOL)

    # the token buffer's guard survives the export; the LM either way
    with pytest.raises(ValueError, match="token buffer"):
        sb.step(state, lp[:, :chunk], np.ones((b, chunk), bool), lm_params)
    with pytest.raises(ValueError, match="LM"):
        sb.init_state()
    with pytest.raises(ValueError, match="LM"):
        sb.step(state, lp[:, :chunk], np.zeros((b, chunk), bool))


@pytest.mark.parametrize("mode", ["streaming", "beam int8 hotwords"])
def test_export_cli_matches_tools_export_decode(mode, tmp_path):
    """One package through `python -m openasr_torch.bin.export_decode` and
    tools/export_decode.py with the same flags: the two artifacts serve the
    same input alike (the tick within 1e-5; preds equal, scores within
    1e-5).  `--device cuda` without a card raises."""
    from openasr_torch.utils.checkpoint import save_package

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import export_decode as jax_cli

    from openasr_torch.bin import export_decode as port_cli

    model_type = "conv-ctc" if mode == "streaming" else "conv-ctc-transformer"
    cfg = speech_config({"chunk": 4, "left_chunks": 2}, model_type=model_type)
    port, _ = pair(cfg, 10)
    pkg = str(tmp_path / "last.pkg")
    save_package({"model": port.package()}, pkg)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("a\nb\nc\nd\n")
    hot = tmp_path / "hot.txt"
    hot.write_text("a b\n")
    argv = ["--model_type", model_type, "--model_pkg", pkg, "--vocab_path", str(vocab),
            "--add_blk", "--platforms", "cpu"]
    if mode == "streaming":
        argv += ["--streaming", "--stream_batches", "2"]
    else:
        argv += ["--buckets", "2x32", "--nbest", "2", "--maxlen", "4", "--int8",
                 "--context_file", str(hot), "--context_weight", "1.5"]
    out_p, out_j = str(tmp_path / "port.zip"), str(tmp_path / "jax.zip")
    port_cli.main(argv + ["--out", out_p, "--device", "cpu"])
    jax_cli.main(argv + ["--out", out_j])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            port_cli.main(argv + ["--out", out_p, "--device", "cuda"])

    from openasr_torch.utils.checkpoint import load_package

    model_pkg = load_package(pkg)["model"]
    jax_params = jax.tree_util.tree_map(jnp.asarray, model_pkg["components"])
    rng = np.random.RandomState(4)
    if mode == "streaming":
        s, js = serving.ExportedStreamer(out_p), jax_serving.ExportedStreamer(out_j)
        chunk = rng.randn(2, 16, 20).astype(np.float32)
        _, tick = s.step(s.prepare_params(model_pkg), s.init_state(2), chunk)
        _, jtick = js.step(jax_params, js.init_state(2), chunk)
        assert scaled_err(tick["logits"].numpy(), jtick["logits"]) <= ENC_TOL
        return
    dec, jdec = serving.ExportedDecoder(out_p), jax_serving.ExportedDecoder(out_j)
    assert dec.meta["context_weight"] == jdec.meta["context_weight"] == 1.5
    assert dec.meta["weights"] == jdec.meta["weights"] == "int8"
    feats, lens = rng.randn(2, 32, 20).astype(np.float32), np.array([32, 26], np.int32)
    got = dec(dec.prepare_params(model_pkg), feats, lens)
    want = jdec(jdec.prepare_params(jax_params), feats, lens)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=SCORE_TOL,
                               atol=SCORE_TOL)
