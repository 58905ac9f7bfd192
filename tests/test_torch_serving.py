"""The port's batch-decode serving artifacts (openasr_torch/serving.py)
against the JAX package's (openasr_tpu/serving.py), on the CPU.

One port artifact and one JAX artifact a kind, exported for the CPU from
the same package weights (the port draws them; the JAX models take the
port's packages, flax's eager init skipped), serve the same seeded
features:

- kind 'beam' (conv-transformer, beam 2, maxlen 4): float32 weights at two
  buckets, int8 weights (d64, so that most leaves quantize), the LSTM LM
  fused, hotwords baked in;
- kind 'ctc' (conv-ctc greedy + log-probs) and kind 'ctc_beam' (the device
  prefix beam with the Transformer LM, hotwords and custom cutoffs);

with preds, lengths and n-best equal and scores within 1e-5.  The port's
exported output equals its live decode; an artifact serves a second
checkpoint without re-export and holds no weight; the beam without its
early exit equals the live beam; the loaders' refusals are the JAX
package's; a subprocess serves an artifact without importing
`openasr_torch.models`; and a model with the fbank frontend exports a
program that takes waves through the fbank operator.
"""

import json
import os
import subprocess
import sys
import zipfile

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
from openasr_torch.ops.ctc_beam_device import build_context_tables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = 1e-5
PHRASES = np.asarray([[3, 4, -1], [6, 7, 8]], np.int32)


def encoder(d=32, ffn=64):
    return {"type": "Transformer", "sub": {"type": "ConvV2", "layer_num": 1}, "input_dim": 20,
            "d_model": d, "nhead": 2, "dim_feedforward": ffn, "activation": "relu",
            "num_layers": 1, "dropout_rate": 0.0}


def attention_config(d=32, ffn=64):
    """tests/test_serving.py's `small_model` (d 32) and tests/test_quant.py's
    `_export_model` (d 64)."""
    return {"type": "conv-transformer", "signal": {"feature_type": "offline"},
            "encoder": encoder(d, ffn),
            "decoder": {"type": "TransformerDecoder", "vocab_size": 20, "d_model": d,
                        "nhead": 2, "num_layers": 1, "encoder_dim": d,
                        "dim_feedforward": ffn, "activation": "relu", "dropout_rate": 0.0}}


CTC_CONFIG = {"type": "conv-ctc", "add_blk": True, "signal": {"feature_type": "offline"},
              "encoder": encoder(), "decoder": {"vocab_size": 12}}
LSTM_LM = {"type": "lstm_lm", "vocab_size": 20, "d_model": 16, "n_layers": 1,
           "dropout_rate": 0.0}
TRANSFORMER_LM = {"type": "transformer_lm", "vocab_size": 11, "d_model": 16, "nhead": 2,
                  "num_layers": 1, "dim_feedforward": 32, "dropout_rate": 0.0}


def pair(cfg, seed):
    """(the port model of `cfg` from `seed`, the JAX model holding its weights)."""
    port = get_model_class(cfg["type"]).create_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    params = jax.tree_util.tree_map(jnp.asarray, port.package()["components"])
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn.Module, "init", lambda self, *a, **k: {"params": params})
        return port, jax_model_class(cfg["type"]).create_model(cfg)


def features(b, t, seed):
    return np.random.RandomState(seed).randn(b, t, 20).astype(np.float32)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """name -> (port model, JAX model, port decoder, JAX decoder, export
    kwargs), each exported once per module, on first use."""
    tmp = tmp_path_factory.mktemp("serving")
    cache = {}
    models = {}

    def model(name, cfg, seed):
        if name not in models:
            models[name] = pair(cfg, seed)
        return models[name]

    def specs():
        att, att64 = attention_config(), attention_config(64, 128)
        return {
            "beam": (("att", att, 0), None, dict(buckets=[(2, 32), (4, 64)])),
            "beam int8": (("att64", att64, 1), None, dict(weights="int8")),
            "beam lm": (("att", att, 0), ("lstm", LSTM_LM, 2), dict(lm_weight=0.4)),
            "beam hotwords": (("att", att, 0), None,
                              dict(context_phrases=PHRASES, context_weight=2.0)),
            "ctc": (("ctc", CTC_CONFIG, 3), None, dict(beam_size=5)),
            "ctc_beam": (("ctc", CTC_CONFIG, 3), ("tlm", TRANSFORMER_LM, 4),
                         dict(buckets=[(2, 12)], beam_size=3, ctc_device_beam=True,
                              cutoff_top_n=6, cutoff_logp=-9.0, lm_weight=0.5,
                              context_phrases=PHRASES, context_weight=2.0)),
        }

    def get(name):
        if name not in cache:
            (mname, cfg, seed), lm_spec, kw = specs()[name]
            port, jm = model(mname, cfg, seed)
            kw = {"buckets": [(2, 32)], "beam_size": 2, "max_decode_len": 4, **kw}
            lms = model(*lm_spec) if lm_spec else (None, None)
            path_p, path_j = str(tmp / f"{name}.port"), str(tmp / f"{name}.jax")
            serving.export_beam_decode(port, path=path_p, platforms=("cpu",), lm=lms[0], **kw)
            jax_serving.export_beam_decode(jm, path=path_j, platforms=("cpu",), lm=lms[1],
                                           **kw)
            cache[name] = {"port": port, "jax": jm, "lm": lms, "kw": kw, "path": path_p,
                           "dec": serving.ExportedDecoder(path_p),
                           "jdec": jax_serving.ExportedDecoder(path_j), "jpath": path_j}
        return cache[name]

    get.model = model
    return get


def serve_both(a, feats, lens):
    """(port outputs, JAX outputs) as NumPy, each artifact given its
    checkpoint's weights in its own form."""
    port_p = a["dec"].prepare_params(a["port"].package())
    jax_p = a["jdec"].prepare_params(a["jax"].params)
    lm_kw, jlm_kw = {}, {}
    if a["lm"][0] is not None:
        lm_kw = {"lm_params": a["dec"].prepare_lm_params(a["lm"][0].package())}
        jlm_kw = {"lm_params": a["lm"][1].params}
    got = a["dec"](port_p, feats, lens, **lm_kw)
    want = a["jdec"](jax_p, feats, lens, **jlm_kw)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def assert_nbest_equal(got, want):
    """preds / tokens and lengths equal, scores within SCORE_TOL."""
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=SCORE_TOL, atol=SCORE_TOL)


def live(a, feats, lens):
    """The port's live decode of the artifact's settings."""
    port, kw = a["port"], a["kw"]
    f, ln = torch.from_numpy(feats), torch.from_numpy(lens)
    ctx = ({"context_tables": build_context_tables(kw["context_phrases"],
                                                   int(port.configs.decoder["vocab_size"])),
            "context_weight": kw["context_weight"]} if "context_phrases" in kw else {})
    lm = a["lm"][0]
    if a["dec"].meta["kind"] == "beam":
        return port.batch_beam_decode(f, ln, beam_size=kw["beam_size"],
                                      max_decode_len=kw["max_decode_len"], lm=lm,
                                      lm_weight=kw.get("lm_weight", 0.0), **ctx)
    from openasr_torch.models.lm import make_lm_fusion
    from openasr_torch.ops.ctc_beam_device import ctc_prefix_beam_device

    logits, len_logits = port.get_logits(f, ln)
    lp = torch.log_softmax(logits.float(), dim=-1)
    step_fn, cache = make_lm_fusion(lm, lp.shape[0] * kw["beam_size"], lp.shape[1] + 1)
    return ctc_prefix_beam_device(lp, len_logits, blank=11, beam=kw["beam_size"],
                                  cutoff_top_n=kw["cutoff_top_n"],
                                  cutoff_logp=kw["cutoff_logp"], lm_step_fn=step_fn,
                                  init_lm_cache=cache, lm_weight=kw["lm_weight"], **ctx)


@pytest.mark.parametrize("name", ["beam", "beam int8", "beam lm", "beam hotwords", "ctc_beam"])
def test_artifact_matches_jax_and_the_live_decode(built, name):
    a = built(name)
    t = 12 if name == "ctc_beam" else 32
    feats, lens = features(2, t, 7), np.array([t, t - 3], np.int32)
    got, want = serve_both(a, feats, lens)
    assert_nbest_equal(got, want)
    ref = [r.numpy() for r in live(a, feats, lens)]
    if name == "beam int8":
        # int8 against the float live decode, as tests/test_quant.py:72
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_allclose(got[2], ref[2], rtol=0.05, atol=0.05)
    else:
        assert_nbest_equal(got, ref)
    meta = a["dec"].meta
    assert meta["format"] == "torch.export" and meta["platforms"] == ["cpu"]
    jmeta = a["jdec"].meta
    for key in jmeta:
        if key not in ("platforms", "lm"):
            assert meta[key] == jmeta[key], key
    if jmeta["lm"]:
        assert {k: meta["lm"][k] for k in jmeta["lm"]} == jmeta["lm"]


def test_ctc_kind_matches_jax(built):
    a = built("ctc")
    feats, lens = features(2, 32, 0), np.array([32, 20], np.int32)
    got, want = serve_both(a, feats, lens)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[2], want[2], atol=SCORE_TOL)
    ids, id_lens = a["port"].greedy_decode(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(got[0], ids.numpy())
    np.testing.assert_array_equal(got[1], id_lens.numpy())
    np.testing.assert_allclose(np.exp(got[2]).sum(-1), 1.0, rtol=1e-4)


def test_bucket_padding_and_trimming(built):
    """tests/test_serving.py:test_export_and_serve_roundtrip: a smaller
    batch pads into the (4, 64) bucket (filler rows of length 1) and comes
    back trimmed; no bucket fits a batch of 8; the least padded area wins."""
    a = built("beam")
    assert a["dec"].buckets == [(2, 32), (4, 64)]
    feats = features(3, 40, 1)
    lens = np.array([40, 33, 20], np.int32)
    got, want = serve_both(a, feats, lens)
    assert got[0].shape[0] == 3
    assert_nbest_equal(got, want)
    ref = a["port"].batch_beam_decode(
        torch.from_numpy(np.pad(feats, ((0, 1), (0, 24), (0, 0)))),
        torch.tensor([40, 33, 20, 1]), beam_size=2, max_decode_len=4)
    np.testing.assert_array_equal(got[0], ref[0][:3].numpy())
    params = a["dec"].prepare_params(a["port"].package())
    with pytest.raises(ValueError, match="no exported bucket"):
        a["dec"](params, features(8, 32, 2), np.full((8,), 32, np.int32))
    dec = object.__new__(serving.ExportedDecoder)
    dec.buckets = [(8, 4096), (16, 128)]
    assert dec._pick(8, 100) == (16, 128)


def test_one_artifact_serves_two_checkpoints_and_holds_no_weights(built, tmp_path):
    """The JAX model's package and the port's give the same parameter
    inputs; a second checkpoint of the same config through the f32 beam
    artifact equals its own live decode.  Re-exported from that checkpoint, the ctc
    artifact's programs are the same bytes: nothing in them depends on the
    weights; none has a parameter or a constant shaped like one."""
    a = built("beam")
    other, _ = pair(attention_config(), 11)
    # a package of either package gives the same inputs
    for got, want in zip(a["dec"].prepare_params(a["jax"].package()),
                         a["dec"].prepare_params(a["port"].package())):
        assert torch.equal(got, want)
    feats, lens = features(2, 32, 3), np.array([32, 25], np.int32)
    for model in (a["port"], other):
        got = a["dec"](a["dec"].prepare_params(model.package()), feats, lens)
        ref = model.batch_beam_decode(torch.from_numpy(feats), torch.from_numpy(lens),
                                      beam_size=2, max_decode_len=4)
        assert_nbest_equal([g.numpy() for g in got], [r.numpy() for r in ref])
    with zipfile.ZipFile(a["path"]) as za:
        names = [n for n in za.namelist() if n.endswith(".pt2")]
        programs = [torch.export.load(za.open(n)) for n in names]
    param_shapes = {tuple(p.shape) for p in other.module.parameters()}
    for program in programs:
        assert not program.state_dict
        assert not any(tuple(c.shape) in param_shapes for c in program.constants.values())

    ctc = built("ctc")
    ctc_other, _ = pair(CTC_CONFIG, 12)
    path = str(tmp_path / "other.zip")
    serving.export_beam_decode(ctc_other, path=path, platforms=("cpu",), **ctc["kw"])
    with zipfile.ZipFile(ctc["path"]) as za, zipfile.ZipFile(path) as zb:
        names = [n for n in za.namelist() if n.endswith(".pt2")]
        assert names == [n for n in zb.namelist() if n.endswith(".pt2")]
        for n in names:
            assert za.read(n) == zb.read(n), n


def test_beam_without_early_exit_equals_the_live_beam(built):
    """With EOS made likely every beam finishes before max_decode_len, so
    the live loop stops early; the exported loop runs every step and gives
    the same preds, lengths and scores."""
    from openasr_torch.data.tokenizer import EOS_ID

    model, _ = pair(attention_config(), 5)
    with torch.no_grad():
        model.module.decoder.out_bias[EOS_ID] += 6.0
    feats, lens = torch.from_numpy(features(2, 32, 4)), torch.tensor([32, 25])
    early = model.batch_beam_decode(feats, lens, beam_size=2, max_decode_len=8)
    assert (early[1] < 6).all()
    full = model.batch_beam_decode(feats, lens, beam_size=2, max_decode_len=8,
                                   stop_when_finished=False)
    for e, f in zip(early, full):
        assert torch.equal(e, f)


def test_loud_refusals(built, tmp_path):
    """The JAX tests' refusals: the LM either way, the ctc kind with an LM,
    a weights format, an unknown platform; and the port's: a JAX
    (StableHLO) artifact, a wrong kind, a platform not exported."""
    a = built("beam lm")
    feats, lens = features(2, 32, 5), np.array([32, 25], np.int32)
    params = a["dec"].prepare_params(a["port"].package())
    with pytest.raises(ValueError, match="lm_params"):
        a["dec"](params, feats, lens)
    plain = built("beam")
    with pytest.raises(ValueError, match="WITHOUT"):
        plain["dec"](params, feats, lens,
                     lm_params=a["dec"].prepare_lm_params(a["lm"][0].package()))
    ctc = built.model("ctc", CTC_CONFIG, 3)[0]
    lm = built.model("tlm", TRANSFORMER_LM, 4)[0]
    for kw, match in ((dict(lm=lm, lm_weight=0.5), "ctc_device_beam"),
                      (dict(weights="int4"), "weights"),
                      (dict(platforms=("tpu",)), "platforms")):
        with pytest.raises(ValueError, match=match):
            serving.export_beam_decode(ctc, buckets=[(2, 32)], path=str(tmp_path / "x"),
                                       **{"platforms": ("cpu",), **kw})
    with pytest.raises(ValueError, match="StableHLO"):
        serving.ExportedDecoder(plain["jpath"])
    with pytest.raises(ValueError, match="not a streaming_step artifact"):
        serving.ExportedStreamer(plain["path"])
    with pytest.raises(ValueError, match="no program for 'cuda'"):
        serving.ExportedDecoder(plain["path"], device="cuda")
    with pytest.raises(ValueError, match="shape"):
        plain["dec"].prepare_params(built("beam int8")["port"].package())


def test_a_subprocess_serves_without_the_models(built, tmp_path):
    """Load the artifact and a package and decode, in a fresh process that
    imports only the serving module and the package reader: the output
    equals this process's, and `openasr_torch.models` was never imported."""
    from openasr_torch.utils.checkpoint import save_package

    a = built("ctc")
    pkg = str(tmp_path / "last.pkg")
    save_package({"model": a["port"].package()}, pkg)
    feats, lens = features(2, 32, 6), np.array([32, 27], np.int32)
    np.savez(tmp_path / "in.npz", feats=feats, lens=lens)
    code = (
        "import json, sys, numpy as np\n"
        "from openasr_torch.serving import ExportedDecoder\n"
        "from openasr_torch.utils.checkpoint import load_package\n"
        f"dec = ExportedDecoder({a['path']!r})\n"
        f"params = dec.prepare_params(load_package({pkg!r})['model'])\n"
        f"x = np.load({str(tmp_path / 'in.npz')!r})\n"
        "ids, id_lens, log_probs, _ = dec(params, x['feats'], x['lens'])\n"
        "print(json.dumps({'ids': ids.tolist(), 'log_probs': log_probs.tolist(),\n"
        "    'models': [m for m in sys.modules if m.startswith('openasr_torch.models')]}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["models"] == []
    got = a["dec"](a["dec"].prepare_params(a["port"].package()), feats, lens)
    assert res["ids"] == got[0].tolist()
    np.testing.assert_allclose(res["log_probs"], got[2].numpy(), rtol=1e-6)


def test_online_model_exports_its_fbank(tmp_path):
    """A model with the fbank frontend exports a program that takes waves
    [B, samples] and runs the fbank operator (the JAX export takes
    features only): equal to the live decode."""
    from test_torch_streaming import speech_config

    cfg = speech_config(None, online=True, model_type="conv-ctc-transformer")
    del cfg["encoder"]["streaming"]
    model = get_model_class(cfg["type"]).create_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(13))
    path = str(tmp_path / "online.zip")
    serving.export_beam_decode(model, [(2, 4000)], path, beam_size=2, max_decode_len=4,
                               platforms=("cpu",))
    dec = serving.ExportedDecoder(path)
    assert dec.meta["feature_type"] == "fbank"
    program = next(iter(dec._fns.values()))
    assert any(n.target is torch.ops.openasr.fbank.default for n in program.graph.nodes)
    waves = torch.from_numpy(np.random.RandomState(8).randn(2, 3500).astype(np.float32) * 100)
    lens = torch.tensor([3500, 3100])
    got = dec(dec.prepare_params(model.package()), waves, lens)
    ref = model.batch_beam_decode(waves, lens, beam_size=2, max_decode_len=4)
    assert_nbest_equal([g.numpy() for g in got], [r.numpy() for r in ref])
    with pytest.raises(ValueError, match="samples"):
        dec(dec.prepare_params(model.package()), features(2, 32, 0), np.array([32, 30]))
