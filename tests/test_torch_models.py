"""The port's conv-(ctc-)transformer against the JAX model, on the CPU.

A small model (2 encoder + 2 decoder layers, d64, 4 heads, GLU, vocab 20)
is built by the JAX package; its package is restored into the port through
the weight bridge, and both run the same numpy inputs in f32 with dropout
off.  Tolerances: 1e-4 abs on encoder / decoder / ctc_fc outputs (f32,
different summation orders over ~6 layers); 1e-5 between the port's own
KV-cached step and its full forward.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openasr_tpu.models import get_model_class as jax_model_class
from openasr_torch.convert import (
    jax_components_to_state_dict,
    state_dict_to_jax_components,
)
from openasr_torch.models import get_model_class

MODEL_TOL = 1e-4
STEP_TOL = 1e-5


def small_config(model_type="conv-ctc-transformer", sub="ConvV2", vocab=20):
    return {
        "type": model_type,
        "add_eos": True,
        "add_blk": True,
        "signal": {"feature_type": "offline"},
        "encoder": {"type": "Transformer", "sub": {"type": sub, "layer_num": 2},
                    "input_dim": 20, "d_model": 64, "nhead": 4,
                    "dim_feedforward": 128, "activation": "glu", "num_layers": 2,
                    "dropout_rate": 0.1},
        "decoder": {"type": "TransformerDecoder", "vocab_size": vocab,
                    "d_model": 64, "nhead": 4, "num_layers": 2, "encoder_dim": 64,
                    "dim_feedforward": 128, "activation": "glu", "dropout_rate": 0.1},
    }


def build_pair(model_type="conv-ctc-transformer", sub="ConvV2"):
    cfg = small_config(model_type, sub)
    jax_model = jax_model_class(model_type).create_model(cfg)
    port = get_model_class(model_type).create_model(cfg, device="cpu")
    port.restore(jax_model.package())
    return jax_model, port


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 41, 20).astype(np.float32)
    lens = np.array([41, 30, 19], np.int32)
    ids = rng.randint(3, 20, size=(3, 7)).astype(np.int32)
    return x, lens, ids


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_weight_bridge_round_trip_is_exact(pair):
    jax_model, port = pair
    comps = jax_model.package()["components"]
    state = jax_components_to_state_dict("conv-ctc-transformer", comps)
    assert set(state) == set(port.module.state_dict())
    back = state_dict_to_jax_components("conv-ctc-transformer", state, port.configs)
    flat_a, flat_b = {}, {}

    def flatten(tree, out, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                flatten(v, out, path + (k,))
            else:
                out[path + (k,)] = np.asarray(v)

    flatten(comps, flat_a)
    flatten(back, flat_b)
    assert set(flat_a) == set(flat_b)
    for key, a in flat_a.items():
        assert flat_b[key].dtype == a.dtype and np.array_equal(flat_b[key], a), key
    # the port writes the same package back
    flatten(port.package()["components"], flat_b)
    for key, a in flat_a.items():
        assert np.array_equal(flat_b[key], a), key


@pytest.mark.parametrize("sub", ["ConvV2", "ConvV1"])
def test_encoder_matches_jax(sub):
    jax_model, port = build_pair(sub=sub)
    x, lens, _ = inputs()
    enc_j, elens_j = jax_model.encode(jax_model.params, x, lens)
    with torch.no_grad():
        enc_t, elens_t = port.encode(_t(x), _t(lens))
    assert np.array_equal(np.asarray(elens_j), elens_t.numpy())
    assert np.abs(np.asarray(enc_j) - enc_t.numpy()).max() <= MODEL_TOL


def test_decoder_and_ctc_logits_match_jax(pair):
    jax_model, port = pair
    x, lens, ids = inputs(1)
    ctc_j, elens_j, ce_j = jax_model.module.apply(
        {"params": jax_model.params}, x, lens, ids, jnp.full((3,), 7, jnp.int32)
    )
    with torch.no_grad():
        ctc_t, elens_t, ce_t = port.module(_t(x), _t(lens), _t(ids))
    assert np.array_equal(np.asarray(elens_j), elens_t.numpy())
    assert np.abs(np.asarray(ctc_j) - ctc_t.numpy()).max() <= MODEL_TOL
    assert np.abs(np.asarray(ce_j) - ce_t.numpy()).max() <= MODEL_TOL


def test_cached_step_reproduces_full_forward(pair):
    _, port = pair
    x, lens, ids = inputs(2)
    decoder = port.module.decoder
    max_len = ids.shape[1]
    with torch.no_grad():
        memory, mlens = port.encode(_t(x), _t(lens))
        full = decoder(memory, mlens, _t(ids))
        from openasr_torch.ops.masks import padding_bias

        bias = padding_bias(mlens, memory.shape[1])
        cache = decoder.init_cache(memory, max_len)
        steps = [
            decoder.step(_t(ids[:, i]), i, cache, bias, max_len)
            for i in range(max_len)
        ]
    assert (torch.stack(steps, 1) - full).abs().max().item() <= STEP_TOL


def test_beam_search_matches_jax(pair):
    jax_model, port = pair
    x, lens, _ = inputs(3)
    preds_j, lens_j, scores_j = jax_model.batch_beam_decode(
        jax_model.params, x, lens, beam_size=4, max_decode_len=9
    )
    preds_t, lens_t, scores_t = port.batch_beam_decode(
        _t(x), _t(lens), beam_size=4, max_decode_len=9
    )
    assert np.array_equal(np.asarray(preds_j), preds_t.numpy())
    assert np.array_equal(np.asarray(lens_j), lens_t.numpy())
    assert np.abs(np.asarray(scores_j) - scores_t.numpy()).max() <= MODEL_TOL


def test_port_package_restores_in_jax(pair):
    """Packages move both ways: the port's package() loads into JAX."""
    _, port = pair
    cfg = small_config()
    jax_model = jax_model_class("conv-ctc-transformer").create_model(
        cfg, rng=None
    )
    # a different init in the port, written back through the bridge
    other = get_model_class("conv-ctc-transformer").create_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(7)
    )
    jax_model.restore(other.package())
    x, lens, _ = inputs(4)
    enc_j, _ = jax_model.encode(jax_model.params, x, lens)
    with torch.no_grad():
        enc_t, _ = other.encode(_t(x), _t(lens))
    assert np.abs(np.asarray(enc_j) - enc_t.numpy()).max() <= MODEL_TOL


def test_bfloat16_encoder_matches_jax(pair):
    """bf16 on both sides.  6.25e-2 abs: outputs reach ~4, where a bf16 ulp
    is 1.6e-2, and the two implementations round at different places (the
    port's flash keeps P in f32; JAX casts it to bf16 before P.V)."""
    jax_f32, _ = pair
    pkg = jax_f32.package()
    cfg = small_config()
    jax_model = jax_model_class("conv-ctc-transformer").create_model(
        cfg, dtype=jnp.bfloat16
    )
    jax_model.restore(pkg)
    port = get_model_class("conv-ctc-transformer").create_model(
        cfg, device="cpu", dtype=torch.bfloat16
    )
    port.restore(pkg)
    x, lens, _ = inputs()
    enc_j, _ = jax_model.encode(jax_model.params, x, lens)
    with torch.no_grad():
        enc_t, _ = port.encode(_t(x), _t(lens))
    assert enc_t.dtype == torch.bfloat16
    diff = np.abs(np.asarray(enc_j, np.float32) - enc_t.float().numpy())
    assert diff.max() <= 6.25e-2


def test_conv_transformer_type_and_bfloat16_decode():
    """conv-transformer (no ctc_fc) restores from JAX, and a bf16 model
    decodes to finite, sorted scores."""
    jax_model, port = build_pair("conv-transformer")
    assert "ctc_fc" not in port.package()["components"]
    cfg = small_config("conv-transformer")
    bf16 = get_model_class("conv-transformer").create_model(
        cfg, device="cpu", dtype=torch.bfloat16
    )
    bf16.restore(jax_model.package())
    assert bf16.module.encoder.final_norm.weight.dtype == torch.float32
    assert bf16.module.decoder.out_bias.dtype == torch.float32
    x, lens, _ = inputs(5)
    _, _, scores = bf16.batch_beam_decode(_t(x), _t(lens), beam_size=3,
                                          max_decode_len=6)
    assert torch.isfinite(scores).all()
    assert (scores[:, :-1] >= scores[:, 1:]).all()


@pytest.mark.parametrize("section,patch,match", [
    pytest.param("type", {"type": "embed_decoder", "encoder": {"vocab_size": 11}}, None,
                 id="type-embed_decoder-item 13"),
    pytest.param("encoder", {"moe": {"num_experts": 2}}, None, id="encoder-patch1-item 14"),
    pytest.param("encoder", {"pipeline": True}, None, id="encoder-patch2-item 15"),
    pytest.param("type", {"type": "gan_phone2char", "encoder": {"vocab_size": 11},
                          "D": {"encoder": {"d_input": 20, "d_model": 16}}}, None,
                 id="type-gan_phone2char-item 13"),
])
def test_unported_configs_name_their_roadmap_item(section, patch, match):
    """The text families of item 13, MoE (item 14) and the stacked encoder
    of the pipeline (item 15c), refused before, build (match None)."""
    cfg = small_config()
    if section == "signal":
        cfg["signal"] = dict(patch)
    elif section == "type":
        for key, value in patch.items():
            cfg[key] = {**cfg[key], **value} if key in cfg and isinstance(value, dict) else value
    else:
        cfg[section].update(patch)
    if match is None:
        model = get_model_class(cfg["type"]).create_model(cfg, device="cpu")
        assert model.model_type.lower() == cfg["type"]
        assert sum(p.numel() for p in model.module.parameters()) > 0
        return
    with pytest.raises(NotImplementedError, match=match):
        get_model_class(cfg["type"]).create_model(cfg, device="cpu")


@pytest.mark.parametrize("encoder,input_dim", [
    ({"sub": {"type": "Stack"}}, 20),
    ({"sub": {"type": "Stack"}, "context_width": 4, "subsample": 2}, 20),
    ({"sub": None}, 20),        # no subsampler: the Dense `affine`
    ({"sub": {}}, 64),          # no subsampler, input_dim == d_model: identity
])
def test_encoder_inputs_match_jax(encoder, input_dim):
    """Stack (a strided 1-D conv + LayerNorm) and the encoder without a
    subsampler, restored from the JAX model: lengths exact, logits to
    MODEL_TOL, and the package written back bit for bit."""
    cfg = small_config("conv-ctc")
    cfg["encoder"].update(encoder, input_dim=input_dim)
    jax_model = jax_model_class("conv-ctc").create_model(cfg)
    port = get_model_class("conv-ctc").create_model(cfg, device="cpu")
    port.restore(jax_model.package())
    rng = np.random.RandomState(6)
    x = rng.randn(3, 41, input_dim).astype(np.float32)
    lens = np.array([41, 30, 19], np.int32)
    logits_j, lens_j = jax_model.module.apply(jax_model.variables, x, lens)
    with torch.no_grad():
        logits_t, lens_t = port.module(_t(x), _t(lens))
    assert np.array_equal(np.asarray(lens_j), lens_t.numpy())
    assert np.array_equal(port.module.encoder_lengths(lens), np.asarray(lens_j))
    assert np.abs(np.asarray(logits_j) - logits_t.numpy()).max() <= MODEL_TOL
    want = jax_model.package()["components"]["encoder"]
    got = port.package()["components"]["encoder"]
    assert set(got) == set(want)
    for key in ("sub", "affine"):
        if key in want:
            for leaf, value in want[key].items():
                if isinstance(value, dict):
                    for name, arr in value.items():
                        assert np.array_equal(got[key][leaf][name], np.asarray(arr))
                else:
                    assert np.array_equal(got[key][leaf], np.asarray(value))


@pytest.mark.parametrize("model_type", ["conv-ctc-transformer", "conv-ctc"])
@pytest.mark.parametrize("average_heads", [False, True])
def test_attention_maps_match_jax(model_type, average_heads):
    """Every attention's probabilities under the JAX package's module
    paths, to MODEL_TOL (f32, encoders equal to 1e-4)."""
    cfg = small_config(model_type)
    jax_model = jax_model_class(model_type).create_model(cfg)
    port = get_model_class(model_type).create_model(cfg, device="cpu")
    port.restore(jax_model.package())
    x, lens, ids = inputs(7)
    paddings = np.zeros(ids.shape, np.float32)
    paddings[1, 5:] = 1.0
    batch = {"feats": x, "feat_lengths": lens, "ids": ids, "paddings": paddings}
    want = jax_model.attention_maps(batch, average_heads=average_heads)
    got = port.attention_maps({k: _t(v) for k, v in batch.items()},
                              average_heads=average_heads)
    assert sorted(got) == sorted(want)
    assert "encoder/layer0/self_attn" in got
    for key, value in want.items():
        assert got[key].dtype == torch.float32 and got[key].shape == np.shape(value)
        assert np.abs(np.asarray(value) - got[key].numpy()).max() <= MODEL_TOL, key


def test_initialization_follows_the_jax_initializers():
    """Convolution kernels as flax's Conv draws them (lecun_normal: a normal
    truncated at 2 standard deviations, variance 1 / fan_in), other weights
    Xavier-uniform: the port's draws and the JAX model's have the same
    variance (to 10% on the 288 draws of conv0, 5% elsewhere) and range."""
    import math

    from openasr_torch.convert import jax_components_to_state_dict

    cfg = small_config("conv-ctc")
    jax_model = jax_model_class("conv-ctc").create_model(cfg)
    want = jax_components_to_state_dict("conv-ctc", jax_model.package()["components"])
    port = get_model_class("conv-ctc").create_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    got = port.module.state_dict()
    for name in ("encoder.sub.conv0.weight", "encoder.sub.conv1.weight",
                 "encoder.sub.affine.weight", "encoder.layer0.self_attn.q.weight",
                 "encoder.layer0.ffn.linear1.weight", "fc.weight"):
        w = got[name]
        fan_in, fan_out = torch.nn.init._calculate_fan_in_and_fan_out(w)
        if "conv" in name:
            std = math.sqrt(1.0 / fan_in)
            assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6
        else:
            std = math.sqrt(2.0 / (fan_in + fan_out))
        tol = 0.1 if w.numel() < 1000 else 0.05
        for sample in (w, want[name]):
            assert abs(float(sample.std()) / std - 1.0) <= tol, name
