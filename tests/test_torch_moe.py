"""The port's mixture of experts (openasr_torch/models/moe.py and its
plumbing) against the JAX package's (openasr_tpu/models/moe.py), on the CPU.

The layer at tests/test_moe.py's `_init_moe` sizes (d16, F32, 4 experts,
top-2, B2 x T12), weights drawn with NumPy from a seed and loaded into both
through the weight bridge: for each activation and router, with and
without a pad mask, under capacity pressure (cf 0.5) and with a zero
router (every gate tied), the output, the auxiliary and the gradients of
every table and of the input within 1e-5 (f32, of each one's scale), and
E = 1 against the dense FFN.  The models at the test configs' widths
(conv-ctc-transformer-moe_test.yaml's d32 with 4 GLU experts, one layer of
each stack): the losses, `moe_aux_loss` and every gradient of
conv-ctc-transformer, conv-ctc, ctc_cif and Embed_Decoder_CTC
(`decoder.moe`), for both routers, within 1e-4
(tests/test_torch_moe_families.py holds conv-transformer, CIF, CIF_FC and
CIF_MIX the same way; tests/test_torch_moe_cli.py the solver's steps).
The refusals of `validate_moe` and of the families carry the JAX
package's messages; the int8 expert tables bridge bit for bit; an MoE
model exports its beam with int8 weights.
"""

import copy
import json
import warnings

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from openasr_torch import quant, serving
from openasr_torch.config import validate_config
from openasr_torch.convert import jax_components_to_state_dict, subtree_to_state_dict
from openasr_torch.models import get_model_class
from openasr_torch.models.layers import FeedForward, TrainRNG
from openasr_torch.models.moe import MoEFeedForward, capacity, top_indices
from openasr_tpu import quant as jax_quant
from openasr_tpu.config import validate_config as jax_validate_config
from openasr_tpu.models import get_model_class as jax_model_class
from openasr_tpu.models.moe import MoEFeedForward as JaxMoE
from openasr_tpu.models.moe import _capacity as jax_capacity

from test_torch_wave_models import close, flat

LAYER_TOL = 1e-5
MODEL_LOSS_RTOL = 1e-4
D, F, E, B, T = 16, 32, 4, 2, 12
MOE = {"num_experts": 4, "top_k": 2, "capacity_factor": 2.0, "every": 1, "aux_weight": 0.01}
with open("egs/aishell1/configs/conv-ctc-transformer-moe_test.yaml") as _f:
    MOE_TEST = yaml.safe_load(_f)


# ------------------------------------------------------------------ layer

def layer_params(act, seed=0, experts=E, zero_router=False):
    """Flax-layout parameters of one MoEFeedForward, from NumPy."""
    rng = np.random.RandomState(seed)
    p = {"router": {"kernel": rng.randn(D, experts).astype(np.float32),
                    "bias": 0.1 * rng.randn(experts).astype(np.float32)},
         "w1": 0.3 * rng.randn(experts, D, F).astype(np.float32),
         "b1": 0.1 * rng.randn(experts, F).astype(np.float32),
         "w2": 0.3 * rng.randn(experts, F, D).astype(np.float32),
         "b2": 0.1 * rng.randn(experts, D).astype(np.float32)}
    if act == "glu":
        p["w_gate"] = 0.3 * rng.randn(experts, D, F).astype(np.float32)
        p["b_gate"] = 0.1 * rng.randn(experts, F).astype(np.float32)
    if zero_router:
        p["router"] = {"kernel": np.zeros((D, experts), np.float32),
                       "bias": np.zeros(experts, np.float32)}
    return p


CASES = {  # name -> (capacity factor, pad mask, zero router)
    "plain": (8.0, False, False),
    "padded": (8.0, True, False),
    "pressure": (0.5, True, False),
    "zero router": (0.5, True, True),
}


def case_inputs(seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, D).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 7:] = 0.0
    cot = rng.randn(B, T, D).astype(np.float32)
    return x, mask, cot


def fast_compile(fn, *args):
    """fn jitted and compiled for `args` without XLA's costlier passes:
    the references run once, their compiles dominate the file's time."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})


def jax_layer(act, router, cf, experts=E):
    """(params, x, mask, cot) -> (y, aux, (param grads, x grad)) of
    sum(y * cot) + aux; mask None gives no pad mask."""
    mod = JaxMoE(D, F, num_experts=experts, top_k=2, capacity_factor=cf, activation=act,
                 router_type=router)

    def run(params, x, mask, cot):
        def f(p, x_):
            y, coll = mod.apply({"params": p}, x_, True, mask, mutable=["moe"])
            leaves = jax.tree_util.tree_leaves(coll.get("moe", {}))
            aux = leaves[0] if leaves else jnp.zeros(())
            return jnp.sum(y * cot) + aux, (y, aux)

        (_, (y, aux)), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, x)
        return y, aux, grads

    return run


def port_layer(act, router, cf, params, experts=E):
    m = MoEFeedForward(D, F, experts, 2, cf, act, 0.0, router)
    m.load_state_dict(subtree_to_state_dict(params))
    return m


@pytest.mark.parametrize("router", ["topk", "expert_choice"])
@pytest.mark.parametrize("act", ["relu", "gelu", "glu"])
def test_layer_matches_jax(act, router):
    """Every case of CASES: output, auxiliary (topk; expert_choice gives
    none) and the gradients of the tables and the input, 1e-5."""
    x, mask, cot = case_inputs()
    references = {}   # one compile per (capacity factor, pad mask)
    for name, (cf, padded, zero) in CASES.items():
        params = layer_params(act, zero_router=zero)
        args = (params, x, jnp.asarray(mask) if padded else None, cot)
        if (cf, padded) not in references:
            references[cf, padded] = fast_compile(jax_layer(act, router, cf), *args)
        y_j, aux_j, (g_j, gx_j) = references[cf, padded](*args)
        m = port_layer(act, router, cf, params)
        m.aux_sink = sink = []
        xt = torch.from_numpy(x).requires_grad_(True)
        y = m(xt, None, torch.from_numpy(mask) > 0 if padded else None)
        aux = sink[0] if sink else torch.zeros(())
        ((y * torch.from_numpy(cot)).sum() + aux).backward()
        assert (len(sink) == 1) == (router == "topk"), name
        close(y.detach().numpy(), y_j, LAYER_TOL, f"{name} y")
        close(float(aux.detach()), float(aux_j), LAYER_TOL, f"{name} aux")
        close(xt.grad.numpy(), gx_j, LAYER_TOL, f"{name} dx")
        got = flat({k: v.grad.numpy() for k, v in m.named_parameters()})
        want = flat(subtree_to_state_dict(jax.tree_util.tree_map(np.asarray, g_j)))
        want = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in want.items()}
        assert set(got) == set(want), name
        for k in want:
            close(got[k], want[k], LAYER_TOL, f"{name} d{k}")
        if padded:
            assert np.abs(y.detach().numpy()[mask == 0]).max() == 0.0, name
        if zero and router == "topk":
            assert abs(float(aux.detach()) - 1.0) <= 1e-6   # the Switch minimum


def test_single_expert_equals_the_dense_ffn():
    """E = 1, top-1, no capacity pressure: every token's output is the
    dense FFN's with the same weights (as tests/test_moe.py holds the JAX
    layer), and matches the JAX layer."""
    params = layer_params("relu", experts=1)
    m = port_layer("relu", "topk", 8.0, params, experts=1)
    dense = FeedForward(D, F, "relu")
    with torch.no_grad():
        dense.linear1.weight.copy_(m.w1[0].T)
        dense.linear1.bias.copy_(m.b1[0])
        dense.linear2.weight.copy_(m.w2[0].T)
        dense.linear2.bias.copy_(m.b2[0])
    x, _, cot = case_inputs(3)
    with torch.no_grad():
        y = m(torch.from_numpy(x))
        close(y.numpy(), dense(torch.from_numpy(x)).numpy(), LAYER_TOL, "E=1 vs dense")
    y_j, _, _ = jax.jit(jax_layer("relu", "topk", 8.0, experts=1))(params, x, None, cot)
    close(y.numpy(), y_j, LAYER_TOL, "E=1 vs JAX")


def test_top_indices_breaks_ties_by_the_lower_index_and_keeps_the_gradient():
    """Uniform gates over 8 experts: jax.lax.top_k's [0, 1] (torch.topk
    gives another pair on the CPU), and the gathered values differentiate
    as top_k's do."""
    g = torch.full((3, 8), 0.125, requires_grad=True)
    idx = top_indices(g, 2)
    assert idx.tolist() == [[0, 1]] * 3
    _, want = jax.lax.top_k(jnp.full((3, 8), 0.125), 2)
    assert idx.tolist() == np.asarray(want).tolist()
    v = torch.tensor([[0.1, 0.5, 0.5, 0.3]], requires_grad=True)
    picked = v.gather(-1, top_indices(v, 3))
    assert top_indices(v, 3).tolist() == [[1, 2, 3]]
    picked.sum().backward()
    assert v.grad.tolist() == [[0.0, 1.0, 1.0, 1.0]]


@pytest.mark.parametrize("tokens,experts,k,factor", [
    (12, 4, 2, 8.0), (8, 4, 1, 1.0), (139, 8, 2, 1.25), (5, 8, 2, 0.5), (1, 3, 1, 0.1)])
def test_capacity_is_the_jax_packages(tokens, experts, k, factor):
    assert capacity(tokens, experts, k, factor) == jax_capacity(tokens, experts, k, factor)


def test_router_runs_in_f32_under_bf16_autocast_and_dropout_draws_from_the_rng():
    """Under bf16 autocast the router's Linear takes f32 and its gates stay
    f32 (the products run in bf16 and the output has the input's dtype);
    dropout on the hidden activations follows the TrainRNG's seed."""
    params = layer_params("glu")
    m = MoEFeedForward(D, F, E, 2, 1.25, "glu", 0.5, "topk")
    m.load_state_dict(subtree_to_state_dict(params))
    seen = []
    m.router.register_forward_hook(lambda mod, a, out: seen.append((a[0].dtype, out.dtype)))
    x = torch.from_numpy(case_inputs()[0])
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y16 = m(x.to(torch.bfloat16))
    assert seen == [(torch.float32, torch.float32)] and y16.dtype == torch.bfloat16
    y = m(x)
    assert float((y16.float() - y).abs().max()) <= 0.1 * float(y.abs().max())
    a = m(x, TrainRNG(5, "cpu"))
    b = m(x, TrainRNG(5, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, y)


@pytest.mark.parametrize("kwargs,match", [
    ({"activation": "swish"}, "activations"),
    ({"router_type": "soft"}, "router"),
])
def test_layer_refusals_are_the_jax_packages(kwargs, match):
    args = {"activation": "relu", "router_type": "topk", **kwargs}
    with pytest.raises(ValueError, match=match) as got:
        MoEFeedForward(8, 16, 2, 2, 1.25, args["activation"], 0.0, args["router_type"])
    mod = JaxMoE(8, 16, num_experts=2, **args)
    with pytest.raises(ValueError, match=match) as want:
        mod.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4, 8)))
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------ models

ENC = {"type": "Transformer", "sub": {"type": "ConvV2", "layer_num": 1}, "input_dim": 20,
       "d_model": 32, "nhead": 2, "dim_feedforward": 64, "activation": "glu",
       "num_layers": 1, "dropout_rate": 0.0}
DEC = {"type": "TransformerDecoder", "vocab_size": 11, "d_model": 32, "nhead": 2,
       "num_layers": 1, "encoder_dim": 32, "dim_feedforward": 64, "activation": "relu",
       "dropout_rate": 0.0}
ASSIGNER = {"d_model": 32, "n_layers": 2, "w_context": 3, "dropout": 0.0}
PHONES = 9


def model_config(model_type, router):
    moe = dict(MOE, router=router)
    if model_type == "Embed_Decoder_CTC":
        return {"type": model_type, "encoder": {"vocab_size": 15, "d_model": 32},
                "decoder": {"vocab_size": 11, "d_model": 32, "nhead": 2, "num_layers": 1,
                            "dim_feedforward": 64, "activation": "glu", "dropout_rate": 0.0,
                            "moe": moe}}
    cfg = {"type": model_type, "add_eos": model_type.startswith("conv"), "add_blk": True,
           "signal": {"feature_type": "offline"}, "encoder": dict(ENC, moe=moe),
           "decoder": dict(DEC)}
    if model_type in ("CIF", "ctc_cif", "CIF_FC", "CIF_MIX"):
        cfg["assigner"] = dict(ASSIGNER)
        cfg["decoder"]["type"] = "CIF_Decoder"
    if model_type == "CIF_MIX":
        cfg["phone_size"] = PHONES
        cfg["decoder"]["type"] = "TransformerDecoder"
    return cfg


def model_batch(model_type, seed=0):
    from test_torch_cif import make_batch as cif_batch
    from test_torch_text import p2c_batch
    from test_torch_train_model import make_batch

    if model_type == "Embed_Decoder_CTC":
        return p2c_batch(seed, char_vocab=11)
    if model_type in ("CIF", "ctc_cif", "CIF_FC", "CIF_MIX"):
        return cif_batch(model_type, seed)
    batch = make_batch(seed)
    batch["ids"] = np.minimum(batch["ids"], 10)
    batch["labels"] = np.minimum(batch["labels"], 10)
    return batch


def mix(losses):
    """A fixed mix of every loss the family returns (the solvers' own mix
    is held by tests/test_torch_moe_cli.py)."""
    total = 0.0
    for key, norm in (("ce_loss", "n_tokens"), ("ctc_loss", "n_seqs"), ("qua_loss", "n_seqs"),
                      ("ce_char_loss", "n_char_tokens")):
        if key in losses:
            total = total + losses[key] / losses[norm]
    return total + losses["moe_aux_loss"]


def twin(port, cfg):
    params = jax.tree_util.tree_map(jnp.asarray, port.package()["components"])
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn.Module, "init", lambda self, *a, **k: {"params": params})
        return jax_model_class(cfg["type"]).create_model(cfg)


def check_model_against_jax(model_type, router):
    """The losses (`moe_aux_loss` included) and every gradient of the
    model's loss forward (dropout off), 1e-4, the JAX package's jitted."""
    cfg = model_config(model_type, router)
    port = get_model_class(model_type).create_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    assert sum(isinstance(m, MoEFeedForward) for m in port.module.modules()) == 1
    jax_model = twin(port, cfg)
    batch = model_batch(model_type)

    def reference(params, b):
        def f(p):
            losses = jax_model.loss(p, b, {}, train=False, label_smooth=0.1)
            return mix(losses), losses
        return jax.value_and_grad(f, has_aux=True)(params)

    (total, losses), grads = fast_compile(reference, jax_model.params, batch)(
        jax_model.params, batch)
    got = port.loss({k: torch.from_numpy(v) for k, v in batch.items()}, None, label_smooth=0.1)
    assert set(got) == set(losses) and "moe_aux_loss" in got
    for k, v in losses.items():
        assert abs(float(got[k]) - float(v)) <= MODEL_LOSS_RTOL * max(abs(float(v)), 1.0), k
    if router == "expert_choice":
        assert float(got["moe_aux_loss"]) == 0.0
    else:
        assert float(got["moe_aux_loss"]) > 0.0
    mix(got).backward()
    from openasr_torch.convert import state_dict_to_jax_components

    got_grads = flat(state_dict_to_jax_components(
        port.model_type, {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                          for n, p in port.module.named_parameters()}, port.configs))
    want = flat(jax.tree_util.tree_map(np.asarray, grads))
    assert any("moe_ffn" in k for k in want)
    floor = 0.1 * max(float(np.abs(w).max()) for w in want.values())
    assert set(got_grads) == set(want)
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), floor)
        assert float(np.abs(got_grads[name] - w).max()) <= MODEL_LOSS_RTOL * scale, name


@pytest.mark.parametrize("router", ["topk", "expert_choice"])
@pytest.mark.parametrize("model_type", ["conv-ctc-transformer", "conv-ctc", "ctc_cif",
                                        "Embed_Decoder_CTC"])
def test_model_losses_and_gradients_match_jax(model_type, router):
    check_model_against_jax(model_type, router)


def test_moe_layers_only_every_nth_and_decode_paths_skip_the_auxiliary():
    """`every: 2` of 2 layers: layer 1 routed, layer 0 dense; a decode
    forward leaves the routers' sinks empty and an MoE model decodes."""
    model_cfg = copy.deepcopy(MOE_TEST["model"])
    model_cfg["decoder"]["vocab_size"] = 11
    port = get_model_class("conv-ctc-transformer").create_model(model_cfg, device="cpu")
    enc = port.module.encoder
    assert enc.layer0.moe_ffn is None and enc.layer0.ffn is not None
    assert enc.layer1.moe_ffn is not None and enc.layer1.ffn is None
    keys = port.package()["components"]["encoder"]["layer1"]["moe_ffn"]
    assert sorted(keys) == ["b1", "b2", "b_gate", "router", "w1", "w2", "w_gate"]
    feats = torch.from_numpy(np.random.RandomState(4).randn(2, 40, 20).astype(np.float32))
    lens = torch.tensor([40, 31], dtype=torch.int32)
    preds, plens, scores = port.batch_beam_decode(feats, lens, beam_size=2, max_decode_len=5)
    assert torch.isfinite(scores).all() and enc.layer1.moe_ffn.aux_sink is None
    ids, ilens = get_model_class("conv-ctc").create_model(
        model_config("conv-ctc", "topk"), device="cpu").greedy_decode(feats, lens)
    assert ids.shape[0] == 2


# --------------------------------------------------------------- refusals

def config_with(moe=None, activation="relu", mtype="conv-ctc-transformer", section="encoder"):
    cfg = {"model": {"type": mtype,
                     "encoder": {"input_dim": 20, "d_model": 32, "nhead": 2,
                                 "dim_feedforward": 64, "num_layers": 2,
                                 "activation": activation}}}
    if section == "encoder":
        cfg["model"]["encoder"]["moe"] = moe
    else:
        cfg["model"][section] = {"vocab_size": 8, "d_model": 32, "nhead": 2, "num_layers": 1,
                                 "dim_feedforward": 64, "activation": activation, "moe": moe}
    return cfg


GOOD = {"num_experts": 4, "top_k": 2, "every": 2}
GAN = {"type": "gan_phone2char",
       "G": {"encoder": {"vocab_size": 16, "d_model": 16},
             "decoder": {"vocab_size": 8, "d_model": 16, "nhead": 2, "num_layers": 1,
                         "dim_feedforward": 32, "activation": "relu", "dropout_rate": 0.0,
                         "moe": {"num_experts": 4, "top_k": 2}}},
       "D": {"encoder": {"d_input": 8, "d_model": 16, "layer_num": 1}}}
GAN["G"]["decoder"]["moe"]["every"] = 1


@pytest.mark.parametrize("cfg", [
    pytest.param(config_with({"top_k": 2}), id="num_experts missing"),
    pytest.param(config_with({"num_experts": 4, "every": 0}), id="every 0"),
    pytest.param(config_with({"num_experts": 4, "every": 3}), id="every > num_layers"),
    pytest.param(config_with({"num_experts": 4, "top_k": 0}), id="top_k 0"),
    pytest.param(config_with({"num_experts": 4, "capacity_factor": -1.0}), id="capacity"),
    pytest.param(config_with(GOOD, activation="swish"), id="activation"),
    pytest.param(config_with(GOOD, mtype="gru_ctc"), id="gru_ctc"),
    pytest.param(config_with(GOOD, mtype="Embed_Decoder"), id="Embed_Decoder"),
    pytest.param(config_with({"num_experts": 4, "router": "soft"}), id="router"),
    pytest.param(config_with(GOOD, section="decoder"), id="decoder section"),
    pytest.param({"model": GAN}, id="GAN G.decoder"),
])
def test_validate_moe_refuses_as_the_jax_package(cfg):
    with pytest.raises(ValueError) as want:
        jax_validate_config(copy.deepcopy(cfg))
    with pytest.raises(ValueError) as got:
        validate_config(copy.deepcopy(cfg))
    assert str(got.value) == str(want.value)


def test_validate_moe_accepts_and_warns_as_the_jax_package():
    validate_config(config_with(GOOD))
    validate_config(config_with(GOOD, activation="glu"))
    validate_config(config_with(dict(GOOD, every=1), mtype="Embed_Decoder_CTC",
                                section="decoder"))
    with pytest.warns(UserWarning, match="disables MoE"):
        validate_config(config_with({"num_experts": 0}))
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        validate_config(config_with({"num_experts": 0}))
    with warnings.catch_warnings(record=True) as want:
        warnings.simplefilter("always")
        jax_validate_config(config_with({"num_experts": 0}))
    assert [str(w.message) for w in got] == [str(w.message) for w in want]


def _family(name):
    moe = {"num_experts": 4, "top_k": 2}
    if name == "gru_ctc":
        return {"type": "gru_ctc", "add_blk": True, "signal": {"d_model": 16},
                "encoder": {"type": "GRU", "d_input": 16, "d_model": 16, "n_layers": 1,
                            "moe": moe},
                "decoder": {"type": "FC_Decoder", "vocab_size": 8, "d_model": 16}}
    if name == "gan G.encoder":
        gan = copy.deepcopy(GAN)
        gan["G"]["encoder"]["moe"] = moe
        del gan["G"]["decoder"]["moe"]
        return gan
    if name == "gan G.decoder":
        return copy.deepcopy(GAN)
    if name == "Embed_Decoder":
        return {"type": "Embed_Decoder", "encoder": {"vocab_size": 16, "d_model": 16, "moe": moe},
                "decoder": dict(DEC, d_model=16, encoder_dim=16, dim_feedforward=32)}
    if name == "wav2vec_ctc":
        with open("egs/wav2vec/configs/wav2vec_ctc_test.yaml") as f:
            cfg = yaml.safe_load(f)["model"]
        cfg["encoder"]["moe"] = moe
        cfg["decoder"]["vocab_size"] = 8
        return cfg
    cfg = model_config("conv-ctc-transformer", "topk")
    cfg["decoder"]["moe"] = moe                     # a section the family never reads
    return cfg


@pytest.mark.parametrize("name", ["gru_ctc", "gan G.encoder", "gan G.decoder",
                                  "Embed_Decoder", "wav2vec_ctc", "decoder section"])
def test_incapable_families_refuse_a_moe_section(name):
    cfg = _family(name)
    with pytest.raises(ValueError, match="moe is not supported") as got:
        get_model_class(cfg["type"]).create_model(cfg, device="cpu")
    assert ("reads its MoE config" in str(got.value)) == (name == "decoder section")


@pytest.mark.parametrize("extra,match", [
    ({"streaming": {"chunk": 4, "left_chunks": 2}}, "does not compose with encoder.streaming"),
    ({"pipeline": True}, "does not compose with encoder.pipeline: the GPipe stack scans"),
])
def test_moe_refuses_streaming_and_the_pipeline_with_the_jax_errors(extra, match):
    cfg = model_config("conv-ctc", "topk")
    cfg["encoder"].update(extra)
    with pytest.raises(NotImplementedError, match=match):
        get_model_class("conv-ctc").create_model(cfg, device="cpu")


@pytest.mark.parametrize("moe,match", [({"num_experts": 4, "every": 0}, "moe"),
                                       ({"num_experts": 4, "every": 5}, "zero MoE layers")])
def test_encoder_from_config_guards_bad_every(moe, match):
    from openasr_torch.models.encoder import TransformerEncoder

    with pytest.raises(ValueError, match=match):
        TransformerEncoder.from_config(dict(ENC, num_layers=2, moe=moe))


# ---------------------------------------------------------- int8, export

def moe_package():
    model_cfg = copy.deepcopy(MOE_TEST["model"])
    model_cfg["decoder"]["vocab_size"] = 11
    return get_model_class("conv-ctc-transformer").create_model(
        model_cfg, device="cpu", generator=torch.Generator().manual_seed(5))


def test_bridge_quantized_expert_tables_bit_for_bit():
    """The [E, D, F] tables quantize with one scale per F over E and D;
    bridged, the port's dequantized weights equal the JAX package's
    dequantized tables, bridged, bit for bit."""
    port = moe_package()
    comps = port.package()["components"]
    q = quant.quantize_params(comps)
    table = q["encoder"]["layer1"]["moe_ffn"]["w1"]
    assert quant.is_quantized_leaf(table) and table[quant.SCALE_KEY].shape == (64,)
    got = quant.dequantize_params(quant.bridge_quantized("conv-ctc-transformer", q))
    want = jax_components_to_state_dict(
        "conv-ctc-transformer", jax.tree_util.tree_map(
            np.asarray, jax_quant.dequantize_params(jax_quant.quantize_params(comps))))
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert got["encoder.layer1.moe_ffn.w_gate"].shape == (4, 32, 64)


@pytest.mark.parametrize("weights", ["int8"])
def test_moe_beam_exports_and_serves_as_the_live_decode(tmp_path, weights):
    """The attention beam of an MoE model exports (capacity static per
    bucket) and serves the live decode of the weights it takes (int8: the
    dequantized ones)."""
    port = moe_package()
    path = str(tmp_path / "moe.zip")
    serving.export_beam_decode(port, [(2, 40)], path, beam_size=2, max_decode_len=3,
                               platforms=("cpu",), weights=weights)
    dec = serving.ExportedDecoder(path)
    feats = np.random.RandomState(6).randn(2, 40, 20).astype(np.float32)
    lens = np.array([40, 33], np.int32)
    got = dec(dec.prepare_params(port.package()), feats, lens)
    live = port
    if weights == "int8":
        pkg = port.package()
        pkg["components"] = quant.dequantize_params(quant.quantize_params(pkg["components"]))
        live = moe_package()
        live.restore(pkg)
    want = live.batch_beam_decode(torch.from_numpy(feats), torch.from_numpy(lens), beam_size=2,
                                  max_decode_len=3, stop_when_finished=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w) if g.dtype != torch.float32 else torch.allclose(
            g, w, rtol=1e-5, atol=1e-5)
    assert json.loads(json.dumps(dec.meta["configs"]))["encoder"]["moe"]["num_experts"] == 4


@pytest.mark.parametrize("router", ["topk", "expert_choice"])
def test_route_replay_counts_the_tokens_routed_otherwise(router):
    """chip_smoke.py's RouteReplay: the recorded picks replayed; the tokens
    the own picks route otherwise counted (an expert's slots in another
    order route no token otherwise), with the gate margin over the call's
    largest gate."""
    import chip_smoke
    from openasr_torch.models import moe

    replay = chip_smoke.RouteReplay(router)
    # topk: a token's gates over 3 experts, top-1; expert_choice: an
    # expert's gates over 3 tokens, its 2 slots
    values = torch.tensor([[[0.5, 0.3, 0.2], [0.3, 0.6, 0.3], [0.4, 0.4, 0.2]]])
    k = 1 if router == "topk" else 2
    with replay.installed("record"):
        recorded = moe.top_indices(values, k)
    nudged = values.clone()
    nudged[0, 1, 2] += 1e-6      # expert_choice: row 1 takes token 2 for token 0
    nudged[0, 2, 1] += 1e-6      # topk: token 2 goes to expert 1
    with replay.installed("replay"):
        got = moe.top_indices(nudged, k)
    assert torch.equal(got, recorded) and moe.top_indices is replay.plain
    assert replay.flips == (1 if router == "topk" else 2)
    assert replay.margins == [pytest.approx(1e-6 / 0.6, rel=0.05)]
