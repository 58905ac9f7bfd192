"""The raw-wave families (WavConv, GRU, gru_ctc, wav2vec_ctc) against the
JAX package, on the CPU.

The port builds each model (random weights and BatchNorm statistics from
a seed) and the JAX package's create_model takes its package in place of
its flax init, so both hold the same weights.  Inputs are seeded int16-
scale waves of three lengths; dropout is off (wav2vec_ctc_test.yaml's
widths; a two-layer GRU at d24 over a WavConv of d16).  Tolerances:
outputs, losses and running statistics 1e-5 relative to their scale,
gradients 1e-4 relative to the larger of their own largest magnitude and
a tenth of the model's largest gradient.  Three solver steps, parameters
1e-5: the wav2vec freeze gate across its threshold (the stock Adam
chain), and gru_ctc's frozen splayer after `load_splayer` on the fused
and the stock paths, with the optimizer states through the bridge both
ways.  The fairseq mapping runs on a synthetic state dict.
"""

import copy
import pickle
import types

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from openasr_torch.convert import (
    jax_components_to_state_dict,
    jax_optim_state_to_port,
    port_optim_state_to_jax,
    state_dict_to_jax_components,
)
from openasr_torch.data.collate import gen_causal_targets
from openasr_torch.models import get_model_class
from openasr_torch.models.frontend import BatchNorm, WavConv
from openasr_torch.models.layers import TrainRNG
from openasr_torch.models.wav2vec import map_fairseq_context_network
from openasr_torch.solvers import CTCSolver
from openasr_torch.utils.checkpoint import load_package
from openasr_tpu.models import get_model_class as jax_model_class
from openasr_tpu.models.encoder import GRUEncoder as JaxGRUEncoder
from openasr_tpu.models.frontend import WavConv as JaxWavConv
from openasr_tpu.models.wav2vec import map_fairseq_context_network as jax_map_fairseq
from openasr_tpu.ops.schedules import get_schedule as jax_get_schedule
from openasr_tpu.solvers import Solver as JaxSolver

from test_torch_train_model import GRAD_RTOL, LOSS_RTOL

VOCAB = 12
LENGTHS = (4000, 3200, 2400)
STATS_RTOL = 1e-5
PARAM_TOL = 1e-5
GRU_CFG = {
    "type": "gru_ctc", "add_blk": True,
    "signal": {"feature_type": "wave", "d_model": 16},
    "encoder": {"d_input": 16, "d_model": 24, "n_layers": 2, "dropout": 0.0},
    "decoder": {"vocab_size": VOCAB},
}
with open("egs/wav2vec/configs/wav2vec_ctc_test.yaml") as _f:
    W2V_CFG = yaml.safe_load(_f)["model"]
W2V_CFG["decoder"]["vocab_size"] = VOCAB
CONFIGS = {"gru_ctc": GRU_CFG, "wav2vec_ctc": W2V_CFG}
TRAINING = {"num_epoch": 1, "exp_dir": None, "init_lr": 1e-3, "grad_max_norm": 5.0,
            "optimtype": "adam", "lr_scheduler": {"type": "warmup_transformer",
                                                  "warmup_step": 20, "d_model": 32}}


def wave_batch(seed=0, lengths=LENGTHS):
    rng = np.random.RandomState(seed)
    waves = np.zeros((len(lengths), max(lengths)), np.float32)
    for i, n in enumerate(lengths):
        waves[i, :n] = rng.randn(n) * 2000.0
    toks = [list(rng.randint(3, VOCAB - 1, size=n)) for n in (5, 3, 2)[:len(lengths)]]
    ids, labels, paddings = gen_causal_targets(toks, add_eos=False, max_len=8)
    return {"waves": waves, "wave_lengths": np.asarray(lengths, np.int32), "ids": ids,
            "labels": labels, "paddings": paddings}


def tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def perturb_batch_norms(module, seed):
    """Random BatchNorm scales and biases, and running statistics near those
    of a seeded batch (a train forward at momentum 0, then scattered), so
    that the eval path differs from the train path and from the init."""
    gen = torch.Generator().manual_seed(seed)
    batch = wave_batch(seed + 10)
    with torch.no_grad():
        for conv in (m for m in module.modules() if isinstance(m, WavConv)):
            norms = [m for m in conv.modules() if isinstance(m, BatchNorm)]
            for m in norms:
                c = m.mean.shape[0]
                m.weight.copy_(1.0 + 0.2 * torch.randn(c, generator=gen))
                m.bias.copy_(0.2 * torch.randn(c, generator=gen))
                m.momentum = 0.0
            conv(torch.from_numpy(batch["waves"]), torch.from_numpy(batch["wave_lengths"]),
                 train=True)
            for m in norms:
                c = m.mean.shape[0]
                m.momentum = 0.9
                m.mean.add_(0.1 * m.var.sqrt() * torch.randn(c, generator=gen))
                m.var.mul_(0.8 + 0.4 * torch.rand(c, generator=gen))


def jax_variables(pkg):
    out = {"params": jax.tree_util.tree_map(jnp.asarray, pkg["components"])}
    if pkg.get("batch_stats") is not None:
        out["batch_stats"] = jax.tree_util.tree_map(jnp.asarray, pkg["batch_stats"])
    return out


def build_pair(model_type, cfg=None, seed=1):
    """(JAX model, port) with the port's weights and statistics."""
    cfg = cfg or CONFIGS[model_type]
    port = get_model_class(model_type).create_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    perturb_batch_norms(port.module, seed)
    variables = jax_variables(port.package())
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn.Module, "init", lambda self, *a, **k: variables)
        jax_model = jax_model_class(model_type).create_model(cfg)
    return jax_model, port


def close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err:.3g} > {rtol} x {scale:.3g}"


def stats_of(module, prefix):
    """The port's running statistics as the JAX `batch_stats` subtree."""
    out = {}
    for name, m in module.named_modules():
        if isinstance(m, BatchNorm) and name.startswith(prefix):
            out[name.split(".")[-1]] = {"mean": m.mean.numpy(), "var": m.var.numpy()}
    return out


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def grads_close(got: dict, want: dict):
    floor = 0.1 * max(float(np.abs(w).max()) for w in want.values())
    assert set(got) == set(want)
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(got[name] - w).max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)


@pytest.fixture(scope="module")
def gru_pair():
    return build_pair("gru_ctc")


@pytest.mark.parametrize("train", [True, False])
def test_wavconv_matches_jax(gru_pair, train):
    """Outputs, frame counts and (train) the updated running statistics:
    flax's BatchNorm updates them with the BIASED batch variance."""
    _, port = gru_pair
    pkg = port.package()
    batch = wave_batch(2)
    variables = {"params": pkg["components"]["splayer"],
                 "batch_stats": pkg["batch_stats"]["splayer"]}
    apply = jax.jit(JaxWavConv(d_model=16).apply,
                    static_argnames=("use_running_average", "mutable"))
    if train:
        (want, want_lens), upd = apply(variables, batch["waves"], batch["wave_lengths"],
                                       use_running_average=False, mutable=("batch_stats",))
    else:
        want, want_lens = apply(variables, batch["waves"], batch["wave_lengths"])
    splayer = get_model_class("gru_ctc").create_model(GRU_CFG, device="cpu").module.splayer
    splayer.load_state_dict(port.module.splayer.state_dict())
    with torch.no_grad():
        got, got_lens = splayer(torch.from_numpy(batch["waves"]),
                                torch.from_numpy(batch["wave_lengths"]), train=train)
    close(got.numpy(), want, STATS_RTOL, "WavConv output")
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    if train:
        for name, stat in flat(upd["batch_stats"]).items():
            close(flat(stats_of(splayer, ""))[name], stat, STATS_RTOL, name)
        # torch's BatchNorm1d would store the unbiased variance: not this
        x = splayer.conv0(torch.from_numpy(batch["waves"])[:, None])
        torch_bn = torch.nn.BatchNorm1d(16, momentum=0.1)
        torch_bn(x)
        assert not np.allclose(torch_bn.running_var.detach().numpy(),
                               np.asarray(upd["batch_stats"]["bn0"]["var"]), rtol=1e-6)


def test_gru_encoder_matches_jax(gru_pair):
    """The cuDNN-style GRU with bias_hh = [0, 0, b_hn] is flax's GRUCell."""
    _, port = gru_pair
    pkg = port.package()
    rng = np.random.RandomState(3)
    feats = rng.randn(3, 25, 16).astype(np.float32)
    lens = np.asarray([25, 20, 9], np.int32)
    want, _ = JaxGRUEncoder(d_input=16, d_model=24, n_layers=2).apply(
        {"params": pkg["components"]["encoder"]}, feats, lens)
    with torch.no_grad():
        got, _ = port.module.encoder(torch.from_numpy(feats), torch.from_numpy(lens))
    close(got.numpy(), want, STATS_RTOL, "GRU output")
    assert sorted(n for n, _ in port.module.encoder.gru0.named_parameters()) == [
        "b_hn", "bias_ih", "weight_hh", "weight_ih"]


_JITTED = {}


def jax_loss_fn(jax_model):
    """Jitted (params, batch_stats, batch) -> (loss / n_seqs, losses with
    the new batch_stats, gradients, eval logits, lengths), compiled once a
    model type (the loss reads only the flax module, alike in every
    model of the type)."""
    if jax_model.model_type in _JITTED:
        return _JITTED[jax_model.model_type]

    def run(params, batch_stats, batch):
        def f(p):
            out = jax_model.loss(p, batch, {"dropout": jax.random.PRNGKey(0)}, train=True,
                                 batch_stats=batch_stats)
            return out["ctc_loss"] / out["n_seqs"], out

        (total, out), grads = jax.value_and_grad(f, has_aux=True)(params)
        logits, lens = jax_model.module.apply(
            {"params": params, "batch_stats": batch_stats}, batch["waves"],
            batch["wave_lengths"])
        return total, out, grads, logits, lens

    _JITTED[jax_model.model_type] = jax.jit(run)
    return _JITTED[jax_model.model_type]


@pytest.mark.parametrize("model_type", ["gru_ctc", "wav2vec_ctc"])
def test_loss_gradients_and_statistics_match_jax(gru_pair, model_type):
    """The training forward's loss, every gradient and the running
    statistics after it; the eval logits with the running statistics."""
    jax_model, port = gru_pair if model_type == "gru_ctc" else build_pair(model_type)
    batch = wave_batch(0)
    total, out, grads, logits, lens = jax_loss_fn(jax_model)(
        jax_model.params, jax_model.batch_stats, batch)
    with torch.no_grad():
        got_logits, got_lens = port.get_logits(torch.from_numpy(batch["waves"]),
                                               torch.from_numpy(batch["wave_lengths"]))
    close(got_logits.numpy(), logits, STATS_RTOL, "eval logits")
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(lens))

    for p in port.module.parameters():
        p.grad = None
    losses = port.loss(tensors(batch), TrainRNG(0, "cpu"))
    (losses["ctc_loss"] / losses["n_seqs"]).backward()
    assert abs(float(losses["ctc_loss"].detach()) - float(out["ctc_loss"])) <= LOSS_RTOL * max(
        abs(float(out["ctc_loss"])), 1.0)
    port_grads = state_dict_to_jax_components(
        model_type, {n: p.grad for n, p in port.module.named_parameters()}, port.configs)
    grads_close(flat(port_grads), flat(grads))
    prefix = "splayer" if model_type == "gru_ctc" else "encoder.frontend"
    jax_stats = flat(out["batch_stats"])
    for name, value in flat(stats_of(port.module, prefix)).items():
        key = next(k for k in jax_stats if k.endswith(name))
        close(value, jax_stats[key], STATS_RTOL, key)


# ----------------------------------------------------------------- solver


def jax_tx(jax_model, training):
    """The JAX solver's optimizer for this model and config."""
    ns = types.SimpleNamespace(model=jax_model, init_lr=training["init_lr"],
                               grad_max_norm=training["grad_max_norm"],
                               schedule=jax_get_schedule(training["lr_scheduler"]))
    return JaxSolver._make_optimizer(ns, training)


def jax_steps(jax_model, tx, batches, zero=()):
    """JAX train steps (the solver's: grads, tx.update, apply_updates, the
    batch_stats threaded through), each with the gradients of the
    components in `zero` set to 0 first."""
    grads_of = jax_loss_fn(jax_model)

    @jax.jit
    def update(grads, state, params):
        grads = {k: jax.tree_util.tree_map(jnp.zeros_like, v) if k in zero else v
                 for k, v in grads.items()}
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    params, bs = jax_model.params, jax_model.batch_stats
    state = tx.init(params)
    raw = []
    for batch in batches:
        _, out, grads, _, _ = grads_of(params, bs, batch)
        bs = out["batch_stats"]
        raw.append(grads)
        params, state = update(grads, state, params)
    return params, bs, state, raw


def as_loaded(state, tmp_path):
    """A live optax state as `load_package` reads it from a package."""
    path = tmp_path / "state.pkg"
    with open(path, "wb") as f:
        pickle.dump({"optim_state": jax.tree_util.tree_map(np.asarray, state)}, f)
    return load_package(str(path))["optim_state"]


def port_steps(port, training, batches, tmp_path):
    cfg = dict(training, exp_dir=str(tmp_path))
    solver = CTCSolver(port, cfg, None, None, device="cpu")
    for batch in batches:
        solver.grad_step(tensors(batch), False)
        solver.apply_update()
    return solver


def moments_close(got, want):
    """Adam's moments, keyed alike: the second (f32) to 1e-5 of its largest
    magnitude (or of a tenth of the largest of any parameter's), the first
    to one bf16 spacing (2^-7 relative) of its largest, as both solvers
    store it in bf16 and gradients that differ in the last f32 bits may
    round it to neighbouring bf16 values."""
    for key, rtol in (("mu", 2.0 ** -7), ("nu", PARAM_TOL)):
        assert set(got[key]) == set(want[key])
        # the floor, as for the gradients: the attention k-biases' are
        # rounding noise about an exact 0
        floor = 0.1 * max(float(np.abs(w).max()) for w in want[key].values())
        for name, value in got[key].items():
            w = np.asarray(want[key][name], np.float64)
            err = float(np.abs(np.asarray(value, np.float64) - w).max())
            assert err <= rtol * max(float(np.abs(w).max()), floor), (key, name, err)


def same_leaves(got, want):
    """The JAX solver restores an optimizer state by its leaves: the same
    leaves, in order, with the same values."""
    got, want = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


def params_close(port, params):
    got = flat(port.package()["components"])
    for name, want in flat(params).items():
        close(got[name], want, PARAM_TOL, name)


def test_freeze_gate_across_its_threshold(tmp_path):
    """freeze_finetune_updates 2: the whole encoder (frontend, proj, the
    layers, final_norm) is unchanged after steps 1 and 2, only fc moves;
    step 3 moves the encoder.  Stock Adam with a bf16 first moment; the
    gate's counter through the bridge."""
    jax_model, port = build_pair("wav2vec_ctc")
    assert port.freeze_gate == jax_model.freeze_gate == (("encoder",), 2)
    before = flat(port.package()["components"])
    batches = [wave_batch(s) for s in range(3)]
    tx = jax_tx(jax_model, TRAINING)
    cfg = dict(TRAINING, exp_dir=str(tmp_path))
    solver = CTCSolver(port, cfg, None, None, device="cpu")
    assert type(solver.optimizer).__name__ == "StockOptimizer"
    for i, batch in enumerate(batches[:2]):
        solver.grad_step(tensors(batch), False)
        solver.apply_update()
    after2 = flat(port.package()["components"])
    for name, value in after2.items():
        moved = not np.array_equal(value, before[name])
        assert moved == name.startswith("fc/"), name
    solver.grad_step(tensors(batches[2]), False)
    solver.apply_update()
    after3 = flat(port.package()["components"])
    assert not np.array_equal(after3["encoder/proj/kernel"], before["encoder/proj/kernel"])

    params, bs, state, _ = jax_steps(jax_model, tx, batches)
    params_close(port, params)
    for name, value in flat(stats_of(port.module, "")).items():
        close(value, flat(bs)[f"encoder/frontend/{name}"], STATS_RTOL, name)
    port_state = solver.optimizer.state_dict()
    bridged = jax_optim_state_to_port("wav2vec_ctc", as_loaded(state, tmp_path), port.configs)
    assert bridged["gate_count"] == port_state["gate_count"] == 3
    assert bridged["count"] == port_state["count"] == 3
    moments_close(port_state, bridged)
    back = port_optim_state_to_jax("wav2vec_ctc", bridged, port.configs, clip=True)
    same_leaves(back, state)


@pytest.mark.parametrize("fused", [True, False])
def test_frozen_splayer_after_load_splayer(tmp_path, fused):
    """load_splayer takes a CPC package's WavConv (weights and running
    statistics) and freezes it: the splayer gets no update and no
    optimizer moments, the clip norm leaves it out, and the rest follows
    the JAX solver's masked chain for 3 steps.  The JAX package's
    `optax.masked` passes a frozen leaf's raw gradient through as its
    update (so its splayer moves by +gradient each step); the port does
    not, so the JAX steps here take the splayer's gradient as 0, and the
    JAX package's own step is checked to move it by exactly its gradient."""
    jax_model, port = build_pair("gru_ctc", seed=2)
    cpc_cfg = {"type": "encoder_cpc", "signal": {"d_model": 16},
               "cpc": {"d_input": 16, "d_coding": 8, "n_layers": 1, "n_steps": 3}}
    cpc = get_model_class("encoder_cpc").create_model(cpc_cfg, device="cpu",
                                                      generator=torch.Generator().manual_seed(5))
    perturb_batch_norms(cpc.module, 5)
    cpc_pkg = cpc.package()
    port.load_splayer(cpc_pkg)
    jax_model.load_splayer(jax.tree_util.tree_map(np.asarray, cpc_pkg))
    assert port.frozen_components == jax_model.frozen_components == ("splayer",)
    for name, value in flat(port.package()["components"]["splayer"]).items():
        np.testing.assert_array_equal(value, flat(cpc_pkg["components"]["splayer"])[name])
    np.testing.assert_array_equal(port.module.splayer.bn2.var.numpy(),
                                  cpc_pkg["batch_stats"]["splayer"]["bn2"]["var"])

    training = dict(TRAINING, fused_adam=fused)
    batches = [wave_batch(s) for s in range(3)]
    solver = port_steps(port, training, batches, tmp_path)
    assert not any(n.startswith("splayer.") for n in solver.optimizer.names)
    tx = jax_tx(jax_model, training)
    params, bs, state, _ = jax_steps(jax_model, tx, batches, zero=("splayer",))
    params_close(port, params)
    for name, value in flat(stats_of(port.module, "")).items():
        close(value, flat(bs)[f"splayer/{name}"], STATS_RTOL, name)
    bridged = jax_optim_state_to_port("gru_ctc", as_loaded(state, tmp_path), port.configs)
    port_state = solver.optimizer.state_dict()
    assert bridged["count"] == port_state["count"] == 3
    moments_close(port_state, bridged)
    frozen = {"splayer": cpc_pkg["components"]["splayer"]}
    back = port_optim_state_to_jax("gru_ctc", bridged, port.configs, clip=True, frozen=frozen)
    same_leaves(back, state)

    # the JAX package's own masked step: splayer += its raw gradient
    jax_model.params = jax.tree_util.tree_map(jnp.asarray, jax_model.params)
    moved, _, _, raw = jax_steps(jax_model, tx, batches[:1])
    for name, value in flat(moved["splayer"]).items():
        want = flat(cpc_pkg["components"]["splayer"])[name] + flat(raw[0]["splayer"])[name]
        np.testing.assert_allclose(value, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ conversions


def test_packages_bridge_both_ways():
    """A JAX model's package (weights and batch_stats) restores into the
    port and packages back equal; GRU cells and BatchNorm included."""
    for model_type in ("gru_ctc", "wav2vec_ctc"):
        jax_model, _ = build_pair(model_type, seed=4)
        pkg = jax.tree_util.tree_map(np.asarray, jax_model.package())
        port = get_model_class(model_type).create_model(CONFIGS[model_type], device="cpu")
        port.restore(pkg)
        back = port.package()
        assert flat(back["components"]).keys() == flat(pkg["components"]).keys()
        for name, value in flat(pkg["components"]).items():
            np.testing.assert_array_equal(flat(back["components"])[name], value)
        for name, value in flat(pkg["batch_stats"]).items():
            np.testing.assert_array_equal(flat(back["batch_stats"])[name], value)
        state = jax_components_to_state_dict(model_type, pkg["components"])
        assert not any(k.endswith((".mean", ".var")) for k in state)


def test_fairseq_mapping_matches_jax():
    """map_fairseq_context_network on a synthetic fairseq-named state dict:
    the port's mapped encoder equals the JAX package's, through the
    bridge."""
    jax_model, port = build_pair("wav2vec_ctc", seed=6)
    rng = np.random.RandomState(0)
    d, ffn = 32, 64
    state = {"post_extract_proj.weight": rng.randn(d, 32).astype(np.float32),
             "post_extract_proj.bias": rng.randn(d).astype(np.float32),
             "encoder.layer_norm.weight": rng.randn(d).astype(np.float32),
             "encoder.layer_norm.bias": rng.randn(d).astype(np.float32)}
    pre = "encoder.layers.0"
    for name in ("q", "k", "v", "out"):
        state[f"{pre}.self_attn.{name}_proj.weight"] = rng.randn(d, d).astype(np.float32)
        state[f"{pre}.self_attn.{name}_proj.bias"] = rng.randn(d).astype(np.float32)
    for name, shape in (("self_attn_layer_norm", (d,)), ("final_layer_norm", (d,))):
        state[f"{pre}.{name}.weight"] = rng.randn(*shape).astype(np.float32)
        state[f"{pre}.{name}.bias"] = rng.randn(*shape).astype(np.float32)
    state[f"{pre}.fc1.weight"] = rng.randn(ffn, d).astype(np.float32)
    state[f"{pre}.fc1.bias"] = rng.randn(ffn).astype(np.float32)
    state[f"{pre}.fc2.weight"] = rng.randn(d, ffn).astype(np.float32)
    state[f"{pre}.fc2.bias"] = rng.randn(d).astype(np.float32)
    want = jax_map_fairseq(state, jax_model.params["encoder"], nhead=2)
    want_state = jax_components_to_state_dict(
        "wav2vec_ctc", {"encoder": jax.tree_util.tree_map(np.asarray, want)}, partial=True)
    got = map_fairseq_context_network(state, port.module.encoder.state_dict(), nhead=2)
    for key, value in want_state.items():
        torch.testing.assert_close(got[key[len("encoder."):]], value, rtol=0, atol=0)
    port.module.encoder.load_state_dict(got)
    with pytest.raises(ValueError, match="not a fairseq wav2vec2"):
        map_fairseq_context_network({}, port.module.encoder.state_dict(), nhead=2)


@pytest.mark.parametrize("fused", [True, False])
def test_package_and_optimizer_state_are_snapshots(tmp_path, fused):
    """A package and an optimizer state_dict taken on the CPU hold copies:
    the next step, which updates the parameters, the moments and the
    running statistics in place, leaves them as they were (the
    asynchronous checkpoint writer pickles them while training goes on)."""
    _, port = build_pair("gru_ctc", seed=3)
    solver = port_steps(port, dict(TRAINING, fused_adam=fused), [wave_batch(0)], tmp_path)
    pkg, state = port.package(), solver.optimizer.state_dict()
    kept = copy.deepcopy((pkg, state))
    solver.grad_step(tensors(wave_batch(1)), False)
    solver.apply_update()
    for got, want in ((pkg, kept[0]), (state, kept[1])):
        want = flat({k: v for k, v in want.items() if isinstance(v, dict)})
        assert want
        for name, value in flat({k: v for k, v in got.items() if isinstance(v, dict)}).items():
            np.testing.assert_array_equal(value, want[name], err_msg=name)
    assert not np.array_equal(port.module.fc.weight.detach().numpy().T,
                              pkg["components"]["fc"]["kernel"])
