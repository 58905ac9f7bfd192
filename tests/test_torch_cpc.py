"""CPC pretraining (`encoder_cpc`) against the JAX package, on the CPU.

The port builds the model (seeded weights and BatchNorm statistics) and
the JAX package's create_model takes its package.  Both modules are fed
the JAX package's own draws of the anchor and the negatives (its loss
draws them from a PRNG key), also where the batch is so short that the
target window runs past the last frame and `dynamic_slice_in_dim`
clamps it back: loss and accuracy 1e-5, gradients 1e-4, running
statistics 1e-5.  The port's own draws keep the JAX bounds.

`train_cpc --type pretrain --continue-training` on the mini wave corpus
continues a package the JAX package wrote (its model, batch_stats,
solver state and fused clip+Adam state after one JAX step); the port's
dev loss is held within 1e-3 to the JAX module's on the port's final
package, at the port's dev draws (the dev anchors come from a fixed seed
in either package, but not the same draws: ROADMAP queue 3).
"""

import copy
import json
import os
import types

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from openasr_torch.bin import gen_mini_corpus, train_cpc
from openasr_torch.convert import state_dict_to_jax_components
from openasr_torch.data.collate import WaveOnlyCollate
from openasr_torch.data.manifest import SpeechDataset
from openasr_torch.data.sampler import TimeBasedSampler
from openasr_torch.models import get_model_class
from openasr_torch.models.cpc import draw_anchor
from openasr_torch.utils.checkpoint import load_package
from openasr_tpu.models import get_model_class as jax_model_class
from openasr_tpu.ops.schedules import get_schedule as jax_get_schedule
from openasr_tpu.solvers import Solver as JaxSolver

from test_torch_wave_models import (
    STATS_RTOL,
    close,
    flat,
    grads_close,
    jax_variables,
    perturb_batch_norms,
    stats_of,
    wave_batch,
)

N_STEPS = 3
CPC_CFG = {"type": "encoder_cpc", "signal": {"d_model": 16},
           "cpc": {"d_input": 16, "d_coding": 8, "n_layers": 1, "n_steps": N_STEPS}}
DEV_TOL = 1e-3


@pytest.fixture(scope="module")
def pair():
    port = get_model_class("cpc_model").create_model(
        CPC_CFG, device="cpu", generator=torch.Generator().manual_seed(3))
    perturb_batch_norms(port.module, 3)
    variables = jax_variables(port.package())
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn.Module, "init", lambda self, *a, **k: variables)
        jax_model = jax_model_class("cpc_model").create_model(CPC_CFG)
    run = jax.jit(lambda p, bs, w, lens, t, neg: jax.value_and_grad(
        lambda q: _jax_apply(jax_model, q, bs, w, lens, t, neg), has_aux=True)(p))
    return jax_model, port, run


def _jax_apply(jax_model, params, bs, waves, lens, t, neg):
    (acc, loss), upd = jax_model.module.apply(
        {"params": params, "batch_stats": bs}, waves, lens, t, neg, deterministic=False,
        mutable=["batch_stats"])
    return loss / waves.shape[0], (acc, loss, upd["batch_stats"])


def jax_draws(lengths, seed):
    """The JAX CPCModel.loss's anchor and negatives for key `seed`."""
    b = len(lengths)
    hi = max(min(lengths) // 160 - N_STEPS, 2)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    t = jax.random.randint(k1, (), 1, hi)
    offset = jax.random.randint(k2, (b,), 1, b)
    return np.asarray(t), np.asarray((np.arange(b) + np.asarray(offset)) % b)


@pytest.mark.parametrize("lengths,seed", [
    ((4000, 3200, 2400), 0),
    ((4000, 3200, 2400), 1),
    # T' 4 < anchor 1 + 1 + n_steps: the target window clamps back to [1, 4)
    ((640, 640, 640, 640), 2),
])
def test_cpc_matches_jax_at_the_jax_draws(pair, lengths, seed):
    jax_model, port, run = pair
    batch = wave_batch(seed, lengths)
    t, neg = jax_draws(lengths, seed)
    if seed == 2:
        assert int(t) == 1 and 4 < int(t) + 1 + N_STEPS
    (_, (acc, loss, bs)), grads = run(jax_model.params, jax_model.batch_stats,
                                          batch["waves"], batch["wave_lengths"], t, neg)
    module = get_model_class("cpc_model").create_model(CPC_CFG, device="cpu").module
    module.load_state_dict(port.module.state_dict())
    got_acc, got_loss = module(torch.from_numpy(batch["waves"]),
                               torch.from_numpy(batch["wave_lengths"]),
                               torch.tensor(int(t)), torch.from_numpy(neg), train=True)
    (got_loss / len(lengths)).backward()
    close(float(got_loss.detach()), float(loss), STATS_RTOL, "cpc loss")
    assert float(got_acc) == pytest.approx(float(acc), abs=1e-6)
    port_grads = state_dict_to_jax_components(
        "encoder_cpc", {k: p.grad for k, p in module.named_parameters()}, port.configs)
    grads_close(flat(port_grads), flat(jax.tree_util.tree_map(np.asarray, grads)))
    for name, value in flat(stats_of(module, "")).items():
        close(value, flat(bs)[f"splayer/{name}"], STATS_RTOL, name)


def test_port_draws_keep_the_jax_bounds():
    """t in [1, max(min_len_z - n_steps, 2)), every negative another row,
    and a fixed generator seed gives the same draws."""
    lens = torch.tensor([4000, 3200, 2400])
    hi = max(2400 // 160 - N_STEPS, 2)
    seen = set()
    for s in range(200):
        t, neg = draw_anchor(lens, N_STEPS, 3, torch.Generator().manual_seed(s))
        assert 1 <= int(t) < hi
        assert all(int(neg[i]) != i for i in range(3))
        seen.add(int(t))
    assert seen == set(range(1, hi))
    a = draw_anchor(lens, N_STEPS, 3, torch.Generator().manual_seed(0))
    b = draw_anchor(lens, N_STEPS, 3, torch.Generator().manual_seed(0))
    assert int(a[0]) == int(b[0]) and torch.equal(a[1], b[1])
    t, neg = draw_anchor(torch.tensor([320]), N_STEPS, 1, torch.Generator())
    assert int(t) == 1 and neg.tolist() == [0]


# ------------------------------------------------------------------ CLI


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("wave_corpus"))
    gen_mini_corpus.main(["--out", out, "--wave", "--num_utts", "16"])
    return out


def pretrain_config(corpus, exp, num_epoch):
    return {
        "data": {"trainset": os.path.join(corpus, "train_wav.json"),
                 "devset": os.path.join(corpus, "dev_wav.json"),
                 "feat_range": "400,120000", "fetchworker_num": 0},
        "model": {"type": "encoder_cpc", **{k: v for k, v in CPC_CFG.items() if k != "type"}},
        "training": {"batch_time": 20000, "exp_dir": str(exp), "print_inteval": 1,
                     "num_epoch": num_epoch, "accumulate_grad_batch": 1, "init_lr": 1e-3,
                     "optimtype": "adam", "grad_max_norm": 5.0, "num_last_ckpt_keep": 5,
                     "lr_scheduler": {"type": "linear", "x0": 0, "y0": 1.0, "x1": 1000000,
                                      "y1": 1.0}},
    }


def write_jax_package(pair, exp, cfg):
    """What the JAX solver writes after one step: the model (weights and
    batch_stats), the solver state and the fused clip+Adam state, pickled
    with the JAX package's classes."""
    from openasr_tpu.utils.checkpoint import save_package as jax_save_package

    jax_model, _, run = pair
    training = cfg["training"]
    ns = types.SimpleNamespace(model=jax_model, init_lr=training["init_lr"],
                               grad_max_norm=training["grad_max_norm"],
                               schedule=jax_get_schedule(training["lr_scheduler"]))
    tx = JaxSolver._make_optimizer(ns, training)
    # the shapes of a parity case above, so the jitted gradient is reused
    lengths = (4000, 3200, 2400)
    batch = wave_batch(7, lengths)
    (_, (_, _, bs)), grads = run(jax_model.params, jax_model.batch_stats, batch["waves"],
                               batch["wave_lengths"], *jax_draws(lengths, 7))
    updates, state = jax.jit(tx.update)(grads, tx.init(jax_model.params), jax_model.params)
    params = optax.apply_updates(jax_model.params, updates)
    stepped = copy.copy(jax_model)
    stepped.params, stepped.batch_stats = params, bs
    os.makedirs(exp, exist_ok=True)
    jax_save_package({
        "model": stepped.package(), "solver_config": training,
        "solver_state": {"epoch": 1, "step": 1, "tr_loss": [1.0], "cv_loss": [1.0],
                         "lr": 1e-3},
        "optim_state": jax.tree_util.tree_map(np.asarray, state),
    }, os.path.join(exp, "last.pkg"))
    return jax_model


def test_train_cpc_continues_a_jax_package(pair, corpus, tmp_path):
    exp = tmp_path / "exp"
    cfg = pretrain_config(corpus, exp, num_epoch=2)
    jax_model = write_jax_package(pair, exp, cfg)
    with open(os.path.join(exp, "last.pkg"), "rb") as f:
        assert b"openasr_tpu.ops.fused_adam" in f.read()
    # the JAX-written CPC package warm-starts both finetuning families
    written = load_package(str(exp / "last.pkg"))["model"]
    from test_torch_wave_models import CONFIGS

    for model_type, method, prefix in (("gru_ctc", "load_splayer", "splayer"),
                                       ("wav2vec_ctc", "load_frontend", "encoder.frontend")):
        cfg_m = dict(CONFIGS[model_type])
        if model_type == "wav2vec_ctc":
            cfg_m["encoder"] = dict(cfg_m["encoder"], conv_dim=16)
        model = get_model_class(model_type).create_model(cfg_m, device="cpu")
        getattr(model, method)(written)
        got = flat(state_dict_to_jax_components(
            model_type, {k: v for k, v in model.module.state_dict().items()
                         if k.startswith(prefix + ".")}, model.configs))
        for name, value in flat(written["components"]["splayer"]).items():
            np.testing.assert_array_equal(got[f"{prefix.replace('.', '/')}/{name}"], value)
        for name, value in flat(written["batch_stats"]["splayer"]).items():
            np.testing.assert_array_equal(
                model.module.get_submodule(prefix).get_buffer(name.replace("/", ".")).numpy(),
                value)
    path = tmp_path / "cpc.yaml"
    path.write_text(yaml.safe_dump(cfg))
    train_cpc.main([str(path), "--type", "pretrain", "--continue-training", "--device", "cpu"])

    with open(exp / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    train_rows = [r for r in rows if r["phase"] == "train"]
    assert train_rows and all("acc" in r and 0.0 <= r["acc"] <= 1.0 for r in train_rows)
    epoch = [r for r in rows if r["phase"] == "epoch"][-1]
    final = load_package(str(exp / "last.pkg"))
    assert epoch["epoch"] == 2 and final["solver_state"]["epoch"] == 2
    assert final["optim_state"]["count"] == final["solver_state"]["step"] > 1

    # the dev pass's loss, by the JAX module on the final package
    params = jax.tree_util.tree_map(jnp.asarray, final["model"]["components"])
    bs = jax.tree_util.tree_map(jnp.asarray, final["model"]["batch_stats"])
    dev = SpeechDataset(cfg["data"]["devset"], reverse=True, feat_range=(400, 120000))
    tot = n = 0.0
    for idx in TimeBasedSampler(dev, cfg["training"]["batch_time"], 1):
        batch = WaveOnlyCollate()([dev[i] for i in idx])
        lens = torch.from_numpy(batch["wave_lengths"])
        t, neg = draw_anchor(lens, N_STEPS, len(idx), torch.Generator().manual_seed(0))
        _, loss = jax_model.module.apply({"params": params, "batch_stats": bs},
                                         batch["waves"], batch["wave_lengths"],
                                         np.asarray(int(t)), neg.numpy())
        tot += float(loss)
        n += len(idx)
    assert abs(epoch["cv_loss"] - tot / n) <= DEV_TOL, (epoch["cv_loss"], tot / n)
