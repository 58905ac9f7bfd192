"""The WGAN-GP gan_phone2char against the JAX package, on the CPU.

G at the p2c widths of tests/test_cpc_text_gan_lm.py (d32, one layer, two
heads, dropout 0), D a two-layer ConvV2 over the character vocabulary;
the port builds the model from a seed (G's blank row of `ctc_fc` zeroed,
so that the greedy shrink keeps frames) and the JAX package's
create_model takes its package.  Both are fed the JAX draw of the
penalty's `alpha` (from the `aug` key; the port draws its own from the
TrainRNG, ROADMAP queue 3).  D's score, `loss_G`, `loss_D` and the
combined loss 1e-5; the gradients of G and D 1e-4, D's including the
penalty's second-order term; G's gradient from the D term and D's from
the G term are zero in both.  `restore_G` from a JAX Embed_Decoder_CTC
package equals the JAX restore.  The GAN solver: 5 iterations at
accumulate_grad_batch 2 (3 steps) equal the JAX solver's parameters
(1e-5) and its dev WER through G (the JAX GAN lacks `greedy_decode`,
which its dev pass calls: the test lends it the Embed_Decoder_CTC one).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openasr_torch.convert import state_dict_to_jax_components
from openasr_torch.models.layers import TrainRNG
from openasr_torch.solvers import get_solver_class
from openasr_tpu.models import get_model_class as jax_model_class
from openasr_tpu.models.gan import GANModule as JaxGANModule
from openasr_tpu.models.gan import GANPhone2Char as JaxGAN
from openasr_tpu.ops.ctc_decode import ctc_greedy_decode as jax_greedy
from openasr_tpu.parallel import make_mesh
from openasr_tpu.solvers import get_solver_class as jax_solver_class

from test_torch_text import TRAINING, dev_wers, p2c_batch, tensors
from test_torch_wave_models import close, flat, grads_close

LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5
GAN_CFG = {
    "type": "gan_phone2char",
    "G": {
        "encoder": {"vocab_size": 15, "d_model": 32},
        "decoder": {"vocab_size": 20, "d_model": 32, "nhead": 2, "num_layers": 1,
                    "dim_feedforward": 64, "activation": "relu", "dropout_rate": 0.0},
    },
    "D": {"encoder": {"d_input": 20, "d_model": 32, "layer_num": 2}},
}


def gan_pair(seed=1):
    from openasr_torch.models import get_model_class

    port = get_model_class("gan_phone2char").create_model(
        json.loads(json.dumps(GAN_CFG)), device="cpu",
        generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        port.module.G.ctc_fc.weight[-1].zero_()
    params = {"params": jax.tree_util.tree_map(jnp.asarray, port.package()["components"])}
    with pytest.MonkeyPatch.context() as m:
        import flax.linen as flax_nn

        m.setattr(flax_nn.Module, "init", lambda self, *a, **k: params)
        jax_model = jax_model_class("gan_phone2char").create_model(
            json.loads(json.dumps(GAN_CFG)))
    return jax_model, port


def gan_batch(seed=0, b=3, p=7, text_t=16):
    rng = np.random.RandomState(seed + 100)
    batch = p2c_batch(seed, b=b, p=p)
    batch["unpaired_phones"] = rng.randint(3, 14, (b, p + 2)).astype(np.int32)
    batch["unpaired_phone_lengths"] = np.array([p + 2, p, 3][:b], np.int32)
    batch["unpaired_text"] = rng.randint(3, 19, (b, text_t)).astype(np.int32)
    batch["unpaired_text_lengths"] = np.array([text_t, text_t - 4, 5][:b], np.int32)
    return batch


def jax_alpha(key, b):
    return np.array(jax.random.uniform(key, (b, 1, 1)))


@pytest.fixture(scope="module")
def pair():
    return gan_pair()


def test_losses_and_gradients_match_jax(pair):
    jax_model, port = pair
    batch = gan_batch(0)
    rngs = {"dropout": jax.random.PRNGKey(0), "aug": jax.random.PRNGKey(1)}
    parts = ("sup", "g", "d")

    @jax.jit
    def run(params, batch):
        def part(p, which):
            ls = jax_model.loss(p, batch, rngs, train=True)
            return {"sup": ls["ctc_loss"] / ls["n_tokens"], "g": ls["g_loss"],
                    "d": ls["d_loss"]}[which], ls

        losses = jax_model.loss(params, batch, rngs, train=True)
        grads = {w: jax.grad(lambda p: part(p, w)[0])(params) for w in parts}
        probs = jax.nn.softmax(jnp.asarray(batch["unpaired_text"], jnp.float32)[..., None]
                               * jnp.linspace(-1.0, 1.0, 20), -1)
        score = jax_model._d_score(params, probs, batch["unpaired_text_lengths"])
        return losses, grads, probs, score

    losses, grads, probs, score = run(jax_model.params, batch)
    grads = {w: flat(jax.tree_util.tree_map(np.asarray, g)) for w, g in grads.items()}
    tb = tensors(batch)
    alpha = torch.from_numpy(jax_alpha(rngs["aug"], 3))
    with torch.no_grad():
        got = port.module.D(torch.from_numpy(np.array(probs)), tb["unpaired_text_lengths"])
    close(got.numpy(), score, LOSS_RTOL, "D score")

    got_grads = {}
    for which in parts:
        for p in port.module.parameters():
            p.grad = None
        ls = port.loss(tb, TrainRNG(0, "cpu"), alpha=alpha)
        {"sup": ls["ctc_loss"] / ls["n_tokens"], "g": ls["g_loss"], "d": ls["d_loss"]}[
            which].backward()
        got_grads[which] = flat(state_dict_to_jax_components(
            "gan_phone2char", {n: p.grad if p.grad is not None else torch.zeros_like(p)
                               for n, p in port.module.named_parameters()}, port.configs))
    for k in ("ctc_loss", "g_loss", "d_loss", "n_tokens", "n_seqs"):
        close(float(ls[k].detach()), float(losses[k]), LOSS_RTOL, k)
    assert float(losses["g_loss"]) != 0.0  # the shrink kept frames
    total = {n: sum(got_grads[w][n] for w in parts) for n in got_grads["d"]}
    grads_close(total, {n: sum(grads[w][n] for w in parts) for n in grads["d"]})
    grads_close(got_grads["d"], grads["d"])
    for which, other in (("d", "G/"), ("g", "D/")):
        for name in grads[which]:
            if name.startswith(other):
                assert not np.any(grads[which][name]), (which, name)
                assert not np.any(got_grads[which][name]), (which, name)
    assert any(np.any(v) for n, v in got_grads["g"].items() if n.startswith("G/"))


def test_penalty_has_its_second_order_term(pair):
    """D's gradient of loss_D moves with gp_weight: the penalty's
    gradient-of-a-gradient reaches D's parameters."""
    _, port = pair
    batch = tensors(gan_batch(1))
    alpha = torch.full((3, 1, 1), 0.3)
    got = {}
    for w in (0.0, 1.0):
        for p in port.module.parameters():
            p.grad = None
        port.loss_D(batch["unpaired_phones"], batch["unpaired_phone_lengths"],
                    batch["unpaired_text"], batch["unpaired_text_lengths"], alpha,
                    gp_weight=w).backward()
        got[w] = port.module.D.encoder.conv0.weight.grad.clone()
        assert all(p.grad is None for p in port.module.G.parameters())
    assert float((got[1.0] - got[0.0]).abs().max()) > 1e-6


def test_restore_g_from_a_jax_package():
    g_cfg = dict(json.loads(json.dumps(GAN_CFG["G"])), type="Embed_Decoder_CTC")
    g_pkg = jax_model_class("Embed_Decoder_CTC").create_model(
        g_cfg, rng=jax.random.PRNGKey(5)).package()
    g_pkg = jax.tree_util.tree_map(np.asarray, g_pkg)
    jax_model, port = gan_pair(seed=2)
    jax_model.restore_G(g_pkg)
    port.restore_G(g_pkg)
    want = flat(jax.tree_util.tree_map(np.asarray, jax_model.params))
    got = flat(port.package()["components"])
    assert set(got) == set(want)
    for name, value in got.items():
        np.testing.assert_array_equal(value, want[name], err_msg=name)
    np.testing.assert_array_equal(got["G/emb/embedding"], g_pkg["components"]["emb"]["embedding"])


def _jax_greedy(self, params, phones, phone_lengths):
    logits, lens = self.module.apply({"params": params}, phones, phone_lengths,
                                     method=JaxGANModule.g_logits)
    return jax_greedy(logits, lens)


def test_gan_solver_matches_jax(tmp_path, monkeypatch):
    """5 iterations at accumulate_grad_batch 2: steps after iterations 2, 4
    and 5 (the leftover), each iteration one paired, one unpaired-phone and
    one unpaired-text batch (the paired and text loaders cycle)."""
    jax_model, port = gan_pair(seed=3)
    paired = [p2c_batch(30 + i) for i in range(2)]
    full = [gan_batch(40 + i) for i in range(5)]
    phones = [{"tokens": b["unpaired_phones"], "token_lengths": b["unpaired_phone_lengths"]}
              for b in full]
    texts = [{"tokens": b["unpaired_text"], "token_lengths": b["unpaired_text_lengths"]}
             for b in full[:3]]
    dev = [p2c_batch(50), p2c_batch(51, b=2)]
    training = dict(TRAINING, accumulate_grad_batch=2)
    monkeypatch.setattr(JaxGAN, "greedy_decode", _jax_greedy, raising=False)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_solver = jax_solver_class("gan_phone2char")(
        jax_model, dict(training, exp_dir=jax_dir), paired, dev, phone_loader=phones,
        text_loader=texts, mesh=make_mesh(jax.devices("cpu")[:1]))
    jax_solver.iter_one_epoch()
    jax_solver.iter_one_epoch(cross_valid=True)

    solver = get_solver_class("gan_phone2char")(
        port, dict(training, exp_dir=port_dir), paired, dev, phone_loader=phones,
        text_loader=texts, device="cpu")
    loss_d = port.loss_D

    def at_the_jax_draw(phones, lens, text, text_lengths, alpha=None, generator=None, **kw):
        key = jax.random.fold_in(jax.random.PRNGKey(0), solver.step * 8191 + solver._niter)
        alpha = torch.from_numpy(jax_alpha(jax.random.fold_in(key, 1), phones.shape[0]))
        return loss_d(phones, lens, text, text_lengths, alpha, **kw)

    port.loss_D = at_the_jax_draw
    tr = solver.iter_one_epoch()
    solver.iter_one_epoch(cross_valid=True)
    assert np.isfinite(tr)
    assert solver.step == jax_solver.step == 3
    want = flat(jax.tree_util.tree_map(np.asarray, jax_solver.model.params))
    for name, value in flat(port.package()["components"]).items():
        close(value, want[name], PARAM_TOL, name)
    got, want = dev_wers(port_dir), dev_wers(jax_dir)
    assert len(got) == len(want) == 1 and abs(got[0] - want[0]) <= 1e-12
