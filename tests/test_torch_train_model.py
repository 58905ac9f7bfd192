"""The port's training forward against the JAX model, on the CPU.

The small model of tests/test_torch_models.py (2 + 2 layers, d64, 4 heads,
GLU, vocab 20) is built by the port and its package handed to the JAX
package's create_model (whose eager flax init would compile op by op for
tens of seconds on the CPU); both compute the loss dict and the gradients of the solver's mixed loss on
the same numpy batch with dropout and SpecAugment off.  Tolerances: loss
1e-5 relative (f32, summation order); each parameter's gradient 1e-4
relative to the larger of its own largest magnitude and a tenth of the
model's largest gradient (the attention k-biases have an analytically zero
gradient, softmax being shift-invariant per row, so their own scale is
rounding noise).

Rows with no valid key (an utterance of at most 6 frames) take the JAX
dense path's value in the port too (a dense fix-up around the flash
kernel), so they are held to the same tolerances, gradients included.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openasr_tpu.models import get_model_class as jax_model_class
from openasr_torch.convert import jax_components_to_state_dict
from openasr_torch.data.collate import gen_causal_targets
from openasr_torch.models import get_model_class
from openasr_torch.models.layers import TrainRNG

from test_torch_models import small_config

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
LAMBDA_CTC = 0.5


def make_batch(seed=0, lengths=(41, 30, 19)):
    rng = np.random.RandomState(seed)
    b = len(lengths)
    feats = np.zeros((b, max(lengths), 20), np.float32)
    for i, n in enumerate(lengths):
        feats[i, :n] = rng.randn(n, 20)
    toks = [list(rng.randint(4, 20, size=n)) for n in (5, 3, 2)[:b]]
    ids, labels, paddings = gen_causal_targets(toks, add_eos=True, max_len=8)
    return {"feats": feats, "feat_lengths": np.asarray(lengths, np.int32),
            "ids": ids, "labels": labels, "paddings": paddings}


def mix(losses, model_type):
    total = 0.0
    if "ce_loss" in losses:
        total = total + losses["ce_loss"] / losses["n_tokens"]
    if "ctc_loss" in losses:
        w = LAMBDA_CTC if model_type == "conv-ctc-transformer" else 1.0
        total = total + w * losses["ctc_loss"] / losses["n_seqs"]
    return total


def build_pair(model_type):
    """(JAX model, port, JAX reference): the two models hold the port's
    weights, passed to the JAX create_model in place of its flax init; the
    reference is `jax_reference` of the JAX model."""
    cfg = small_config(model_type)
    port = get_model_class(model_type).create_model(cfg, device="cpu")
    params = jax.tree_util.tree_map(jnp.asarray, port.package()["components"])
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn.Module, "init", lambda self, *a, **k: {"params": params})
        jax_model = jax_model_class(model_type).create_model(cfg)
    return jax_model, port, jax_reference(jax_model, model_type)


@pytest.fixture(scope="module")
def pairs():
    """model type -> `build_pair`, built once per module, so that tests at
    the same batch shapes share one compile of the JAX reference."""
    cache = {}

    def get(model_type):
        if model_type not in cache:
            cache[model_type] = build_pair(model_type)
        return cache[model_type]

    return get


def jax_reference(model, model_type):
    """Jitted batch -> (total, losses, gradients, outputs) of the JAX model;
    the outputs (encoder output and lengths, teacher-forced logits) for the
    attention families, else None."""
    def run(params, batch):
        def f(p):
            losses = model.loss(p, batch, {}, train=False, label_smooth=0.1)
            return mix(losses, model_type), losses

        (total, losses), grads = jax.value_and_grad(f, has_aux=True)(params)
        outs = None
        if model_type != "conv-ctc":
            x, lens, ids = batch["feats"], batch["feat_lengths"], batch["ids"]
            outs = (model.encode(params, x, lens),
                    model.module.apply({"params": params}, x, lens, ids,
                                       jnp.full((x.shape[0],), ids.shape[1], jnp.int32)))
        return total, losses, grads, outs

    jitted = jax.jit(run)

    def reference(batch):
        total, losses, grads, outs = jitted(model.params, batch)
        return float(total), {k: float(v) for k, v in losses.items()}, grads, outs

    return reference


def port_loss_and_grads(port, batch, model_type):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for p in port.module.parameters():
        p.grad = None
    losses = port.loss(tb, None, label_smooth=0.1)
    total = mix(losses, model_type)
    total.backward()
    grads = {n: p.grad for n, p in port.module.named_parameters()}
    return float(total.detach()), {k: float(v.detach()) for k, v in losses.items()}, grads


@pytest.mark.parametrize("model_type", ["conv-ctc-transformer", "conv-transformer",
                                        "conv-ctc"])
def test_loss_and_grads_match_jax(model_type, pairs):
    _, port, reference = pairs(model_type)
    batch = make_batch(lengths=(41, 30, 19))
    tot_j, losses_j, grads_j, _ = reference(batch)
    tot_t, losses_t, grads_t = port_loss_and_grads(port, batch, model_type)
    assert set(losses_j) == set(losses_t)
    for k, v in losses_j.items():
        assert abs(losses_t[k] - v) <= LOSS_RTOL * max(abs(v), 1.0), k
    assert abs(tot_t - tot_j) <= LOSS_RTOL * abs(tot_j)
    assert_grads_match(grads_j, grads_t, model_type)


def assert_grads_match(grads_j, grads_t, model_type):
    want = jax_components_to_state_dict(
        model_type, jax.tree_util.tree_map(np.asarray, grads_j))
    assert set(want) == set(grads_t)
    floor = 0.1 * max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        scale = max(float(w.abs().max()), floor)
        assert float((grads_t[name] - w).abs().max()) <= GRAD_RTOL * scale, name


def test_zero_length_rows_take_the_dense_mean(pairs):
    """Utterances of 6 and 5 frames have encoder length 0: the port's flash
    rule gives O = 0 on their rows, the JAX dense path softmax(s + NEG_INF)
    (the mean of V where |s| < 32).  The port's MHA fix-up, switched on by
    `has_empty_rows` of the host lengths, must reproduce the JAX encoder
    output and the decoder's cross-attention output (teacher-forced logits)
    within the f32 tolerance of tests/test_torch_models.py, and the losses
    and gradients within this file's."""
    _, port, reference = pairs("conv-ctc-transformer")
    batch = make_batch(3, lengths=(41, 6, 5))
    x, lens, ids = batch["feats"], batch["feat_lengths"], batch["ids"]
    _, losses_j, grads_j, ((enc_j, elens_j), (ctc_j, _, ce_j)) = reference(batch)
    assert port.has_empty_rows(lens) and not port.has_empty_rows(lens[:1])
    with torch.no_grad():
        enc_t, elens_t = port.encode(torch.from_numpy(x), torch.from_numpy(lens),
                                     empty_rows=True)
        ctc_t, _, ce_t = port.module(torch.from_numpy(x), torch.from_numpy(lens),
                                     torch.from_numpy(ids))
    assert list(np.asarray(elens_j)) == list(elens_t.numpy()) and elens_t[1:].max() == 0
    assert np.abs(np.asarray(enc_j) - enc_t.numpy()).max() <= 1e-4
    assert np.abs(np.asarray(ctc_j) - ctc_t.numpy()).max() <= 1e-4
    assert np.abs(np.asarray(ce_j) - ce_t.numpy()).max() <= 1e-4
    _, losses_t, grads_t = port_loss_and_grads(port, batch, "conv-ctc-transformer")
    for k, v in losses_j.items():
        assert abs(losses_t[k] - v) <= LOSS_RTOL * max(abs(v), 1.0), k
    assert_grads_match(grads_j, grads_t, "conv-ctc-transformer")


def test_train_forward_draws_from_the_rng():
    """With a TrainRNG the forward drops (residual, FFN, attention,
    embedding) and masks (SpecAugment): it differs from the deterministic
    one, repeats under the same seed, and its gradients are finite."""
    cfg = small_config()
    cfg["signal"] = {"feature_type": "offline", "spec_aug": {
        "freq_mask_num": 1, "freq_mask_width": 5, "time_mask_num": 1,
        "time_mask_width": 8}}
    port = get_model_class("conv-ctc-transformer").create_model(cfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in make_batch(1).items()}
    det = float(mix(port.loss(tb, None), "conv-ctc-transformer").detach())
    runs = []
    for _ in range(2):
        loss = mix(port.loss(tb, TrainRNG(7, "cpu")), "conv-ctc-transformer")
        loss.backward()
        runs.append(float(loss.detach()))
    assert runs[0] == runs[1] and runs[0] != det
    assert all(torch.isfinite(p.grad).all() for p in port.module.parameters())


def test_bfloat16_autocast_loss_close_to_f32():
    """bf16 under autocast over f32 weights (the solver's bf16 training):
    the loss stays within 2% of f32 on the CPU, and gradients land f32."""
    cfg = small_config()
    port = get_model_class("conv-ctc-transformer").create_model(cfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in make_batch(2, (41, 30, 19)).items()}
    f32 = float(mix(port.loss(tb, None), "conv-ctc-transformer").detach())
    with torch.autocast("cpu", dtype=torch.bfloat16):
        loss = mix(port.loss(tb, None), "conv-ctc-transformer")
    loss.backward()
    assert abs(float(loss.detach()) - f32) <= 2e-2 * abs(f32)
    assert all(p.grad.dtype == torch.float32 for p in port.module.parameters())


def test_empty_rows_under_attention_dropout_use_the_flash_calls_mask():
    """In training the dense fix-up of an empty row drops its weights with
    the hash mask of the same seed the flash call drew, as one dense
    attention over the whole batch would."""
    from openasr_torch.kernels.flash_attention import (
        attention_dropout_mask,
        draw_dropout_seed,
        flash_attention_reference,
    )
    from openasr_torch.models.layers import MultiHeadAttention, dot_product_attention
    from openasr_torch.ops.masks import padding_bias

    torch.manual_seed(0)
    mha = MultiHeadAttention(64, 2, dropout_rate=0.3)
    x = torch.from_numpy(np.random.RandomState(9).randn(2, 7, 64).astype(np.float32))
    lens = torch.tensor([7, 0])
    with torch.no_grad():
        got = mha(x, x, kv_lengths=lens, rng=TrainRNG(3, "cpu"), empty_rows=True)
        seed = draw_dropout_seed(TrainRNG(3, "cpu").host)
        q, (k, v) = mha._heads(mha.q(x)), mha.project_kv(x)
        keep = attention_dropout_mask(seed, 2, 2, 7, 7, 0.3)
        dense = dot_product_attention(q, k, v, padding_bias(lens, 7), keep, 0.3)
        flash, _ = flash_attention_reference(q, k, v, lens, False, None, 0.3, seed)
    assert torch.allclose(got[1], mha._merge(dense)[1], atol=1e-5)
    assert torch.allclose(got[0], mha._merge(flash)[0], atol=1e-5)
    assert not torch.allclose(got[1], mha._merge(flash)[1], atol=1e-3)


def test_restore_without_fc_loads_the_encoder_only():
    """The train CLI's `pretrained_model` warm start: the encoder comes from
    the package, the output layers (decoder, ctc_fc) stay as built."""
    cfg = small_config()
    cls = get_model_class("conv-ctc-transformer")
    source = cls.create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    target = cls.create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    fresh = {n: p.clone() for n, p in target.module.state_dict().items()}
    target.restore(source.package(), without_fc=True)
    want = source.module.state_dict()
    for name, value in target.module.state_dict().items():
        from_source = name.startswith("encoder.")
        assert torch.equal(value, want[name] if from_source else fresh[name]), name
    assert not torch.equal(fresh["ctc_fc.weight"], want["ctc_fc.weight"])


@pytest.mark.parametrize("t", [7, 384])
def test_empty_rows_take_the_dense_value_at_every_length(t):
    """With `empty_rows` an empty row takes the dense value below and
    above the JAX package's TPU flash crossover of 384 frames alike (the
    port keeps no TPU length routing); without it the fix-up is off and
    the row keeps the kernel's O = 0."""
    from openasr_torch.kernels.flash_attention import flash_attention_reference
    from openasr_torch.models.layers import MultiHeadAttention, dot_product_attention
    from openasr_torch.ops.masks import padding_bias

    torch.manual_seed(1)
    mha = MultiHeadAttention(64, 2)
    x = torch.from_numpy(np.random.RandomState(4).randn(2, t, 64).astype(np.float32))
    lens = torch.tensor([t, 0])
    with torch.no_grad():
        got = mha(x, x, kv_lengths=lens, empty_rows=True)
        off = mha(x, x, kv_lengths=lens)
        q, (k, v) = mha._heads(mha.q(x)), mha.project_kv(x)
        flash = mha._merge(flash_attention_reference(q, k, v, lens)[0])
        dense = mha._merge(dot_product_attention(q, k, v, padding_bias(lens, t)))
    assert torch.equal(off, flash)
    assert torch.allclose(got, dense, atol=1e-5)
    assert not torch.allclose(dense[1], flash[1], atol=1e-3)
