"""The port's CIF family against the JAX package, on the CPU.

Both packages get the same inputs, made from a seed with numpy, and the
same weights: the port draws them and the JAX model takes the port's
package (flax's eager init is skipped, as in test_torch_train_model.py).
Every JAX reference is jitted.

- ops: `cif_parallel` and `cif_scan` against JAX's closed form and scan
  (1e-5; their gradients by a random cotangent 1e-4), with frames whose
  alpha exceeds 1 (a backlog) and capacities below the fire count
  (overflow); the product in f32 under bf16 autocast; `scale_alphas`
  with one U(0, 1) draw handed to both, and `cif_output_lengths`; the
  square loss; the CTC loss and gradient (1e-5, 1e-4) where a target is
  the blank id, as without a blank of its own (`add_blk: false`), and
  bit for bit F.ctc_loss's gradient where none is, and `chip_smoke.py`'s
  plain rewrite where some are; its ReLU replay and the flips it reports.
- modules: both assigners, the CIF decoder's forward and decode step
  and the FC decoder (1e-5).
- models: the deterministic losses (1e-5 relative) and the gradients of
  the solver's mixed loss (1e-4 of the larger of a parameter's own and a
  tenth of the model's largest gradient; the attention k-biases' true
  gradient is 0) of CIF, ctc_cif, CIF_FC and CIF_MIX (paired and
  acoustic batches).
- decode: `batch_beam_decode`'s tokens (equal) and scores (1e-4), with
  and without hotword tables, and a batch whose CIF lengths hold a 0;
  CIF_FC's greedy phone decode (equal).
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openasr_tpu.models import get_model_class as jax_model_class
from openasr_tpu.ops import cif as jax_cif
from openasr_torch.convert import state_dict_to_jax_components
from openasr_torch.data.collate import gen_causal_targets
from openasr_torch.models import get_model_class
from openasr_torch.ops import cif as port_cif
from openasr_torch.ops.ctc_beam_device import build_context_tables

OP_TOL = 1e-5
OP_GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
SCORE_TOL = 1e-4
LAMBDA_CTC = 0.5
LAMBDA_QUA = 1.0
VOCAB, PHONES = 11, 9


def cif_config(model_type="CIF", assigner="1d"):
    cfg = {
        "type": model_type,
        "add_eos": False,
        "add_blk": False,
        "signal": {"feature_type": "offline"},
        "encoder": {"type": "Transformer", "sub": {"type": "ConvV2", "layer_num": 1},
                    "input_dim": 20, "d_model": 32, "nhead": 2, "dim_feedforward": 64,
                    "activation": "glu", "num_layers": 1, "dropout_rate": 0.1},
        "assigner": {"d_model": 32, "n_layers": 2, "w_context": 3, "dropout": 0.1},
        "decoder": {"type": "CIF_Decoder", "vocab_size": VOCAB, "d_model": 32, "nhead": 2,
                    "num_layers": 2, "encoder_dim": 32, "dim_feedforward": 64,
                    "activation": "glu", "dropout_rate": 0.1},
    }
    if assigner == "2d":
        cfg["assigner"] = {"type": "2d", "d_model": 32, "n_layers": 2, "dropout": 0.1}
    if model_type == "CIF_MIX":
        cfg["phone_size"] = PHONES
        cfg["decoder"]["type"] = "TransformerDecoder"
    return cfg


def _t(a):
    return torch.from_numpy(np.asarray(a))


def jax_twin(port, cfg):
    """The JAX model of `cfg` holding the port model's weights."""
    params = jax.tree_util.tree_map(jnp.asarray, port.package()["components"])
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn.Module, "init", lambda self, *a, **k: {"params": params})
        return jax_model_class(cfg["type"]).create_model(cfg)


def build_pair(model_type, assigner="1d", seed=0):
    cfg = cif_config(model_type, assigner)
    port = get_model_class(model_type).create_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    return jax_twin(port, cfg), port


# ---------------------------------------------------------------- ops

def cif_case(name):
    """(hidden, alphas, capacity) of a named case."""
    rng = np.random.RandomState(7)
    b, t, d = 3, 17, 5
    hidden = rng.randn(b, t, d).astype(np.float32)
    alphas = rng.uniform(0.05, 0.7, size=(b, t)).astype(np.float32)
    capacity = 12
    if name == "backlog":
        alphas[:, 3] = 2.6      # one frame worth several fires: a backlog
        alphas[1, 9] = 1.4
    elif name == "overflow":
        capacity = 3            # fewer slots than fires
    alphas[2, 12:] = 0.0        # a padded tail
    return hidden, alphas, capacity


@pytest.fixture(scope="module")
def jax_cif_fns():
    def value_and_grads(fn):
        def f(h, a, cot, capacity):
            out, vjp = jax.vjp(lambda h_, a_: fn(h_, a_, capacity), h, a)
            return (out,) + vjp(cot)
        return jax.jit(f, static_argnums=3)

    return {"parallel": value_and_grads(jax_cif.cif_parallel),
            "scan": value_and_grads(jax_cif.cif_scan)}


@pytest.mark.parametrize("case", ["plain", "backlog", "overflow"])
@pytest.mark.parametrize("form", ["parallel", "scan"])
def test_cif_forms_match_jax_with_gradients(jax_cif_fns, case, form):
    hidden, alphas, capacity = cif_case(case)
    cot = np.random.RandomState(8).randn(hidden.shape[0], capacity,
                                         hidden.shape[2]).astype(np.float32)
    want, dh_want, da_want = jax_cif_fns[form](hidden, alphas, cot, capacity)
    h, a = _t(hidden).requires_grad_(), _t(alphas).requires_grad_()
    fn = port_cif.cif_parallel if form == "parallel" else port_cif.cif_scan
    got = fn(h, a, capacity)
    (got * _t(cot)).sum().backward()
    assert got.shape == (3, capacity, 5) and got.dtype == torch.float32
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= OP_TOL
    assert np.abs(h.grad.numpy() - np.asarray(dh_want)).max() <= OP_GRAD_TOL
    assert np.abs(a.grad.numpy() - np.asarray(da_want)).max() <= OP_GRAD_TOL
    # the closed form and the scan agree in the port too
    other = port_cif.cif_scan if form == "parallel" else port_cif.cif_parallel
    assert np.abs(other(_t(hidden), _t(alphas), capacity).numpy()
                  - got.detach().numpy()).max() <= OP_TOL


def test_cif_product_is_f32_under_bf16_autocast():
    hidden, alphas, capacity = cif_case("plain")
    want = port_cif.cif(_t(hidden), _t(alphas), capacity)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = port_cif.cif(_t(hidden).bfloat16(), _t(alphas), capacity)
    assert got.dtype == torch.float32
    # the only rounding is the hidden frames' own, to bf16 on the way in
    ref = port_cif.cif(_t(hidden).bfloat16().float(), _t(alphas), capacity)
    assert torch.equal(got, ref)
    assert np.abs(got.numpy() - want.numpy()).max() <= 2e-2


def test_scale_alphas_with_one_draw_and_output_lengths():
    rng = np.random.RandomState(3)
    alphas = rng.uniform(0.0, 1.0, size=(4, 9)).astype(np.float32)
    tlen = np.array([3, 5, 1, 7], np.int32)
    key = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key, (4,)))
    want, want_raw = jax.jit(jax_cif.scale_alphas)(alphas, tlen, key)
    got, got_raw = port_cif.scale_alphas(_t(alphas), _t(tlen), noise=_t(u))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= OP_TOL
    assert np.abs(got_raw.numpy() - np.asarray(want_raw)).max() <= OP_TOL
    plain, _ = port_cif.scale_alphas(_t(alphas), _t(tlen))
    want_plain, _ = jax_cif.scale_alphas(alphas, tlen)
    assert np.abs(plain.numpy() - np.asarray(want_plain)).max() <= OP_TOL
    # a generator draws the same u as the explicit tensor from its stream
    gen = torch.Generator().manual_seed(9)
    drawn, _ = port_cif.scale_alphas(_t(alphas), _t(tlen), generator=gen)
    u9 = torch.rand(4, generator=torch.Generator().manual_seed(9))
    again, _ = port_cif.scale_alphas(_t(alphas), _t(tlen), noise=u9)
    assert torch.equal(drawn, again)
    sums = np.array([[0.2, 0.25], [0.5, 1.0], [1.0, 1.5], [0.3, 0.1]], np.float32)
    assert (port_cif.cif_output_lengths(_t(sums)).numpy()
            == np.asarray(jax_cif.cif_output_lengths(sums))).all()


@pytest.mark.parametrize("labels,n", [
    ([10, 7, 2, 2], 2), ([7, 10, 5, 2], 3), ([10, 10, 2, 2], 2), ([7, 5, 10, 2], 3),
    ([10, 2, 2, 2], 1), ([7, 5, 3, 2], 3),
])
def test_ctc_gradient_where_a_target_is_the_blank_id(labels, n):
    """Without a blank of its own (add_blk: false, as in the CIF configs)
    the vocabulary's last unit is both a target and CTC's blank; where it
    ends the targets, both end states emit it on the last frame."""
    from openasr_tpu.ops.ctc import cal_ctc_loss as jax_ctc
    from openasr_torch.ops.losses import cal_ctc_loss

    rng = np.random.RandomState(len(labels) * 10 + n)
    logits = rng.randn(2, 9, VOCAB).astype(np.float32)
    targets = np.array([labels, labels], np.int32)
    llen, tlen = np.array([9, 7], np.int32), np.array([n, n], np.int32)
    want, want_grad = jax.jit(jax.value_and_grad(jax_ctc))(logits, llen, targets, tlen)
    x = _t(logits).requires_grad_()
    got = cal_ctc_loss(x, _t(llen), _t(targets), _t(tlen))
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert np.abs(x.grad.numpy() - np.asarray(want_grad)).max() <= OP_GRAD_TOL


def test_ctc_last_blank_rewrite_against_the_smoke_tests_plain_versions():
    """Where no target ends in the blank id the rewrite is the identity:
    the gradient equals F.ctc_loss's without it bit for bit
    (`parent_ctc_loss`), rows of one frame included; where some do, it
    equals the plain rewrite over the whole tensor
    (`plain_last_blank_grad`), which the smoke test holds it to on the
    card."""
    import chip_smoke
    from openasr_torch.ops.losses import cal_ctc_loss

    rng = np.random.RandomState(5)
    x = _t(rng.randn(4, 12, VOCAB).astype(np.float32)).requires_grad_()
    llen, tlen = _t(np.array([12, 9, 1, 6])), _t(np.array([4, 3, 1, 2]))
    targets = _t(rng.randint(0, VOCAB - 1, (4, 4)))
    got = torch.autograd.grad(cal_ctc_loss(x, llen, targets, tlen), x)[0]
    want = torch.autograd.grad(chip_smoke.parent_ctc_loss(x, llen, targets, tlen), x)[0]
    assert torch.equal(got, want)
    targets[[0, 2], [3, 0]] = VOCAB - 1
    got = torch.autograd.grad(cal_ctc_loss(x, llen, targets, tlen), x)[0]
    want = chip_smoke.plain_last_blank_grad(x, llen, targets, tlen)
    assert (got - want).abs().max() <= 1e-6
    assert not torch.equal(got, torch.autograd.grad(
        chip_smoke.parent_ctc_loss(x, llen, targets, tlen), x)[0])


def test_relu_replay_reports_flips_relative_to_the_call():
    """The smoke test's ReLU replay: a sign that differs from the
    recorded input's counts as a flip, with the larger |x| at the flips
    over the call's largest |x| beside the call's largest difference."""
    import chip_smoke

    relus = chip_smoke.ReluMasks()
    card = torch.tensor([[2.0, -1.0, 1e-7, -4.0], [0.5, 3.0, -2e-7, 1.0]])
    relus.relu(card)
    relus.replay, relus.calls = True, 0
    cpu = card.clone()
    cpu[0, 2], cpu[1, 2] = -1e-7, 1e-7
    out = relus.relu(cpu)
    assert torch.equal(out, torch.where(card > 0, cpu, torch.zeros_like(cpu)))
    assert relus.flips == 2
    assert relus.flipped == [{"call": 0, "flips": 2, "flip_abs_rel": pytest.approx(2e-7 / 4.0),
                              "diff_rel": pytest.approx(3e-7 / 4.0)}]


# ------------------------------------------------------------ modules

def encoded_inputs(seed=1, b=3, t=13, d=32):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, d).astype(np.float32),
            np.array([13, 9, 4], np.int32)[:b])


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_assigner_matches_jax(kind):
    from openasr_tpu.models.assigner import AttentionAssigner as JaxAssigner

    cfg = cif_config("CIF", kind)
    port = get_model_class("CIF").create_model(cfg, device="cpu")
    params = port.package()["components"]["assigner"]
    x, lens = encoded_inputs()
    module = JaxAssigner.from_config(cfg["assigner"])
    want = jax.jit(lambda p, x_, l_: module.apply({"params": p}, x_, l_))(params, x, lens)
    with torch.no_grad():
        got = port.module.assigner(_t(x), _t(lens))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - np.asarray(want)).max() <= OP_TOL
    assert (got.numpy()[2, 4:] == 0).all()


def test_cif_decoder_forward_and_step_match_jax():
    from openasr_tpu.models.decoder import cif_decoder_from_config

    cfg = cif_config("CIF")
    port = get_model_class("CIF").create_model(cfg, device="cpu")
    params = port.package()["components"]["decoder"]
    enc, _ = encoded_inputs(seed=2, t=8)
    rng = np.random.RandomState(4)
    ids = rng.randint(0, VOCAB, size=(3, 8)).astype(np.int32)
    lens = np.array([8, 5, 2], np.int32)
    module = cif_decoder_from_config(cfg["decoder"])

    @jax.jit
    def reference(p, e, i, n):
        full = module.apply({"params": p}, e, i, n)
        step = module.apply({"params": p}, e, n, i, 4, method=type(module).step)
        return full, step

    full, step = reference(params, enc, ids, lens)
    dec = port.module.decoder
    with torch.no_grad():
        got = dec(_t(enc), _t(ids), _t(lens))
        got_step = dec.step(_t(enc), _t(lens), _t(ids), 4)
    # positions past a row's length attend nothing valid past it: compare all
    assert np.abs(got.numpy() - np.asarray(full)).max() <= OP_TOL
    assert np.abs(got_step.numpy() - np.asarray(step)).max() <= OP_TOL
    assert torch.equal(got_step, got[:, 3])


def test_fc_decoder_and_the_square_loss_match_jax():
    from openasr_tpu.models.decoder import FCDecoder as JaxFC
    from openasr_tpu.ops.losses import cal_ce_square_loss as jax_square
    from openasr_torch.models.decoder import FCDecoder
    from openasr_torch.ops.losses import cal_ce_square_loss

    fc = FCDecoder(VOCAB, 32)
    x, _ = encoded_inputs(seed=3)
    params = {"output_affine": {"kernel": fc.output_affine.weight.detach().numpy().T,
                                "bias": fc.output_affine.bias.detach().numpy()}}
    want = jax.jit(lambda p, x_: JaxFC(VOCAB, 32).apply({"params": p}, x_))(params, x)
    with torch.no_grad():
        assert np.abs(fc(_t(x)).numpy() - np.asarray(want)).max() <= OP_TOL
    rng = np.random.RandomState(2)
    a, b = (rng.rand(2, 5, 5).astype(np.float32) for _ in range(2))
    assert abs(float(cal_ce_square_loss(_t(a), _t(b))) - float(jax_square(a, b))) <= 1e-5


# ------------------------------------------------------------- models

def make_batch(model_type, seed=0, lengths=(41, 30, 19), paired=True):
    rng = np.random.RandomState(seed)
    b = len(lengths)
    feats = np.zeros((b, max(lengths), 20), np.float32)
    for i, n in enumerate(lengths):
        feats[i, :n] = rng.randn(n, 20)
    batch = {"feats": feats, "feat_lengths": np.asarray(lengths, np.int32)}
    if model_type in ("CIF_FC", "CIF_MIX"):
        plen = np.array([5, 3, 4], np.int32)[:b]
        phones = np.full((b, 8), 2, np.int32)   # padded with <eos>
        for i, n in enumerate(plen):
            phones[i, :n] = rng.randint(3, PHONES - 1, size=n)
        batch.update(phones=phones, phone_lengths=plen)
        if not (model_type == "CIF_MIX" and paired):
            return batch
    toks = [list(rng.randint(3, VOCAB, size=n)) for n in (5, 3, 2)[:b]]
    ids, labels, paddings = gen_causal_targets(toks, add_eos=False, max_len=8)
    batch.update(ids=ids, labels=labels, paddings=paddings)
    return batch


def mix(losses, model_type):
    total = losses["ce_loss"] / losses["n_tokens"] + LAMBDA_QUA * losses["qua_loss"] / losses["n_seqs"]
    if model_type != "CIF":
        total = total + LAMBDA_CTC * losses["ctc_loss"] / losses["n_seqs"]
    if "ce_char_loss" in losses:
        total = total + losses["ce_char_loss"] / losses["n_char_tokens"]
    return total


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(model_type):
        if model_type not in cache:
            cache[model_type] = build_pair(model_type)
        return cache[model_type]

    return get


@pytest.mark.parametrize("model_type,paired", [
    ("CIF", True), ("ctc_cif", True), ("CIF_FC", True), ("CIF_MIX", True),
    ("CIF_MIX", False),
])
def test_losses_and_gradients_match_jax(pairs, model_type, paired):
    jax_model, port = pairs(model_type)
    batch = make_batch(model_type, paired=paired)

    @jax.jit
    def reference(params, b):
        def f(p):
            losses = jax_model.loss(p, b, {}, train=False, label_smooth=0.1)
            return mix(losses, model_type), losses
        return jax.value_and_grad(f, has_aux=True)(params)

    (total, losses), grads = reference(jax_model.params, batch)
    for p in port.module.parameters():
        p.grad = None
    got = port.loss({k: _t(v) for k, v in batch.items()}, None, label_smooth=0.1)
    assert set(got) == set(losses)
    for k, v in losses.items():
        assert abs(float(got[k]) - float(v)) <= LOSS_RTOL * max(abs(float(v)), 1.0), k
    got_total = mix(got, model_type)
    assert abs(float(got_total) - float(total)) <= LOSS_RTOL * abs(float(total))
    got_total.backward()
    got_grads = state_dict_to_jax_components(
        port.model_type,
        {n: (p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in port.module.named_parameters()},
        port.configs)
    flat_want = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got_grads)[0])
    assert set(flat_got) == set(flat_want)
    top = max(float(np.abs(np.asarray(v)).max()) for v in flat_want.values())
    for path, want in flat_want.items():
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 0.1 * top)
        err = float(np.abs(np.asarray(flat_got[path]) - want).max())
        assert err <= GRAD_RTOL * scale, (jax.tree_util.keystr(path), err, scale)


def test_cif_mix_acoustic_batch_has_no_char_loss(pairs):
    _, port = pairs("CIF_MIX")
    batch = make_batch("CIF_MIX", paired=False)
    losses = port.loss({k: _t(v) for k, v in batch.items()}, None)
    assert "ce_char_loss" not in losses and "n_char_tokens" not in losses


# ------------------------------------------------------------- decode

@pytest.fixture(scope="module")
def decode_pair():
    jax_model, port = build_pair("CIF", seed=3)
    rng = np.random.RandomState(5)
    x = rng.randn(3, 61, 20).astype(np.float32)
    lens = np.array([61, 47, 33], np.int32)
    return jax_model, port, x, lens


def jax_decode(model, x, lens, beam, maxlen, tables=None, weight=0.0):
    fn = jax.jit(lambda p, x_, l_: model.batch_beam_decode(
        p, x_, l_, beam_size=beam, max_decode_len=maxlen, context_tables=tables,
        context_weight=weight))
    return [np.asarray(a) for a in fn(model.params, x, lens)]


@pytest.mark.parametrize("hotwords", [False, True])
def test_batch_beam_decode_matches_jax(decode_pair, hotwords):
    jax_model, port, x, lens = decode_pair
    tables, weight = None, 0.0
    if hotwords:
        tables = build_context_tables(np.array([[3, 4, -1], [5, 5, 6]], np.int32), VOCAB)
        weight = 1.5
    preds, plens, scores = jax_decode(jax_model, x, lens, 3, 6, tables, weight)
    got = port.batch_beam_decode(_t(x), _t(lens), beam_size=3, max_decode_len=6,
                                 context_tables=tables, context_weight=weight)
    g_preds, g_lens, g_scores = (a.numpy() for a in got)
    assert g_preds.shape == preds.shape == (3, 3, 6)
    assert (g_lens == plens).all()
    assert (g_preds == preds).all()
    assert np.abs(g_scores - scores).max() <= SCORE_TOL


def test_cif_fc_greedy_phone_decode_matches_jax(pairs):
    jax_model, port = pairs("CIF_FC")
    batch = make_batch("CIF_FC")
    x, lens = batch["feats"], batch["feat_lengths"]
    ids, n = (np.asarray(a) for a in jax.jit(
        lambda p, x_, l_: jax_model.greedy_phone_decode(p, x_, l_, max_decode_len=6))(
            jax_model.params, x, lens))
    got_ids, got_n = port.greedy_phone_decode(_t(x), _t(lens), max_decode_len=6)
    assert (got_n.numpy() == n).all() and (got_ids.numpy() == ids).all()


def test_a_zero_cif_length_in_a_decode_batch():
    """The assigner's bias set low: the short utterance's weights sum
    below 0.5, so its CIF length is 0 and the CIF decoder's attention sees
    a row with no valid key (the JAX dense path's value)."""
    cfg = cif_config("CIF")
    port = get_model_class("CIF").create_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        port.module.assigner.linear.bias.fill_(-3.0)
    jax_model = jax_twin(port, cfg)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 81, 20).astype(np.float32)
    lens = np.array([81, 11], np.int32)
    preds, plens, scores = jax_decode(jax_model, x, lens, 2, 5)
    _, cif_lens = port.get_encoded(_t(x), _t(lens), 5)
    assert int(cif_lens[1]) == 0 and int(cif_lens[0]) > 0
    got = port.batch_beam_decode(_t(x), _t(lens), beam_size=2, max_decode_len=5)
    g_preds, g_lens, g_scores = (a.numpy() for a in got)
    assert (g_lens == plens).all() and (g_lens[1] == 0).all()
    assert (g_preds == preds).all()
    assert np.abs(g_scores - scores).max() <= SCORE_TOL
