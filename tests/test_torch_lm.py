"""The port's LMs against the JAX package, on the CPU.

Both packages get the same inputs, made from a seed with numpy, and the
same weights: the port draws them and the JAX model takes the port's
package (flax's eager init is skipped).  Every JAX reference is jitted
once per module.

- data: `CountBatchSampler` forms the JAX sampler's batches epoch for
  epoch; `TextCollate` gives its ids, labels and paddings.
- packages: the JAX package's LM package of each type loads into the port
  and the port writes it back bit for bit.
- models, both types: the logits (1e-5), the label-smoothed loss (1e-5
  relative) and its gradients (1e-4 of the larger of a parameter's own
  largest and a tenth of the model's largest).
- the cached step: against the JAX step and the port's own batch forward
  (1e-5), with rows at divergent positions against a replay of each row
  alone, at the cache's last slot, and the refusal past 5000 positions.
- `encoder layer chunk_step` against the JAX layer's (1e-5).
- the train CLI: the port's `train_lm --continue-training` on a package
  that the JAX `train_lm` wrote reads the same dev perplexity as the JAX
  CLI's own later epochs (1e-3 relative); the JAX CLI runs in a
  subprocess with one CPU device.
"""

import json
import os
import shutil
import subprocess
import sys

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from openasr_tpu.models import get_model_class as jax_model_class
from openasr_torch.convert import state_dict_to_jax_components
from openasr_torch.models import get_model_class

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
GRAD_RTOL = 1e-4
PPL_RTOL = 1e-3
VOCAB = 14
CONFIGS = {
    "transformer_lm": {"type": "transformer_lm", "vocab_size": VOCAB, "d_model": 32,
                       "nhead": 2, "num_layers": 2, "dim_feedforward": 48,
                       "dropout_rate": 0.1},
    "lstm_lm": {"type": "lstm_lm", "vocab_size": VOCAB, "d_model": 24, "n_layers": 2,
                "dropout_rate": 0.1},
}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def jax_twin(port, cfg):
    params = jax.tree_util.tree_map(jnp.asarray, port.package()["components"])
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn.Module, "init", lambda self, *a, **k: {"params": params})
        return jax_model_class(cfg["type"]).create_model(cfg)


@pytest.fixture(scope="module")
def pairs():
    """model type -> (JAX model, port model, jitted JAX references)."""
    out = {}
    for model_type, cfg in CONFIGS.items():
        port = get_model_class(model_type).create_model(
            cfg, device="cpu", generator=torch.Generator().manual_seed(3))
        jm = jax_twin(port, cfg)
        mod = jm.module

        def loss(p, batch, jm=jm):
            losses = jm.loss(p, batch, {}, train=False, label_smooth=0.1)
            return losses["ce_loss"], losses

        refs = {
            "logits": jax.jit(lambda p, ids, mod=mod: mod.apply({"params": p}, ids)),
            "loss": jax.jit(jax.value_and_grad(loss, has_aux=True)),
            "step": jax.jit(lambda p, tok, cache, mod=mod: mod.apply(
                {"params": p}, tok, cache, method=type(mod).step)),
        }
        out[model_type] = (jm, port, refs)
    return out


def text_batch(seed, b=3, t=7):
    from openasr_torch.data.collate import gen_causal_targets

    rng = np.random.RandomState(seed)
    lines = [list(rng.randint(3, VOCAB, size=rng.randint(2, t))) for _ in range(b)]
    ids, labels, paddings = gen_causal_targets(lines, True, max_len=t)
    return {"ids": ids, "labels": labels, "paddings": paddings}


# ------------------------------------------------------------------- data

def test_count_sampler_and_text_collate_match_jax(tmp_path):
    from openasr_tpu.data.collate import TextCollate as JaxTextCollate
    from openasr_tpu.data.sampler import CountBatchSampler as JaxCountBatchSampler
    from openasr_tpu.data.tokenizer import CharTokenizer as JaxCharTokenizer
    from openasr_torch.data.collate import TextCollate
    from openasr_torch.data.manifest import TextLineByLineDataset
    from openasr_torch.data.sampler import CountBatchSampler
    from openasr_torch.data.tokenizer import CharTokenizer

    for shuffle, drop_last in ((True, True), (False, False)):
        got, want = (cls(23, 5, shuffle=shuffle, seed=4, drop_last=drop_last)
                     for cls in (CountBatchSampler, JaxCountBatchSampler))
        assert len(got) == len(want)
        for _ in range(3):
            assert [list(map(int, b)) for b in got] == [list(map(int, b)) for b in want]
    vocab = tmp_path / "chars.txt"
    vocab.write_text("".join(f"c{i}\n" for i in range(6)))
    text = tmp_path / "text.txt"
    text.write_text("c1 c2 c3\nc0 c5\nc4 c4 c4 c4 c4 c4 c4 c4 c9 c2\n")
    lines = TextLineByLineDataset(str(text))
    assert len(lines) == 3 and lines[1] == "c0 c5"
    got = TextCollate(CharTokenizer(str(vocab)), maxlen=6)(list(lines.data))
    want = JaxTextCollate(JaxCharTokenizer(str(vocab)), maxlen=6)(list(lines.data))
    assert set(got) == set(want) == {"ids", "labels", "paddings"}
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


# --------------------------------------------------------------- packages

@pytest.mark.parametrize("model_type", sorted(CONFIGS))
def test_jax_package_round_trips_bit_for_bit(pairs, model_type):
    jm = pairs[model_type][0]
    pkg = jax.tree_util.tree_map(np.asarray, jm.package())
    port = get_model_class(model_type).create_model(CONFIGS[model_type], device="cpu")
    port.restore(pkg)
    back = port.package()
    assert back["model_type"] == pkg["model_type"] == model_type
    assert back["configs"] == pkg["configs"]
    want = jax.tree_util.tree_leaves_with_path(pkg["components"])
    got = jax.tree_util.tree_leaves_with_path(back["components"])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), path


# ----------------------------------------------------------------- models

@pytest.mark.parametrize("model_type", sorted(CONFIGS))
def test_logits_loss_and_gradients_match_jax(pairs, model_type):
    jm, port, refs = pairs[model_type]
    batch = text_batch(11)
    want_logits = np.asarray(refs["logits"](jm.params, batch["ids"]))
    with torch.no_grad():
        got_logits = port.module(_t(batch["ids"])).numpy()
    assert np.abs(got_logits - want_logits).max() <= TOL

    (want_ce, want_losses), want_grads = refs["loss"](jm.params, batch)
    port.module.zero_grad()
    losses = port.loss({k: _t(v) for k, v in batch.items()}, None, label_smooth=0.1)
    losses["ce_loss"].backward()
    assert abs(float(losses["ce_loss"].detach()) - float(want_ce)) <= TOL * abs(float(want_ce))
    assert float(losses["n_tokens"]) == float(want_losses["n_tokens"])
    assert float(losses["n_seqs"]) == float(want_losses["n_seqs"])
    grads = state_dict_to_jax_components(
        model_type, {n: p.grad for n, p in port.module.named_parameters()}, port.configs)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want_grads))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert flat_got.keys() == flat_want.keys()
    # the attention k-biases' true gradient is 0: their scale is a tenth of
    # the model's largest gradient
    top = max(float(np.abs(np.asarray(w)).max()) for w in flat_want.values())
    for path, w in flat_want.items():
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 0.1 * top)
        assert np.abs(flat_got[path] - w).max() <= GRAD_RTOL * scale, path


def jax_cache(model_type, jm, b, max_len):
    mod = jm.module
    if model_type == "transformer_lm":
        return mod.apply({"params": jm.params}, b, max_len, method=type(mod).init_step_cache)
    return mod.apply({"params": jm.params}, b, method=type(mod).init_carries)


@pytest.mark.parametrize("model_type", sorted(CONFIGS))
def test_step_matches_jax_step_and_the_batch_forward(pairs, model_type):
    from openasr_torch.models.lm import make_lm_fusion

    jm, port, refs = pairs[model_type]
    batch = text_batch(12, b=3, t=7)
    ids = batch["ids"]
    b, t = ids.shape
    step, cache = make_lm_fusion(port, b, max_len=t)
    jcache = jax_cache(model_type, jm, b, t)
    got, want = [], []
    with torch.inference_mode():
        for j in range(t):
            lp, cache = step(_t(ids[:, j]), cache)
            got.append(lp.numpy())
            jlp, jcache = refs["step"](jm.params, ids[:, j], jcache)
            want.append(np.asarray(jlp))
        batch_lp = torch.log_softmax(port.module(_t(ids)), dim=-1).numpy()
        # a row at the cache's last position attends to its token and keeps nothing
        lp, _ = step(_t(ids[:, 0]), cache)
        jlp, _ = refs["step"](jm.params, ids[:, 0], jcache)
    got, want = np.stack(got, 1), np.stack(want, 1)
    assert np.abs(got - want).max() <= TOL
    assert np.abs(got - batch_lp).max() <= TOL
    assert np.abs(lp.numpy() - np.asarray(jlp)).max() <= TOL


def test_transformer_step_with_divergent_row_positions(pairs):
    """Rows at different positions in one call (a stay in the CTC beam
    keeps its parent's position): each row equals a replay of its own
    prefix alone, and the JAX step on the same divergent cache."""
    from openasr_torch.models.lm import make_lm_fusion

    jm, port, refs = pairs["transformer_lm"]
    prefixes = [(3, 5, 2), (7,), (1, 2, 3, 4), ()]
    nxt = np.array([4, 9, 6, 2], np.int32)
    b, max_len = len(prefixes), 8

    def replay(prefix, tok):
        step, cache = make_lm_fusion(port, 1, max_len)
        for c in prefix + (int(tok),):
            lp, cache = step(torch.tensor([c]), cache)
        return lp[0].numpy()

    step, cache = make_lm_fusion(port, b, max_len)
    jcache = jax_cache("transformer_lm", jm, b, max_len)
    with torch.inference_mode():
        # feed every row one token a step, then take each row's cache and
        # position as they were after its own prefix
        snaps, jsnaps = {}, {}
        for t in range(max(len(p) for p in prefixes) + 1):
            for i, p in enumerate(prefixes):
                if len(p) == t:
                    snaps[i] = {"idx": cache["idx"][i].clone(),
                                "layers": [{k: v[i].clone() for k, v in lc.items()}
                                           for lc in cache["layers"]]}
                    jsnaps[i] = jax.tree_util.tree_map(lambda x: np.asarray(x[i]), jcache)
            toks = np.array([p[t] if t < len(p) else 0 for p in prefixes], np.int32)
            _, cache = step(_t(toks).long(), cache)
            _, jcache = refs["step"](jm.params, toks, jcache)
        mixed = {"idx": torch.stack([snaps[i]["idx"] for i in range(b)]),
                 "layers": [{k: torch.stack([snaps[i]["layers"][n][k] for i in range(b)])
                             for k in ("k", "v")} for n in range(len(cache["layers"]))]}
        jmixed = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *[jsnaps[i] for i in range(b)])
        assert mixed["idx"].tolist() == [len(p) for p in prefixes]
        got, _ = step(_t(nxt).long(), mixed)
        want = np.asarray(refs["step"](jm.params, nxt, jmixed)[0])
        for i, p in enumerate(prefixes):
            solo = replay(p, nxt[i])
            assert np.abs(got[i].numpy() - solo).max() <= TOL
            assert np.abs(got[i].numpy() - want[i]).max() <= TOL


def test_step_cache_refuses_more_than_5000_positions(pairs):
    _, port, _ = pairs["transformer_lm"]
    port.module.init_step_cache(1, 5000)
    with pytest.raises(ValueError, match="5000-row positional-encoding table"):
        port.module.init_step_cache(1, 5001)


def test_encoder_layer_chunk_step_matches_jax():
    from openasr_tpu.models.layers import TransformerEncoderLayer as JaxLayer
    from openasr_torch.models import init_parameters
    from openasr_torch.models.layers import TransformerEncoderLayer

    rng = np.random.RandomState(5)
    d, h, ch, cached = 16, 2, 3, 4
    jl = JaxLayer(d, h, 24, 0.0, "relu")
    x = rng.randn(2, ch, d).astype(np.float32)
    ck, cv = (rng.randn(2, cached, h, d // h).astype(np.float32) for _ in range(2))
    bias = np.where(rng.rand(2, 1, 1, cached + ch) < 0.3, -1e9, 0.0).astype(np.float32)
    bias[..., -ch:] = 0.0
    layer = TransformerEncoderLayer(d, h, 24, "relu", 0.0)
    init_parameters(layer, torch.Generator().manual_seed(4))
    params = state_dict_to_jax_components(
        "transformer_lm", {f"layer0.{k}": v for k, v in layer.state_dict().items()},
        {"vocab_size": 4, "d_model": d, "nhead": h, "num_layers": 1})["layer0"]
    want = jax.jit(lambda p, *a: jl.apply({"params": p}, *a, method=JaxLayer.chunk_step))(
        params, x, ck, cv, bias)
    with torch.no_grad():
        got = layer.chunk_step(_t(x), _t(ck), _t(cv), _t(bias))
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= TOL


# -------------------------------------------------------------------- CLI

JAX_RUN = "import sys; from openasr_tpu.bin import train_lm; train_lm.main(sys.argv[1:])"
EPOCHS = 3


def lm_corpus(tmp, rng):
    chars = [f"w{i}" for i in range(8)]
    (tmp / "chars.txt").write_text("".join(c + "\n" for c in chars))
    for name, n in (("train", 40), ("dev", 10)):
        lines = [" ".join(rng.choice(chars, size=rng.randint(3, 12))) for _ in range(n)]
        (tmp / f"{name}.txt").write_text("\n".join(lines) + "\n")


def lm_config(tmp, exp):
    cfg = {
        "data": {"trainset": str(tmp / "train.txt"), "devset": str(tmp / "dev.txt"),
                 "vocab_path": str(tmp / "chars.txt"), "fetchworker_num": 0},
        "model": {"type": "transformer_lm", "d_model": 16, "nhead": 2, "num_layers": 1,
                  "dim_feedforward": 32, "dropout_rate": 0.0},
        # one batch of every line an epoch: a run and a continuation in a new
        # process (whose sampler restarts its draws) sum the same lines
        "training": {"exp_dir": str(exp), "batch_size": 40, "num_epoch": EPOCHS,
                     "print_inteval": 1, "init_lr": 0.002, "optimtype": "adam",
                     "grad_max_norm": 5.0, "label_smooth": 0.1,
                     "lr_scheduler": {"type": "warmup_transformer", "warmup_step": 4,
                                      "d_model": 16}},
    }
    path = tmp / f"{exp.name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def cv_losses(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r["cv_loss"] for r in rows if r["phase"] == "epoch"]


def test_port_continues_a_jax_train_lm_package(tmp_path):
    """The JAX CLI trains 3 epochs; the port continues its epoch-1 package
    (weights, Adam moments, step) to epoch 3 and reads the same dev
    perplexity."""
    from openasr_torch.bin import train_lm

    lm_corpus(tmp_path, np.random.RandomState(8))
    jax_exp, port_exp = tmp_path / "jax", tmp_path / "port"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    run = subprocess.run([sys.executable, "-c", JAX_RUN, lm_config(tmp_path, jax_exp)],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-3000:]
    os.makedirs(port_exp)
    shutil.copy(jax_exp / "ep-0001.pkg", port_exp / "last.pkg")
    train_lm.main([lm_config(tmp_path, port_exp), "--continue-training", "--device", "cpu"])
    want, got = cv_losses(jax_exp), cv_losses(port_exp)
    assert len(want) == EPOCHS and len(got) == EPOCHS - 1
    ppl_want, ppl_got = np.exp(want[-1]), np.exp(got[-1])
    assert abs(ppl_got - ppl_want) <= PPL_RTOL * ppl_want, (ppl_got, ppl_want)
    assert want[-1] < want[0]
