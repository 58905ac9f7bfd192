"""GRU-CTC's f32 step-1 gradient against float64, the port's and the JAX
package's, on the CPU (ROADMAP queue 3 item 39).

libri's gru_ctc (egs/libri/configs/gru_ctc_finetune.yaml: the WavConv
splayer, a 2-layer GRU, the fc head and CTC) at width 64 and vocabulary
4233, its weights from a seed carried across with `openasr_torch.convert`,
on item 26's batch (`tests/test_torch_wavconv_precision.py`: the two
shortest utterances of chip_smoke.py's wav2vec corpus, cut to 1 s) and on
four longer ones of that corpus, with seeded targets: one training
forward (the batch's statistics, dropout 0) and the gradient of the CTC
loss over the sequences, in four ways: each package in f32 and in
float64 (jax.enable_x64 as a context).

Both packages compute their CTC in f32 whatever the logits' dtype is (the
JAX package's `ops/ctc.py` casts to f32; the port's `cal_ctc_loss` did
until it kept float64): the JAX float64 run here lifts its CTC's f32
casts to float64 (a stand-in for `jnp` in `openasr_tpu.ops.ctc`) and
starts its GRU from a float64 zero carry (flax's is the cell's f32
param_dtype), so that both float64 gradients are float64 throughout.

Per leaf, of max(the leaf's largest |g|, a tenth of the largest of any
leaf) (chip_smoke.py's `floor_grad_errs`): the two float64 gradients
within F64_TOL of each other, and the port's f32 distance from its
float64 no more than F32_RATIO times the JAX package's f32 distance from
its own, plus F64_TOL.  The figures are printed (pytest -s).
"""

import types

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openasr_tpu.ops.ctc as jax_ctc
from openasr_torch.convert import subtree_to_state_dict
from openasr_torch.models import get_model_class
from openasr_torch.models.layers import TrainRNG
from openasr_tpu.models import get_model_class as jax_model_class

WIDTH = 64
VOCAB = 4233
F64_TOL = 1e-6
F32_RATIO = 2.0
CFG = {
    "type": "gru_ctc", "add_blk": True,
    "signal": {"feature_type": "wave", "d_model": WIDTH},
    "encoder": {"d_input": WIDTH, "d_model": WIDTH, "n_layers": 2, "dropout": 0.0},
    "decoder": {"vocab_size": VOCAB},
}
MODULES = ("splayer.conv", "splayer.bn", "encoder.gru", "fc")


# item 26's batch, and four longer utterances of the same corpus, uncut
# (122201-147063 samples, T' up to 920): the CTC's f32 error grows with
# the frames and the loss
BATCHES = {"1 s": (slice(0, 2), 16000, (12, 9)), "long": (slice(8, 12), None, (20, 15, 12, 10))}


@pytest.fixture(scope="module", params=sorted(BATCHES))
def item39_batch(request, tmp_path_factory):
    """Utterances of chip_smoke.py's wav2vec corpus (item 26's fixture:
    its rng and lengths), padded as the collate pads them, with seeded
    targets below the blank; no wav file is written."""
    import chip_smoke
    from openasr_torch.data import audio

    rows, cut, n_tokens = BATCHES[request.param]
    with pytest.MonkeyPatch.context() as m:
        m.setattr(chip_smoke, "WORK", str(tmp_path_factory.mktemp("item39")))
        m.setattr(audio, "write_wav", lambda *a, **k: None)
        rng = np.random.RandomState(chip_smoke.SEED + 20)
        lengths = np.concatenate([rng.randint(400000, 480001, 3),
                                  rng.randint(120000, 300001, 34), rng.randint(4000, 60001, 8)])
        _, waves = chip_smoke.write_wave_corpus("w2vtrain", rng, ["a", "b"], len(lengths), None,
                                                (5, 20), lengths=lengths)
        utts = sorted(waves, key=lambda u: waves[u].shape[0])[rows]
        return chip_smoke.wave_batch({u: waves[u][:cut] for u in utts}, utts,
                                     np.random.RandomState(chip_smoke.SEED + 21), n_tokens, VOCAB)


def jax_ctc_in(dtype):
    """`openasr_tpu.ops.ctc`'s `jnp` with float32 read as `dtype`: its
    casts and accumulations to f32 then keep float64."""
    names = {k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")}
    return types.SimpleNamespace(**{**names, "float32": dtype})


def floor_errs(got: dict, want: dict) -> dict:
    floor = 0.1 * max(float(np.abs(v).max()) for v in want.values())
    return {k: float(np.abs(got[k] - v).max()) / max(float(np.abs(v).max()), floor)
            for k, v in want.items()}


@pytest.fixture(scope="module")
def gradients(item39_batch):
    """{"port f32", "port f64", "jax f32", "jax f64"}: each run's gradient,
    as float64 NumPy leaves keyed by the port's parameter names."""
    port = get_model_class("gru_ctc").create_model(
        CFG, device="cpu", generator=torch.Generator().manual_seed(39))
    pkg = port.package()
    names = [n for n, _ in port.module.named_parameters()]
    out = {}
    for dtype in (torch.float32, torch.float64):
        m = get_model_class("gru_ctc").create_model(CFG, device="cpu")
        m.restore(pkg)
        m.module.to(dtype)
        tb = {k: torch.from_numpy(v) for k, v in item39_batch.items()}
        tb["waves"] = tb["waves"].to(dtype)
        losses = m.loss(tb, TrainRNG(0, "cpu"))
        assert losses["ctc_loss"].dtype == dtype
        (losses["ctc_loss"] / losses["n_seqs"]).backward()
        out[f"port {'f32' if dtype == torch.float32 else 'f64'}"] = {
            n: p.grad.double().numpy() for n, p in m.module.named_parameters()}

    def jax_grads(dtype):
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), dtype), t)
        variables = {"params": cast(pkg["components"]), "batch_stats": cast(pkg["batch_stats"])}
        with pytest.MonkeyPatch.context() as m:
            m.setattr(flax_nn.Module, "init", lambda self, *a, **k: variables)
            model = jax_model_class("gru_ctc").create_model(CFG, dtype=dtype)
            if dtype == jnp.float64:
                m.setattr(jax_ctc, "jnp", jax_ctc_in(jnp.float64))
                # flax's zero carry takes the cell's param_dtype (f32)
                m.setattr(flax_nn.GRUCell, "initialize_carry", lambda self, rng, shape: jnp.zeros(
                    shape[:-1] + (self.features,), self.dtype))
            batch = {k: (jnp.asarray(v, dtype) if k == "waves" else jnp.asarray(v))
                     for k, v in item39_batch.items()}

            @jax.jit
            def grads(params, stats):
                def f(p):
                    o = model.loss(p, batch, {"dropout": jax.random.PRNGKey(0)}, train=True,
                                   batch_stats=stats)
                    return o["ctc_loss"] / o["n_seqs"]
                return jax.grad(f)(params)

            g = grads(variables["params"], variables["batch_stats"])
        state = {}
        for comp, sub in g.items():
            for k, v in subtree_to_state_dict(
                    jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), sub)).items():
                state[f"{comp}.{k}"] = v.numpy()
        return state

    out["jax f32"] = jax_grads(jnp.float32)
    with jax.enable_x64(True):
        out["jax f64"] = jax_grads(jnp.float64)
    for run, g in out.items():
        assert sorted(g) == sorted(names), (run, sorted(g))
    return out


def report(name, errs) -> None:
    worst = max(errs, key=errs.get)
    per_module = {mod: max(v for k, v in errs.items() if k.startswith(mod)) for mod in MODULES}
    print(f"[item 39] {name}: worst {errs[worst]:.3g} ({worst}); by module " + ", ".join(
        f"{k} {v:.3g}" for k, v in per_module.items()))
    print("[item 39]   " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))


def test_float64_gradients_agree(gradients):
    errs = floor_errs(gradients["port f64"], gradients["jax f64"])
    report("port float64 vs jax float64", errs)
    bad = {k: v for k, v in errs.items() if v > F64_TOL}
    assert not bad, bad


def test_port_f32_no_farther_from_float64_than_jax(gradients):
    port = floor_errs(gradients["port f32"], gradients["port f64"])
    ref = floor_errs(gradients["jax f32"], gradients["jax f64"])
    report("port f32 vs its float64", port)
    report("jax f32 vs its float64", ref)
    bad = {k: (port[k], ref[k]) for k in ref if port[k] > F32_RATIO * ref[k] + F64_TOL}
    assert not bad, bad
