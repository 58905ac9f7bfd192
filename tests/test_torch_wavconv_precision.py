"""The f32 WavConv gradient against float64, the port's and the JAX
package's, on the CPU (ROADMAP queue 3 item 26).

The batch is `chip_smoke.py:check_wav2vec_against_cpu`'s: the two shortest
utterances of the wav2vec training corpus that `phase_wave` writes with
`write_wave_corpus` (tones over noise with a stretch scaled by 0.01, here
4463 and 11801 samples, padded to 12624), cut to 1 s, through a WavConv of
256 channels in a training forward (the batch's statistics) under a seeded
cotangent.  Each package's f32 gradient is held to its own float64 one
(jax.enable_x64 as a context), 1e-4 of each parameter's largest
magnitude, and the two float64 gradients to each other, 1e-6.

oneDNN's f32 conv1d input gradient with a padding argument is wrong at
some strided shapes (the first output frames of some channel blocks), one
of them the last WavConv layer's input of this batch, [2, 256, 157] at
kernel 4, stride 2, padding 1; WavConv pads explicitly and convolves with
padding 0.  `test_wavconv_conv_is_exact_where_the_library_is_not` prints
the library's error at that shape and holds WavConv's formulation to
float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from openasr_torch.convert import state_dict_to_jax_components, subtree_to_state_dict
from openasr_torch.models import init_parameters
from openasr_torch.models.frontend import WavConv
from openasr_tpu.models.frontend import WavConv as JaxWavConv

WIDTH = 256
GRAD_RTOL = 1e-4
F64_TOL = 1e-6


@pytest.fixture(scope="module")
def item26_batch(tmp_path_factory):
    """The two shortest utterances of chip_smoke.py's wav2vec training
    corpus (its rng and lengths), cut to 1 s, padded as the collate pads
    them; no wav file is written."""
    import chip_smoke
    from openasr_torch.data import audio

    with pytest.MonkeyPatch.context() as m:
        m.setattr(chip_smoke, "WORK", str(tmp_path_factory.mktemp("item26")))
        m.setattr(audio, "write_wav", lambda *a, **k: None)
        rng = np.random.RandomState(chip_smoke.SEED + 20)
        lengths = np.concatenate([rng.randint(400000, 480001, 3),
                                  rng.randint(120000, 300001, 34), rng.randint(4000, 60001, 8)])
        _, waves = chip_smoke.write_wave_corpus("w2vtrain", rng, ["a", "b"], len(lengths), None,
                                                (5, 20), lengths=lengths)
        utts = sorted(waves, key=lambda u: waves[u].shape[0])[:2]
        batch = chip_smoke.wave_batch({u: waves[u][:16000] for u in utts}, utts,
                                      np.random.RandomState(chip_smoke.SEED + 21))
    return batch["waves"], batch["wave_lengths"]


def rel_errs(got: dict, want: dict) -> dict:
    return {k: float(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64)).max()
                     / np.abs(np.asarray(want[k], np.float64)).max()) for k in want}


def test_wavconv_f32_gradient_against_float64_in_both_packages(item26_batch):
    waves, lengths = item26_batch
    assert waves.shape == (2, 12624) and lengths.tolist() == [4463, 11801]
    conv = WavConv(WIDTH)
    init_parameters(conv, torch.Generator().manual_seed(1234))
    state = {k: v for k, v in conv.state_dict().items() if not k.endswith(("mean", "var"))}
    params = state_dict_to_jax_components("gru_ctc", {f"splayer.{k}": v for k, v in state.items()},
                                          {})["splayer"]
    cot = np.random.RandomState(3).randn(2, waves.shape[1] // 160, WIDTH)

    def port(dtype):
        m = WavConv(WIDTH)
        m.load_state_dict(conv.state_dict())
        m.to(dtype)
        out, _ = m(torch.from_numpy(waves).to(dtype), torch.from_numpy(lengths), train=True)
        (out * torch.from_numpy(cot).to(dtype)).sum().backward()
        return {n: p.grad.numpy() for n, p in m.named_parameters()}

    def jax_grads(dtype):
        mod = JaxWavConv(WIDTH, dtype=dtype)
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), dtype), params)
        stats = {f"bn{i}": {"mean": jnp.zeros(WIDTH, dtype), "var": jnp.ones(WIDTH, dtype)}
                 for i in range(5)}

        @jax.jit
        def grads(p):
            def f(p):
                (out, _), _ = mod.apply({"params": p, "batch_stats": stats},
                                        jnp.asarray(waves, dtype), jnp.asarray(lengths),
                                        use_running_average=False, mutable=["batch_stats"])
                return jnp.sum(out * jnp.asarray(cot, dtype))
            return jax.grad(f)(p)

        return {k: v.numpy() for k, v in subtree_to_state_dict(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), grads(p))).items()}

    port32, port64 = port(torch.float32), port(torch.float64)
    jax32 = jax_grads(jnp.float32)
    with jax.enable_x64(True):
        jax64 = jax_grads(jnp.float64)
    errs = {"port f32 vs its float64": rel_errs(port32, port64),
            "jax f32 vs its float64": rel_errs(jax32, jax64),
            "port float64 vs jax float64": rel_errs(port64, jax64)}
    for name, e in errs.items():
        worst = max(e, key=e.get)
        print(f"[item 26] {name}: worst {e[worst]:.3g} ({worst})")
    for name, tol in (("port f32 vs its float64", GRAD_RTOL), ("jax f32 vs its float64", GRAD_RTOL),
                      ("port float64 vs jax float64", F64_TOL)):
        assert max(errs[name].values()) <= tol, (name, errs[name])


def test_wavconv_conv_is_exact_where_the_library_is_not():
    """At the last layer's input of the item-26 batch, [2, 256, 157] at
    kernel 4, stride 2, padding 1: the input gradient of WavConv's
    formulation (explicit zero padding, padding 0) within 1e-5 of float64;
    the library's with a padding argument is printed beside it."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 256, 157, generator=gen, dtype=torch.float64)
    w = torch.randn(256, 256, 4, generator=gen, dtype=torch.float64) / 32
    g = torch.randn(2, 256, 78, generator=gen, dtype=torch.float64)
    want = torch.nn.grad.conv1d_input(x.shape, w, g, 2, 1)

    def input_grad(explicit):
        xs = x.float().requires_grad_(True)
        y = (F.conv1d(F.pad(xs, (1, 1)), w.float(), None, 2, 0) if explicit
             else F.conv1d(xs, w.float(), None, 2, 1))
        y.backward(g.float())
        return float((xs.grad.double() - want).abs().max() / want.abs().max())

    library, ours = input_grad(False), input_grad(True)
    print(f"[item 26] conv1d input gradient at [2, 256, 157] k4 s2 p1, f32 vs float64: "
          f"padding argument {library:.3g}, explicit padding {ours:.3g}")
    assert ours <= 1e-5
    conv = WavConv(256)
    assert all(getattr(conv, f"conv{i}").padding == (0,) for i in range(5))
