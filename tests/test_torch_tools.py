"""The port's tools against the JAX package's, on the CPU: `utils/timer.py`,
`bin/convert_reference_pkg.py`, `bin/plot_attention.py`,
`bin/gen_wav_flist.py`, `bin/gen_libri_json.py`, and the recipe scripts.

- convert_reference_pkg: a reference-layout (eastonYi/OpenASR) state dict
  drawn from a seed at tests/test_reference_parity.py's widths gives the
  same package through both tools, leaf by leaf and exactly; restored, the
  port's model and the JAX model give the same forward within 1e-5 (f32).
- plot_attention: both tools on the JAX-saved package and a mini-corpus
  manifest, matplotlib blocked, write the same `.npz` names, the maps
  within 1e-5.
- gen_wav_flist / gen_libri_json: byte-identical outputs on a
  LibriSpeech-shaped tree of the committed FLAC files.
"""

import glob
import importlib.util
import os
import re
import shutil
import sys
import time

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openasr_tpu.models import get_model_class as jax_model_class
from openasr_tpu.utils.timer import Timer as JaxTimer
from openasr_torch.bin import (
    convert_reference_pkg,
    gen_libri_json,
    gen_mini_corpus,
    gen_wav_flist,
    plot_attention,
)
from openasr_torch.models import get_model_class
from openasr_torch.utils.checkpoint import load_package
from openasr_torch.utils.timer import Timer
from tools import convert_reference_pkg as jax_convert
from tools import gen_wav_flist as jax_gen_wav_flist
from tools import plot_attention as jax_plot_attention

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
JAX_PKG = os.path.join(DATA, "jax_solver_conv_ctc_transformer_test.pkg")
FORWARD_TOL = 1e-5
MAP_TOL = 1e-5

# tests/test_reference_parity.py:38-44
ENC_CFG = {"input_dim": 20, "d_model": 32, "nhead": 2, "dim_feedforward": 64,
           "num_layers": 2, "dropout_rate": 0.0, "activation": "relu",
           "sub": {"type": "ConvV2", "layer_num": 2}}
DEC_CFG = {"d_model": 32, "nhead": 2, "num_layers": 2, "encoder_dim": 32,
           "dim_feedforward": 64, "vocab_size": 11, "dropout_rate": 0.0,
           "activation": "relu"}
MODEL_TYPES = ("conv-transformer", "conv-ctc-transformer", "conv-ctc")


# ------------------------------------------------------------------ Timer

@pytest.mark.parametrize("cls", [Timer, JaxTimer])
def test_timer_behaves_as_the_jax_one(cls):
    t = cls()
    with pytest.raises(RuntimeError, match=r"Timer not started; call tic\(\) first\."):
        t.toc()
    t.tic()
    time.sleep(0.01)
    first = t.toc()
    assert 0.01 <= first <= t.toc()
    with cls() as ctx:
        time.sleep(0.01)
    assert ctx.elapsed >= 0.01 and not hasattr(cls(), "elapsed")


# ------------------------------------------------------ convert_reference_pkg

def reference_package(model_type, seed=0) -> dict:
    """A reference package (the `{name}_config` / `{name}_state` pairs of
    Speech_Models.py) with torch tensors drawn from a seed."""
    rng = np.random.RandomState(seed)
    d, ff, v = ENC_CFG["d_model"], ENC_CFG["dim_feedforward"], DEC_CFG["vocab_size"]

    def t(*shape, mean=0.0):
        # a trained model's scale: weights 1 / sqrt(fan in), biases 0.02
        std = 0.02 if len(shape) == 1 else 1.0 / np.sqrt(np.prod(shape[1:]))
        return torch.from_numpy((mean + std * rng.randn(*shape)).astype(np.float32))

    def mha(sd, p):
        sd.update({f"{p}.in_proj_weight": t(3 * d, d), f"{p}.in_proj_bias": t(3 * d),
                   f"{p}.out_proj.weight": t(d, d), f"{p}.out_proj.bias": t(d)})

    def block(sd, p, norms):
        sd.update({f"{p}.linear1.weight": t(ff, d), f"{p}.linear1.bias": t(ff),
                   f"{p}.linear2.weight": t(d, ff), f"{p}.linear2.bias": t(d)})
        for n in norms:
            sd.update({f"{p}.{n}.weight": t(d, mean=1.0), f"{p}.{n}.bias": t(d)})

    freq = ENC_CFG["input_dim"] - 2 * ENC_CFG["sub"]["layer_num"]
    enc = {"sub.conv.subsample/conv0.weight": t(32, 1, 3, 3),
           "sub.conv.subsample/conv0.bias": t(32),
           "sub.conv.subsample/conv1.weight": t(32, 32, 3, 3),
           "sub.conv.subsample/conv1.bias": t(32),
           "sub.affine.weight": t(d, 32 * freq), "sub.affine.bias": t(d),
           "transformer_encoder.norm.weight": t(d, mean=1.0),
           "transformer_encoder.norm.bias": t(d)}
    for i in range(ENC_CFG["num_layers"]):
        p = f"transformer_encoder.layers.{i}"
        mha(enc, f"{p}.self_attn")
        block(enc, p, ("norm1", "norm2"))
    pkg = {"splayer_config": {"feature_type": "offline"},
           "encoder_config": dict(ENC_CFG), "encoder_state": enc}
    if model_type == "conv-ctc":
        pkg["fc_state"] = {"weight": t(v, d)}
        return pkg
    dec = {"emb.weight": t(v, d), "output_affine.bias": t(v)}
    for i in range(DEC_CFG["num_layers"]):
        p = f"transformer_block.layers.{i}"
        mha(dec, f"{p}.self_attn")
        mha(dec, f"{p}.multihead_attn")
        block(dec, p, ("norm1", "norm2", "norm3"))
    pkg.update({"decoder_config": dict(DEC_CFG), "decoder_state": dec})
    if model_type == "conv-ctc-transformer":
        pkg["ctc_fc_state"] = {"weight": t(v, d)}
    return pkg


def flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        out.update(flat(v, path + (k,)) if isinstance(v, dict) else {path + (k,): v})
    return out


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_converted_packages_equal_the_jax_tools(model_type):
    ref = reference_package(model_type)
    mine = convert_reference_pkg.convert(ref, model_type)
    theirs = jax_convert.convert(ref, model_type)
    assert mine["model_type"] == theirs["model_type"] and mine["configs"] == theirs["configs"]
    a, b = flat(mine["components"]), flat(theirs["components"])
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
    if model_type == "conv-ctc-transformer":
        # the reference writes the CTC head as a bias-free Linear's state dict
        np.testing.assert_array_equal(mine["components"]["ctc_fc"]["kernel"],
                                      ref["ctc_fc_state"]["weight"].numpy().T)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_converted_package_forward_matches_the_jax_model(model_type, tmp_path):
    ref = reference_package(model_type, seed=1)
    ref_path, out = str(tmp_path / "ref.pt"), str(tmp_path / "out.pkg")
    torch.save({"model": ref, "optimizer": {}}, ref_path)  # a solver checkpoint
    convert_reference_pkg.main([ref_path, out, "--model_type", model_type])
    pkg = load_package(out)
    jax_pkg = jax_convert.convert(ref, model_type)
    # the JAX model without flax's eager init: its init returns the package
    params = jax.tree_util.tree_map(jnp.asarray, jax_pkg["components"])
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn.Module, "init", lambda self, *a, **k: {"params": params})
        jax_model = jax_model_class(model_type).create_model(jax_pkg["configs"])
    jax_model.restore(jax_pkg)
    port = get_model_class(model_type).create_model(pkg["configs"], device="cpu")
    port.restore(pkg)

    rng = np.random.RandomState(2)
    x = rng.randn(3, 41, 20).astype(np.float32)
    lens = np.array([41, 30, 19], np.int32)
    ids = rng.randint(3, DEC_CFG["vocab_size"], size=(3, 7)).astype(np.int32)
    args = (x, lens) if model_type == "conv-ctc" else (x, lens, ids)
    jax_args = args if model_type == "conv-ctc" else (*args, np.full((3,), 7, np.int32))
    want = jax.jit(jax_model.module.apply)({"params": jax_model.params}, *jax_args)
    with torch.no_grad():
        got = port.module(*(torch.from_numpy(a) for a in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        if g.dtype.kind == "i":
            np.testing.assert_array_equal(g, w)
        else:
            assert np.abs(g - w).max() <= FORWARD_TOL


# ------------------------------------------------------------ plot_attention

def test_plot_attention_maps_equal_the_jax_tools(tmp_path, monkeypatch):
    data = str(tmp_path / "mini")
    gen_mini_corpus.main(["--out", data])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    outs = {}
    for name, tool in (("port", plot_attention), ("jax", jax_plot_attention)):
        outs[name] = str(tmp_path / name)
        argv = ["--model_type", "conv-ctc-transformer", "--model_pkg", JAX_PKG,
                "--vocab_path", os.path.join(data, "chars.txt"),
                "--json_file", os.path.join(data, "test.json"), "--output_dir", outs[name],
                "--utts", "3", "--add_blk"]
        if name == "port":
            tool.main(argv + ["--device", "cpu"])
            continue
        # the JAX tool without flax's eager init, which its restore overwrites
        params = jax.tree_util.tree_map(jnp.asarray, load_package(JAX_PKG)["model"]["components"])
        with pytest.MonkeyPatch.context() as m:
            m.setattr(flax_nn.Module, "init", lambda self, *a, **k: {"params": params})
            tool.main(argv)
    names = sorted(os.listdir(outs["port"]))
    assert names == sorted(os.listdir(outs["jax"]))
    assert len(names) == 3 and all(n.endswith(".npz") for n in names)
    for n in names:
        got = np.load(os.path.join(outs["port"], n))["attn"]
        want = np.load(os.path.join(outs["jax"], n))["attn"]
        assert got.shape == want.shape and np.abs(got - want).max() <= MAP_TOL, n


# ------------------------------------------------ gen_wav_flist, gen_libri_json

@pytest.fixture
def libri_tree(tmp_path):
    """LibriSpeech's layout: <speaker>/<chapter>/<utt>.flac beside
    <speaker>-<chapter>.trans.txt, one transcript line without its flac."""
    root = tmp_path / "LibriSpeech" / "dev-clean"
    for utt, text in (("100-121669-0000", "TOM THE PIPER'S SON"),
                      ("103-1240-0005", "AND SHE SAID")):
        spk, chapter, _ = utt.split("-")
        d = root / spk / chapter
        d.mkdir(parents=True)
        shutil.copy(os.path.join(DATA, f"{utt}.flac"), d / f"{utt}.flac")
        (d / f"{spk}-{chapter}.trans.txt").write_text(
            f"{utt} {text}\n{spk}-{chapter}-9999 NO SUCH FLAC\n")
    return str(root)


def test_gen_wav_flist_equals_the_jax_tools(libri_tree, tmp_path, monkeypatch):
    mine, theirs = str(tmp_path / "port.flist"), str(tmp_path / "jax.flist")
    gen_wav_flist.main(["--wav-dir", libri_tree, "--ext", ".flac", "--output", mine])
    monkeypatch.setattr(sys, "argv", ["gen_wav_flist.py", "--wav-dir", libri_tree,
                                      "--ext", ".flac", "--output", theirs])
    jax_gen_wav_flist.main()
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        a, b = f.read(), g.read()
    assert a == b and len(a.splitlines()) == 2


def test_gen_libri_json_equals_the_jax_tools(libri_tree, tmp_path, monkeypatch):
    mine, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    gen_libri_json.main([libri_tree, mine])
    spec = importlib.util.spec_from_file_location(
        "libri_gen_json", os.path.join(ROOT, "egs", "libri", "gen_json.py"))
    jax_gen_json = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_gen_json)
    monkeypatch.setattr(sys, "argv", ["gen_json.py", libri_tree, theirs])
    jax_gen_json.main()
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        a, b = f.read(), g.read()
    assert a == b and a.count(b'"uttid"') == 2


# ------------------------------------------------------------ recipe scripts

def test_every_jax_recipe_script_has_a_torch_one():
    """Every egs/*/*.sh that runs the JAX package or a tools/ script has a
    `_torch.sh` beside it, but for path.sh (sourced by both), the *_cpu.sh
    smokes (the port's scripts take --device cpu) and the TPU recipe gate;
    no `_torch.sh` names openasr_tpu, and every module it runs exists."""
    without, modules = [], set()
    for path in sorted(glob.glob(os.path.join(ROOT, "egs", "*", "*.sh"))):
        with open(path) as f:
            text = f.read()
        rel = os.path.relpath(path, ROOT)
        if path.endswith("_torch.sh"):
            assert "openasr_tpu" not in text and "tools/" not in text, rel
            modules.update(re.findall(r"python -m (openasr_torch\.[\w.]+)", text))
        elif ("openasr_tpu" in text or "tools/" in text) and not os.path.exists(
                path[:-3] + "_torch.sh"):
            without.append(rel)
    allowed = sorted(
        glob.glob(os.path.join(ROOT, "egs", "*", "path.sh"))
        + glob.glob(os.path.join(ROOT, "egs", "*", "*_cpu.sh"))
        + [os.path.join(ROOT, "egs", "aishell1", "run_recipe_gate_tpu.sh")])
    assert without == [os.path.relpath(p, ROOT) for p in allowed]
    assert os.path.exists(os.path.join(ROOT, "egs", "libri", "gen_json_torch.sh"))
    for m in sorted(modules):
        assert importlib.util.find_spec(m) is not None, m
