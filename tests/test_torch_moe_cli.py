"""The port's CLIs on egs/aishell1/configs/conv-ctc-transformer-moe_test.yaml
against the JAX package, on the CPU.

On the features of `openasr_torch.bin.gen_mini_corpus` (20-dim), its
five utterances of 41-47 frames and 2 characters as the training set and
the dev set (one batch each, so that the JAX CLI compiles its steps once
and an epoch's batch order cannot differ), both train CLIs run 3 epochs
(3 steps) from one package (the port's weights from seed 0, step 0,
`--continue-training`); the JAX CLI runs in this process on ONE CPU device
(its mesh), with flax's eager init skipped (the package replaces it
anyway):

- the port CLI's logged losses, `moe_aux_loss` included, equal the JAX
  CLI's within 1e-4, and its last package's parameters the JAX CLI's
  within 1e-5;
- the package the JAX CLI wrote after epoch 1, continued to epoch 3 by
  the port's CLI in a subprocess that cannot import jax, flax, optax or
  openasr_tpu, logs the JAX CLI's epochs 2 and 3 within 1e-4;
- the infer CLI decodes the port's package with the attention beam;
- `average_packages` averages the two epoch packages' expert tables.
"""

import copy
import json
import os
import shutil
import subprocess
import sys
import textwrap

import flax.linen as flax_nn
import jax
import numpy as np
import pytest
import torch
import yaml

from openasr_torch.bin import infer as port_infer
from openasr_torch.bin import train as port_train
from openasr_torch.bin.gen_mini_corpus import main as gen_mini_corpus
from openasr_torch.data.tokenizer import CharTokenizer
from openasr_torch.models import get_model_class
from openasr_torch.utils.checkpoint import average_packages, load_package, save_package

from test_torch_wave_models import close, flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE_YAML = os.path.join(ROOT, "egs", "aishell1", "configs", "conv-ctc-transformer-moe_test.yaml")
LOSS_RTOL = 1e-4
PARAM_TOL = 1e-5

PORT_WITHOUT_JAX = textwrap.dedent("""
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ml_dtypes",
                                      "openasr_tpu"):
                raise ImportError(f"{name} blocked")
            return None

    sys.meta_path.insert(0, Block())
    from openasr_torch.bin import train
    train.main([sys.argv[1], "--continue-training", "--device", "cpu"])
""")


def one_batch_set(corpus):
    """moe.json: the corpus's 41-47-frame, 2-character utterances, one
    batch at the config's batch_frames."""
    with open(os.path.join(corpus, "train.json")) as f:
        rows = [r for r in json.load(f) if r["token_length"] == 2 and 41 <= r["feat_length"] <= 47]
    assert len(rows) == 5
    with open(os.path.join(corpus, "moe.json"), "w") as f:
        json.dump(rows, f)


def write_config(corpus, exp_dir, path, **training):
    with open(MOE_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(trainset=os.path.join(corpus, "moe.json"),
                       devset=os.path.join(corpus, "moe.json"),
                       vocab_path=os.path.join(corpus, "chars.txt"))
    cfg["training"].update({"exp_dir": str(exp_dir), "print_inteval": 1, "num_epoch": 3,
                            "num_last_ckpt_keep": 3, **training})
    os.makedirs(exp_dir, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def read_metrics(exp_dir):
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def jax_cli(cfg_path, init_params):
    """The JAX train CLI with --continue-training on one CPU device, its
    eager flax init replaced by `init_params` (last.pkg replaces them)."""
    from openasr_tpu.bin import train as jax_train
    from openasr_tpu.parallel import make_mesh

    def one_device(model=1, pipe=1):
        return make_mesh(jax.devices("cpu")[:1], model=model, pipe=pipe)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_train, "make_mesh", one_device)
        m.setattr(flax_nn.Module, "init", lambda self, *a, **k: {"params": init_params})
        jax_train.main([cfg_path, "--continue-training"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' 3 epochs: {name: exp dir}, plus the corpus and the
    configs (port_continued's, for the continuation test)."""
    tmp = tmp_path_factory.mktemp("moe_cli")
    corpus = str(tmp / "corpus")
    gen_mini_corpus(["--out", corpus])
    one_batch_set(corpus)
    out = {"corpus": corpus}
    for name in ("jax", "port", "port_continued"):
        out[name] = str(tmp / f"exp_{name}")
        out[f"{name}.yaml"] = write_config(corpus, out[name], tmp / f"{name}.yaml")
    with open(out["port.yaml"]) as f:
        cfg = yaml.safe_load(f)
    model_cfg = copy.deepcopy(cfg["model"])
    model_cfg["decoder"]["vocab_size"] = CharTokenizer(
        cfg["data"]["vocab_path"], add_blk=True).unit_num()
    model = get_model_class("conv-ctc-transformer").create_model(
        model_cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    init = {"model": model.package(), "optim_state": None,
            "solver_state": {"epoch": 0, "step": 0, "tr_loss": [], "cv_loss": []}}
    for name in ("jax", "port"):
        save_package(init, os.path.join(out[name], "last.pkg"))
    params = jax.tree_util.tree_map(np.asarray, init["model"]["components"])
    jax_cli(out["jax.yaml"], params)
    shutil.copy(os.path.join(out["jax"], "ep-0001.pkg"),
                os.path.join(out["port_continued"], "last.pkg"))
    port_train.main([out["port.yaml"], "--continue-training", "--device", "cpu"])
    return out


def assert_metrics_close(got, want):
    assert [r["phase"] for r in got] == [r["phase"] for r in want]
    for a, b in zip(want, got):
        for key in ("epoch", "step", "batch"):
            assert a.get(key) == b.get(key), (a, b)
        assert set(k for k in a if k.endswith("loss")) == set(k for k in b if k.endswith("loss"))
        for key, value in a.items():
            if key.endswith("loss") or key == "lr":
                assert abs(b[key] - value) <= LOSS_RTOL * max(abs(value), 1e-3), (key, a, b)


def test_training_matches_the_jax_cli(runs):
    want, got = read_metrics(runs["jax"]), read_metrics(runs["port"])
    steps = [r for r in want if r["phase"] == "train"]
    assert len(steps) >= 3 and all("moe_aux_loss" in r for r in steps)
    assert all(r["moe_aux_loss"] > 0 for r in want if r["phase"] in ("train", "cv"))
    assert_metrics_close(got, want)
    mine = load_package(os.path.join(runs["port"], "last.pkg"))
    theirs = load_package(os.path.join(runs["jax"], "last.pkg"))
    assert mine["solver_state"]["step"] == theirs["solver_state"]["step"] == len(steps)
    want_p = flat(theirs["model"]["components"])
    got_p = flat(mine["model"]["components"])
    assert any("moe_ffn/w_gate" in k for k in got_p) and set(got_p) == set(want_p)
    for name, value in got_p.items():
        close(value, want_p[name], PARAM_TOL, name)


def test_the_port_continues_a_jax_package_without_jax(runs):
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = subprocess.run([sys.executable, "-c", PORT_WITHOUT_JAX, runs["port_continued.yaml"]],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-3000:]
    want = [r for r in read_metrics(runs["jax"]) if r["epoch"] >= 2]
    got = read_metrics(runs["port_continued"])
    assert want[0]["epoch"] == 2 and any("moe_aux_loss" in r for r in want)
    assert_metrics_close(got, want)


def test_infer_cli_decodes_the_moe_package(runs, tmp_path):
    hyp = str(tmp_path / "hyp.txt")
    port_infer.main(["--model_type", "conv-ctc-transformer",
                     "--model_pkg", os.path.join(runs["port"], "last.pkg"),
                     "--vocab_path", os.path.join(runs["corpus"], "chars.txt"),
                     "--json_file", os.path.join(runs["corpus"], "test.json"),
                     "--output", hyp, "--add_blk", "--offline", "--nbest", "2",
                     "--maxlen", "8", "--device", "cpu"])
    with open(hyp) as f:
        lines = [line for line in f if line.strip()]
    with open(os.path.join(runs["corpus"], "test.json")) as f:
        assert len(lines) == len(json.load(f))


def test_average_packages_averages_the_expert_tables(runs):
    paths = [os.path.join(runs["port"], "last.pkg"), os.path.join(runs["jax"], "ep-0001.pkg")]
    avg = flat(average_packages(paths)["model"]["components"])
    a, b = (flat(load_package(p)["model"]["components"]) for p in paths)
    tables = [k for k in avg if "moe_ffn" in k]
    assert {k.rsplit("/", 1)[1] for k in tables} >= {"w1", "b1", "w2", "b2", "w_gate", "b_gate",
                                                       "kernel", "bias"}
    for k in tables:
        np.testing.assert_allclose(avg[k], (a[k].astype(np.float64) + b[k]) / 2, rtol=1e-6,
                                   atol=1e-7)
