"""Packages the JAX solver writes, read by the port without jax.

The JAX CLI trains egs/aishell1/configs/conv-ctc-transformer-test.yaml on
the tools/gen_mini_corpus.py corpus for one epoch with each optimizer of
its solver (the fused clip + Adam, `fused_adam: false` and `optimtype:
sgd`), in a subprocess on ONE CPU device (as tests/test_torch_train_cli.py
runs it), and continues the committed package
tests/data/jax_solver_conv_ctc_transformer_test.pkg (that CLI's fused run,
1 epoch) for 2 more epochs.  Then:

- a subprocess whose meta path refuses jax, jaxlib, flax, optax,
  ml_dtypes and openasr_tpu loads every package with the port's
  `load_package` and restores its optimizer state into the port's solver;
- the optimizer-state bridge goes JAX -> port -> JAX bit for bit;
- the port's train CLI, continuing the committed package for the same 2
  epochs, logs the JAX CLI's loss curve to 1e-6 relative;
- the committed package still holds what the JAX solver writes today;
- `AsyncCheckpointer.wait()` re-raises a failed write.
"""

import json
import os
import pickle
import pickletools
import shutil
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import yaml

from openasr_torch.bin import train as port_train
from openasr_torch.convert import jax_optim_state_to_port, port_optim_state_to_jax
from openasr_torch.utils.checkpoint import AsyncCheckpointer, load_package

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_YAML = os.path.join(ROOT, "egs", "aishell1", "configs", "conv-ctc-transformer-test.yaml")
COMMITTED = os.path.join(ROOT, "tests", "data", "jax_solver_conv_ctc_transformer_test.pkg")
RTOL = 1e-6
OPTIMIZERS = {"fused": {}, "adam": {"fused_adam": False}, "sgd": {"optimtype": "sgd"}}

JAX_RUNS = textwrap.dedent("""
    import sys
    from openasr_tpu.bin import train
    for path in sys.argv[1:]:
        args = [path.removesuffix("+continue")]
        if path.endswith("+continue"):
            args.append("--continue-training")
        train.main(args)
""")

BLOCKED_LOAD = textwrap.dedent("""
    import json, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ml_dtypes",
                                      "openasr_tpu"):
                raise ImportError(f"{name} blocked")
            return None

    sys.meta_path.insert(0, Block())
    import yaml
    from openasr_torch.data.tokenizer import CharTokenizer
    from openasr_torch.models import get_model_class
    from openasr_torch.solvers import get_solver_class
    from openasr_torch.utils.checkpoint import load_package

    out = {}
    for name, pkg_path, cfg_path in zip(sys.argv[1::3], sys.argv[2::3], sys.argv[3::3]):
        cfg = yaml.safe_load(open(cfg_path))
        pkg = load_package(pkg_path)
        model_cfg = cfg["model"]
        model_cfg["decoder"]["vocab_size"] = CharTokenizer(
            cfg["data"]["vocab_path"], add_blk=True).unit_num()
        model = get_model_class(model_cfg["type"]).create_model(model_cfg, device="cpu")
        model.restore(pkg["model"])
        solver = get_solver_class(model_cfg["type"])(model, cfg["training"], None, None,
                                                     device="cpu")
        solver.restore(pkg)
        state = solver.optimizer.state_dict()
        out[name] = {"state_class": type(pkg["optim_state"]).__name__,
                     "count": state["count"], "keys": sorted(state),
                     "step": solver.step}
    bad = sorted(m for m in sys.modules if m.split(".")[0] in
                 ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "openasr_tpu"))
    print(json.dumps({"loaded": out, "imported": bad}))
""")


def write_config(corpus, exp_dir, path, **training):
    with open(TEST_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(trainset=os.path.join(corpus, "train.json"),
                       devset=os.path.join(corpus, "dev.json"),
                       vocab_path=os.path.join(corpus, "chars.txt"))
    cfg["training"].update(exp_dir=str(exp_dir), print_inteval=1, **training)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def read_metrics(exp_dir):
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """{name: (config, exp dir)} of the JAX CLI's runs: one epoch with each
    optimizer, and "continued": the committed package continued to epoch 3."""
    tmp = tmp_path_factory.mktemp("jax_runs")
    corpus = str(tmp / "corpus")
    subprocess.run([sys.executable, "-m", "openasr_torch.bin.gen_mini_corpus", "--out", corpus],
                   cwd=ROOT, check=True, capture_output=True)
    runs, argv = {}, []
    for name, extra in OPTIMIZERS.items():
        runs[name] = (write_config(corpus, tmp / f"exp_{name}", tmp / f"{name}.yaml",
                                   num_epoch=1, **extra), str(tmp / f"exp_{name}"))
        argv.append(runs[name][0])
    os.makedirs(tmp / "exp_continued")
    shutil.copy(COMMITTED, tmp / "exp_continued" / "last.pkg")
    runs["continued"] = (write_config(corpus, tmp / "exp_continued", tmp / "continued.yaml",
                                      num_epoch=3), str(tmp / "exp_continued"))
    argv.append(runs["continued"][0] + "+continue")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    run = subprocess.run([sys.executable, "-c", JAX_RUNS, *argv], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stdout[-3000:]
    return runs


def test_jax_packages_load_with_jax_blocked(jax_runs):
    args = []
    for name in OPTIMIZERS:
        cfg, exp = jax_runs[name]
        args += [name, os.path.join(exp, "last.pkg"), cfg]
    args += ["committed", COMMITTED, jax_runs["continued"][0]]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "-c", BLOCKED_LOAD, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    result = json.loads(run.stdout.strip().splitlines()[-1])
    assert result["imported"] == []
    loaded = result["loaded"]
    assert loaded["fused"]["state_class"] == loaded["committed"]["state_class"] == \
        "FusedClipAdamState"
    assert loaded["adam"]["state_class"] == loaded["sgd"]["state_class"] == "ApplyIfFiniteState"
    assert loaded["fused"]["keys"] == ["count", "mu", "notfinite", "nu"]
    assert loaded["adam"]["keys"] == ["count", "last_finite", "mu", "notfinite",
                                      "notfinite_count", "nu"]
    assert loaded["sgd"]["keys"] == ["count", "last_finite", "notfinite", "notfinite_count",
                                     "trace"]
    for name, got in loaded.items():
        assert got["count"] == got["step"] > 0, name


def _structure(tree):
    """(class name, fields) of every node, and the leaves, of a state."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__, tree._fields, tuple(_structure(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return tuple(_structure(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return "leaf"


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_state_bridge_round_trips_bit_for_bit(jax_runs, name):
    cfg_path, exp = jax_runs[name]
    path = os.path.join(exp, "last.pkg")
    with open(path, "rb") as f:
        jax_pkg = pickle.load(f)  # the JAX package's own classes
    port_pkg = load_package(path)
    state = jax_optim_state_to_port("conv-ctc-transformer", port_pkg["optim_state"])
    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    back = port_optim_state_to_jax("conv-ctc-transformer", state, port_pkg["model"]["configs"],
                                   clip=float(cfg["training"]["grad_max_norm"]) > 0)
    assert _structure(back) == _structure(jax_pkg["optim_state"])
    want = jax.tree_util.tree_leaves(jax_pkg["optim_state"])
    got = jax.tree_util.tree_leaves(back)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        a = np.asarray(a)
        a = a.astype(np.float32) if a.dtype.kind == "V" or str(a.dtype) == "bfloat16" else a
        assert a.shape == np.shape(b) and np.array_equal(a, np.asarray(b))
        if a.dtype.kind != "f":
            assert a.dtype == np.asarray(b).dtype


def test_port_continues_a_jax_package_on_the_jax_loss_curve(jax_runs, tmp_path):
    cfg_path, exp_j = jax_runs["continued"]
    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    cfg["training"]["exp_dir"] = str(tmp_path / "exp")
    os.makedirs(tmp_path / "exp")
    shutil.copy(COMMITTED, tmp_path / "exp" / "last.pkg")
    with open(tmp_path / "port.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    port_train.main([str(tmp_path / "port.yaml"), "--continue-training", "--device", "cpu"])
    want, got = read_metrics(exp_j), read_metrics(tmp_path / "exp")
    assert [r["phase"] for r in got] == [r["phase"] for r in want]
    assert sum(r["phase"] == "train" for r in want) >= 8  # 2 epochs of steps
    assert want[0]["epoch"] == 2 and want[0]["step"] == 5
    for a, b in zip(want, got):
        for key in ("epoch", "step", "batch"):
            assert a.get(key) == b.get(key), (a, b)
        for key, value in a.items():
            if key.endswith("loss") or key == "lr":
                assert abs(b[key] - value) <= RTOL * abs(value), (key, a, b)


def _globals(path):
    """The (module, name) pairs a pickle file imports."""
    found, strings = set(), []
    with open(path, "rb") as f:
        for op, arg, _ in pickletools.genops(f.read()):
            if op.name in ("SHORT_BINUNICODE", "BINUNICODE", "UNICODE"):
                strings.append(arg)
            elif op.name == "STACK_GLOBAL":
                found.add((strings[-2], strings[-1]))
            elif op.name == "GLOBAL":
                found.add(tuple(arg.split(" ", 1)))
    return found


def test_committed_package_is_what_the_jax_solver_writes(jax_runs):
    """Its keys, optimizer-state classes (as they pickle), tree and leaf
    shapes and dtypes equal those of a package the JAX solver writes now."""
    fresh = os.path.join(jax_runs["fused"][1], "last.pkg")
    assert _globals(COMMITTED) == _globals(fresh)
    with open(COMMITTED, "rb") as f:
        old = pickle.load(f)
    with open(fresh, "rb") as f:
        new = pickle.load(f)
    assert sorted(old) == sorted(new)
    assert sorted(old["solver_state"]) == sorted(new["solver_state"])
    assert old["model"]["configs"] == new["model"]["configs"]
    for part in ("optim_state", "model"):
        a, b = (jax.tree_util.tree_flatten_with_path(p[part]["components"] if part == "model"
                                                     else p[part]) for p in (old, new))
        assert a[1] == b[1]
        assert [(k, np.shape(v), np.asarray(v).dtype) for k, v in a[0]] == \
            [(k, np.shape(v), np.asarray(v).dtype) for k, v in b[0]]


def test_async_checkpointer_wait_reraises_a_failed_write(tmp_path):
    ckpt = AsyncCheckpointer()
    ckpt.save({"x": np.ones(3)}, str(tmp_path / "ok.pkg"))
    ckpt.wait()
    assert load_package(str(tmp_path / "ok.pkg"))["x"].tolist() == [1.0, 1.0, 1.0]
    ckpt.save({"x": torch.ones(2)}, str(tmp_path / "missing" / "dir" / "a.pkg"))
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ckpt.wait()
    ckpt.wait()  # the failure is reported once


def test_load_package_refuses_other_globals_by_name(tmp_path):
    path = tmp_path / "bad.pkg"
    with open(path, "wb") as f:
        pickle.dump({"optim_state": AsyncCheckpointer}, f)
    with pytest.raises(pickle.UnpicklingError, match="AsyncCheckpointer"):
        load_package(str(path))
