"""The pipe axis through the CLIs, on the CPU: `--pipeline 2` under torchrun
over gloo, and the jax-free tools `bin/stack_encoder_pkg.py` and
`bin/avg_last_ckpts.py`.

- `bin/stack_encoder_pkg.py` on the committed JAX-written package
  (tests/data/jax_solver_conv_ctc_transformer_test.pkg) writes what
  tools/stack_encoder_pkg.py writes, bit for bit, both ways, and its
  stacked package loads and evaluates in the JAX package as the per-layer
  one does (1e-5).
- `bin/avg_last_ckpts.py` writes what the JAX package's
  `average_last_ckpts` writes, bit for bit.
- A stacked package that the JAX solver wrote (one step of
  conv-ctc-transformer-test.yaml with 2 encoder layers and
  `encoder.pipeline: true`, its optimizer state in the stacked layout)
  continues under `torch.distributed.run --nproc-per-node 2 ...
  --distributed --pipeline 2 --device cpu --continue-training`, one layer a
  stage, to what one process continuing it writes (1e-5 of max(1, |x|)).
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from openasr_torch.bin import avg_last_ckpts, stack_encoder_pkg
from openasr_torch.bin import train as port_train
from openasr_torch.config import load_config
from openasr_torch.data.tokenizer import CharTokenizer
from openasr_torch.utils.checkpoint import load_package
from openasr_tpu.config import Config
from openasr_tpu.parallel import make_mesh, shard_batch
from openasr_tpu.solvers import array_fields
from openasr_tpu.solvers import get_solver_class as jax_solver_class
from openasr_tpu.utils import checkpoint as jax_checkpoint

from test_torch_parallel import feature_batch, jax_twin, params_close, port_package
from test_torch_parallel_cli import ROOT, corpus, write_config  # noqa: F401

sys.path.insert(0, os.path.join(ROOT, "tools"))
import stack_encoder_pkg as jax_stack_tool  # noqa: E402

COMMITTED = os.path.join(ROOT, "tests", "data", "jax_solver_conv_ctc_transformer_test.pkg")


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def same_bits(got, want, what):
    got, want = leaves(got), leaves(want)
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k, v in want.items():
        a, b = np.asarray(got[k]), np.asarray(v)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), (what, k)


def test_stack_tool_matches_the_jax_tool_and_loads_in_jax(tmp_path, capsys):
    out = {}
    for tag, main in (("port", stack_encoder_pkg.main), ("jax", jax_stack_tool.main)):
        stacked, back = str(tmp_path / f"{tag}_stacked.pkg"), str(tmp_path / f"{tag}_back.pkg")
        main([COMMITTED, stacked])
        main([stacked, back, "--unstack"])
        out[tag] = load_package(stacked), load_package(back)
    printed = capsys.readouterr().out
    assert printed.count("note: optimizer state dropped") == 2 and "stacked 1 layers" in printed
    original = load_package(COMMITTED)
    for i, what in enumerate(("stacked", "unstacked")):
        got, want = out["port"][i], out["jax"][i]
        assert got["optim_state"] is None and want["optim_state"] is None
        assert got["solver_state"] == want["solver_state"]
        same_bits(got["model"]["components"], want["model"]["components"], what)
    same_bits(out["port"][1]["model"]["components"], original["model"]["components"], "round trip")
    enc = out["port"][0]["model"]["components"]["encoder"]
    assert "layer0" not in enc and enc["stack"]["stacked_layers"]["norm1"]["scale"].shape[0] == 1

    # the JAX package evaluates the stacked package as the per-layer one
    pkg = jax_checkpoint.load_package(str(tmp_path / "port_stacked.pkg"))
    cfg = pkg["model"]["configs"]
    losses = []
    for c, comps in ((cfg, original["model"]["components"]),
                     (dict(cfg, encoder=dict(cfg["encoder"], pipeline=True)),
                      pkg["model"]["components"])):
        jm = jax_twin("conv-ctc-transformer", c, {"components": comps})
        batch = array_fields(feature_batch(4, (30, 22, 17), vocab=c["decoder"]["vocab_size"]))
        res = jax.jit(lambda p, b, jm=jm: jm.loss(p, b, None, train=False))(jm.params, batch)
        losses.append({k: float(v) for k, v in res.items()})
    for k in ("ce_loss", "ctc_loss"):
        assert abs(losses[1][k] - losses[0][k]) <= 1e-5 * max(1.0, abs(losses[0][k])), k


def test_avg_tool_matches_jax_average_last_ckpts(tmp_path):
    from test_torch_models import small_config

    exp = tmp_path / "exp"
    exp.mkdir()
    for ep in range(1, 5):
        pkg = {"model": port_package("conv-ctc-transformer", small_config(), seed=ep),
               "solver_state": {"epoch": ep, "step": 10 * ep}, "optim_state": None}
        jax_checkpoint.save_package(pkg, str(exp / f"ep-{ep:04d}.pkg"))
    avg_last_ckpts.main([str(exp), "3"])
    got = load_package(str(exp / "avg3.pkg"))
    want = jax_checkpoint.load_package(
        jax_checkpoint.average_last_ckpts(str(exp), 3, str(tmp_path / "jax_avg3.pkg")))
    same_bits(got["model"]["components"], want["model"]["components"], "avg3")
    assert got["solver_state"] == want["solver_state"] == {"epoch": 2, "step": 20}
    with pytest.raises(ValueError, match="num must be >= 1"):
        avg_last_ckpts.main([str(exp), "0"])


def jax_stacked_package(cfg_path, out_path):
    """One JAX solver step (single device, the stacked scan) of the
    config's model from a port-initialised package, written by the JAX
    package as epoch 1's last.pkg."""
    config = load_config(cfg_path)
    model_cfg = config["model"]
    model_cfg["decoder"]["vocab_size"] = CharTokenizer(
        config["data"]["vocab_path"], add_blk=True).unit_num()
    model_cfg = model_cfg.to_dict() if hasattr(model_cfg, "to_dict") else dict(model_cfg)
    jm = jax_twin("conv-ctc-transformer", model_cfg,
                  port_package("conv-ctc-transformer", model_cfg))
    mesh = make_mesh(jax.devices("cpu")[:1])
    training = config["training"]
    training = training.to_dict() if hasattr(training, "to_dict") else dict(training)
    solver = jax_solver_class("conv-ctc-transformer")(jm, Config(training), [], [], mesh=mesh)
    batch = feature_batch(2, (40, 33, 21, 18), vocab=model_cfg["decoder"]["vocab_size"])
    jm.params, solver.opt_state, _, _ = solver._train_step(
        jm.params, solver.opt_state, shard_batch(array_fields(batch), mesh),
        jax.random.PRNGKey(0))
    solver.step, solver.epoch = 1, 1
    jax_checkpoint.save_package(jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jnp.ndarray) else x, solver.package()), out_path)


def test_pipeline_cli_continues_a_jax_stacked_package(corpus, tmp_path):  # noqa: F811
    exp, ref = tmp_path / "exp", tmp_path / "ref"
    stacked = {"model": {"encoder": {"num_layers": 2, "pipeline": True}}}

    def config(exp_dir, path):
        p = write_config(corpus, exp_dir, path, num_epoch=2)
        with open(p) as f:
            cfg = yaml.safe_load(f)
        cfg["model"]["encoder"].update(stacked["model"]["encoder"])
        with open(p, "w") as f:
            yaml.safe_dump(cfg, f)
        return p

    cfg = config(exp, tmp_path / "c.yaml")
    os.makedirs(exp)
    jax_stacked_package(cfg, str(exp / "last.pkg"))
    shutil.copytree(exp, ref)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "openasr_torch.bin.train", cfg, "--distributed", "--pipeline", "2",
         "--device", "cpu", "--continue-training"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "data 0 of 1, model 0 of 1, pipe 1 of 2" in out.stderr
    got = load_package(str(exp / "last.pkg"))
    port_train.main([config(ref, tmp_path / "r.yaml"), "--device", "cpu", "--continue-training"])
    want = load_package(str(ref / "last.pkg"))
    assert got["solver_state"]["epoch"] == want["solver_state"]["epoch"] == 2
    assert got["solver_state"]["step"] == want["solver_state"]["step"] > 1
    assert "stacked_layers" in got["model"]["components"]["encoder"]["stack"]
    params_close(got["model"]["components"], want["model"]["components"])
    for key in ("mu", "nu"):
        params_close(got["optim_state"][key], want["optim_state"][key], what=key)
