"""`--distributed` through the train CLI, on the CPU over gloo.

`python -m torch.distributed.run --standalone --nproc-per-node 2 -m
openasr_torch.bin.train <config> --distributed --device cpu` trains
egs/aishell1/configs/conv-ctc-transformer-test.yaml one epoch on the
jax-free mini corpus: every rank builds the batch plan of twice the
config's budget (divisible by 2) and loads its rows.  Its last.pkg (rank
0's) equals, to 1e-5 of max(1, |x|), the package of one process training
the same global batch plan (the loaders of `build_loaders(ndata=2)`, world
1), loads in the JAX package, and continues at world 1 through
`--continue-training`.
"""

import json
import os
import subprocess
import sys

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from openasr_torch.bin import train as port_train
from openasr_torch.config import load_config
from openasr_torch.data.tokenizer import CharTokenizer
from openasr_torch.models import get_model_class
from openasr_torch.solvers import get_solver_class
from openasr_torch.utils.checkpoint import load_package
from openasr_tpu.models import get_model_class as jax_model_class
from openasr_tpu.utils.checkpoint import load_package as jax_load_package

from test_torch_parallel import params_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_YAML = os.path.join(ROOT, "egs", "aishell1", "configs", "conv-ctc-transformer-test.yaml")


def write_config(corpus, exp, path, **training):
    with open(TEST_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(trainset=os.path.join(corpus, "train.json"),
                       devset=os.path.join(corpus, "dev.json"),
                       vocab_path=os.path.join(corpus, "chars.txt"), fetchworker_num=1)
    cfg["training"].update({"exp_dir": str(exp), "print_inteval": 1, "num_epoch": 1,
                            "adam_mu_dtype": "float32", **training})
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def one_process(cfg_path, ndata):
    """The CLI's training in this process over the batch plan of `ndata`
    ranks' global budget."""
    config = load_config(cfg_path)
    data, training, model_cfg = config["data"], config["training"], config["model"]
    tokenizer = CharTokenizer(data["vocab_path"], add_blk=model_cfg.get("add_blk", False))
    model_cfg["decoder"]["vocab_size"] = tokenizer.unit_num()
    tr, cv = port_train.build_loaders(data, training, model_cfg, tokenizer, ndata=ndata)
    model = get_model_class(model_cfg["type"]).create_model(
        model_cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    solver = get_solver_class(model_cfg["type"])(model, training, tr, cv, device="cpu")
    solver.train()
    return solver


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mini"))
    subprocess.run([sys.executable, "-m", "openasr_torch.bin.gen_mini_corpus", "--out", out,
                    "--num_utts", "24"], check=True, cwd=ROOT, capture_output=True)
    return out


def test_distributed_cli_at_world_2_equals_one_process_and_continues(corpus, tmp_path):
    exp = tmp_path / "exp"
    cfg = write_config(corpus, exp, tmp_path / "c.yaml")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "openasr_torch.bin.train", cfg, "--distributed", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "rank 1 of 2 on cpu (gloo)" in out.stderr
    got = load_package(str(exp / "last.pkg"))
    ref = one_process(write_config(corpus, tmp_path / "ref", tmp_path / "r.yaml"), ndata=2)
    assert got["solver_state"]["step"] == ref.step >= 3
    want = ref.package()
    params_close(got["model"]["components"], want["model"]["components"])
    for key in ("mu", "nu"):
        params_close(got["optim_state"][key], want["optim_state"][key], what=key)
    rows = [json.loads(line) for line in open(exp / "metrics.jsonl")]
    assert [r["step"] for r in rows if r["phase"] == "train"] == list(range(1, ref.step + 1))

    # the JAX package loads it as its own
    pkg = jax_load_package(str(exp / "last.pkg"))
    params = jax.tree_util.tree_map(jnp.asarray, pkg["model"]["components"])
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn.Module, "init", lambda self, *a, **k: {"params": params})
        jax_model = jax_model_class("conv-ctc-transformer").create_model(pkg["model"]["configs"])
    jax_model.restore(pkg["model"])

    # and one process continues it
    cont = write_config(corpus, exp, tmp_path / "c2.yaml", num_epoch=2)
    port_train.main([cont, "--device", "cpu", "--continue-training"])
    again = load_package(str(exp / "last.pkg"))
    assert again["solver_state"]["epoch"] == 2
    assert again["solver_state"]["step"] > got["solver_state"]["step"]
    assert all(np.isfinite(v) for v in again["solver_state"]["tr_loss"])
