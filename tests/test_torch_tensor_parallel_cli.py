"""`--model-parallel` through the train CLI, on the CPU over gloo.

`python -m torch.distributed.run --standalone --nproc-per-node 2 -m
openasr_torch.bin.train <config> --distributed --model-parallel 2 --device
cpu` trains egs/aishell1/configs/conv-ctc-transformer-test.yaml (d_model
32, 2 heads: one a rank) on the jax-free mini corpus at dp1 x tp2: both
ranks load every row of the config's batch plan.  Its last.pkg (rank 0's,
gathered over the model group) equals, to 1e-5 of max(1, |x|), the package
of one process training the same batch plan, loads in the JAX package,
and continues in one process through `--continue-training`.
"""

import os
import subprocess
import sys

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openasr_torch.bin import train as port_train
from openasr_torch.utils.checkpoint import load_package
from openasr_tpu.models import get_model_class as jax_model_class
from openasr_tpu.utils.checkpoint import load_package as jax_load_package

from test_torch_parallel import params_close
from test_torch_parallel_cli import ROOT, corpus, one_process, write_config  # noqa: F401


def test_model_parallel_cli_equals_one_process_and_continues(corpus, tmp_path):  # noqa: F811
    exp = tmp_path / "exp"
    cfg = write_config(corpus, exp, tmp_path / "c.yaml")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "openasr_torch.bin.train", cfg, "--distributed", "--model-parallel", "2",
         "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "data 0 of 1, model 1 of 2" in out.stderr
    got = load_package(str(exp / "last.pkg"))
    ref = one_process(write_config(corpus, tmp_path / "ref", tmp_path / "r.yaml"), ndata=1)
    assert got["solver_state"]["step"] == ref.step >= 3
    want = ref.package()
    params_close(got["model"]["components"], want["model"]["components"])
    for key in ("mu", "nu"):
        params_close(got["optim_state"][key], want["optim_state"][key], what=key)

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
