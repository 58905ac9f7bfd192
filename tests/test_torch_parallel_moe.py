"""Expert parallelism and the global MoE auxiliary, on the CPU.

conv-ctc-transformer-moe_test.yaml's model (4 experts, top-2, one MoE
layer) trains 3 solver steps at world 2 (gloo ranks,
tests/torch_parallel_ranks.py), for the topk and expert_choice routers,
against the JAX solver's step on one device: losses and the auxiliary
1e-5, parameters 1e-5 of max(1, |p|), the first step's gradients 1e-5 of
the port's one-process run and 1e-4 of the JAX run (as
tests/test_torch_parallel.py).  The rank slices have different natural
lengths, so the capacity min(ceil(cf T K / E), T) is the reconciled T's.
Each rank holds 2 of the 4 experts (its optimizer state too), the step
all-gathers no table (ZeRO-1's all-gather carries only the replicated
leaves' shards), the package holds the whole tables in the JAX layout.
"""

import numpy as np
import pytest
import yaml

from openasr_torch.parallel import Grid
from openasr_torch.parallel.mesh import zero1_dim

from test_torch_parallel import (
    FLAGSHIP_BATCHES,
    TRAINING,
    check_against_jax,
    first_moment,
    jax_train,
    losses_close,
    port_package,
)
from torch_parallel_ranks import RankPool, train

with open("egs/aishell1/configs/conv-ctc-transformer-moe_test.yaml") as _f:
    MOE_MODEL = yaml.safe_load(_f)["model"]
MOE_MODEL["decoder"]["vocab_size"] = 20
TABLES = ("w1", "b1", "w2", "b2", "w_gate", "b_gate")


@pytest.fixture(scope="module")
def pool2():
    pool = RankPool(2)
    yield pool
    pool.close()


@pytest.mark.parametrize("router", ["topk", "expert_choice"])
def test_expert_parallel_training_matches_jax(pool2, tmp_path, router):
    cfg = {**MOE_MODEL, "encoder": {**MOE_MODEL["encoder"], "moe": {
        **MOE_MODEL["encoder"]["moe"], "router": router}}}
    pkg = port_package("conv-ctc-transformer", cfg)
    training = dict(TRAINING, exp_dir=str(tmp_path))
    spec = {"model_type": "conv-ctc-transformer", "model_cfg": cfg, "pkg": pkg,
            "training": training, "loaders": {"tr": FLAGSHIP_BATCHES}}
    (tmp_path / "jax").mkdir()
    want = jax_train("conv-ctc-transformer", cfg, pkg, training, FLAGSHIP_BATCHES,
                     tmp_path / "jax")
    one = train(Grid.single("cpu"), spec)
    outs = pool2.run("train", spec)
    check_against_jax(outs, want, one)
    if router == "topk":
        assert min(want["aux"]) > 0
    else:
        assert want["aux"] == [0.0, 0.0, 0.0]
    losses_close(outs[0]["aux"], one["aux"])

    full = {n: v.shape for n, v in first_moment(outs[0]["pkg"]["optim_state"]).items()}
    tables = [n for n in full if "moe_ffn" in n and n.split(".")[-1] in TABLES]
    assert tables
    zero1_bytes = 0
    for name, shape in outs[0]["shards"].items():
        if name in tables:
            # this rank's experts: E/2 rows of each table, state too
            assert shape == (full[name][0] // 2,) + tuple(full[name][1:]), name
        elif zero1_dim(full[name], 2) is not None:
            zero1_bytes += 4 * int(np.prod(shape))
    for out in outs:
        calls, nbytes = out["calls"], out["bytes"]
        # the dispatch all-to-all and its mirror, forward and backward
        assert calls["all_to_all"] == 4
        # one all-gather a step, of the ZeRO-1 shards alone: no table
        assert calls["all_gather"] == 1 and nbytes["all_gather"] == zero1_bytes
        # the whole tables in the package, as one process holds them
        for name in tables:
            assert (first_moment(out["pkg"]["optim_state"])[name].shape
                    == first_moment(one["pkg"]["optim_state"])[name].shape)
