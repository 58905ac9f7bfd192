"""Tensor and sequence parallelism of the port against the JAX package, on
the CPU: the flagship on a (data, model) grid of gloo ranks.

The port's ranks run as gloo processes (tests/torch_parallel_ranks.py) on
grids of dp1 x tp2 (world 2) and dp2 x tp2 (world 4), started once per
module; each data row loads its contiguous rows of a global batch trimmed
to their own extents, both ranks of a model group the same rows.  The
JAX package runs on one device, the oracle whose mesh-invariance its own
tests hold (tests/test_tensor_parallel.py, test_sequence_parallel.py: the
`dp4_tp2` mesh trains as `single` does).

The flagship (tests/test_torch_models.py's small conv-ctc-transformer:
d_model 32, 2 heads, so that tp2 leaves one head a rank; dropout 0)
trains 3 solver steps with sequence parallelism on and off, ZeRO-1 on and
off, against the JAX solver's `_train_step` and the port's one-process
run, to tests/test_torch_parallel.py's tolerances: losses 1e-5, step-1
gradients 1e-5 of each leaf's scale (1e-4 against JAX), parameters after
3 steps 1e-5 of scale.  Sequence parallelism on equals off.  An
accumulation group of an even-T' and an odd-T' batch (the encoder's and
decoder's sites T-sharded in one micro-batch and not in the other)
equals the one-process run and the JAX solver's accumulation.  At dropout 0.1 every
replicated parameter is bitwise equal across a model group after 3 steps
(the element-wise masks drawn at the global shape from a generator the
model group shares).  The units: the rule table against
`param_shardings` on the flagship, CIF and MoE trees, the
sequence-parallel decision against `shard_time`, the (data, model) dropout
seed rule against the JAX flash kernel on a dp2 x tp2 mesh, the layout
checks and the CLI's exits.
"""

import numpy as np
import pytest
import torch

from openasr_torch.parallel import DataGroup, Grid, partition_seed
from openasr_torch.parallel.mesh import node_layout, shard_id, validate_layout
from openasr_torch.parallel.tensor_parallel import TensorParallel, param_specs

from test_torch_parallel import (
    FLAGSHIP_BATCHES,
    TRAINING,
    check_against_jax,
    feature_batch,
    first_moment,
    flagship_config,
    grads_close,
    jax_train,
    losses_close,
    moments,
    params_close,
    port_package,
)
from torch_parallel_ranks import RankPool, train

SP_TOL = 1e-6


@pytest.fixture(scope="module")
def grids():
    """{"dp1_tp2": a pool of world 2, "dp2_tp2": one of world 4}, each
    started on first use."""
    pools = {}

    def get(layout):
        if layout not in pools:
            world = {"dp1_tp2": 2, "dp2_tp2": 4}[layout]
            pools[layout] = RankPool(world, model=2)
        return pools[layout]
    yield get
    for pool in pools.values():
        pool.close()


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """(spec, the JAX run, the port's one-process run) of the flagship over
    FLAGSHIP_BATCHES (SGD)."""
    cfg = flagship_config()
    pkg = port_package("conv-ctc-transformer", cfg)
    spec = {"model_type": "conv-ctc-transformer", "model_cfg": cfg, "pkg": pkg,
            "training": dict(TRAINING, exp_dir=str(tmp_path_factory.mktemp("tp"))),
            "loaders": {"tr": FLAGSHIP_BATCHES}}
    want = jax_train("conv-ctc-transformer", cfg, pkg, TRAINING, FLAGSHIP_BATCHES,
                     tmp_path_factory.mktemp("tp_jax"))
    one = train(Grid.single("cpu"), dict(spec, training=dict(spec["training"], zero1=False)))
    return spec, want, one


def with_training(spec, **training):
    return dict(spec, training=dict(spec["training"], **training))


@pytest.mark.parametrize("layout", ["dp1_tp2", "dp2_tp2"])
def test_flagship_matches_jax_on_the_grid(flagship, grids, layout):
    """Every rank's run, sequence parallelism on, against the JAX and
    one-process runs; at dp2 x tp2 ZeRO-1 on equals off and shards the
    local shards (never the dimension the model axis took)."""
    spec, want, one = flagship
    pool = grids(layout)
    runs = {z: pool.run("train", with_training(spec, zero1=z)) for z in (False, True)}
    for outs in runs.values():
        check_against_jax(outs, want, one)
        # the sites were T-sharded: reduce-scatters on the model group
        assert outs[0]["model_calls"].get("reduce_scatter", 0) > 0
    off, on = runs[False][0], runs[True][0]
    params_close(on["pkg"]["model"]["components"], off["pkg"]["model"]["components"],
                 SP_TOL, "zero1 on vs off")
    for key, value in moments(off["pkg"]["optim_state"]).items():
        grads_close(on["pkg"]["optim_state"][key], value)
    full = {n: v.shape for n, v in first_moment(off["pkg"]["optim_state"]).items()}
    for out in runs[True]:
        for name, shape in out["shards"].items():
            assert len(shape) == len(full[name]), name
            if layout == "dp1_tp2":
                continue
            # a model-sharded leaf's ZeRO-1 shard halves another dimension
            taken = [i for i, (a, b) in enumerate(zip(shape, full[name])) if a != b]
            assert len(taken) <= 2, (name, shape, full[name])


@pytest.mark.parametrize("layout", ["dp1_tp2", "dp2_tp2"])
def test_sequence_parallel_train_parity_on_off(flagship, grids, layout):
    """`training.sequence_parallel` on and off train alike; off sends no
    reduce-scatter on the model group (plain tensor parallelism)."""
    spec, _, one = flagship
    pool = grids(layout)
    on = pool.run("train", with_training(spec, sequence_parallel=True))
    off = pool.run("train", with_training(spec, sequence_parallel=False))
    assert "reduce_scatter" not in off[0]["model_calls"]
    assert on[0]["model_calls"]["reduce_scatter"] > 0
    for a, b in zip(on, off):
        losses_close(a["losses"], b["losses"])
        params_close(a["pkg"]["model"]["components"], b["pkg"]["model"]["components"], SP_TOL,
                     "sequence parallelism on vs off")
        grads_close(b["g1"], one["g1"])


def test_even_and_odd_t_in_one_accumulation_group(flagship, grids, tmp_path):
    """Two micro-batches an update: the first's T' and U are even (its
    sites T-sharded), the second's odd (plain tensor parallelism), so a
    LayerNorm's gradient is partial in one and whole in the other; both
    grids equal the one-process run and the JAX solver's accumulation.
    The vocabulary is odd (21): its rows split 11 + 10."""
    from openasr_torch.models import get_model_class

    from test_torch_models import small_config

    cfg = small_config(vocab=21)
    for sec in ("encoder", "decoder"):
        cfg[sec]["dropout_rate"] = 0.0
    spec = dict(flagship[0], model_cfg=cfg, pkg=port_package("conv-ctc-transformer", cfg))
    model = get_model_class("conv-ctc-transformer").create_model(cfg, device="cpu")
    even, odd = feature_batch(20, (41, 37, 19, 60)), feature_batch(21, (45, 30, 56, 22))
    # the even batch's decoder sites shard too (U 6; the first row's last
    # label cut)
    even = {k: (v[:, :6] if k in ("ids", "labels", "paddings") else v) for k, v in even.items()}
    t = [int(model.module.encoder_lengths(np.asarray([b["feats"].shape[1]]))[0])
         for b in (even, odd)]
    assert t[0] % 2 == 0 and t[1] % 2 == 1, t
    assert even["ids"].shape[1] == 6 and odd["ids"].shape[1] % 2 == 1
    run = dict(spec, loaders={"tr": [even, odd, odd, even]})
    run = with_training(run, accumulate_grad_batch=2)
    one = train(Grid.single("cpu"), with_training(run, zero1=False))
    want = jax_train("conv-ctc-transformer", cfg, spec["pkg"],
                     dict(TRAINING, accumulate_grad_batch=2), run["loaders"]["tr"], tmp_path)
    for layout in ("dp1_tp2", "dp2_tp2"):
        outs = grids(layout).run("train", run)
        assert [out["shards"]["decoder.emb.weight"][0] for out in outs[:2]] == [11, 10]
        check_against_jax(outs, want, one)
        for out in outs:
            assert out["step"] == one["step"] == 2
            losses_close(out["losses"], one["losses"])
            params_close(out["pkg"]["model"]["components"], one["pkg"]["model"]["components"])


def test_dropout_keeps_a_model_group_replicated(grids, tmp_path):
    """At dropout 0.1 (residual, FFN, embedding and attention dropout) the
    replicated parameters stay bitwise equal across a model group after 3
    steps, and the model-sharded ones differ."""
    cfg = flagship_config()
    for sec in ("encoder", "decoder"):
        cfg[sec]["dropout_rate"] = 0.1
    spec = {"model_type": "conv-ctc-transformer", "model_cfg": cfg,
            "pkg": port_package("conv-ctc-transformer", cfg),
            "training": dict(TRAINING, exp_dir=str(tmp_path)), "loaders": {"tr": FLAGSHIP_BATCHES}}
    outs = grids("dp2_tp2").run("train", spec)
    for d in range(2):
        a, b = outs[2 * d]["replicated"], outs[2 * d + 1]["replicated"]
        assert set(a) == set(b) and len(a) > 10
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    # dropout bit: the run differs from a dropout-0 one
    plain = grids("dp2_tp2").run("train", dict(spec, model_cfg=flagship_config(),
                                               pkg=port_package("conv-ctc-transformer",
                                                                flagship_config())))
    assert abs(plain[0]["losses"][1] - outs[0]["losses"][1]) > 1e-4


# ------------------------------------------------------------ units

def _jax_model_paths(model_type, cfg):
    """The JAX leaf paths of the model tree (from a port package) that
    `param_shardings` shards over the model axis, and all of them."""
    import jax

    from openasr_tpu.parallel import make_mesh
    from openasr_tpu.parallel.mesh import MODEL_AXIS, param_shardings

    params = port_package(model_type, cfg)["components"]
    mesh = make_mesh(jax.devices("cpu")[:8], model=2)
    flat = jax.tree_util.tree_flatten_with_path(param_shardings(params, mesh))[0]
    paths = {"/".join(str(k.key) for k in path): s.spec for path, s in flat}
    return {p for p, spec in paths.items() if MODEL_AXIS in tuple(spec)}, set(paths)


def _jax_path(module, name):
    """The JAX leaf path of port parameter `name` (the weight bridge's
    names: Linear weight -> kernel, Embedding weight -> embedding)."""
    owner, leaf = name.rsplit(".", 1)
    if leaf == "weight":
        leaf = "embedding" if isinstance(module.get_submodule(owner), torch.nn.Embedding) \
            else "kernel"
    return f"{owner.replace('.', '/')}/{leaf}"


@pytest.mark.parametrize("family", ["flagship", "cif", "moe"])
def test_param_shardings_assign_model_axis(family):
    """The rule table shards exactly the leaves that the JAX package's
    `param_shardings` shards over the model axis (attention, FFN,
    embeddings, the MoE tables' F), through the bridge's names: a leaf
    renamed on either side fails it."""
    from openasr_torch.models import get_model_class

    from test_torch_cif import cif_config
    from test_torch_parallel_moe import MOE_MODEL

    model_type, cfg = {"flagship": ("conv-ctc-transformer", flagship_config()),
                       "cif": ("ctc_cif", cif_config("ctc_cif")),
                       "moe": ("conv-ctc-transformer", MOE_MODEL)}[family]
    want, every = _jax_model_paths(model_type, cfg)
    module = get_model_class(model_type).create_model(cfg, device="cpu").module
    specs = param_specs(module)
    got = {_jax_path(module, n) for n in specs}
    assert got <= every, sorted(got - every)
    assert got == want, (sorted(got - want), sorted(want - got))
    assert any("emb" in p for p in got) and any("linear1" in p or "w1" in p for p in got)
    if family == "moe":
        assert {"w1", "w2", "b1", "w_gate"} <= {p.rsplit("/", 1)[1] for p in got}


def test_sequence_parallel_decision_matches_shard_time():
    """`shards_time` against `test_shard_time_mechanism`'s cases: T 16
    shards over tp 2, T 15 and T 1 do not; off, or a model size of 1,
    never."""
    import jax

    from openasr_tpu.parallel import make_mesh
    from openasr_tpu.parallel.mesh import MODEL_AXIS, sequence_parallel, shard_time

    mesh = make_mesh(jax.devices("cpu")[:8], model=2)
    tp = TensorParallel(DataGroup(0, 2), True)
    for t in (16, 15, 1, 2, 3):
        with sequence_parallel(mesh):
            out = jax.jit(lambda a: shard_time(a))(np.ones((8, t, 32), np.float32))
        sharded = MODEL_AXIS in tuple(getattr(out.sharding, "spec", ()) or ())
        assert tp.shards_time(t) == sharded, t
    assert not TensorParallel(DataGroup(0, 2), False).shards_time(16)
    assert not TensorParallel(DataGroup.single(), True).shards_time(16)


def test_dropout_seed_rule_matches_the_jax_kernel_on_a_grid():
    """The JAX flash kernel (interpret mode) on a dp2 x tp2 mesh folds the
    shard's (data, model) position into the seed; the port's rank (d, m)
    with `partition_seed(seed, shard_id(d, m, 2))` draws the same masks for
    its rows and heads."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import openasr_tpu.kernels as kernels
    from openasr_torch.kernels.flash_attention import flash_attention as port_flash
    from openasr_tpu.kernels.flash_attention import flash_attention

    b, t, h, d, rate, seed = 4, 128, 2, 64, 0.5, 7
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(3))
    lens = np.asarray([128, 100, 77, 128], np.int32)
    mesh = Mesh(np.array(jax.devices("cpu")[:4]).reshape(2, 2), ("data", "model"))
    heads = NamedSharding(mesh, P("data", None, "model", None))
    prev = kernels.spmd_partitioning_enabled()
    kernels.set_spmd_partitioning(True)
    try:
        f = jax.jit(lambda q, k, v, l: flash_attention(
            q, k, v, kv_lengths=l, dropout_rate=rate,
            dropout_seed=jnp.asarray([seed], jnp.uint32), interpret=True))
        want = np.asarray(f(*[jax.device_put(x, heads) for x in (q, k, v)],
                            jax.device_put(lens, NamedSharding(mesh, P("data")))))
    finally:
        kernels.set_spmd_partitioning(prev)
    for di in range(2):
        for m in range(2):
            rows, hs = slice(2 * di, 2 * di + 2), slice(m, m + 1)
            got, _ = port_flash(*(torch.from_numpy(np.ascontiguousarray(x[rows, :, hs]))
                                  for x in (q, k, v)),
                                kv_lengths=torch.from_numpy(lens[rows]), dropout_rate=rate,
                                dropout_seed=partition_seed(seed, shard_id(di, m, 2)))
            np.testing.assert_allclose(got.numpy(), want[rows, :, hs], rtol=1e-5, atol=1e-5)
    # a model size of 1 (the heads not sharded) is the data axis's rule
    assert shard_id(3, 0, 1) == 3 and partition_seed(seed, shard_id(0, 0, 2)) == seed
    assert shard_id(1, 1, 2) == (0x9E3779B9 + 1) % 2 ** 32


def test_layout_checks_and_the_cli_exits(tmp_path):
    """The grid's layout checks keep the JAX messages (a torchrun node for
    a JAX host); `--model-parallel` without `--distributed` names torchrun;
    `--pipeline` without `encoder.pipeline` exits with the JAX CLI's
    message."""
    from openasr_torch.bin import train as port_train

    validate_layout(node_layout(8, 2, 4))
    assert node_layout(4, 2).tolist() == [[0, 0], [0, 0]]
    with pytest.raises(ValueError, match="model-parallel groups may not span hosts"):
        validate_layout(node_layout(4, 2, 1))
    with pytest.raises(ValueError, match="model-parallel groups may not span hosts"):
        validate_layout(node_layout(6, 3, 2))
    with pytest.raises(ValueError, match="not divisible by --model-parallel 3"):
        node_layout(4, 3)
    cfg = tmp_path / "c.yaml"
    cfg.write_text(open("egs/aishell1/configs/conv-ctc-transformer-test.yaml").read())
    with pytest.raises(SystemExit, match="needs --distributed.*torch.distributed.run"):
        port_train.main([str(cfg), "--model-parallel", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--pipeline requires the stacked layer layout: set "
                                         "encoder.pipeline: true"):
        port_train.main([str(cfg), "--pipeline", "2", "--distributed", "--device", "cpu"])


@pytest.mark.parametrize("first,then", [("dp2_tp2", "one"), ("dp2_tp2", "dp1_tp2"),
                                        ("one", "dp2_tp2"), ("dp1_tp2", "dp2_tp2")])
def test_packages_continue_across_grids(flagship, grids, first, then):
    """A package written on one grid continues on another (1 x 1, 1 x 2,
    2 x 2, both ways): the restored state packages back to itself exactly,
    and the next steps equal those of a continuation on the first grid."""
    spec, _, _ = flagship
    spec = dict(spec, loaders={"tr": FLAGSHIP_BATCHES[:2]})

    def run(layout, spec):
        if layout == "one":
            return train(Grid.single("cpu"), spec)
        return grids(layout).run("train", spec)[0]

    pkg = run(first, spec)["pkg"]
    cont = dict(spec, pkg=pkg["model"], restore=pkg, loaders={"tr": FLAGSHIP_BATCHES[2:]})
    same = run(then, dict(cont, loaders={"tr": []}))["pkg"]
    for key, value in moments(pkg["optim_state"]).items():
        for name, v in value.items():
            np.testing.assert_array_equal(same["optim_state"][key][name], v, err_msg=name)
    params_close(same["model"]["components"], pkg["model"]["components"], 0.0, "restored")
    got, want = run(then, cont), run(first, cont)
    losses_close(got["losses"], want["losses"])
    params_close(got["pkg"]["model"]["components"], want["pkg"]["model"]["components"])
