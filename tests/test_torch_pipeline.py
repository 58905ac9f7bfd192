"""GPipe pipeline parallelism of the port against the JAX package, on the
CPU: `openasr_torch/parallel/pipeline.py`, the pipe axis of
`parallel/mesh.py:Grid`, the stacked encoder and `remat`.

The port's ranks run as gloo processes (tests/torch_parallel_ranks.py) on
grids of pp2 (world 2), pp2 x dp2 and pp2 x tp2 (world 4), started once per
module.  The oracles are the JAX package's own (tests/test_pipeline.py):

- `stack_layer_params` / `unstack_layer_params` against the JAX functions
  on the same trees (bit for bit), and their errors;
- the port's `gpipe_apply` at pp2 and pp2 x dp2, M 1 and 4 (and per-stage
  remat), against the JAX `gpipe_apply` on the virtual CPU mesh (pipe 2,
  data 1 or 2): output 1e-5, the stack's gradients rtol 2e-4 / atol 1e-5
  (tests/test_pipeline.py's tolerances), the input's gradient on every
  rank of the pipe group;
- the stacked layout's eval losses against the per-layer one's, in the port
  and in the JAX package, to 1e-5;
- two training steps of the stacked flagship at pp2 x dp2 and pp2 x tp2
  against the port's one process and the JAX solver's single-device
  stacked scan (tests/test_torch_parallel.py's tolerances, which are
  tighter than the JAX test's rtol 2e-4 / 2e-3);
- remat on equals remat off at dropout 0.1, for the per-layer encoder and
  decoder in one process and for the pipeline's stages at pp2 (the port's
  generators replayed in the recompute);
- the grid's coordinates and its layout checks.

Dropout is 0 wherever the port is held to JAX: the pipe's dropout draws are
the port's own (ROADMAP queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openasr_torch.convert import subtree_to_state_dict
from openasr_torch.models import get_model_class
from openasr_torch.models.layers import TrainRNG
from openasr_torch.parallel import Grid
from openasr_torch.parallel.mesh import node_layout, validate_layout
from openasr_torch.parallel.pipeline import (
    microbatch_count,
    stack_layer_params,
    unstack_layer_params,
)
from openasr_tpu.models.layers import TransformerEncoderLayer as JaxLayer
from openasr_tpu.parallel import make_mesh
from openasr_tpu.parallel import pipeline as jax_pipeline

from test_torch_parallel import (
    FLAGSHIP_BATCHES,
    TRAINING,
    check_against_jax,
    flagship_config,
    jax_train,
    jax_twin,
    losses_close,
    params_close,
    port_package,
)
from test_torch_models import small_config
from torch_parallel_ranks import RankPool, train

D, NHEAD, FFN, L = 16, 2, 32, 4
B, T = 8, 12
OUT_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-5


@pytest.fixture(scope="module")
def grids():
    """{"pp2": world 2, "pp2_dp2": world 4, "pp2_tp2": world 4}, each
    started on first use."""
    pools = {}

    def get(layout):
        if layout not in pools:
            world, model = {"pp2": (2, 1), "pp2_dp2": (4, 1), "pp2_tp2": (4, 2)}[layout]
            pools[layout] = RankPool(world, model=model, pipe=2)
        return pools[layout]
    yield get
    for pool in pools.values():
        pool.close()


def layer_trees(seed=0):
    """L per-layer JAX trees of a relu TransformerEncoderLayer(D, NHEAD,
    FFN), as NumPy."""
    module = JaxLayer(D, NHEAD, FFN, 0.0, "relu")
    x, lengths = jnp.zeros((2, T, D)), jnp.full((2,), T, jnp.int32)
    init = jax.jit(lambda key: module.init(key, x, None, True, lengths, False)["params"])
    return {f"layer{i}": jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed + i)))
            for i in range(L)}


def flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


# ------------------------------------------------------------ the package layout

def test_stack_and_unstack_match_jax_and_keep_its_errors():
    params = layer_trees()
    stacked, n = stack_layer_params(params)
    want, n_jax = jax_pipeline.stack_layer_params(params)
    assert n == n_jax == L
    got, want = flat_leaves(stacked), flat_leaves(jax.tree_util.tree_map(np.asarray, want))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    back = unstack_layer_params(stacked, n)
    jax_back = jax_pipeline.unstack_layer_params(jax_pipeline.stack_layer_params(params)[0], n)
    for i in range(L):
        for k, v in flat_leaves(params[f"layer{i}"]).items():
            assert np.array_equal(flat_leaves(back[f"layer{i}"])[k], v)
            assert np.array_equal(flat_leaves(jax_back[f"layer{i}"])[k], v)
    gap = {k: v for k, v in params.items() if k != "layer2"}
    for fn in (stack_layer_params, jax_pipeline.stack_layer_params):
        with pytest.raises(ValueError, match=r"non-contiguous layer indices \[0, 1, 3\]"):
            fn(gap)
        with pytest.raises(ValueError, match="no 'block<i>' layer subtrees"):
            fn(params, prefix="block")


def test_microbatch_rule_and_the_grid_layout(grids):
    """The JAX stack's microbatch pick; rank = p D M + d M + m with its
    groups; a pipe axis on more than one node is refused with the JAX
    message."""
    assert [microbatch_count(b, 8) for b in (82, 81, 8, 3, 1)] == [2, 3, 8, 3, 1]
    assert microbatch_count(12, 4) == 4 and microbatch_count(10, 4) == 2
    for layout, want in (("pp2_dp2", [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]),
                         ("pp2_tp2", [(0, 0, 0), (0, 0, 1), (1, 0, 0), (1, 0, 1)])):
        coords = grids(layout).run("coords")
        assert [c["pdm"] for c in coords] == want
        for c in coords:
            assert sorted(c["sizes"].items()) == sorted(
                {"data": 2 if layout == "pp2_dp2" else 1, "model": 2 if layout == "pp2_tp2"
                 else 1, "pipe": 2}.items())
    assert node_layout(8, 2, pipe=2).shape == (2, 2, 2)
    validate_layout(node_layout(8, 2, 8, pipe=2))
    with pytest.raises(ValueError, match="pipeline-parallel meshes are single-host"):
        validate_layout(node_layout(4, 1, 2, pipe=2))
    with pytest.raises(ValueError, match=r"not divisible by --model-parallel 2 x --pipeline 2"):
        node_layout(6, 2, pipe=2)


# ------------------------------------------------------------ the schedule

@pytest.fixture(scope="module")
def jax_pipe():
    """(spec of the layers and inputs, {(data, M): the JAX gpipe_apply's
    output, stack gradient in the port's names and input gradient}), each
    jitted once."""
    params = layer_trees(seed=11)
    stacked = jax.tree_util.tree_map(jnp.asarray, jax_pipeline.stack_layer_params(params)[0])
    rng = np.random.RandomState(9)
    spec = {"layers": [params[f"layer{i}"] for i in range(L)], "dims": (D, NHEAD, FFN),
            "x": rng.randn(B, T, D).astype(np.float32),
            "lengths": np.linspace(T // 2, T, B).astype(np.int32),
            "cot": rng.randn(B, T, D).astype(np.float32)}
    refs = {}

    def layer_apply(lp, h, aux, rr):
        return JaxLayer(D, NHEAD, FFN, 0.0, "relu").apply(
            {"params": lp}, h, None, True, aux["lengths"], False)

    def get(data, m):
        if (data, m) not in refs:
            mesh = make_mesh(jax.devices("cpu")[:2 * data], model=1, pipe=2)

            def loss(p, x):
                out = jax_pipeline.gpipe_apply(layer_apply, p, x, {"lengths": spec["lengths"]},
                                               mesh, m)
                return jnp.sum(out * spec["cot"]), out

            (_, out), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                            has_aux=True))(stacked, spec["x"])
            layers = unstack_layer_params(jax.tree_util.tree_map(np.asarray, gp), L)
            grads = {f"layer{i}.{k}": v.numpy() for i in range(L)
                     for k, v in subtree_to_state_dict(layers[f"layer{i}"]).items()}
            refs[data, m] = np.asarray(out), grads, np.asarray(gx)
        return refs[data, m]
    return spec, get


@pytest.mark.parametrize("layout,m,remat", [("pp2", 1, False), ("pp2", 4, False),
                                            ("pp2", 4, True), ("pp2_dp2", 1, False),
                                            ("pp2_dp2", 4, False)])
def test_gpipe_matches_jax(grids, jax_pipe, layout, m, remat):
    """Every rank's output rows, its stage's gradients (summed over the data
    group) and the input's gradient (stage 0's, on every rank of the pipe
    group) against the JAX `gpipe_apply`; the hops: M + S - 2 all-to-alls
    each way, two all-reduces (the output and the input's gradient)."""
    spec, get = jax_pipe
    data = 2 if layout == "pp2_dp2" else 1
    out, grads, dx = get(data, m)
    ranks = grids(layout).run("gpipe", dict(spec, m=m, remat=remat))
    held = set()
    for r, res in enumerate(ranks):
        d = (r % data) if data > 1 else 0
        rows = slice(d * B // data, (d + 1) * B // data)
        np.testing.assert_allclose(res["out"], out[rows], rtol=OUT_TOL, atol=OUT_TOL)
        np.testing.assert_allclose(res["dx"], dx[rows], rtol=GRAD_RTOL, atol=GRAD_ATOL)
        for k, v in res["grads"].items():
            np.testing.assert_allclose(v, grads[k], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
        held |= set(res["grads"])
        assert res["calls"] == {"all_to_all": 2 * (m + 2 - 2), "all_reduce": 2}, res["calls"]
    assert held == set(grads)


# ------------------------------------------------------------ the stacked model

def stacked_config(cfg, **encoder):
    return dict(cfg, encoder=dict(cfg["encoder"], pipeline=True, **encoder))


def stacked_package(pkg, cfg):
    from openasr_torch.bin.stack_encoder_pkg import convert_encoder

    comps = dict(pkg["components"], encoder=convert_encoder(pkg["components"]["encoder"], False))
    return dict(pkg, components=comps, configs=cfg)


def test_stacked_layout_equals_per_layer(tmp_path):
    """The same weights in both layouts give the same eval losses, in the
    port (its stacked encoder run layer by layer, without a pipe) and in
    the JAX package (its stacked scan)."""
    from openasr_tpu.solvers import array_fields

    cfg = flagship_config()
    pkg = port_package("conv-ctc-transformer", cfg)
    scfg = stacked_config(cfg)
    spkg = stacked_package(pkg, scfg)
    batch = FLAGSHIP_BATCHES[0]
    arrays = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    losses = {}
    for tag, c, p in (("per-layer", cfg, pkg), ("stacked", scfg, spkg)):
        model = get_model_class("conv-ctc-transformer").create_model(c, device="cpu")
        model.restore(p)
        with torch.no_grad():
            losses[f"port {tag}"] = {k: float(v) for k, v in model.loss(arrays).items()}
        jm = jax_twin("conv-ctc-transformer", c, p)
        out = jax.jit(lambda params, b, jm=jm: jm.loss(params, b, None, train=False))(
            jm.params, array_fields(batch))
        losses[f"jax {tag}"] = {k: float(v) for k, v in out.items()}
    assert "stack" in spkg["components"]["encoder"]
    assert set(model.module.encoder.stack.state_dict()) >= {"layer0.norm1.weight"}
    want = losses["port per-layer"]
    for tag, got in losses.items():
        for k in ("ce_loss", "ctc_loss"):
            assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k])), (tag, k, got, want)


@pytest.fixture(scope="module")
def stacked_flagship(tmp_path_factory):
    """(spec, the JAX single-device stacked run, the port's one-process
    run) of the stacked flagship (2 encoder layers: one a stage) over two
    of FLAGSHIP_BATCHES (SGD)."""
    cfg = stacked_config(flagship_config())
    pkg = stacked_package(port_package("conv-ctc-transformer", flagship_config()), cfg)
    batches = FLAGSHIP_BATCHES[:2]
    training = dict(TRAINING, pipeline_microbatch=4)
    spec = {"model_type": "conv-ctc-transformer", "model_cfg": cfg, "pkg": pkg,
            "training": dict(training, exp_dir=str(tmp_path_factory.mktemp("pp"))),
            "loaders": {"tr": batches}}
    want = jax_train("conv-ctc-transformer", cfg, pkg, training, batches,
                     tmp_path_factory.mktemp("pp_jax"))
    one = train(Grid.single("cpu"), dict(spec, training=dict(spec["training"], zero1=False)))
    return spec, want, one


@pytest.mark.parametrize("layout", ["pp2_dp2", "pp2_tp2"])
def test_stacked_flagship_trains_as_jax_on_the_grid(stacked_flagship, grids, layout):
    """Two SGD steps on every rank against the JAX solver and the port's
    one process (losses, step-1 gradient, parameters): the stages' layers
    and moments gathered into the package's whole stack, the clip's norm
    over the pipe group, the hops on the pipe group."""
    spec, want, one = stacked_flagship
    outs = grids(layout).run("train", spec)
    check_against_jax(outs, want, one)
    for out in outs:
        losses_close(out["losses"], one["losses"])
        params_close(out["pkg"]["model"]["components"], one["pkg"]["model"]["components"])
        assert out["pipe_calls"].get("all_to_all", 0) > 0
    stack = outs[0]["pkg"]["model"]["components"]["encoder"]["stack"]["stacked_layers"]
    assert stack["norm1"]["scale"].shape == (2, 64)


# ------------------------------------------------------------ remat

def remat_run(cfg, remat):
    c = dict(cfg, encoder=dict(cfg["encoder"], remat=remat),
             decoder=dict(cfg["decoder"], remat=remat))
    model = get_model_class("conv-ctc-transformer").create_model(c, device="cpu")
    arrays = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in FLAGSHIP_BATCHES[1].items()}
    rng = TrainRNG(7, "cpu")
    losses = model.loss(arrays, rng, label_smooth=0.1)
    total = losses["ce_loss"] / losses["n_tokens"] + losses["ctc_loss"] / losses["n_seqs"]
    total.backward()
    after = (rng.host.get_state(), rng.device.get_state())
    return float(total.detach()), {n: p.grad for n, p in model.module.named_parameters()}, after


@pytest.mark.parametrize("where", ["one", "pp2"])
def test_remat_equals_no_remat_at_dropout(grids, tmp_path, where):
    """Dropout 0.1 (and SpecAugment off): remat recomputes each layer (one
    process: the per-layer encoder and the decoder) or each stage's
    microbatch (pp2) with the forward's draws, so the loss and the
    gradients equal those without remat, and the generators end where the
    forward left them."""
    cfg = small_config()
    if where == "one":
        a, ga, sa = remat_run(cfg, False)
        b, gb, sb = remat_run(cfg, True)
        assert a == b
        for n, g in ga.items():
            assert torch.equal(g, gb[n]), n
        assert all(torch.equal(x, y) for x, y in zip(sa, sb))
        return
    runs = {}
    for remat in (False, True):
        c = stacked_config(cfg, remat=remat)
        spec = {"model_type": "conv-ctc-transformer", "model_cfg": c, "seed": 3,
                "training": dict(TRAINING, pipeline_microbatch=4, zero1=False,
                                 exp_dir=str(tmp_path / f"remat_{remat}")),
                "loaders": {"tr": FLAGSHIP_BATCHES[:2]}}
        runs[remat] = grids("pp2").run("train", spec)
    for off, on in zip(runs[False], runs[True]):
        assert off["losses"] == on["losses"]
        params_close(on["pkg"]["model"]["components"], off["pkg"]["model"]["components"],
                     0.0, "remat on vs off")
    # the replicated layers drew the same masks on both stages
    for n, v in runs[True][0]["replicated"].items():
        if ".stack." not in n:
            assert np.array_equal(v, runs[True][1]["replicated"][n]), n
