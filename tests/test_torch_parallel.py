"""Data parallelism of the port against the JAX package, on the CPU.

The port's ranks run as gloo processes (tests/torch_parallel_ranks.py,
started once per module at world 2 and 4); the JAX package runs on one
device, the oracle whose mesh-invariance its own tests hold
(tests/test_tensor_parallel.py, test_zero1.py, test_multihost.py).  Each
rank loads its contiguous rows of a global batch trimmed to their own
extents, so that a rank that did not pad to the cross-rank shapes would
compute otherwise.  Dropout is 0 (the dropout draws are per rank, as the
JAX kernels' are under their partition rule).

The flagship (tests/test_torch_models.py's small conv-ctc-transformer,
dropout 0) trains 3 solver steps at world 2 and 4, ZeRO-1 on and off,
against the JAX solver's `_train_step`: losses 1e-5 relative, parameters
1e-5 of max(1, |p|), and the first step's gradients (read as the
optimizer's first moment after one step: SGD's trace, the clipped
gradient; Adam's mu, (1 - b1) times it, f32) 1e-5 relative to the port's
one-process run and 1e-4 to the JAX run (the port's one-process gradients
sit up to 2.1e-5 off the JAX package's here, as
tests/test_torch_train_model.py allows 1e-4).  The runs use SGD with
momentum at a constant lr of 0.02 (`TRAINING`), so that 3 steps move the
weights by far more than the tolerance and the parameters are linear in
the gradients; Adam, whose first updates are +-lr wherever a gradient is
rounding noise about 0 (the attention key biases), is held by its
moments (`ADAM`, the fused clip + Adam at its warm-up rate).  ZeRO-1 on
equals off, parameters to 1e-6 and moments to 1e-5 of their scale, its
shards follow `zero1_sharding`'s rule.
With SpecAugment on (its draws the port's own), world 2 equals the port's
one-process run.  The units: the
shard rule, the dropout seed rule against the JAX kernel on a 2-device
data mesh, `reconcile_batch` against `_shard_batch_multihost`, the
loader's rows against the JAX loader's, the layout checks, one-sided
preemption and packages continued across world sizes.
"""

import os
import pickle

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openasr_torch.convert import jax_optim_state_to_port
from openasr_torch.data.collate import gen_causal_targets
from openasr_torch.parallel import (
    DataGroup,
    Grid,
    all_gather_host,
    init_distributed,
    partition_seed,
)
from openasr_torch.parallel.mesh import rand_rows, validate_layout, zero1_dim
from openasr_torch.utils.checkpoint import load_package
from openasr_tpu.config import Config
from openasr_tpu.models import get_model_class as jax_model_class
from openasr_tpu.parallel import make_mesh, shard_batch
from openasr_tpu.solvers import array_fields
from openasr_tpu.solvers import get_solver_class as jax_solver_class

from test_torch_models import small_config
from torch_parallel_ranks import RankPool, natural, rows, train

LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5
GRAD_RTOL = 1e-5
JAX_GRAD_RTOL = 1e-4
ZERO1_TOL = 1e-6
TRAINING = {"num_epoch": 1, "print_inteval": 100, "accumulate_grad_batch": 1, "init_lr": 0.02,
            "optimtype": "sgd", "grad_max_norm": 5.0, "label_smooth": 0.1, "lambda_ctc": 0.5,
            "lr_scheduler": {"type": "linear", "x0": 0, "y0": 1.0, "x1": 1, "y1": 1.0}}
ADAM = dict(TRAINING, optimtype="adam", init_lr=1e-3, adam_mu_dtype="float32",
            lr_scheduler={"type": "warmup_transformer", "warmup_step": 20, "d_model": 64})


@pytest.fixture(scope="module")
def pool2():
    pool = RankPool(2)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def pool4():
    pool = RankPool(4)
    yield pool
    pool.close()


# ------------------------------------------------------------ helpers

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float64)}


def close(got, want, rtol, what, floor=1.0):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = max(float(np.abs(want).max()) if want.size else 0.0, floor)
    assert err <= rtol * scale, f"{what}: {err:.3g} > {rtol} x {scale:.3g}"


def params_close(got_pkg, want, rtol=PARAM_TOL, what="params"):
    got = flat(got_pkg)
    want = flat(want)
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for name in want:
        close(got[name], want[name], rtol, f"{what} {name}")


def grads_close(got: dict, want: dict, rtol=GRAD_RTOL):
    """Per leaf, relative to its largest magnitude or a tenth of the
    largest of any leaf (the attention k-biases' gradients are rounding
    noise about an exact 0)."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    floor = 0.1 * max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name, w in want.items():
        close(np.asarray(got[name], np.float64), np.asarray(w, np.float64), rtol,
              f"gradient {name}", floor)


def losses_close(got, want, rtol=LOSS_RTOL):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) <= rtol * max(abs(b), 1.0), (i, a, b)


def moments(state: dict) -> dict:
    """The per-parameter moments of an optimizer `state_dict` (`trace`, or
    `mu` and `nu`)."""
    return {k: v for k, v in state.items() if k in ("trace", "mu", "nu")}


def first_moment(state: dict) -> dict:
    return state["trace"] if "trace" in state else state["mu"]


def jax_twin(model_type, cfg, pkg):
    """The JAX model of `cfg` holding a port package's weights (and
    statistics), without flax's eager init."""
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, pkg["components"])}
    if pkg.get("batch_stats") is not None:
        variables["batch_stats"] = jax.tree_util.tree_map(jnp.asarray, pkg["batch_stats"])
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn.Module, "init", lambda self, *a, **k: variables)
        return jax_model_class(model_type).create_model(cfg)


def jax_train(model_type, cfg, pkg, training, batches, tmp):
    """The JAX solver's jitted step on one device over the global batches
    (at `accumulate_grad_batch` above 1, its accumulation protocol, as its
    epoch loop runs it: a micro-batch a batch, the summed gradients applied
    every that many and at the last): {losses (a batch each), aux (the MoE
    auxiliaries), g1 (the first moment after step 1, in the port's names),
    params, stats (the final batch_stats)}."""
    model = jax_twin(model_type, cfg, pkg)
    mesh = make_mesh(jax.devices("cpu")[:1])
    solver = jax_solver_class(model_type)(model, Config(dict(training, exp_dir=str(tmp))),
                                          [], [], mesh=mesh)
    params, opt = model.params, solver.opt_state
    every = int(training.get("accumulate_grad_batch", 1))
    cur = solver._accum_begin() if every > 1 else None
    losses, aux, g1 = [], [], None
    for i, b in enumerate(batches):
        arrays, key = shard_batch(array_fields(b), mesh), jax.random.PRNGKey(i)
        applied = (i + 1) % every == 0 or i == len(batches) - 1
        if cur is None:
            params, opt, loss, parts = solver._train_step(params, opt, arrays, key)
        else:
            loss, parts = solver._accum_micro(cur, params, arrays, key)
            params = solver._accum_maybe_apply(cur, params, applied)
            opt = solver.opt_state
        losses.append(float(loss))
        aux.append(float(parts.get("moe_aux_loss", 0.0)))
        if applied and g1 is None:
            path = os.path.join(str(tmp), "state.pkg")
            with open(path, "wb") as f:
                pickle.dump({"optim_state": jax.tree_util.tree_map(np.asarray, opt)}, f)
            state = load_package(path)["optim_state"]
            g1 = first_moment(jax_optim_state_to_port(model_type, state, model.configs))
    stats = model.batch_stats
    return {"losses": losses, "aux": aux, "g1": g1,
            "params": jax.tree_util.tree_map(np.asarray, params),
            "stats": None if stats is None else jax.tree_util.tree_map(np.asarray, stats)}


def check_against_jax(outs, want, one):
    """Every rank's run against the JAX one: losses, first-step gradients
    (and against the port's one-process run `one`), parameters (and running
    statistics)."""
    for out in outs:
        losses_close(out["losses"], want["losses"])
        losses_close(out["aux"], want["aux"])
        grads_close(out["g1"], one["g1"])
        grads_close(out["g1"], want["g1"], JAX_GRAD_RTOL)
        params_close(out["pkg"]["model"]["components"], want["params"])
        if want["stats"] is not None:
            params_close(out["pkg"]["model"]["batch_stats"], want["stats"], what="batch_stats")


def port_package(model_type, cfg, seed=1):
    from openasr_torch.models import get_model_class

    return get_model_class(model_type).create_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed)).package()


# ------------------------------------------------------------ the flagship

def flagship_config(spec_aug=None):
    cfg = small_config()
    for sec in ("encoder", "decoder"):
        cfg[sec]["dropout_rate"] = 0.0
    if spec_aug:
        cfg["signal"] = {"feature_type": "offline", "spec_aug": spec_aug}
    return cfg


def feature_batch(seed, lengths, vocab=20, dim=20):
    """A global batch at its natural extents: features [B, max(lengths),
    dim], targets with <sos>/<eos>, of 6 tokens in the first row and 1-5 in
    the others (the batches of one length list share their global shapes,
    so that the JAX reference compiles once)."""
    rng = np.random.RandomState(seed)
    b = len(lengths)
    feats = np.zeros((b, max(lengths), dim), np.float32)
    for i, n in enumerate(lengths):
        feats[i, :n] = rng.randn(n, dim)
    toks = [list(rng.randint(4, vocab, size=6 if i == 0 else rng.randint(1, 6)))
            for i in range(b)]
    ids, labels, paddings = gen_causal_targets(toks, add_eos=True, max_len=8)
    return natural({"feats": feats, "feat_lengths": np.asarray(lengths, np.int32), "ids": ids,
                    "labels": labels, "paddings": paddings})


FLAGSHIP_BATCHES = [feature_batch(i, lens) for i, lens in enumerate(
    [(41, 37, 19, 60), (30, 60, 44, 12), (25, 26, 60, 33)])]


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """optimizer -> (spec, the JAX run, the port's one-process run) of the
    flagship over FLAGSHIP_BATCHES, made on first use."""
    cfg = flagship_config()
    pkg = port_package("conv-ctc-transformer", cfg)
    runs = {}

    def get(opt):
        if opt not in runs:
            training = {"sgd": TRAINING, "adam": ADAM}[opt]
            spec = {"model_type": "conv-ctc-transformer", "model_cfg": cfg, "pkg": pkg,
                    "training": dict(training, exp_dir=str(tmp_path_factory.mktemp(opt))),
                    "loaders": {"tr": FLAGSHIP_BATCHES}}
            want = jax_train("conv-ctc-transformer", cfg, pkg, training, FLAGSHIP_BATCHES,
                             tmp_path_factory.mktemp(f"{opt}_jax"))
            runs[opt] = spec, want, train(Grid.single("cpu"), dict(spec, training=dict(
                spec["training"], zero1=False)))
        return runs[opt]
    return get


@pytest.mark.parametrize("world", [2, 4])
def test_flagship_matches_jax_with_zero1_on_and_off(flagship, pool2, pool4, world):
    check_flagship(flagship("sgd"), {2: pool2, 4: pool4}[world], world)


@pytest.mark.parametrize("world", [2, 4])
def test_flagship_adam_moments_match_jax_with_zero1_on_and_off(flagship, pool2, pool4, world):
    check_flagship(flagship("adam"), {2: pool2, 4: pool4}[world], world)


def check_flagship(run, pool, world):
    """The flagship's ranks at `world`, ZeRO-1 off and on, against the JAX
    and one-process runs `run`, and on against off."""
    spec, want, one = run
    runs = {z: pool.run("train", dict(spec, training=dict(spec["training"], zero1=z)))
            for z in (False, True)}
    for z, outs in runs.items():
        check_against_jax(outs, want, one)
    off, on = runs[False][0], runs[True][0]
    params_close(on["pkg"]["model"]["components"], off["pkg"]["model"]["components"],
                 ZERO1_TOL, "zero1 on vs off")
    # the moments are gradients: to GRAD_RTOL of their scale (the norm
    # and the reduction sum in another order)
    for key, value in moments(off["pkg"]["optim_state"]).items():
        grads_close(on["pkg"]["optim_state"][key], value)
    # ZeRO-1's shards: the largest dimension that the world size divides
    full = {n: v.shape for n, v in first_moment(off["pkg"]["optim_state"]).items()}
    for rank, out in enumerate(runs[True]):
        for name, shape in out["shards"].items():
            d = zero1_dim(full[name], world)
            want_shape = list(full[name])
            if d is not None:
                want_shape[d] //= world
            assert tuple(want_shape) == shape, (rank, name, shape)
    # the step's collectives: the normalizers and one bucket of gradients
    # (off); the bucket of replicated leaves, one reduce-scatter and one
    # all-gather (on)
    assert off["calls"] == {"all_reduce": 2}
    assert on["calls"]["reduce_scatter"] == 1 and on["calls"]["all_gather"] == 1


def test_spec_aug_draws_are_the_one_process_runs(pool2, tmp_path):
    """SpecAugment on: rank r's rows take the draws of the one-process run
    (one draw for the global batch), so world 2 equals world 1."""
    cfg = flagship_config({"freq_mask_num": 2, "freq_mask_width": 6, "time_mask_num": 2,
                           "time_mask_width": 8})
    spec = {"model_type": "conv-ctc-transformer", "model_cfg": cfg,
            "pkg": port_package("conv-ctc-transformer", cfg),
            "training": dict(TRAINING, exp_dir=str(tmp_path)), "loaders": {"tr": FLAGSHIP_BATCHES}}
    one = train(Grid.single("cpu"), spec)
    outs = pool2.run("train", spec)
    plain = train(Grid.single("cpu"), dict(spec, model_cfg=flagship_config()))
    assert abs(plain["losses"][0] - one["losses"][0]) > 1e-3  # the masks bite
    for out in outs:
        losses_close(out["losses"], one["losses"])
        grads_close(out["g1"], one["g1"])
        params_close(out["pkg"]["model"]["components"], one["pkg"]["model"]["components"])


def test_rand_rows_cuts_the_global_draw():
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    whole = torch.rand((2, 3, 8), generator=gen())
    for rank in range(4):
        got = rand_rows(gen(), (2, 3, 2), 2, rank, 4)
        assert torch.equal(got, whole[..., 2 * rank:2 * rank + 2])


# ------------------------------------------------------------ units

def test_zero1_rule_matches_zero1_sharding():
    from openasr_tpu.parallel.mesh import DATA_AXIS, zero1_sharding

    for world in (2, 4, 8):
        mesh = make_mesh(jax.devices("cpu")[:world], model=1)
        for shape in [(6, 32, 16), (64,), (3, 5), (512, 2048), (8, 8), (12, 6), (2, 4, 4), ()]:
            sh = zero1_sharding(jax.device_put(np.zeros(shape, np.float32)), mesh)
            want = None if sh is None else list(sh.spec).index(DATA_AXIS)
            assert zero1_dim(shape, world) == want, (world, shape)
    assert zero1_dim((64,), 1) is None


def test_dropout_seed_rule_matches_the_jax_kernel_on_a_data_mesh():
    """The JAX flash kernel (interpret mode) on a 2-device data mesh folds
    the shard into the seed (kernels/partition.py); the port's rank r with
    `partition_seed(seed, r)` draws the same masks for its local rows."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import openasr_tpu.kernels as kernels
    from openasr_torch.kernels.flash_attention import flash_attention as port_flash
    from openasr_tpu.kernels.flash_attention import flash_attention

    b, t, h, d, rate, seed = 4, 128, 1, 64, 0.5, 7
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(3))
    lens = np.asarray([128, 100, 77, 128], np.int32)
    mesh = Mesh(np.array(jax.devices("cpu")[:2]), ("data",))
    sh = NamedSharding(mesh, P("data"))
    prev = kernels.spmd_partitioning_enabled()
    kernels.set_spmd_partitioning(True)
    try:
        f = jax.jit(lambda q, k, v, l: flash_attention(
            q, k, v, kv_lengths=l, dropout_rate=rate,
            dropout_seed=jnp.asarray([seed], jnp.uint32), interpret=True))
        want = np.asarray(f(*[jax.device_put(x, sh) for x in (q, k, v, lens)]))
    finally:
        kernels.set_spmd_partitioning(prev)
    for r in range(2):
        lo = slice(2 * r, 2 * r + 2)
        got, _ = port_flash(*(torch.from_numpy(x[lo]) for x in (q, k, v)),
                            kv_lengths=torch.from_numpy(lens[lo]), dropout_rate=rate,
                            dropout_seed=partition_seed(seed, r))
        np.testing.assert_allclose(got.numpy(), want[lo], rtol=1e-5, atol=1e-5)
    assert partition_seed(seed, 0) == seed
    assert partition_seed(0xFFFFFFFF, 3) == (0xFFFFFFFF + 3 * 0x85EBCA6B) % 2 ** 32


def _jax_padded(batch_r, batches, monkeypatch):
    """`_shard_batch_multihost`'s reconciled local batch for one host of
    `batches` (every host's local batch): the shape all-gather answered
    from `batches`, the global array's callback read back for this host's
    rows."""
    import openasr_tpu.parallel.mesh as jax_mesh

    def shapes(b):
        keys = sorted(k for k, v in b.items() if hasattr(v, "ndim"))
        out = np.zeros((len(keys), 8), np.int32)
        for i, k in enumerate(keys):
            out[i, :b[k].ndim] = b[k].shape
        return out

    monkeypatch.setattr(jax_mesh, "_allgather_host_data",
                        lambda mesh, local: np.stack([shapes(b) for b in batches]))
    monkeypatch.setattr(jax, "make_array_from_callback", lambda shape, sharding, cb: cb(
        (slice(0, shape[0] // len(batches)),) + (slice(None),) * (len(shape) - 1)))
    return jax_mesh._shard_batch_multihost(batch_r, make_mesh(jax.devices("cpu")[:2]),
                                           len(batches))


def test_reconcile_batch_matches_shard_batch_multihost(pool2, monkeypatch):
    """Each rank pads to the cross-rank shapes that the JAX multi-host path
    pads to, with the same values, except that new label positions get
    `paddings` 1 (the one-process batch's; the JAX path pads 0, counting
    them as tokens, which no one-host batch does)."""
    batches = [FLAGSHIP_BATCHES[1], feature_batch(9, (12, 15, 70, 22))]
    got = pool2.run("reconcile", batches)
    for i, global_batch in enumerate(batches):
        local = [rows(global_batch, r, 2) for r in range(2)]
        assert local[0]["feats"].shape != local[1]["feats"].shape
        for r in range(2):
            want = _jax_padded(local[r], local, monkeypatch)
            mine = got[r][i]
            assert sorted(mine) == sorted(want)
            for k, v in want.items():
                assert mine[k].shape == v.shape, (k, mine[k].shape, v.shape)
                if k == "paddings":
                    u = local[r][k].shape[1]
                    np.testing.assert_array_equal(mine[k][:, :u], v[:, :u])
                    assert (mine[k][:, u:] == 1).all()
                else:
                    np.testing.assert_array_equal(mine[k], v)
            for k, v in global_batch.items():
                assert mine[k].shape[1:] == v.shape[1:], k


def test_loader_rows_match_the_jax_loader(tmp_path):
    from openasr_torch.data.loader import DataLoader
    from openasr_torch.data.sampler import BudgetBatchSampler
    from openasr_tpu.data.loader import DataLoader as JaxLoader
    from openasr_tpu.data.sampler import BudgetBatchSampler as JaxSampler

    data = [{"uttid": f"u{i}", "feat_length": 10 + 7 * i % 13} for i in range(23)]

    def collate(items):
        return [d["uttid"] for d in items]

    for rank in range(2):
        got = list(DataLoader(data, BudgetBatchSampler(data, 60, divisible_by=2, shuffle=True),
                              collate, num_workers=1, rank=rank, world=2))
        want = list(JaxLoader(data, JaxSampler(data, 60, divisible_by=2, shuffle=True), collate,
                              num_workers=0, rank=rank, world=2))
        assert got == want and len(got) > 2
    with pytest.raises(AssertionError, match="not divisible by world=2"):
        list(DataLoader(data, [[0, 1, 2]], collate, num_workers=1, rank=0, world=2))


def test_all_gather_host_and_the_layout_checks(pool2):
    assert all_gather_host(DataGroup.single(), np.arange(3)).tolist() == [[0, 1, 2]]
    validate_layout(np.arange(4)[:, None])
    with pytest.raises(ValueError, match="model-parallel groups may not span hosts"):
        validate_layout(np.array([[0, 1], [0, 1]]))
    with pytest.raises(ValueError, match="must divide evenly"):
        validate_layout(np.array([[0], [1], [2], [0], [1]]))
    with pytest.raises(ValueError, match="process-contiguous"):
        validate_layout(np.array([[0], [1], [0], [1]]))
    with pytest.raises(RuntimeError, match="MASTER_ADDR, MASTER_PORT not set"):
        init_distributed("cpu", env={"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0"})


# ------------------------------------------------------------ preemption, resume

def test_one_sided_preemption_stops_both_ranks_and_resumes(pool2, tmp_path):
    """SIGTERM reaches rank 0 alone at batch 3 of 10: the agreement (every
    8 batches) stops both ranks after batch 7, rank 0 writes last.pkg (the
    epoch not counted), and the package continues at world 2."""
    batches = [feature_batch(20 + i, (20 + i, 30, 17 + 2 * i, 25)) for i in range(10)]
    exp = tmp_path / "exp"
    spec = {"model_type": "conv-ctc-transformer", "model_cfg": flagship_config(),
            "pkg": port_package("conv-ctc-transformer", flagship_config()),
            "training": dict(TRAINING, exp_dir=str(exp)), "loaders": {"tr": batches}}
    outs = pool2.run("preempt", spec, 3)
    assert [o["step"] for o in outs] == [7, 7] and [o["epoch"] for o in outs] == [0, 0]
    assert all(o["stopped"] for o in outs)
    pkg = load_package(str(exp / "last.pkg"))
    assert pkg["solver_state"]["step"] == 7 and pkg["solver_state"]["epoch"] == 0
    resumed = pool2.run("train", dict(spec, pkg=pkg["model"], restore=pkg,
                                      loaders={"tr": batches[:2]}))
    assert [o["step"] for o in resumed] == [9, 9]
    assert resumed[0]["pkg"]["optim_state"]["count"] == 9


@pytest.mark.parametrize("first,then", [(2, 1), (1, 2)])
def test_packages_continue_across_world_sizes(pool2, tmp_path, first, then):
    """A package written at one world size continues at the other: the
    restored state packages back to itself exactly, and the next steps
    equal those of a continuation at the first world size."""
    spec = {"model_type": "conv-ctc-transformer", "model_cfg": flagship_config(),
            "pkg": port_package("conv-ctc-transformer", flagship_config()),
            "training": dict(TRAINING, exp_dir=str(tmp_path)),
            "loaders": {"tr": FLAGSHIP_BATCHES[:2]}}

    def run(world, spec):
        return (train(Grid.single("cpu"), spec) if world == 1
                else pool2.run("train", spec)[0])

    pkg = run(first, spec)["pkg"]
    cont = dict(spec, pkg=pkg["model"], restore=pkg, loaders={"tr": FLAGSHIP_BATCHES[2:]})
    same = run(then, dict(cont, loaders={"tr": []}))["pkg"]
    for key, value in moments(pkg["optim_state"]).items():
        for name, v in value.items():
            np.testing.assert_array_equal(same["optim_state"][key][name], v)
    assert same["optim_state"]["count"] == pkg["optim_state"]["count"] == 2
    got, want = run(then, cont), run(first, cont)
    losses_close(got["losses"], want["losses"])
    params_close(got["pkg"]["model"]["components"], want["pkg"]["model"]["components"])
