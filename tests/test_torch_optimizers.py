"""The port's stock optimizers against the optax chains the JAX solver
builds, on the CPU.

`optimtype: sgd` and `fused_adam: false` are
apply_if_finite(chain(clip_by_global_norm, sgd(lr, momentum=0.9) | adam(lr,
mu_dtype)), 100) in the JAX package (openasr_tpu/solvers/__init__.py).  The
same seeded gradients, with a step of nan among them, go through both for
10 steps: parameters to 1e-6 (f32, the same operations in the same order),
the states through the bridge (`convert.jax_optim_state_to_port`) to the
same tolerance, counters exactly.  A run of 101 non-finite steps shows
optax's acceptance of the 101st, which the port follows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openasr_torch.ops.optimizers import MAX_CONSECUTIVE_ERRORS, StockOptimizer
from openasr_torch.ops.schedules import get_schedule
from openasr_tpu.ops.schedules import get_schedule as jax_get_schedule

TOL = 1e-6
INIT_LR = 1e-3
SCHEDULE = {"type": "warmup_transformer", "warmup_step": 4, "d_model": 32}
SHAPES = {"w": (6, 5), "b": (5,), "v": (3, 4, 2)}


def jax_chain(kind, max_norm, mu_dtype, skip):
    decay = jax_get_schedule(SCHEDULE)

    def lr_fn(count):
        return INIT_LR * decay(count + 1)

    if kind == "sgd":
        opt = optax.sgd(lr_fn, momentum=0.9)
    else:
        opt = optax.adam(lr_fn, b1=0.9, b2=0.999, eps=1e-8,
                         mu_dtype=jnp.dtype(mu_dtype) if mu_dtype else None)
    chain = ([optax.clip_by_global_norm(max_norm)] if max_norm > 0 else []) + [opt]
    tx = optax.chain(*chain)
    return optax.apply_if_finite(tx, max_consecutive_errors=100) if skip else tx


def port_optimizer(kind, max_norm, mu_dtype, skip, params):
    schedule = get_schedule(SCHEDULE)

    def lr_fn(count):
        return INIT_LR * schedule(count + 1)

    return StockOptimizer(params, lr_fn, kind, max_norm=max_norm,
                          mu_dtype=getattr(torch, mu_dtype) if mu_dtype else None,
                          skip_nonfinite=skip)


def initial_params(seed=0):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def gradients(step, rng):
    """Seeded gradients; large enough every third step to trip a clip at 5."""
    scale = 3.0 if step % 3 == 0 else 0.2
    return {k: (scale * rng.randn(*s)).astype(np.float32) for k, s in SHAPES.items()}


def run_both(kind, max_norm, mu_dtype, skip, grad_seq):
    tx = jax_chain(kind, max_norm, mu_dtype, skip)
    update = jax.jit(tx.update)
    jparams = {k: jnp.asarray(v) for k, v in initial_params().items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in initial_params().items()}
    opt = port_optimizer(kind, max_norm, mu_dtype, skip, tparams)
    for grads in grad_seq:
        updates, jstate = update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.from_numpy(grads[n]) for n in opt.names])
    return jparams, jstate, tparams, opt


def numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x).astype(np.float32)
                                  if np.asarray(x).dtype == jnp.bfloat16 else np.asarray(x), tree)


@pytest.mark.parametrize("kind,max_norm,mu_dtype,skip", [
    ("sgd", 5.0, None, True),
    ("adam", 5.0, "bfloat16", True),
    ("adam", 0.0, None, True),
    ("sgd", 0.0, None, False),
])
def test_stock_optimizer_matches_the_optax_chain(kind, max_norm, mu_dtype, skip):
    rng = np.random.RandomState(1)
    seq = [gradients(i, rng) for i in range(10)]
    if skip:
        seq[4]["w"][2, 3] = np.nan  # rejected: nothing moves, nothing counts
    jparams, jstate, tparams, opt = run_both(kind, max_norm, mu_dtype, skip, seq)
    for k in SHAPES:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                   atol=TOL, rtol=0)
    # the same state, field for field
    state = opt.state_dict()
    want = jax_optim_state_to_port_flat(jstate)
    assert state["count"] == want["count"] == (9 if skip else 10)
    for key in ("notfinite", "notfinite_count", "last_finite"):
        assert state.get(key) == want.get(key), key
    for key in ("trace", "mu", "nu"):
        if key in want:
            for name in SHAPES:
                np.testing.assert_allclose(state[key][name], want[key][name], atol=TOL, rtol=0)


def jax_optim_state_to_port_flat(jstate):
    """The optax state's fields by name, moments as flat dicts (the
    parameters here are a flat dict, so no weight-layout mapping)."""
    out = {}
    state = numpy_tree(jstate)
    if isinstance(state, optax.ApplyIfFiniteState):
        out.update(notfinite=int(state.total_notfinite),
                   notfinite_count=int(state.notfinite_count),
                   last_finite=bool(state.last_finite))
        state = state.inner_state
    inner, schedule = [s for s in state if not isinstance(s, optax.EmptyState)][0]
    out["count"] = int(schedule.count)
    if isinstance(inner, optax.TraceState):
        out["trace"] = inner.trace
    else:
        assert int(inner.count) == out["count"]
        out.update(mu=inner.mu, nu=inner.nu)
    return out


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_the_101st_consecutive_nonfinite_step_is_accepted_as_optax_does(kind):
    """optax's apply_if_finite rejects up to 100 non-finite steps in a row
    and accepts the 101st (its inf gradient leaves nan in the parameter
    that held it); a finite step then resets the run of errors."""
    rng = np.random.RandomState(2)
    seq = [gradients(1, rng)]
    for _ in range(MAX_CONSECUTIVE_ERRORS + 1):
        g = gradients(1, rng)
        g["b"][0] = np.inf
        seq.append(g)
    jparams, jstate, tparams, opt = run_both(kind, 5.0, None, True, seq[:-1])
    assert int(opt.notfinite_count) == int(jstate.notfinite_count) == 100
    assert np.isfinite(tparams["w"].detach().numpy()).all()
    for k in SHAPES:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                   atol=TOL, rtol=0)
    jparams, jstate, tparams, opt = run_both(kind, 5.0, None, True, seq + [gradients(1, rng)])
    want = jax_optim_state_to_port_flat(jstate)
    state = opt.state_dict()
    assert want["notfinite"] == state["notfinite"] == 101
    assert want["notfinite_count"] == state["notfinite_count"] == 0
    assert want["count"] == state["count"] == 3
    for k in SHAPES:  # nan where optax put nan, the rest to TOL
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                   atol=TOL, rtol=0, equal_nan=True)
    assert np.isnan(tparams["b"].detach().numpy()).any()


def test_state_dict_round_trip():
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v)) for k, v in initial_params().items()}
    opt = port_optimizer("adam", 5.0, "bfloat16", True, tparams)
    rng = np.random.RandomState(3)
    for i in range(3):
        opt.step([torch.from_numpy(gradients(i, rng)[n]) for n in opt.names])
    state = opt.state_dict()
    other = port_optimizer("adam", 5.0, "bfloat16", True,
                           {k: torch.nn.Parameter(torch.zeros(s)) for k, s in SHAPES.items()})
    other.load_state_dict(state)
    again = other.state_dict()
    assert {k: v for k, v in again.items() if not isinstance(v, dict)} == \
        {k: v for k, v in state.items() if not isinstance(v, dict)}
    for key in ("mu", "nu"):
        for n in SHAPES:
            assert np.array_equal(again[key][n], state[key][n])
    with pytest.raises(ValueError, match="stock sgd"):
        port_optimizer("sgd", 5.0, None, True, tparams).load_state_dict(state)
