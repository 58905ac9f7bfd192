"""The stock optimizers: clip + SGD with momentum, or clip + Adam, each
optionally inside optax's `apply_if_finite`.

Counterpart of the non-fused branch of `Solver._make_optimizer` in
openasr_tpu/solvers/__init__.py (`optimtype: sgd`, or `fused_adam: false`):

  optax.apply_if_finite(optax.chain(optax.clip_by_global_norm(max_norm),
                                    optax.sgd(lr_fn, momentum=0.9)
                                    | optax.adam(lr_fn, mu_dtype=...)), 100)

with optax's arithmetic, in its order:

- the clip scales by max_norm only when the global norm is at least
  max_norm, as (g / norm) * max_norm (max_norm <= 0: no clip);
- sgd keeps a trace t = g + 0.9 t and updates by -lr(count) t;
- adam keeps mu = (1 - b1) g + b1 mu (b1 rounded to the first moment's
  dtype, bf16 by default) and nu likewise, and updates by
  -lr(count) ((mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps)), n the
  incremented count;
- with a `gate` (wav2vec's `freeze_finetune_updates`, the JAX solver's
  `freeze_until` first in the chain), the gated parameters' gradients are
  zeroed during the first n updates, before the clip, so its norm leaves
  them out; Adam's count runs on through those steps, and the gate's own
  counter (`gate_count`) advances with every accepted step;
- the schedule's own counter starts at 0, so the first update uses
  lr_fn(0); a rejected step advances no counter;
- `apply_if_finite` rejects a step whose gradients hold an inf or nan
  (parameters and state stay, `total_notfinite` counts it) until more than
  `max_consecutive_errors` (100) came in a row: then optax accepts the
  update, non-finite values and all, and so does this class.

As in `FusedClipAdam`, the counters live on the device, a step is foreach
tensor ops with no read back to the host, and a rejected step is undone by
selects.  The state's fields are optax's, keyed by parameter name
(`state_dict`), so `openasr_torch.convert` maps the JAX package's states
onto them one to one.  The NamedTuples below carry optax's state fields in
its order, under its class names: `openasr_torch.utils.checkpoint` builds
them in place of optax's classes when it reads a package the JAX package
wrote.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from openasr_torch.ops.fused_adam import global_norm, host_copy

MAX_CONSECUTIVE_ERRORS = 100


class ScaleByAdamState(NamedTuple):
    count: Any
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: Any


class TraceState(NamedTuple):
    trace: Any


class EmptyState(NamedTuple):
    pass


class ApplyIfFiniteState(NamedTuple):
    notfinite_count: Any
    last_finite: Any
    total_notfinite: Any
    inner_state: Any


class MaskedState(NamedTuple):
    inner_state: Any


class MaskedNode(NamedTuple):
    pass


def all_finite(tensors: List[torch.Tensor], norm_fn=global_norm) -> torch.Tensor:
    """Whether every element of every tensor is finite, as a device bool:
    0 * x is nan exactly where x is inf or nan, and a norm over a nan is
    nan."""
    return torch.isfinite(norm_fn(torch._foreach_mul(tensors, 0.0)))


class StockOptimizer:
    """`kind` "sgd" (momentum 0.9) or "adam" (b1 0.9, b2 0.999, eps 1e-8,
    the JAX solver's) after the global-norm clip, inside `apply_if_finite`
    when `skip_nonfinite`.  `mu_dtype` is Adam's first-moment dtype (None:
    the parameters').  `gate`: (component names, n) zeroes the gradients
    of the parameters under those top-level components for the first n
    updates.  `norm_fn` computes the clip's and the finiteness check's
    global norm (default: over the given tensors; the data-parallel one
    sums the ZeRO-1 shards' squares over the ranks)."""

    momentum, b1, b2, eps = 0.9, 0.9, 0.999, 1e-8

    def __init__(
        self,
        named_params: Dict[str, torch.nn.Parameter],
        lr_fn: Callable[[torch.Tensor], torch.Tensor],
        kind: str,
        max_norm: float = 0.0,
        mu_dtype: Optional[torch.dtype] = None,
        skip_nonfinite: bool = False,
        gate: Optional[Tuple[Tuple[str, ...], int]] = None,
        norm_fn: Optional[Callable[[List[torch.Tensor]], torch.Tensor]] = None,
    ):
        self.norm_fn = norm_fn or global_norm
        if kind not in ("sgd", "adam"):
            raise ValueError(f"Unknown optimizer {kind}")
        self.kind = kind
        self.names = list(named_params)
        self.params: List[torch.Tensor] = [named_params[n] for n in self.names]
        self.lr_fn = lr_fn
        self.max_norm = float(max_norm)
        self.skip_nonfinite = skip_nonfinite
        device = self.params[0].device
        zero = torch.zeros((), dtype=torch.int32, device=device)
        # the schedule's counter; Adam's own count always equals it
        self.count = zero.clone()
        self.notfinite_count = zero.clone()
        self.last_finite = torch.ones((), dtype=torch.bool, device=device)
        self.notfinite = zero.clone()  # apply_if_finite's total_notfinite
        self.gate = gate
        if gate is not None:
            self.gated = [n.split(".")[0] in gate[0] for n in self.names]
            self.gate_count = zero.clone()
        if kind == "sgd":
            self.trace = [torch.zeros_like(p) for p in self.params]
        else:
            self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]

    def _moments(self) -> Dict[str, List[torch.Tensor]]:
        if self.kind == "sgd":
            return {"trace": self.trace}
        return {"mu": self.mu, "nu": self.nu}

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        """Apply one update from `grads` (one per parameter, f32)."""
        g = [x.float() for x in grads]
        accept = None
        if self.skip_nonfinite:
            finite = all_finite(g, self.norm_fn)
            self.notfinite_count = torch.where(finite, 0, self.notfinite_count + 1).int()
            self.notfinite = torch.where(finite, self.notfinite, self.notfinite + 1).int()
            self.last_finite = finite
            accept = finite | (self.notfinite_count > MAX_CONSECUTIVE_ERRORS)
        if self.gate is not None:
            open_ = (self.gate_count >= self.gate[1]).float()
            g = [x * open_ if gated else x for x, gated in zip(g, self.gated)]
            self.gate_count = self.gate_count + (1 if accept is None else accept.int())
        if self.max_norm > 0:
            norm = self.norm_fn(g)
            clipped = torch._foreach_mul(torch._foreach_div(g, norm), self.max_norm)
            keep = norm < self.max_norm
            g = [torch.where(keep, a, b) for a, b in zip(g, clipped)]
        step_size = -1.0 * self.lr_fn(self.count)
        if self.kind == "sgd":
            new_state = {"trace": torch._foreach_add(g, torch._foreach_mul(self.trace, self.momentum))}
            upd = torch._foreach_mul(new_state["trace"], step_size)
        else:
            # jnp's b1 * mu rounds b1 to mu's dtype (a weak-typed scalar)
            # and XLA keeps the product in f32
            b1 = float(torch.tensor(self.b1, dtype=self.mu[0].dtype))
            mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - self.b1),
                                    torch._foreach_mul([m.float() for m in self.mu], b1))
            nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2),
                                    torch._foreach_mul(self.nu, self.b2))
            n = (self.count + 1).float()
            mu_hat = torch._foreach_div(mu, 1.0 - self.b1 ** n)
            denom = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - self.b2 ** n))
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_mul(torch._foreach_div(mu_hat, denom), step_size)
            new_state = {"mu": mu, "nu": nu}
        if accept is not None:
            upd = [torch.where(accept, u, 0.0) for u in upd]
            for key, old in self._moments().items():
                new_state[key] = [torch.where(accept, a, b.float())
                                  for a, b in zip(new_state[key], old)]
            self.count = self.count + accept.int()
        else:
            self.count = self.count + 1
        torch._foreach_add_(self.params, upd)
        for key, old in self._moments().items():
            for o, new in zip(old, new_state[key]):
                o.copy_(new)

    # ---------------------------------------------------------- packaging

    def state_dict(self) -> dict:
        """Host copy: `count` (the schedule's, and Adam's), the moments
        (`trace`, or `mu` and `nu`) as f32 NumPy keyed by parameter name,
        and with `skip_nonfinite` apply_if_finite's `notfinite` (its
        total_notfinite), `notfinite_count` and `last_finite`."""
        state = {"count": int(self.count)}
        for key, tensors in self._moments().items():
            state[key] = {n: host_copy(t) for n, t in zip(self.names, tensors)}
        if self.skip_nonfinite:
            state.update(notfinite=int(self.notfinite),
                         notfinite_count=int(self.notfinite_count),
                         last_finite=bool(self.last_finite))
        if self.gate is not None:
            state["gate_count"] = int(self.gate_count)
        return state

    def load_state_dict(self, state: dict) -> None:
        moments = self._moments()
        gate = {"gate_count"} if self.gate is not None else set()
        if set(state) - {"notfinite", "notfinite_count", "last_finite"} != {"count", *moments,
                                                                            *gate}:
            raise ValueError(
                f"optimizer state {sorted(state)} is not that of the stock "
                f"{self.kind} optimizer ({sorted({'count', *moments, *gate})})"
            )
        for key in moments:
            if set(state[key]) != set(self.names):
                raise ValueError("optimizer state does not match the model's parameters")
        self.count = torch.full_like(self.count, int(state["count"]))
        self.notfinite = torch.full_like(self.notfinite, int(state.get("notfinite", 0)))
        self.notfinite_count = torch.full_like(self.notfinite_count,
                                               int(state.get("notfinite_count", 0)))
        self.last_finite = torch.full_like(self.last_finite, bool(state.get("last_finite", True)))
        if self.gate is not None:
            self.gate_count = torch.full_like(self.gate_count, int(state["gate_count"]))
        with torch.no_grad():
            for key, tensors in moments.items():
                for n, t in zip(self.names, tensors):
                    t.copy_(torch.from_numpy(np.asarray(state[key][n])))
