"""Global-norm clip + Adam with a bf16 first moment, in plain PyTorch.

Counterpart of `fused_clip_adam` in openasr_tpu/ops/fused_adam.py, whose
semantics are those of optax.chain(clip_by_global_norm, adam):

- the clip scales the gradients by max_norm / ||g|| only when the global
  norm is at least max_norm (max_norm <= 0 turns it off);
- the bias corrections use the incremented count, the learning rate
  lr_fn(count) the count BEFORE the increment;
- the moments are computed in f32 and stored in `mu_dtype` / `nu_dtype`
  (default: first moment bf16, second f32, as the JAX solver sets them);
- with `skip_nonfinite`, a step whose gradient norm is inf or nan is
  rejected: parameters, moments and count stay, `notfinite` counts it.

torch.optim.Adam keeps its moments in the parameters' dtype, so it cannot
hold a bf16 first moment beside f32 parameters; this class does, with
`torch._foreach_*` ops over the parameter list.  As in the JAX package,
the step count and `notfinite` live on the device, the lr is `lr_fn` of
the on-device count and a rejected step is undone by selects, so a step
reads nothing back to the host.

Under data parallelism the parameters may be ZeRO-1 shards (views of the
full parameters) and `norm_fn` the global norm over the ranks
(openasr_torch/parallel/data_parallel.py); the arithmetic is the same.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch


def host_copy(t: torch.Tensor) -> np.ndarray:
    """An f32 NumPy copy of a parameter or moment: on the CPU .numpy()
    would alias the live tensor, which the next step changes in place
    while the asynchronous writer pickles the package."""
    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class FusedClipAdamState(NamedTuple):
    """The JAX package's state of this optimizer, field for field
    (`openasr_tpu.ops.fused_adam.FusedClipAdamState`): packages it wrote
    unpickle into this class (`openasr_torch.utils.checkpoint`).
    `notfinite` is None in packages written before it existed."""

    count: Any
    mu: Any
    nu: Any
    notfinite: Any = None


class FusedClipAdam:
    def __init__(
        self,
        named_params: Dict[str, torch.nn.Parameter],
        lr_fn: Callable[[torch.Tensor], torch.Tensor],
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        max_norm: float = 0.0,
        mu_dtype: Optional[torch.dtype] = torch.bfloat16,
        nu_dtype: Optional[torch.dtype] = None,
        skip_nonfinite: bool = False,
        norm_fn: Optional[Callable[[List[torch.Tensor]], torch.Tensor]] = None,
    ):
        self.names = list(named_params)
        self.norm_fn = norm_fn or global_norm
        self.params: List[torch.Tensor] = [named_params[n] for n in self.names]
        self.lr_fn = lr_fn
        self.b1, self.b2, self.eps = b1, b2, eps
        self.max_norm = float(max_norm)
        self.skip_nonfinite = skip_nonfinite
        device = self.params[0].device
        # int32 counters on the device, as the JAX optimizer state holds them
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.notfinite = torch.zeros((), dtype=torch.int32, device=device)
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=nu_dtype or p.dtype) for p in self.params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        """Apply one update from `grads` (one per parameter, f32).  With
        `skip_nonfinite`, a step whose gradient norm is not finite leaves
        the parameters, moments and count as they were and adds one to
        `notfinite`."""
        gf = [g.float() for g in grads]
        finite = None
        if self.max_norm > 0 or self.skip_nonfinite:
            g_norm = self.norm_fn(gf)
            if self.skip_nonfinite:
                finite = torch.isfinite(g_norm)
        if self.max_norm > 0:
            # optax.clip_by_global_norm: scale only when norm >= max_norm
            scale = torch.where(g_norm < self.max_norm, 1.0, self.max_norm / g_norm)
            gf = torch._foreach_mul(gf, scale.float())
        b1, c1, b2, c2 = self.b1, 1.0 - self.b1, self.b2, 1.0 - self.b2
        count_inc = self.count + 1
        if finite is not None:
            # a rejected step: zero gradients, and moment decays of 1 and 0
            # that keep the moments exactly; its update is selected away
            keep = finite.float()
            gf = [torch.where(finite, g, 0.0) for g in gf]
            b1, c1 = keep * b1 + (1.0 - keep), keep * c1
            b2, c2 = keep * b2 + (1.0 - keep), keep * c2
            count_inc = self.count + finite.int()
        bc1 = 1.0 - self.b1 ** count_inc.float()
        bc2 = 1.0 - self.b2 ** count_inc.float()
        # optax.adam takes lr at the count BEFORE the increment
        step_size = -1.0 * self.lr_fn(self.count)

        mu_f = torch._foreach_mul([m.float() for m in self.mu], b1)
        torch._foreach_add_(mu_f, torch._foreach_mul(gf, c1))
        nu_f = torch._foreach_mul([n.float() for n in self.nu], b2)
        torch._foreach_add_(nu_f, torch._foreach_mul(torch._foreach_mul(gf, gf), c2))
        denom = torch._foreach_div(nu_f, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_f, bc1)
        torch._foreach_mul_(upd, step_size)
        torch._foreach_div_(upd, denom)
        if finite is not None:
            # a rejected first step divides by zero bias corrections
            upd = [torch.where(finite, u, 0.0) for u in upd]
        torch._foreach_add_(self.params, upd)
        for m, mf in zip(self.mu, mu_f):
            m.copy_(mf)
        for n, nf in zip(self.nu, nu_f):
            n.copy_(nf)
        self.count = count_inc
        if finite is not None:
            self.notfinite = self.notfinite + (1 - finite.int())

    # ---------------------------------------------------------- packaging

    def state_dict(self) -> dict:
        """Host copy, keyed by parameter name; moments as f32 NumPy (a bf16
        moment converts exactly)."""
        return {
            "count": int(self.count),
            "notfinite": int(self.notfinite),
            "mu": {n: host_copy(m) for n, m in zip(self.names, self.mu)},
            "nu": {n: host_copy(v) for n, v in zip(self.names, self.nu)},
        }

    def load_state_dict(self, state: dict) -> None:
        if set(state) - {"notfinite"} != {"count", "mu", "nu"}:
            raise ValueError(f"optimizer state {sorted(state)} is not the fused "
                             "clip + Adam's (count, notfinite, mu, nu)")
        if set(state["mu"]) != set(self.names) or set(state["nu"]) != set(self.names):
            raise ValueError("optimizer state does not match the model's parameters")
        self.count = torch.full_like(self.count, int(state["count"]))
        self.notfinite = torch.full_like(self.notfinite, int(state.get("notfinite", 0)))
        with torch.no_grad():
            for n, m, v in zip(self.names, self.mu, self.nu):
                m.copy_(torch.from_numpy(np.asarray(state["mu"][n])))
                v.copy_(torch.from_numpy(np.asarray(state["nu"][n])))
