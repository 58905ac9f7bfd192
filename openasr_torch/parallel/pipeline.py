"""GPipe pipeline parallelism over a grid's pipe group.

Counterpart of openasr_tpu/parallel/pipeline.py.  The JAX package streams
microbatches through stages laid over its mesh's `pipe` axis inside one
`shard_map` and lets autodiff transpose the schedule; here each stage is a
rank of the grid's `pipe` group (parallel/mesh.py:Grid) holding layers
[p L / S, (p + 1) L / S) of the stack, and the schedule and its reverse
run explicitly:

- `pipeline_scope` / `pipeline_context`: the (pipe group, requested
  microbatch count) that the stacked encoder (models/encoder.py:
  PipelinedEncoderStack) reads, scoped by the solver to each step, as the
  JAX solver scopes its (mesh, n_microbatch).
- `stack_layer_params` / `unstack_layer_params`: the package layout of a
  stack, one layer-shaped tree of NumPy arrays whose leaves carry a leading
  [L] (`stacked_layers`), from and to the per-layer `layer{i}` trees, with
  the JAX errors for a gap and for a missing prefix.
- `gpipe_apply`: the schedule of T = M + S - 1 steps.  At step t stage s
  runs microbatch t - s when 0 <= t - s < M (a bubble step otherwise:
  no compute, but the hop); stage 0 takes microbatch t of the input; the
  hop hands each stage's output to the next one (the JAX package's
  `ppermute`), as an all-to-all over the pipe group with only the
  neighbour's slot filled, which gloo takes on CUDA tensors; every rank
  calls it at the same steps, so the collectives pair.  The last stage's
  outputs go to every rank of the pipe group (an all-reduce of it and the
  others' zeros, the JAX psum of the valid steps).  `aux` (the key
  lengths) is replicated on every stage, which takes microbatch t - s's
  rows of it (the JAX hop carries them with the microbatch).
- The backward runs the reverse schedule in one autograd Function: the
  last stage takes its microbatches' rows of the output's gradient once
  (every rank of the pipe group computes the same loss from the same
  output, so the cotangent is not summed over them); each stage
  backpropagates its layers and hands the input's gradient back one stage
  (the transposed hop); stage 0's gradient of the input reaches every rank
  of the pipe group (an all-reduce), as `shard_map` sums a replicated
  input's cotangent, so the layers before the stack keep one gradient.
  With `remat` each stage's microbatch runs under `torch.utils.checkpoint`
  (its activations recomputed in the backward).
- Dropout: the JAX package folds (step, stage, layer) into its key.  The
  port draws one seed from the caller's host generator (the same draw on
  every rank of the pipe group, so the layers before and after the stack
  keep equal draws there) and reseeds a generator of the caller's shard
  coordinates for each (microbatch, layer) pair (`layer_seed`), so a
  recomputed stage replays its masks and no stage's draws move another's.
- `full_stacks`: every stage's layers gathered over the pipe group (one
  all-gather), for the package, which holds the whole stack.
- Sequence parallelism is suspended inside the stack (the JAX package's
  `sequence_parallel(None)`): the layers run on whole microbatches;
  tensor parallelism inside a stage stays on.
"""

from __future__ import annotations

import contextlib
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from openasr_torch.parallel.mesh import DataGroup

LayerApply = Callable[[torch.nn.Module, torch.Tensor, Dict[str, torch.Tensor], Any],
                      torch.Tensor]

_PIPE_CTX: Optional[Tuple[DataGroup, int]] = None  # (pipe group, n_microbatch)
_MASK62 = (1 << 62) - 1


class pipeline_scope:
    """Scope the (pipe group, n_microbatch) pipeline context to a call."""

    def __init__(self, ctx: Optional[tuple]):
        self.ctx = ctx

    def __enter__(self):
        global _PIPE_CTX
        self.prev = _PIPE_CTX
        _PIPE_CTX = self.ctx

    def __exit__(self, *exc):
        global _PIPE_CTX
        _PIPE_CTX = self.prev


def pipeline_context() -> Optional[tuple]:
    return _PIPE_CTX


# ------------------------------------------------------------ the package layout

def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_layer_params(params: dict, prefix: str = "layer"):
    """Stack the per-layer subtrees `params[f'{prefix}{i}']` into one
    layer-shaped tree with leading [L] leaves.  Returns (stacked, L)."""
    pat = re.compile(re.escape(prefix) + r"(\d+)$")
    names = sorted((k for k in params if pat.match(k)),
                   key=lambda k: int(pat.match(k).group(1)))
    if not names:
        raise ValueError(f"no '{prefix}<i>' layer subtrees among {sorted(params)}")
    idx = [int(pat.match(k).group(1)) for k in names]
    if idx != list(range(len(names))):
        raise ValueError(f"non-contiguous layer indices {idx}")
    stacked = _tree_map(lambda *leaves: np.stack([np.asarray(x) for x in leaves]),
                        *(params[k] for k in names))
    return stacked, len(names)


def unstack_layer_params(stacked, n_layers: int, prefix: str = "layer") -> dict:
    """Inverse of `stack_layer_params`."""
    return {f"{prefix}{i}": _tree_map(lambda leaf, i=i: np.asarray(leaf)[i], stacked)
            for i in range(n_layers)}


# ------------------------------------------------------------ the schedule

def stage_layers(n_layers: int, rank: int, size: int) -> range:
    """The layers stage `rank` of `size` holds: [rank L / S, (rank + 1) L / S)."""
    if n_layers % size:
        raise ValueError(f"{n_layers} layers not divisible by {size} stages")
    k = n_layers // size
    return range(rank * k, (rank + 1) * k)


def microbatch_count(batch: int, requested: int) -> int:
    """The largest microbatch count <= requested that divides the batch
    (the JAX stack's rule)."""
    m = max(1, min(int(requested), batch))
    while batch % m:
        m -= 1
    return m


def layer_seed(base: int, microbatch: int, layer: int) -> int:
    """The dropout seed of global layer `layer` on microbatch `microbatch`
    of a pipelined forward whose draw was `base`."""
    return (int(base) + microbatch * 0x9E3779B97F4A7C15 + layer * 0xBF58476D1CE4E5B9) & _MASK62


class _Schedule:
    """One pipelined call: the stage's layers, the microbatches' rows and
    the hops over the pipe group."""

    def __init__(self, layer_apply: LayerApply, layers, x: torch.Tensor,
                 aux: Dict[str, torch.Tensor], group: DataGroup, n_microbatch: int,
                 remat: bool, rng, first: int):
        self.layer_apply, self.layers, self.group = layer_apply, list(layers), group
        self.m, self.remat, self.first = n_microbatch, remat, first
        self.s, self.n = group.rank, group.world
        if x.shape[0] % n_microbatch:
            raise ValueError(f"batch {x.shape[0]} not divisible by M={n_microbatch}")
        self.mb = x.shape[0] // n_microbatch
        self.aux = aux
        self.rng, self.base = None, 0
        if rng is not None:
            self.base = int(torch.randint(0, 1 << 62, (), generator=rng.host))
            self.rng = rng.fork()

    def rows(self, t: torch.Tensor, j: int) -> torch.Tensor:
        return t[j * self.mb:(j + 1) * self.mb]

    def stage(self, h: torch.Tensor, j: int) -> torch.Tensor:
        """This stage's layers on microbatch j."""
        aux = {k: self.rows(v, j) for k, v in self.aux.items()}
        for i, layer in enumerate(self.layers):
            if self.rng is not None:
                self.rng.reseed(layer_seed(self.base, j, self.first + i))
            h = self.layer_apply(layer, h, aux, self.rng)
        return h

    def _hop(self, y: Optional[torch.Tensor], like: torch.Tensor, step: int) -> Optional[torch.Tensor]:
        """Every rank's `y` to the rank `step` stages on (+1 forward, -1
        backward) over one all-to-all; returns what the rank `step` stages
        back sent, or None at the end of the line."""
        s, n = self.s, self.n
        buf = like.new_zeros((n,) + tuple(like.shape))
        if y is not None and 0 <= s + step < n:
            buf[s + step] = y
        out = self.group.all_to_all(torch.empty_like(buf), buf)
        return out[s - step] if 0 <= s - step < n else None

    def forward(self, x: torch.Tensor, grad: bool) -> torch.Tensor:
        """The schedule; with `grad` each microbatch's graph is kept (its
        stage input a leaf) for `backward`."""
        s, n, m = self.s, self.n, self.m
        like = self.rows(x, 0)
        self.saved: Dict[int, tuple] = {}
        outs: List[torch.Tensor] = []
        recv = None
        for t in range(m + n - 1):
            j, y = t - s, None
            if 0 <= j < m:
                h = (self.rows(x, j) if s == 0 else recv).detach()
                if grad:
                    h.requires_grad_(s > 0 or x.requires_grad)
                    with torch.enable_grad():
                        y = (checkpoint(self.stage, h, j, use_reentrant=False,
                                        preserve_rng_state=False)
                             if self.remat else self.stage(h, j))
                    self.saved[j] = (h, y)
                else:
                    y = self.stage(h, j)
                if s == n - 1:
                    outs.append(y.detach())
            if t < m + n - 2:
                recv = self._hop(None if y is None else y.detach().to(like.dtype), like, 1)
        out = torch.cat(outs).to(x.dtype) if s == n - 1 else torch.zeros_like(x)
        return self.group.all_reduce(out)

    def backward(self, g: torch.Tensor, want_dx: bool) -> Optional[torch.Tensor]:
        """The reverse schedule: parameter gradients accumulate in `.grad`;
        returns the input's gradient (every rank's) when `want_dx`."""
        s, n, m = self.s, self.n, self.m
        like = self.rows(g, 0)
        dx = torch.zeros_like(g) if want_dx else None
        recv = None
        for t in reversed(range(m + n - 1)):
            j, dh = t - s, None
            if 0 <= j < m:
                h, y = self.saved.pop(j)
                dy = self.rows(g, j) if s == n - 1 else recv
                torch.autograd.backward(y, dy.to(y.dtype))
                dh = h.grad
                if s == 0 and want_dx:
                    dx[j * self.mb:(j + 1) * self.mb] = dh
            if t > 0:
                recv = self._hop(None if dh is None else dh.to(like.dtype), like, -1)
        return None if dx is None else self.group.all_reduce(dx)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, x: torch.Tensor, *params):
        ctx.sched = sched
        return sched.forward(x, grad=True)

    @staticmethod
    def backward(ctx, g):
        dx = ctx.sched.backward(g.contiguous(), ctx.needs_input_grad[1])
        return (None, dx) + (None,) * (len(ctx.needs_input_grad) - 2)


def gpipe_apply(layer_apply: LayerApply, layers, x: torch.Tensor,
                aux: Dict[str, torch.Tensor], group: DataGroup, n_microbatch: int,
                remat: bool = False, rng=None, first: int = 0) -> torch.Tensor:
    """Run this stage's `layers` (global indices first, first + 1, ...) of a
    homogeneous stack as a GPipe pipeline over `group` (the pipe group).

    layer_apply(layer, h, aux_rows, rng) -> h: one layer.  `aux`: tensors
    with the batch's leading dim (the key lengths), whose microbatch rows
    each stage gives its layers.  `rng`: a `TrainRNG` (dropout), or None.
    x: [B, T, ...], the same on every rank of the group, B % n_microbatch
    == 0; returns the stack's [B, T, ...] on every rank of the group."""
    sched = _Schedule(layer_apply, layers, x, aux, group, n_microbatch, remat, rng, first)
    params = [p for layer in sched.layers for p in layer.parameters() if p.requires_grad]
    if torch.is_grad_enabled() and (x.requires_grad or params):
        return _GPipe.apply(sched, x, *params)
    return sched.forward(x, grad=False)


# ------------------------------------------------------------ the package's stack

@contextlib.contextmanager
def full_stacks(module: torch.nn.Module, group: DataGroup):
    """Within: every `PipelinedEncoderStack` of `module` holds all its
    layers, the other stages' gathered over the pipe `group` (one
    all-gather of this stage's parameters, whole: inside the model group's
    `full_tables`); after it, its stage's again."""
    from openasr_torch.models.encoder import PipelinedEncoderStack

    held = []
    try:
        for stack in [m for m in module.modules() if isinstance(m, PipelinedEncoderStack)]:
            held.append((stack, stack.held))
            sizes = [p.numel() for layer in stack.layers for p in layer.parameters()]
            flat = torch.cat([p.detach().reshape(-1) for layer in stack.layers
                              for p in layer.parameters()])
            full = torch.empty(group.world * flat.numel(), dtype=flat.dtype, device=flat.device)
            full = group.all_gather(full, flat).view(group.world, -1)
            for r in range(group.world):
                if r == group.rank:
                    continue
                pieces = iter(full[r].split(sizes))
                for i in stage_layers(stack.num_layers, r, group.world):
                    layer = stack.new_layer().to(flat.device)
                    with torch.no_grad():
                        for p in layer.parameters():
                            p.copy_(next(pieces).view(p.shape))
                    stack.add_module(f"layer{i}", layer)
            stack.held = range(stack.num_layers)
        yield
    finally:
        for stack, stage in held:
            for i in stack.held:
                if i not in stage:
                    delattr(stack, f"layer{i}")
            stack.held = stage
