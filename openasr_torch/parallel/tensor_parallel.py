"""The model axis: tensor and sequence parallelism over a grid's model group.

Counterpart of the model axis of openasr_tpu/parallel/mesh.py (`_tp_entries`,
`_moe_entries`, `_spec_for`, `shard_time`).  The JAX package places the
parameters Megatron-style on its mesh and lets GSPMD insert the
collectives; here every rank of a model group holds its shards and the
layers call the collectives below, so that M ranks compute what one
process computes:

- `RULES` is the placement on the port's parameter names: q/k/v weight
  rows and biases by head, the attention `out` weight's columns by head,
  the FFN's `linear1` rows and bias (GLU: rows [mF/M, (m+1)F/M) of each
  half, value and gate) and `linear2` columns, the `emb` tables by vocab
  row (uneven: ceil(V/M) rows a rank, the last rank fewer), the MoE
  tables' F (w1/b1/w_gate/b_gate on F, w2 on its F row); everything else
  replicated.  `param_specs` applies it to a module, `shard_module` cuts
  the module's parameters to this rank's shards, `full_tables` gathers
  them back for a package and `shard_array` / `full_array` do the same for
  a host array (an optimizer moment).
- The collectives with their backward, on the model group: `copy_to_model`
  (identity; all-reduce backward) before a column-parallel product on a
  whole activation, `reduce_from_model` (all-reduce; identity backward)
  after a row-parallel one, `scatter_time` (reduce-scatter along T;
  all-gather backward) and `gather_time` (all-gather along T;
  reduce-scatter backward) around a row- or column-parallel product at a
  sequence-parallel site, `split_time` (this rank's T rows; all-gather
  backward) and `whole_time` (all-gather along T; this rank's rows of the
  gradient) between a whole activation and T-shards, `gather_vocab`
  (all-gather of vocab-sharded logits; this rank's columns of the
  gradient) and `first_rank_grad` (identity; the gradient kept on model
  rank 0 only, for work that every rank repeats on a whole activation
  whose gradient the model group then sums).
- Sequence parallelism (`TensorParallel.shards_time`): a call site with
  T rows runs its residual add, dropout and LayerNorm on this rank's T / M
  rows when the model size is above 1, `training.sequence_parallel` is on,
  T > 1 and M divides T (`shard_time`'s rule), decided from the host's
  shapes.  Elsewhere the site is plain tensor parallelism (all-reduce).
- `PartialGrads`: a replicated parameter used on T-shards (a LayerNorm's
  scale and bias, a row-parallel bias at a sequence-parallel site) gets a
  gradient over this rank's rows only.  `TensorParallel.partial` routes it
  into the sink instead of `.grad`; the solver sums the sink over the model group
  once a step (`reduce_into`) and adds it to the gradient that the
  unsharded sites gave whole, so a step that mixes sharded and unsharded
  sites counts each row once.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from openasr_torch.parallel.mesh import DataGroup


class Spec(NamedTuple):
    """A model-sharded parameter: its `dim` of whole length `n`, cut into
    `blocks` equal blocks each split over the ranks (2 for GLU's value and
    gate halves), or `uneven`ly (ceil(n / M) a rank)."""
    dim: int
    n: int
    blocks: int = 1
    uneven: bool = False


# (pattern on the port's parameter name, dim); GLU's blocks and the vocab's
# unevenness come from the module (`param_specs`)
RULES = (
    (re.compile(r"(^|\.)(self_attn|cross_attn)\.(q|k|v)\.(weight|bias)$"), 0),
    (re.compile(r"(^|\.)(self_attn|cross_attn)\.out\.weight$"), 1),
    (re.compile(r"(^|\.)ffn\.linear1\.(weight|bias)$"), 0),
    (re.compile(r"(^|\.)ffn\.linear2\.weight$"), 1),
    (re.compile(r"(^|\.)emb\.weight$"), 0),
    (re.compile(r"(^|\.)moe_ffn\.(w1|w_gate)$"), 2),
    (re.compile(r"(^|\.)moe_ffn\.(b1|b_gate|w2)$"), 1),
)


def rule(name: str) -> Optional[int]:
    """The dimension that the model axis shards of parameter `name`, or
    None (replicated)."""
    for pattern, dim in RULES:
        if pattern.search(name):
            return dim
    return None


def param_specs(module: nn.Module) -> Dict[str, Spec]:
    """The sharded parameters of `module` by name."""
    specs = {}
    for name, p in module.named_parameters():
        dim = rule(name)
        if dim is None:
            continue
        owner = module.get_submodule(name.rsplit(".", 2)[0]) if ".linear1." in name else None
        glu = getattr(owner, "activation", None) == "glu"
        specs[name] = Spec(dim, p.shape[dim], 2 if glu else 1, name.endswith("emb.weight"))
    return specs


def local_range(spec: Spec, rank: int, size: int) -> List[tuple]:
    """The (start, length) pieces of the whole dimension that rank `rank`
    of `size` holds, in order."""
    n = spec.n
    if spec.uneven:
        chunk = -(-n // size)
        lo = min(n, rank * chunk)
        return [(lo, min(n, lo + chunk) - lo)]
    block = n // spec.blocks
    if block % size:
        raise ValueError(f"--model-parallel {size} does not divide a dimension of {block} "
                         "(attention heads, FFN width or MoE width)")
    k = block // size
    return [(b * block + rank * k, k) for b in range(spec.blocks)]


def shard_tensor(full: torch.Tensor, spec: Spec, rank: int, size: int) -> torch.Tensor:
    pieces = [full.narrow(spec.dim, lo, k) for lo, k in local_range(spec, rank, size)]
    return torch.cat(pieces, dim=spec.dim) if len(pieces) > 1 else pieces[0]


def shard_array(full: np.ndarray, spec: Spec, rank: int, size: int) -> np.ndarray:
    return shard_tensor(torch.from_numpy(np.asarray(full)), spec, rank, size).numpy()


def gather_tensor(local: torch.Tensor, spec: Spec, group: DataGroup) -> torch.Tensor:
    """The whole tensor from every rank's `local` shard (one all-gather; a
    collective)."""
    size, n = group.world, spec.n
    if size == 1:
        return local
    moved = local.movedim(spec.dim, 0)
    width = -(-n // size) if spec.uneven else moved.shape[0]
    buf = moved.new_zeros((width,) + tuple(moved.shape[1:]))
    buf[:moved.shape[0]] = moved
    out = torch.empty((size * width,) + tuple(moved.shape[1:]), dtype=local.dtype,
                      device=local.device)
    group.all_gather(out.view(-1), buf.contiguous().view(-1))
    parts = out.view(size, width, *moved.shape[1:])
    full = torch.empty((n,) + tuple(moved.shape[1:]), dtype=local.dtype, device=local.device)
    for r in range(size):
        at = 0
        for lo, k in local_range(spec, r, size):
            full[lo:lo + k] = parts[r, at:at + k]
            at += k
    return full.movedim(0, spec.dim)


def full_array(local: np.ndarray, spec: Spec, group: DataGroup) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(local)).to(group.comm_device)
    return gather_tensor(t, spec, group).cpu().numpy()


# ------------------------------------------------------------ collectives with a backward

def _along(x: torch.Tensor, dim: int, fn, out_len: int) -> torch.Tensor:
    """`fn(out, flat_x)` on x with `dim` moved first: out is [out_len,
    ...]."""
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((out_len,) + tuple(moved.shape[1:]))
    fn(out.view(-1), moved.view(-1))
    return out.movedim(0, dim)


def _all_gather(x, group: DataGroup, dim: int) -> torch.Tensor:
    return _along(x, dim, group.all_gather, x.shape[dim] * group.world)


def _reduce_scatter(x, group: DataGroup, dim: int) -> torch.Tensor:
    return _along(x, dim, group.reduce_scatter, x.shape[dim] // group.world)


def _rows(x, group: DataGroup, dim: int) -> torch.Tensor:
    k = x.shape[dim] // group.world
    return x.narrow(dim, group.rank * k, k)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous().clone()), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, 1), None


class _GatherTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, 1), None


class _SplitTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _rows(x, group, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, 1), None


class _WholeTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _rows(g, ctx.group, 1).contiguous(), None


class _GatherVocab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, lo):
        ctx.group, ctx.lo, ctx.k = group, lo, x.shape[-1]
        return gather_tensor(x.contiguous(), Spec(x.dim() - 1, n, uneven=True), group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.lo, ctx.k).contiguous(), None, None, None


class _FirstRank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.keep = group.rank == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


class _Partial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, sink):
        ctx.sink, ctx.p = sink, p
        return p.view_as(p)

    @staticmethod
    def backward(ctx, g):
        ctx.sink.add(ctx.p, g)
        return None, None


def copy_to_model(x, group: DataGroup):
    return x if group.world == 1 else _Copy.apply(x, group)


def reduce_from_model(x, group: DataGroup):
    return x if group.world == 1 else _Reduce.apply(x, group)


def scatter_time(x, group: DataGroup):
    return _ScatterTime.apply(x, group)


def gather_time(x, group: DataGroup):
    return _GatherTime.apply(x, group)


def split_time(x, group: DataGroup):
    return _SplitTime.apply(x, group)


def whole_time(x, group: DataGroup):
    return _WholeTime.apply(x, group)


def gather_vocab(x, group: DataGroup, n: int, lo: int):
    """[..., n] logits from every rank's vocabulary columns [..., k] (this
    rank's start at `lo`)."""
    return x if group.world == 1 else _GatherVocab.apply(x, group, n, lo)


def first_rank_grad(x, group: DataGroup):
    return x if group.world == 1 else _FirstRank.apply(x, group)


# ------------------------------------------------------------ the model group

class PartialGrads:
    """Gradients of replicated parameters over this rank's rows only,
    summed over the model group once a step (`reduce_into`)."""

    def __init__(self):
        self.grads: Dict[int, list] = {}

    def add(self, p: torch.Tensor, g: torch.Tensor) -> None:
        entry = self.grads.get(id(p))
        if entry is None:
            self.grads[id(p)] = [p, g.detach().clone()]
        else:
            entry[1] += g.detach()

    def reduce_into(self, params: List[torch.Tensor], grads: List[torch.Tensor],
                    group: DataGroup) -> List[torch.Tensor]:
        """`grads` (in `params`' order) plus the model group's sum of the
        partial gradients, in one all-reduce; the sink empties."""
        if not self.grads:
            return grads
        index = {id(p): i for i, p in enumerate(params)}
        held = [(index[k], g) for k, (_, g) in self.grads.items() if k in index]
        self.grads.clear()
        if not held:
            return grads
        flat = group.all_reduce(torch.cat([g.reshape(-1) for _, g in held]))
        out = list(grads)
        for (i, g), piece in zip(held, flat.split([g.numel() for _, g in held])):
            out[i] = out[i] + piece.view(g.shape)
        return out


class TensorParallel:
    """A model's view of its model group: `group` (a `DataGroup` of M
    ranks), whether sequence parallelism is on, and the sink of partial
    gradients."""

    def __init__(self, group: DataGroup, sequence_parallel: bool = True):
        self.group = group
        self.sequence_parallel = bool(sequence_parallel)
        self.sink = PartialGrads()

    @property
    def size(self) -> int:
        return self.group.world

    def shards_time(self, t: int) -> bool:
        """Whether a site of T = `t` rows runs on T-shards (`shard_time`)."""
        m = self.group.world
        return self.sequence_parallel and m > 1 and t > 1 and t % m == 0

    def enter(self, x: torch.Tensor, sharded: bool) -> torch.Tensor:
        """The whole input of a column-parallel product: gathered from
        T-shards, or a whole activation whose gradient the group sums."""
        return gather_time(x, self.group) if sharded else copy_to_model(x, self.group)

    def leave(self, y: torch.Tensor, bias: Optional[torch.Tensor], sharded: bool) -> torch.Tensor:
        """A row-parallel product's partial sums -> T-shards (reduce-
        scatter) or the whole activation (all-reduce), plus `bias`, partial
        on T-shards."""
        if sharded:
            y = scatter_time(y, self.group)
            return y if bias is None else y + self.partial(bias).to(y.dtype)
        y = reduce_from_model(y, self.group)
        return y if bias is None else y + bias.to(y.dtype)

    def partial(self, p: torch.Tensor) -> torch.Tensor:
        return _Partial.apply(p, self.sink)


def time_shards(x: torch.Tensor, tp: Optional[TensorParallel]) -> bool:
    """Whether a stack whose activations are x [B, T, ...] runs its sites
    on T-shards."""
    return tp is not None and x.dim() >= 3 and tp.shards_time(x.shape[1])


def to_shards(x: torch.Tensor, tp: Optional[TensorParallel], sharded: bool) -> torch.Tensor:
    """A stack's whole input -> this rank's T rows (where `sharded`)."""
    return split_time(x, tp.group) if sharded else x


def to_whole(x: torch.Tensor, tp: Optional[TensorParallel], sharded: bool) -> torch.Tensor:
    """A stack's T-shards -> its whole output (where `sharded`)."""
    return whole_time(x, tp.group) if sharded else x


# ------------------------------------------------------------ placement

def shard_module(module: nn.Module, tp: TensorParallel) -> Dict[str, Spec]:
    """Cut `module`'s sharded parameters (`param_specs`) to this rank's
    shards, as new parameters, and give every submodule with a `tp`
    attribute the model group.  Returns the specs by name."""
    specs = param_specs(module)
    g = tp.group
    for name, spec in specs.items():
        owner_name, leaf = name.rsplit(".", 1)
        owner = module.get_submodule(owner_name)
        p = owner._parameters[leaf]
        owner._parameters[leaf] = nn.Parameter(
            shard_tensor(p.detach(), spec, g.rank, g.world).clone(),
            requires_grad=p.requires_grad)
    for m in module.modules():
        if hasattr(m, "tp"):
            m.tp = tp
    return specs


@contextlib.contextmanager
def full_tables(module: nn.Module, specs: Dict[str, Spec], group: DataGroup):
    """Within: every sharded parameter of `module` whole (gathered over the
    model group); after it, its shard again."""
    swapped = []
    if group.world > 1:
        for name, spec in specs.items():
            owner_name, leaf = name.rsplit(".", 1)
            owner = module.get_submodule(owner_name)
            local = owner._parameters[leaf]
            whole = gather_tensor(local.detach().contiguous(), spec, group)
            owner._parameters[leaf] = nn.Parameter(whole, requires_grad=local.requires_grad)
            swapped.append((owner, leaf, local))
    try:
        yield
    finally:
        for owner, leaf, local in swapped:
            owner._parameters[leaf] = local
