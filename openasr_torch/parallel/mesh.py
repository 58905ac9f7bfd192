"""The grid of ranks: a (pipe, data, model) layout of processes, one card a
rank.

Counterpart of openasr_tpu/parallel/mesh.py's (pipe, data, model) mesh.  The
JAX package shards the global batch over its mesh's `data` axis, the layers
over its `model` axis and the stacked encoder layers over its `pipe` axis
and lets XLA insert the collectives; here each rank is a process and a
`Grid` carries its collectives, so that N ranks compute what one process
computes on the global batch:

- `Grid`: rank = p * data * model + d * model + m (`make_mesh`'s layout,
  the pipe axis outermost: each model group is `model` consecutive ranks,
  each pipe stage data * model consecutive ones).  `grid.data` is a
  `DataGroup` over the ranks that share this rank's (p, m) (the gradients,
  loss normalizers, BatchNorm statistics and every other collective of the
  data axis), `grid.model` one over the ranks that share its (p, d) (tensor
  and sequence parallelism, parallel/tensor_parallel.py), `grid.pipe` one
  over the ranks that share its (d, m) (the GPipe stages,
  parallel/pipeline.py), `grid.everyone` the world (the preemption
  agreement).  Sizes of 1 make `data` the world and the other groups
  groups of one; a world of 1 is the same code with no collective.
- `init_distributed` reads torchrun's environment (`RANK`, `WORLD_SIZE`,
  `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`), as
  `jax.distributed.initialize()` reads its coordinator: NCCL on cards
  (`cuda:LOCAL_RANK`, one card a rank), gloo on the CPU.  `new_group`
  takes the coordinates explicitly (gloo also runs several ranks on one
  card).
- `validate_layout` keeps the JAX package's checks of a process layout,
  with its messages; a JAX host is a process with many devices, here a
  rank is one card, so a "host" is a torchrun node (`LOCAL_WORLD_SIZE`
  ranks): a model group may not span nodes, and a layout with a pipe axis
  lives on one node (JAX pipe meshes are single-host).
- `all_gather_host` gathers a small host array from every rank;
  `reconcile_batch` pads every rank's batch to the cross-rank maximum of
  each non-batch dimension (one all_reduce(MAX)), so that the padded
  length that the MoE capacity and the BatchNorm statistics read is the
  global batch's; it asserts equal local batch sizes.
- `partition_seed` is the dropout seed of a shard, the rule of
  openasr_tpu/kernels/partition.py: seed + shard_id * 0x85EBCA6B mod 2^32
  (shard 0's seed unchanged); `shard_id(d, m, M)` folds the axes of the
  attention kernel's shardable factors b (data) and h (model) in sorted
  order, d * 0x9E3779B9 + m mod 2^32 (d at a model size of 1, where the
  heads are not sharded).
- `rand_rows` draws per-row host randomness for the global batch and keeps
  this rank's rows, so that rank r's rows get the one-process run's draws.
- `zero1_dim` is ZeRO-1's shard rule (`zero1_sharding`): the largest
  dimension that the world size divides.
- `all_reduce_with_grad`, `gather_rows` and `experts_to_owners` /
  `experts_to_tokens` are collectives with their backward (all_reduce,
  all_reduce, the mirror all_to_all).

A world of 1 is the same code with no collective.  Every collective goes
through a `DataGroup` method, which counts its calls and bytes
(`calls`, `bytes`), so that a caller can see what a step sent.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

SHARD_SEED_MULT = 0x85EBCA6B
_MASK32 = 0xFFFFFFFF
SHARD_AXIS_MULT = 0x9E3779B9
ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


class DataGroup:
    """The ranks of the data axis: `rank` of `world`, the process group
    (None at a world of 1) and the rank's `device`.  Collectives of a
    world of 1 return their input."""

    def __init__(self, rank: int = 0, world: int = 1, device="cpu",
                 group=None, backend: Optional[str] = None):
        self.rank, self.world = int(rank), int(world)
        self.device = torch.device(device)
        self.group = group
        self.backend = backend
        self.calls: Dict[str, int] = collections.Counter()
        self.bytes: Dict[str, int] = collections.Counter()

    @property
    def comm_device(self) -> torch.device:
        """Where host values go for a collective: the card under NCCL,
        the CPU under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def reset_counts(self) -> None:
        self.calls.clear()
        self.bytes.clear()

    def _count(self, name: str, t: torch.Tensor) -> None:
        self.calls[name] += 1
        self.bytes[name] += t.numel() * t.element_size()

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In place; returns `t`."""
        if self.world > 1:
            self._count("all_reduce", t)
            dist.all_reduce(t, _OPS[op], group=self.group)
        return t

    def all_gather(self, out: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """out [world * n] <- every rank's t [n], rank order."""
        if self.world == 1:
            return out.copy_(t.reshape(out.shape))
        self._count("all_gather", t)
        dist.all_gather_into_tensor(out, t, group=self.group)
        return out

    def reduce_scatter(self, out: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """out [n] <- the sum over ranks of chunk `rank` of t [world * n]."""
        if self.world == 1:
            return out.copy_(t.reshape(out.shape))
        self._count("reduce_scatter", t)
        dist.reduce_scatter_tensor(out, t, group=self.group)
        return out

    def all_to_all(self, out: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Chunk j of t (dim 0 split in `world`) goes to rank j; chunk j
        of out came from rank j."""
        if self.world == 1:
            return out.copy_(t)
        self._count("all_to_all", t)
        dist.all_to_all_single(out, t, group=self.group)
        return out

    @classmethod
    def single(cls, device="cpu") -> "DataGroup":
        return cls(0, 1, device)


def validate_layout(procs: np.ndarray) -> None:
    """Reject process layouts that the batch plan cannot serve, with the
    JAX package's messages: a (pipe, data, model) layout with a pipe axis
    above 1 may not span processes (`make_mesh`), and of a (data, model)
    one (`_validate_multihost_layout`) a model-parallel group (one mesh
    row) may not span processes, the data axis must divide evenly by the
    process count, and each process's rows must be contiguous.  procs: the
    [data, model] or [pipe, data, model] process index of each device; in
    the port a torchrun node's (`node_layout`), as a rank is one card."""
    if procs.ndim == 3:
        if procs.shape[0] > 1 and len(set(procs.flat)) > 1:
            raise ValueError(
                "pipeline-parallel meshes are single-host for now: the "
                "GPipe executor's ppermute ring has no multi-host batch "
                f"plan; got process layout {procs.tolist()}"
            )
        procs = procs[0]
    nproc = len(set(procs.flat))
    if nproc <= 1:
        return
    data = procs.shape[0]
    if any(len(set(row)) != 1 for row in procs):
        raise ValueError(
            "model-parallel groups may not span hosts: each mesh row (one "
            "tensor-parallel group of the (data, model) mesh) must live on "
            f"a single process, got process layout {procs.tolist()}. Use "
            "--model-parallel <= devices per host."
        )
    if data % nproc != 0:
        raise ValueError(
            f"data axis ({data}) must divide evenly across the "
            f"{nproc} host processes for per-host batch row slicing"
        )
    k = data // nproc
    row_proc = procs[:, 0]
    if any(len(set(row_proc[i * k:(i + 1) * k])) != 1 for i in range(nproc)):
        raise ValueError(
            "data-axis rows must be process-contiguous (host r owns rows "
            f"[r*{k}, (r+1)*{k})); got per-row processes {row_proc.tolist()}"
        )


class Grid:
    """The (pipe, data, model) grid of ranks: this rank's `data` group (the
    ranks of its (p, m)), its `model` group (the ranks of its (p, d)), its
    `pipe` group (the ranks of its (d, m)) and `everyone`.  `rank`,
    `world`, `device` and `backend` are the process's own."""

    def __init__(self, data: DataGroup, model: DataGroup, everyone: DataGroup,
                 pipe: Optional[DataGroup] = None):
        self.data, self.model, self.everyone = data, model, everyone
        self.pipe = pipe if pipe is not None else DataGroup(0, 1, everyone.device,
                                                            backend=everyone.backend)
        self.rank, self.world = everyone.rank, everyone.world
        self.device, self.backend = everyone.device, everyone.backend

    def groups(self) -> Dict[str, DataGroup]:
        """The distinct groups by axis name (`everyone` only where it is
        not the data group)."""
        out = {"data": self.data, "model": self.model, "pipe": self.pipe}
        if self.everyone is not self.data:
            out["everyone"] = self.everyone
        return out

    def reset_counts(self) -> None:
        for g in self.groups().values():
            g.reset_counts()

    @classmethod
    def single(cls, device="cpu") -> "Grid":
        one = DataGroup.single(device)
        return cls(one, DataGroup.single(device), one)


def node_layout(world: int, model: int, local_world: Optional[int] = None,
                pipe: int = 1) -> np.ndarray:
    """The node index of each rank (rank = p * D * M + d * M + m; node =
    rank // local_world, torchrun's LOCAL_WORLD_SIZE ranks a node, all of
    them on one node by default), [data, model], or [pipe, data, model]
    with a pipe axis above 1: the process layout that `validate_layout`
    checks, a node standing for a JAX host."""
    if model < 1 or pipe < 1 or world % (model * pipe):
        axes = (f"--model-parallel {model}" if pipe == 1
                else f"--model-parallel {model} x --pipeline {pipe}")
        raise ValueError(f"world size {world} not divisible by {axes}")
    local_world = world if local_world is None else int(local_world)
    nodes = np.arange(world) // local_world
    if pipe > 1:
        return nodes.reshape(pipe, world // (model * pipe), model)
    return nodes.reshape(world // model, model)


def new_group(rank: int, world: int, init_method: str, backend: str,
              device, model: int = 1, local_world: Optional[int] = None,
              pipe: int = 1) -> Grid:
    """Join the process group at `init_method` (tcp://host:port) as `rank`
    of `world` over `backend`, the rank on `device`, on a grid of `pipe`
    stages of world / (model * pipe) data rows of `model` ranks.  Every
    rank creates every sub-group, in the same order (torch's `new_group`
    rule): the data groups of each (p, m), then the model groups of each
    (p, d), then the pipe groups of each (d, m)."""
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the NCCL backend needs a card: pass a cuda device")
        torch.cuda.set_device(device)
    validate_layout(node_layout(world, model, local_world, pipe))
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    everyone = DataGroup(rank, world, device, group=dist.group.WORLD, backend=backend)
    if model == 1 and pipe == 1:
        return Grid(everyone, DataGroup(0, 1, device, backend=backend), everyone)
    rows = world // (model * pipe)
    p, rest = divmod(rank, rows * model)
    d, m = divmod(rest, model)

    def sub(ranks):
        ranks = list(ranks)
        return dist.new_group(ranks, backend=backend) if len(ranks) > 1 else None

    def at(pp, dd, mm):
        return pp * rows * model + dd * model + mm

    data = {(pp, mm): sub(at(pp, dd, mm) for dd in range(rows))
            for pp in range(pipe) for mm in range(model)}[p, m]
    mod = {(pp, dd): sub(at(pp, dd, mm) for mm in range(model))
           for pp in range(pipe) for dd in range(rows)}[p, d]
    stage = {(dd, mm): sub(at(pp, dd, mm) for pp in range(pipe))
             for dd in range(rows) for mm in range(model)}[d, m]
    return Grid(DataGroup(d, rows, device, group=data, backend=backend),
                DataGroup(m, model, device, group=mod, backend=backend), everyone,
                DataGroup(p, pipe, device, group=stage, backend=backend))


def init_distributed(device_type: str = "cuda", env=None, model: int = 1,
                     pipe: int = 1) -> Grid:
    """The rank's grid from torchrun's environment, `model` ranks a model
    group and `pipe` pipeline stages: `cuda:LOCAL_RANK` over NCCL, or the
    CPU over gloo with `device_type` "cpu".  Raises naming the variables
    that are missing."""
    env = os.environ if env is None else env
    missing = [k for k in ENV if k not in env]
    if missing:
        raise RuntimeError(
            f"--distributed needs torchrun's environment; {', '.join(missing)} "
            "not set: launch with python -m torch.distributed.run "
            "--nproc-per-node N -m openasr_torch.bin.train <config> --distributed"
        )
    rank, world, local = int(env["RANK"]), int(env["WORLD_SIZE"]), int(env["LOCAL_RANK"])
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    init = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if device_type == "cpu":
        return new_group(rank, world, init, "gloo", "cpu", model, local_world, pipe)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda but torch.cuda.is_available() is False; pass "
            "--device cpu to run on the CPU"
        )
    cards = torch.cuda.device_count()
    if local >= cards:
        raise ValueError(
            f"LOCAL_RANK {local} but this host has {cards} card(s): NCCL runs one "
            "rank a card (--nproc-per-node at most the card count)"
        )
    return new_group(rank, world, init, "nccl", f"cuda:{local}", model, local_world, pipe)


def destroy(group) -> None:
    if group.world > 1 and dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------ host data

def all_gather_host(group: DataGroup, local: np.ndarray) -> np.ndarray:
    """[world, *local.shape] on every rank: each rank's small host array
    (`_allgather_host_data`), through one all_reduce of a zero-filled
    buffer (so that gloo on a card can carry it too)."""
    local = np.asarray(local)
    if group.world == 1:
        return local[None]
    dtype = torch.float64 if local.dtype.kind == "f" else torch.int64
    buf = torch.zeros((group.world,) + local.shape, dtype=dtype, device=group.comm_device)
    buf[group.rank] = torch.from_numpy(local.astype(np.float64 if dtype == torch.float64
                                                    else np.int64))
    return group.all_reduce(buf).cpu().numpy().astype(local.dtype)


def reconcile_batch(group: DataGroup, batch: dict) -> dict:
    """Pad every array field's non-batch dimensions to the cross-rank
    maximum (`_shard_batch_multihost`'s reconciliation), with one
    all_reduce(MAX) of the shapes and their negatives; the batch
    dimensions must agree.  New label positions get `paddings` 1, every
    other field 0; the lengths fields mask the rest, as in the one-process
    batch, whose padded shapes these are."""
    if group.world == 1:
        return batch
    keys = sorted(k for k, v in batch.items() if isinstance(v, np.ndarray))
    shapes = np.zeros((len(keys), 8), np.int64)
    for i, k in enumerate(keys):
        shapes[i, :batch[k].ndim] = batch[k].shape
    both = torch.from_numpy(np.concatenate([shapes, -shapes])).to(group.comm_device)
    both = group.all_reduce(both, "max").cpu().numpy()
    hi, lo = both[:len(keys)], -both[len(keys):]
    out = dict(batch)
    for i, k in enumerate(keys):
        v = batch[k]
        tgt = tuple(int(d) for d in hi[i, :v.ndim])
        assert tgt[0] == lo[i, 0] == v.shape[0], (
            f"{k}: per-host batch dims differ ({v.shape[0]} vs {tgt[0]}) — "
            "every host must load the same local batch size"
        )
        if tgt != v.shape:
            pad = 1 if k.endswith("paddings") else 0
            out[k] = np.pad(v, [(0, t - s) for s, t in zip(v.shape, tgt)],
                            constant_values=pad)
    return out


# ------------------------------------------------------------ randomness

def partition_seed(seed: int, shard_id: int) -> int:
    """The dropout seed of shard `shard_id` (`shard_id(d, m)`): the seed of
    openasr_tpu/kernels/partition.py, seed + shard_id * 0x85EBCA6B mod
    2^32."""
    return (int(seed) + int(shard_id) * SHARD_SEED_MULT) & _MASK32


def shard_id(data_index: int, model_index: int = 0, model_size: int = 1) -> int:
    """The attention kernel's shard id at grid position (d, m): the axes of
    its shardable factors b (data) and h (model, where the model axis
    shards the heads: a model size above 1), folded in sorted order,
    d * 0x9E3779B9 + m mod 2^32, and d alone at a model size of 1
    (partition.py's `lower_fn`)."""
    if model_size == 1:
        return int(data_index) & _MASK32
    return (int(data_index) * SHARD_AXIS_MULT + int(model_index)) & _MASK32


def rand_rows(generator: torch.Generator, shape: Sequence[int], dim: int = 0,
              rank: int = 0, world: int = 1) -> torch.Tensor:
    """Uniform draws of `shape` (this rank's b rows at `dim`) cut from one
    draw for the global batch of world * b rows: rank r's rows get the
    draws that the one-process run gives them."""
    full = list(shape)
    b = full[dim]
    full[dim] = b * world
    u = torch.rand(full, generator=generator)
    return u if world == 1 else u.narrow(dim, rank * b, b)


# ------------------------------------------------------------ ZeRO-1

def zero1_dim(shape: Sequence[int], world: int, taken: Optional[int] = None) -> Optional[int]:
    """The dimension ZeRO-1 shards (`zero1_sharding`): the largest one
    that `world` divides (the first of equal ones), other than `taken`
    (the dimension that the model axis shards, which `zero1_sharding`
    leaves to it); None for a scalar, a world of 1, or no such
    dimension."""
    if world <= 1 or not shape:
        return None
    best, best_size = None, 0
    for i, d in enumerate(shape):
        if i != taken and d % world == 0 and d > best_size:
            best, best_size = i, d
    return best


# ------------------------------------------------------------ collectives with a backward

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous().clone()), None


def all_reduce_with_grad(group: DataGroup, x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of x; its gradient is the sum over ranks of the
    output's (each rank's loss reaches every rank's x)."""
    return x if group.world == 1 else _AllReduce.apply(x, group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        b = x.shape[0]
        buf = x.new_zeros((group.world * b,) + tuple(x.shape[1:]))
        buf[group.rank * b:(group.rank + 1) * b] = x
        return group.all_reduce(buf)

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        g = group.all_reduce(g.contiguous().clone())
        b = g.shape[0] // group.world
        return g[group.rank * b:(group.rank + 1) * b], None


def gather_rows(group: DataGroup, x: torch.Tensor) -> torch.Tensor:
    """[world * b, ...]: every rank's rows x [b, ...] in rank order (one
    all_reduce of a zero-filled buffer); the backward sums the gradient
    over ranks and keeps this rank's rows."""
    return x if group.world == 1 else _GatherRows.apply(x, group)


def _exchange(x: torch.Tensor, group: DataGroup, to_owners: bool) -> torch.Tensor:
    n = group.world
    if to_owners:
        # [E, B, C, D]: expert chunk j to rank j -> [E/N, N*B, C, D]
        x = x.contiguous()
        out = group.all_to_all(torch.empty_like(x), x)
        e, b = out.shape[0] // n, out.shape[1]
        return out.reshape(n, e, b, *out.shape[2:]).transpose(0, 1).reshape(
            e, n * b, *out.shape[2:])
    # [E/N, N*B, C, D]: batch chunk j back to rank j -> [E, B, C, D]
    e, b = x.shape[0], x.shape[1] // n
    y = x.reshape(e, n, b, *x.shape[2:]).transpose(0, 1).contiguous()
    out = group.all_to_all(torch.empty_like(y), y)
    return out.reshape(n * e, b, *x.shape[2:])


class _ToOwners(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group, True)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, False), None


class _ToTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group, False)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, True), None


def experts_to_owners(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """GShard's dispatch all-to-all: this rank's dispatched tokens
    [E, B, C, D] -> the tokens of the whole batch for the experts that this
    rank owns, [E/N, N*B, C, D] (rank order along the batch); the backward
    is the mirror all-to-all."""
    return _ToOwners.apply(x, group)


def experts_to_tokens(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """The mirror all-to-all: the owners' outputs [E/N, N*B, C, D] -> this
    rank's tokens' outputs from every expert, [E, B, C, D]."""
    return _ToTokens.apply(x, group)
