"""The solver's side of the data axis: gradient reduction, ZeRO-1 and the
global norm.

Counterpart of what the JAX solver gets from GSPMD on a `data` mesh
(openasr_tpu/solvers/__init__.py: the gradient all-reduce, `zero1_sharding`
of the optimizer moments, expert-sharded MoE tables).  Each rank
backpropagates its own loss numerators over the global counts, so the SUM
of the ranks' gradients is the one-process gradient.  Every trainable
parameter is one of three kinds:

  replicated  its gradient is all-reduced (flat buckets, after the last
              micro-batch of an accumulation group); every rank updates it
              alike;
  zero1       (`training.zero1`, default on, at a world above 1) the
              parameter's optimizer state holds only this rank's shard
              along `zero1_dim`: the gradient is reduce-scattered into
              that shard, the optimizer updates the shard in place (a view
              of the parameter), and the shards are all-gathered back;
  expert      an expert table of this rank's experts (expert
              parallelism): its gradient is complete on its owner, so it
              leaves the reduction and ZeRO-1.

Under tensor parallelism (a grid's `model` group of size above 1) two
more kinds sit beside those three:

  model-sharded  a leaf of the rule table (parallel/tensor_parallel.py):
                 this rank holds its shard, whose gradient is complete
                 for the shard; it is reduced over the data group alone,
                 and ZeRO-1 shards the local shard along `zero1_dim` of the
                 local shape, never the dimension the model axis took
                 (`zero1_sharding` extends the TP spec so);
  model-partial  contributions to a replicated leaf's gradient from this
                 rank's T-shard (a LayerNorm's scale and bias, a
                 row-parallel bias at a sequence-parallel site): the
                 solver sums them over the model group once a step
                 (`PartialGrads.reduce_into`) before the data reduction.

On a grid with a pipe axis (GPipe, parallel/pipeline.py) one more:

  pipe-sharded  a layer of this rank's stage of a stacked encoder: only
                this stage holds it; its gradient is reduced over the data
                group of this rank's (p, m) like any other leaf, and its
                moments belong to this stage.

The global norm of the clip counts each shard and expert table once over
the ranks, each stage's layers once over the pipe group and each
replicated leaf once.  The package keeps full moments (`full_state`
gathers the shards over the data and model axes and the stages' moments
over the pipe axis; `shard_state` cuts them back), so a package continues
at any grid and in the JAX package.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from openasr_torch.parallel.mesh import Grid, zero1_dim
from openasr_torch.parallel.tensor_parallel import Spec, full_array, shard_array

BUCKET_ELEMENTS = 1 << 25


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


class DataParallel:
    def __init__(self, grid: Grid, named_params: Dict[str, torch.nn.Parameter],
                 zero1: bool = True, expert: frozenset = frozenset(),
                 tp_specs: Optional[Dict[str, Spec]] = None,
                 stage: frozenset = frozenset()):
        self.group, self.model, self.pipe = grid.data, grid.model, grid.pipe
        self.tp_specs = dict(tp_specs or {})
        self.names = list(named_params)
        self.params = [named_params[n] for n in self.names]
        world = self.group.world
        self.dims: List[Optional[int]] = []
        for n, p in zip(self.names, self.params):
            taken = self.tp_specs[n].dim if n in self.tp_specs else None
            if n in expert:
                self.dims.append(0)
            elif zero1 and world > 1:
                self.dims.append(zero1_dim(tuple(p.shape), world, taken))
            else:
                self.dims.append(None)
        self.kind = ["expert" if n in expert else ("zero1" if d is not None else "replicated")
                     for n, d in zip(self.names, self.dims)]
        self.sharded = [k != "replicated" for k in self.kind]
        self.msharded = [n in self.tp_specs for n in self.names]
        self.psharded = [n in stage for n in self.names]
        self.stage_names = [n for n in self.names if n in stage]

    def _shard(self, t: torch.Tensor, i: int) -> torch.Tensor:
        d = self.dims[i]
        k = t.shape[d] // self.group.world
        return t.narrow(d, self.group.rank * k, k)

    def optimizer_params(self) -> Dict[str, torch.Tensor]:
        """What the optimizer updates: each parameter, or for a ZeRO-1
        leaf this rank's shard (a view, so the update lands in place)."""
        return {n: (self._shard(p.detach(), i) if self.kind[i] == "zero1" else p)
                for i, (n, p) in enumerate(zip(self.names, self.params))}

    # ------------------------------------------------------------ the step

    def reduce(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The optimizer's gradients from this rank's: replicated leaves
        all-reduced, ZeRO-1 leaves reduce-scattered into this rank's shard,
        expert tables as they are."""
        group = self.group
        if group.world == 1:
            return grads
        out = list(grads)
        rep = [i for i, k in enumerate(self.kind) if k == "replicated"]
        for bucket in self._buckets(rep, grads):
            flat = group.all_reduce(_flat([grads[i] for i in bucket]))
            for i, piece in zip(bucket, flat.split([grads[i].numel() for i in bucket])):
                out[i] = piece.view(grads[i].shape)
        z = [i for i, k in enumerate(self.kind) if k == "zero1"]
        if z:
            n = group.world
            moved = [grads[i].movedim(self.dims[i], 0).reshape(n, -1) for i in z]
            shard = torch.empty(sum(m.shape[1] for m in moved), dtype=moved[0].dtype,
                                device=moved[0].device)
            group.reduce_scatter(shard, torch.cat(moved, dim=1).reshape(-1))
            for i, m, piece in zip(z, moved, shard.split([m.shape[1] for m in moved])):
                shape = list(grads[i].movedim(self.dims[i], 0).shape)
                shape[0] //= n
                out[i] = piece.view(shape).movedim(0, self.dims[i])
        return out

    @staticmethod
    def _buckets(idx: List[int], tensors: List[torch.Tensor]) -> List[List[int]]:
        buckets, cur, size = [], [], 0
        for i in idx:
            cur.append(i)
            size += tensors[i].numel()
            if size >= BUCKET_ELEMENTS:
                buckets.append(cur)
                cur, size = [], 0
        return buckets + ([cur] if cur else [])

    def norm(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """The global L2 norm of a gradient list in the optimizer's order:
        the shards' and expert tables' squares summed over ranks, the
        replicated leaves' once."""
        norms = torch.stack(torch._foreach_norm(tensors))
        if ((self.model.world > 1 and any(self.msharded))
                or (self.pipe.world > 1 and any(self.psharded))):
            return self._grid_norm(norms)
        if self.group.world == 1 or not any(self.sharded):
            return torch.linalg.vector_norm(norms)
        mask = torch.tensor(self.sharded, device=norms.device)
        sq = norms * norms
        parts = torch.stack([torch.where(mask, sq, 0.0).sum(), torch.where(mask, 0.0, sq).sum()])
        shared = self.group.all_reduce(parts[:1].clone())
        return torch.sqrt(shared[0] + parts[1])

    def _grid_norm(self, norms: torch.Tensor) -> torch.Tensor:
        """The global norm on a (pipe, data, model) grid: the squares of
        leaves sharded over data summed over the data group, those sharded
        over model over the model group, those sharded over both over both,
        those of this stage's layers then over the pipe group, and the
        replicated ones once."""
        d = torch.tensor(self.sharded, device=norms.device)
        m = torch.tensor(self.msharded, device=norms.device)
        p = torch.tensor(self.psharded, device=norms.device)
        sq = norms * norms

        def part(mask):
            return torch.where(mask, sq, 0.0).sum()

        over_data = self.group.all_reduce(torch.stack(
            [part(d & ~m & ~p), part(d & m & ~p), part(d & ~m & p), part(d & m & p)]))
        over_model = self.model.all_reduce(torch.stack(
            [part(~d & m & ~p) + over_data[1], part(~d & m & p) + over_data[3]]))
        over_pipe = self.pipe.all_reduce(
            (part(~d & ~m & p) + over_data[2] + over_model[1]).reshape(1))
        return torch.sqrt(part(~d & ~m & ~p) + over_data[0] + over_model[0] + over_pipe[0])

    @torch.no_grad()
    def gather_params(self) -> None:
        """After the update: every ZeRO-1 leaf's shards all-gathered into
        the full parameter."""
        z = [i for i, k in enumerate(self.kind) if k == "zero1"]
        if not z:
            return
        n = self.group.world
        moved = [self._shard(self.params[i].detach(), i).movedim(self.dims[i], 0) for i in z]
        local = _flat([m.contiguous() for m in moved])
        full = torch.empty(n * local.numel(), dtype=local.dtype, device=local.device)
        self.group.all_gather(full, local).view(n, -1)
        for i, m, piece in zip(z, moved, full.view(n, -1).split([m.numel() for m in moved],
                                                                 dim=1)):
            whole = piece.reshape(n * m.shape[0], *m.shape[1:]).movedim(0, self.dims[i])
            self.params[i].data.copy_(whole)

    # ------------------------------------------------------------ packaging

    def full_state(self, state: dict) -> dict:
        """An optimizer `state_dict` with every sharded moment (ZeRO-1
        shards, expert tables' moments, model shards) all-gathered to the
        full leaf, in the one-process layout.  A collective: every rank
        calls it."""
        state = self._full_over_data(state)
        if self.model.world > 1 and self.tp_specs:
            state = dict(state)
            for key, moments in list(state.items()):
                if not (isinstance(moments, dict) and set(moments) == set(self.names)):
                    continue
                state[key] = {n: (full_array(np.asarray(v, np.float32), self.tp_specs[n],
                                             self.model)
                                  if n in self.tp_specs else v) for n, v in moments.items()}
        return self._full_over_pipe(state)

    def _full_over_pipe(self, state: dict) -> dict:
        """Every stage's moments of its layers, all-gathered over the pipe
        group and named by their global layer index."""
        group = self.pipe
        if group.world == 1 or not self.stage_names:
            return state
        state = dict(state)
        per = len({_STAGE_LAYER.search(n).group(2) for n in self.stage_names})
        for key, moments in list(state.items()):
            if not (isinstance(moments, dict) and set(moments) == set(self.names)):
                continue
            local = [np.asarray(moments[n], np.float32) for n in self.stage_names]
            flat = torch.from_numpy(np.concatenate([v.reshape(-1) for v in local])).to(
                group.comm_device)
            full = torch.empty(group.world * flat.numel(), dtype=flat.dtype, device=flat.device)
            full = group.all_gather(full, flat).view(group.world, -1).cpu().numpy()
            moments = dict(moments)
            for r in range(group.world):
                off = 0
                for n, v in zip(self.stage_names, local):
                    moments[_shift_layer(n, (r - group.rank) * per)] = (
                        full[r, off:off + v.size].reshape(v.shape))
                    off += v.size
            state[key] = moments
        return state

    def _full_over_data(self, state: dict) -> dict:
        if self.group.world == 1 or not any(self.sharded):
            return state
        state = dict(state)
        n = self.group.world
        idx = [i for i, s in enumerate(self.sharded) if s]
        for key, moments in list(state.items()):
            if not (isinstance(moments, dict) and set(moments) == set(self.names)):
                continue
            moved = [np.moveaxis(np.asarray(moments[self.names[i]], np.float32), self.dims[i], 0)
                     for i in idx]
            local = torch.from_numpy(np.concatenate([m.reshape(-1) for m in moved])).to(
                self.group.comm_device)
            full = torch.empty(n * local.numel(), dtype=local.dtype, device=local.device)
            full = self.group.all_gather(full, local).view(n, -1).cpu().numpy()
            moments = dict(moments)
            off = 0
            for i, m in zip(idx, moved):
                piece = full[:, off:off + m.size].reshape((n * m.shape[0],) + m.shape[1:])
                moments[self.names[i]] = np.ascontiguousarray(np.moveaxis(piece, 0,
                                                                          self.dims[i]))
                off += m.size
            state[key] = moments
        return state

    def shard_state(self, state: dict) -> dict:
        """A full optimizer `state_dict` cut to this rank's shards (and to
        its stage's layers)."""
        if self.pipe.world > 1:
            state = {k: ({n: m[n] for n in self.names}
                         if isinstance(m, dict) and set(self.names) <= set(m) else m)
                     for k, m in state.items()}
        if self.model.world > 1 and self.tp_specs:
            state = dict(state)
            m = self.model
            for key, moments in list(state.items()):
                if isinstance(moments, dict) and set(moments) == set(self.names):
                    state[key] = {n: (shard_array(v, self.tp_specs[n], m.rank, m.world)
                                      if n in self.tp_specs else v)
                                  for n, v in moments.items()}
        if self.group.world == 1 or not any(self.sharded):
            return state
        state = dict(state)
        for key, moments in list(state.items()):
            if not (isinstance(moments, dict) and set(moments) == set(self.names)):
                continue
            moments = dict(moments)
            for i, n in enumerate(self.names):
                if self.sharded[i]:
                    moments[n] = self._shard(torch.from_numpy(np.asarray(moments[n])), i).numpy()
            state[key] = moments
        return state


_STAGE_LAYER = re.compile(r"(^|\.)stack\.layer(\d+)\.")


def _shift_layer(name: str, shift: int) -> str:
    """A stacked encoder's parameter `name` of layer i -> of layer i + shift."""
    return _STAGE_LAYER.sub(lambda m: f"{m.group(1)}stack.layer{int(m.group(2)) + shift}.",
                            name, count=1)


@contextlib.contextmanager
def full_expert_tables(module: torch.nn.Module):
    """Within: every expert-parallel MoE layer of `module` holds its whole
    tables, all-gathered from their owners (for the package, in the JAX
    layout [E, ...]); after it, its own experts' again."""
    from openasr_torch.models.moe import MoEFeedForward

    swapped = []
    for m in module.modules():
        if isinstance(m, MoEFeedForward) and m.ep_group is not None:
            group = m.ep_group
            for name in m.table_names():
                local = m._parameters[name]
                full = torch.empty((group.world * local.numel(),), dtype=local.dtype,
                                   device=local.device)
                group.all_gather(full, local.detach().reshape(-1).contiguous())
                m._parameters[name] = torch.nn.Parameter(
                    full.view(group.world * local.shape[0], *local.shape[1:]),
                    requires_grad=local.requires_grad)
                swapped.append((m, name, local))
    try:
        yield
    finally:
        for m, name, local in swapped:
            m._parameters[name] = local
