"""Mixture-of-experts FFN: a routed mixture of position-wise FFN experts.

Counterpart of openasr_tpu/models/moe.py on one device.  Every `every`-th
encoder layer's dense FFN becomes `MoEFeedForward` (models/layers.py,
models/encoder.py).  The routing is the JAX package's dense formulation:
one-hot dispatch and combine tensors [B, T, E, C] at a static capacity
C = min(ceil(capacity_factor * T * K / E), T) with K = min(top_k, E), each
batch row its own routing group, and the expert products as four plain
einsums over the expert tables, as the JAX package computes them outside
any Pallas kernel.  T is the padded length of the batch, so the capacity
follows the collate's padding, as the JAX loader's does.

Two routers (`router_type`):

  topk           (GShard / Switch) each token takes its top-K experts, the
                 gates renormalized over the K; the k-th choice of every
                 token is placed after every earlier choice (per-row
                 offsets, the cumsum over T only); a token past an expert's
                 capacity gets 0 there (it survives through the layer's
                 residual add); padding never takes a slot.  The Switch
                 load-balance auxiliary E * sum_e me_e * ce_e over the valid
                 tokens (1 at a uniform router) goes to the loss.
  expert_choice  each expert takes its top-C tokens of the row by router
                 probability, padded tokens masked to -1.0; a slot that
                 took a masked token contributes nothing; the combine
                 weight is the unnormalized probability.  No auxiliary.

The router (a Linear with bias) and its softmax run in f32, with autocast
off, whatever the compute dtype; the dispatch and combine tensors are cast
to the compute dtype for the products.  Both top-k selections go through
`top_indices`, which breaks ties by the lower index on every device (as
jax.lax.top_k does; torch.topk does not), so a zero router routes every
token to experts 0..K-1 as in the JAX package.

The auxiliary is computed only while `aux_sink` is a list (the families'
losses set it through `Framework.forward_with_moe_aux`); the decode paths
leave it None and compute none.  The expert tables keep the flax layout
([E, D, F], [E, F], [E, F, D], [E, D]; GLU adds `w_gate` / `b_gate`) so the
weight bridge and the int8 scales need no transpose.  Dropout on the hidden
activations draws from the port's `TrainRNG`.

Under data parallelism the solver sets `group` (the auxiliary's me, ce and
valid count over the global batch: each rank adds its share) and, when the
world size divides E, `shard_experts` (expert parallelism: rank r owns
experts [r E/N, (r+1) E/N); one all-to-all carries each rank's dispatched
[E, B, C, D] to the owners, which compute [E/N, N B, C, D], and the mirror
all-to-all brings the outputs home).  Capacity and routing are per row, so
they equal the one-process run's at the reconciled padded length.

Under tensor parallelism (`tp`, set by `shard_module`) the expert tables
hold F / M of their inner width (`_moe_entries`), on top of the experts
over data.  The layer gathers its whole input (`tp.enter`), every rank of
the model group routes it alike (the router replicated), the expert
outputs, partial over F, are all-reduced over the model group before the
combine, and a sequence-parallel site keeps its T-shard of the combined
output (`split_time`).  The router's input gradient is kept on model rank 0
alone (`first_rank_grad`): every rank computes the same whole one, and the
input's backward sums the ranks' gradients.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from openasr_torch.models.layers import TrainRNG, activation_dtype, autocast_off, dropout
from openasr_torch.parallel.mesh import DataGroup, experts_to_owners, experts_to_tokens
from openasr_torch.parallel.tensor_parallel import (
    first_rank_grad,
    reduce_from_model,
    split_time,
)


def capacity(tokens: int, num_experts: int, top_k: int, factor: float) -> int:
    """ceil(tokens * top_k * factor / num_experts), at least 1."""
    cap = int(-(-(tokens * top_k * factor) // num_experts))
    return max(cap, 1)


def one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """[..., n] rows with a 1 at each index; an index outside [0, n) gives
    a row of zeros, as jax.nn.one_hot does (F.one_hot raises there)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_indices(values: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest entries along the last axis, largest
    first, equal values by the lower index (jax.lax.top_k's order)."""
    return torch.sort(values, dim=-1, descending=True, stable=True).indices[..., :k]


class MoEFeedForward(nn.Module):
    tp = None

    SUPPORTED_ACTIVATIONS = ("relu", "gelu", "glu")
    SUPPORTED_ROUTERS = ("topk", "expert_choice")

    def __init__(self, d_model: int, dim_feedforward: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25, activation: str = "relu",
                 dropout_rate: float = 0.0, router_type: str = "topk"):
        super().__init__()
        if router_type not in self.SUPPORTED_ROUTERS:
            raise ValueError(f"moe router must be one of {self.SUPPORTED_ROUTERS}, "
                             f"got {router_type!r}")
        if activation not in self.SUPPORTED_ACTIVATIONS:
            raise ValueError(f"moe supports {'/'.join(self.SUPPORTED_ACTIVATIONS)} "
                             f"activations, got {activation!r}")
        e, d, f = num_experts, d_model, dim_feedforward
        self.num_experts, self.top_k = e, top_k
        self.capacity_factor = capacity_factor
        self.activation, self.dropout_rate, self.router_type = activation, dropout_rate, router_type
        self.router = nn.Linear(d, e)
        self.w1 = nn.Parameter(torch.empty(e, d, f))
        self.b1 = nn.Parameter(torch.zeros(e, f))
        self.w2 = nn.Parameter(torch.empty(e, f, d))
        self.b2 = nn.Parameter(torch.zeros(e, d))
        tables, biases = ["w1", "w2"], ["b1", "b2"]
        if activation == "glu":
            self.w_gate = nn.Parameter(torch.empty(e, d, f))
            self.b_gate = nn.Parameter(torch.zeros(e, f))
            tables.append("w_gate")
            biases.append("b_gate")
        # init_parameters: flax's xavier_uniform over the stacked tables
        # (fans D*E and F*E), the bias tables zero
        self.param_inits = {**{n: "xavier_uniform_stacked" for n in tables},
                            **{n: "zeros" for n in biases}}
        self.aux_sink: Optional[list] = None
        self.group = DataGroup.single()  # the auxiliary over this group's global batch
        self.ep_group = None  # set by `shard_experts`: this rank's experts only

    def table_names(self) -> tuple:
        return tuple(n for n in ("w1", "b1", "w2", "b2", "w_gate", "b_gate")
                     if n in self._parameters)

    def shard_experts(self, group) -> tuple:
        """Expert parallelism (`shard_experts` / `_moe_entries` of the JAX
        mesh): keep experts [r E/N, (r+1) E/N) of rank r's tables, as new
        parameters; the forward then carries the dispatched tokens to their
        owners and back.  Returns the tables' names."""
        k = self.num_experts // group.world
        lo = group.rank * k
        for name in self.table_names():
            p = self._parameters[name]
            self._parameters[name] = nn.Parameter(p.detach()[lo:lo + k].clone(),
                                                  requires_grad=p.requires_grad)
        self.ep_group = group
        return self.table_names()

    def forward(self, x: torch.Tensor, rng: Optional[TrainRNG] = None,
                pad_mask: Optional[torch.Tensor] = None, sharded: bool = False) -> torch.Tensor:
        """x [B, T, D] (this rank's T-shard where `sharded`); pad_mask
        [B, T] (true on valid tokens) or None."""
        tp = self.tp
        if tp is not None:
            x = tp.enter(x, sharded)
            combine = self.route(first_rank_grad(x, tp.group), pad_mask)
        else:
            combine = self.route(x, pad_mask)
        xin = self.dispatch(combine, x)
        if self.ep_group is None:
            out = self.expert_ffn(xin, rng)
        else:
            out = experts_to_tokens(
                self.expert_ffn(experts_to_owners(xin, self.ep_group), rng), self.ep_group)
        y = self.combine(out, combine).to(x.dtype)
        return split_time(y, tp.group) if sharded else y

    def route(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The router (f32, autocast off) and its combine tensor
        [B, T, E, C] in f32; the auxiliary goes to `aux_sink` when set."""
        b, t, _ = x.shape
        e = self.num_experts
        k = min(self.top_k, e)
        c = min(capacity(t, e, k, self.capacity_factor), t)
        with autocast_off(x.device.type):
            logits = self.router(x.to(torch.promote_types(x.dtype, self.router.weight.dtype)))
            gates = torch.softmax(logits, dim=-1)                   # [B, T, E] f32
            valid = (pad_mask.to(gates.dtype) if pad_mask is not None
                     else gates.new_ones((b, t)))
            if self.router_type == "expert_choice":
                return self._expert_choice_combine(gates, valid, c)
            if self.aux_sink is not None:
                self.aux_sink.append(self._aux(gates, valid))
            return self._topk_combine(gates, valid, k, c)

    @staticmethod
    def dispatch(combine: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The tokens of each expert's slots, [E, B, C, D] in the compute
        dtype: the one-hot dispatch (combine > 0) times x."""
        dt = activation_dtype(x)
        with autocast_off(x.device.type):
            return torch.einsum("btec,btd->ebcd", (combine > 0).to(dt), x.to(dt))

    def expert_ffn(self, xin: torch.Tensor, rng: Optional[TrainRNG] = None) -> torch.Tensor:
        """Each expert's FFN over its slots, [E, B, C, D] in xin's dtype."""
        dt = xin.dtype
        with autocast_off(xin.device.type):
            h = torch.einsum("ebcd,edf->ebcf", xin, self.w1.to(dt)) + self.b1.to(dt)[:, None, None]
            if self.activation == "relu":
                h = F.relu(h)
            elif self.activation == "gelu":
                h = F.gelu(h)
            else:
                g = (torch.einsum("ebcd,edf->ebcf", xin, self.w_gate.to(dt))
                     + self.b_gate.to(dt)[:, None, None])
                h = h * torch.sigmoid(g)
            tp = self.tp
            h = dropout(h, self.dropout_rate, rng,
                        None if tp is None else (3, tp.group.rank, tp.size))
            y = torch.einsum("ebcf,efd->ebcd", h, self.w2.to(dt))
            if tp is not None:
                y = reduce_from_model(y, tp.group)
            return y + self.b2.to(dt)[:, None, None]

    @staticmethod
    def combine(out: torch.Tensor, combine: torch.Tensor) -> torch.Tensor:
        """The experts' outputs back to the tokens, weighted: [B, T, D]."""
        with autocast_off(out.device.type):
            return torch.einsum("ebcd,btec->btd", out, combine.to(out.dtype))

    # ------------------------------------------------------------ routers

    def _topk_combine(self, gates, valid, k: int, c: int) -> torch.Tensor:
        """combine [B, T, E, C] f32 from each token's renormalized top-k
        gates, GShard's position in expert, capacity c."""
        b, t, e = gates.shape
        top_i = top_indices(gates, k)                               # [B, T, K]
        top_g = gates.gather(-1, top_i)
        top_g = top_g / top_g.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        combine = gates.new_zeros((b, t, e, c))
        offsets = gates.new_zeros((b, e))
        for j in range(k):
            m = one_hot(top_i[..., j], e, gates.dtype) * valid[..., None]
            pos = torch.cumsum(m, dim=1) - m + offsets[:, None, :]
            kept = m * (pos < c).to(gates.dtype)
            # the chosen expert's slot: a position >= c (dropped) gets the
            # zero row
            slot = one_hot((pos * m).sum(dim=-1).to(torch.int64), c, gates.dtype)  # [B, T, C]
            combine = combine + top_g[..., j, None, None] * kept[..., None] * slot[:, :, None, :]
            offsets = offsets + m.sum(dim=1)
        return combine

    @staticmethod
    def _expert_choice_combine(gates, valid, c: int) -> torch.Tensor:
        """combine [B, T, E, C] f32: expert e's c slots hold the row's c
        tokens of the highest router probability for e, masked tokens
        (-1.0) only when no valid one is left, and contribute nothing."""
        t = gates.shape[1]
        masked = torch.where(valid[:, :, None] > 0, gates, torch.full_like(gates, -1.0))
        per_e = masked.transpose(1, 2)                              # [B, E, T]
        idx = top_indices(per_e, c)                                 # [B, E, C]
        g = per_e.gather(-1, idx)
        sel = one_hot(idx, t, gates.dtype)                          # [B, E, C, T]
        picked = sel * (g[..., None] > 0).to(gates.dtype)
        return (g[..., None] * picked).permute(0, 3, 1, 2)

    def _aux(self, gates, valid) -> torch.Tensor:
        """Switch's E * sum_e me_e * ce_e over the valid tokens: me the mean
        router probability of e, ce the share of tokens whose first argmax
        is e."""
        e = gates.shape[-1]
        top1 = one_hot(gates.argmax(dim=-1), e, gates.dtype)
        # the global batch's ce and n_valid (no gradient); this rank's share
        # of me's sum, so that the shares add up, value and gradient, to the
        # one-process auxiliary
        counts = torch.cat([(top1 * valid[..., None]).sum(dim=(0, 1)), valid.sum()[None]])
        counts = self.group.all_reduce(counts.detach().clone())
        n_valid = counts[-1].clamp(min=1.0)
        me = (gates * valid[..., None]).sum(dim=(0, 1)) / n_valid
        return e * (me * (counts[:e] / n_valid)).sum()

