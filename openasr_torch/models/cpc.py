"""CPC self-supervised pretraining (`encoder_cpc`, alias `cpc_model`).

Counterpart of openasr_tpu/models/cpc.py: WavConv (x160) -> a GRU over
the full padded sequence (unidirectional, so its output at the anchor t
is that of the prefix run) -> the context c_t -> `n_steps` prediction
heads `mappings_{k}` -> the dot-product grid prob[k, i, j] between the
softmaxed targets z[i, t+1+k] and the softmaxed predictions of row j.
loss = sum(1 - diag) + sum(negatives), a negative being row i's
prediction scored against the target of row neg_idx[i].

As `jax.lax.dynamic_slice_in_dim` does, the target window and the
context index are clamped into the sequence: where t + 1 + n_steps runs
past T', the window shifts back to end at T'.  The anchor t is drawn in
[1, max(min_len_z - n_steps, 2)), min_len_z the shortest utterance's
frames, and each row's negative is a different row: (i + offset_i) % B,
offset_i in [1, B).  A training forward draws from the `TrainRNG`'s host
generator, the dev pass from a generator seeded 0 each call (the JAX
package draws its dev anchors from a fixed key too); the bound and the
anchor are computed on the device, so a step reads nothing back.  The
module takes `t_samples` and `neg_idx` as arguments, as the JAX module
does.  Under data parallelism (the model's `data_group`) the anchor and
the negatives are the global batch's, and a row's negative may live on
another rank: every rank gathers the global batch's predictions
(`gather_rows`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from openasr_torch.config import Config
from openasr_torch.models import Framework, register_model
from openasr_torch.models.encoder import GRUEncoder
from openasr_torch.models.frontend import WavConv
from openasr_torch.models.layers import TrainRNG, autocast_off
from openasr_torch.parallel.mesh import DataGroup, gather_rows


class CPCModule(nn.Module):
    def __init__(self, d_model: int, d_input: int, d_coding: int, n_layers: int,
                 n_steps: int):
        super().__init__()
        self.n_steps = n_steps
        self.splayer = WavConv(d_model)
        self.rnn = GRUEncoder(d_input, d_coding, n_layers)
        for k in range(n_steps):
            head = nn.Linear(d_coding, d_input)
            head.kernel_init = "lecun_normal"  # flax Dense's default
            self.add_module(f"mappings_{k}", head)
        self.mappings = [getattr(self, f"mappings_{k}") for k in range(n_steps)]

    @staticmethod
    def encoder_lengths(input_lengths):
        return WavConv.output_lengths(input_lengths)

    def forward(self, waves, wave_lengths, t_samples: torch.Tensor, neg_idx: torch.Tensor,
                train: bool = False, group: DataGroup = DataGroup.single()):
        """t_samples: [] int anchor; neg_idx: [B] int negative row of each
        row (a row of the global batch under a data `group`, whose
        predictions every rank gathers).  -> (acc, loss) f32 scalars, this
        rank's rows'."""
        z, len_z = self.splayer(waves, wave_lengths, train=train)
        b, t_max = z.shape[0], z.shape[1]
        k = self.n_steps
        steps = torch.arange(k, device=z.device)
        start = torch.clamp(t_samples + 1, max=t_max - k).clamp(min=0)
        target = z.float().index_select(1, start + steps)
        output, _ = self.rnn(z, len_z)
        c_t = output.index_select(1, t_samples.clamp(0, t_max - 1).reshape(1))[:, 0]
        encode = torch.softmax(target, dim=-1)              # [B, K, C], f32
        preds = torch.stack([torch.softmax(m(c_t).float(), -1) for m in self.mappings], dim=1)
        # the grid in f32: autocast would run the einsum in bf16
        with autocast_off(z.device.type):
            preds = gather_rows(group, preds.float())
            prob = torch.einsum("ikc,jkc->kij", encode, preds)
            diag = torch.diagonal(prob, offset=group.rank * b, dim1=1, dim2=2)   # [K, B]
            neg = prob.gather(2, neg_idx.reshape(1, b, 1).expand(k, b, 1))[..., 0]
            loss = torch.sum(1.0 - diag) + torch.sum(neg)
            n_correct = torch.sum(diag > 0.5) + torch.sum(neg < 0.5)
        return n_correct.float() / (b * k * 2), loss


def draw_anchor(wave_lengths: torch.Tensor, n_steps: int, b: int,
                generator: torch.Generator, group: DataGroup = DataGroup.single()):
    """(t_samples [] int64, neg_idx [B] int64) on the lengths' device, from
    `generator` (a CPU generator).  Under a data `group` they are the
    global batch's: the anchor's bound from the shortest utterance of every
    rank (an all_reduce(MIN)), and this rank's rows of the negatives drawn
    for all world * B rows (indices into the global batch)."""
    rank, world = group.rank, group.world
    u = torch.rand((), generator=generator).to(wave_lengths.device)
    shortest = group.all_reduce(wave_lengths.min().clone(), "min")
    hi = torch.clamp(shortest // 160 - n_steps, min=2)
    t_samples = torch.minimum(1 + torch.floor(u * (hi - 1)).long(), hi - 1)
    n = b * world
    offset = (torch.randint(1, n, (n,), generator=generator) if n > 1
              else torch.ones(n, dtype=torch.int64))
    neg_idx = ((torch.arange(n) + offset) % n)[rank * b:(rank + 1) * b]
    return t_samples, neg_idx.to(wave_lengths.device)


@register_model("encoder_cpc")
class CPCModel(Framework):
    @classmethod
    def build_module(cls, configs: Config) -> nn.Module:
        cpc = configs.cpc or configs.decoder or {}
        d_model = int(configs.signal["d_model"])
        return CPCModule(d_model, int(cpc.get("d_input", d_model)),
                         int(cpc.get("d_coding", 256)), int(cpc.get("n_layers", 1)),
                         int(cpc.get("n_steps", 12)))

    def loss(self, batch: dict, rng: Optional[TrainRNG] = None,
             label_smooth: float = 0.0, empty_rows: Optional[bool] = None) -> dict:
        """{cpc_loss, acc, n_tokens, n_seqs}; `rng` makes it the train
        forward (and the source of the anchor and negatives)."""
        del label_smooth, empty_rows
        waves, lengths = batch["waves"], batch["wave_lengths"]
        b = waves.shape[0]
        gen = rng.host if rng is not None else torch.Generator().manual_seed(0)
        t_samples, neg_idx = draw_anchor(lengths, self.module.n_steps, b, gen, self.data_group)
        acc, loss = self.module(waves, lengths, t_samples, neg_idx, train=rng is not None,
                                group=self.data_group)
        n = torch.tensor(float(b), device=waves.device)
        return {"cpc_loss": loss, "acc": acc, "n_tokens": n, "n_seqs": n}

    def fc_component_names(self) -> tuple:
        return tuple(f"mappings_{k}" for k in range(self.module.n_steps))
