"""WGAN-GP semi-supervised phone2char (`gan_phone2char`): G and D.

Counterpart of openasr_tpu/models/gan.py.  G is Embed_Decoder_CTC's module
(`emb`, `encoder_block`, `ctc_fc`).  D scores probability sequences
[B, T, V]: the input masked in time past each length and zero-padded to
4 * layer_num + 4 frames when shorter, ConvV2 (`encoder`: layer_num 3x3
convolutions, stride 2 in time, d_input = the character vocabulary), a
`score_fc` without bias, and the mean of the scores over each row's
encoded frames (length-normalised, as in the JAX package).

One training loss sums three terms, as the JAX package's one gradient:
  supervised  the paired batch's CTC loss through G (train mode);
  loss_G      minus D's summed score of G's shrunk softmax outputs
              (`ctc_shrink_soft`), D's parameters detached
              (`torch.func.functional_call`), so the gradient reaches G
              through D's input and D gets none;
  loss_D      D(fake) - D(real) + gp_weight * the gradient penalty, with G
              in eval mode under no_grad (its forward kernels only): the
              penalty's gradient of D at alpha * real + (1 - alpha) * fake
              (both time-padded to a common T, lengths the lesser of the
              two) comes from `torch.autograd.grad(create_graph=True)`,
              so D's parameters get the second-order term; the norm runs
              over (time, vocab) jointly per example, 1e-12 inside the
              square root.
`alpha` [B, 1, 1] is drawn by the `TrainRNG` (`rand_rows`: this rank's
rows of one host draw for the global batch; without one, `loss_D` draws
from a generator seeded 0); `loss_D` also takes it as an argument.
The JAX package draws it from its `aug` key, so the draws differ (ROADMAP
queue 3).  `gp_weight` is 1.0: the JAX package reads no
`training.lambda_gp`.  `greedy_decode` runs G, for the dev pass's WER;
the JAX GAN lacks it (ROADMAP queue 3).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from openasr_torch.config import Config
from openasr_torch.models import Framework, register_model
from openasr_torch.models.layers import TrainRNG
from openasr_torch.models.speech import target_lengths_of
from openasr_torch.models.subsample import Conv2dSubsampleV2
from openasr_torch.models.text import EmbedDecoderCTCModule, _phone_lengths
from openasr_torch.ops.ctc_decode import ctc_greedy_decode, ctc_shrink_soft
from openasr_torch.ops.losses import cal_ctc_loss
from openasr_torch.ops.masks import sequence_mask
from openasr_torch.parallel.mesh import rand_rows


class Discriminator(nn.Module):
    def __init__(self, d_input: int, d_model: int, layer_num: int = 2):
        super().__init__()
        self.min_t = 4 * layer_num + 4
        self.encoder = Conv2dSubsampleV2(d_input, d_model, layer_num)
        self.score_fc = nn.Linear(d_model, 1, bias=False)

    def forward(self, inputs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """inputs [B, T, V] probability sequences -> scores [B]."""
        t = inputs.shape[1]
        x = inputs * sequence_mask(lengths, t)[:, :, None].to(inputs.dtype)
        if t < self.min_t:
            x = F.pad(x, (0, 0, 0, self.min_t - t))
        encoded, enc_lens = self.encoder(x, lengths)
        scores = self.score_fc(encoded)[..., 0]
        m = sequence_mask(enc_lens, encoded.shape[1]).to(scores.dtype)
        return (scores * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)


class GANModule(nn.Module):
    def __init__(self, configs: Config):
        super().__init__()
        d = configs.D["encoder"]
        self.G = EmbedDecoderCTCModule(configs.G)
        self.D = Discriminator(int(d["d_input"]), int(d["d_model"]),
                               int(d.get("layer_num", 2)))

    encoder_lengths = staticmethod(_phone_lengths)


@register_model("gan_phone2char")
class GANPhone2Char(Framework):
    @classmethod
    def build_module(cls, configs: Config) -> nn.Module:
        return GANModule(configs)

    @classmethod
    def create_model(cls, configs, device="cuda", dtype=torch.float32,
                     generator: Optional[torch.Generator] = None):
        """G's sections under `G` (or the top-level `encoder` / `decoder`),
        D's under `D`: the configs the JAX package stores."""
        configs = Config(configs)
        g_cfg = configs.G or {"encoder": configs.encoder, "decoder": configs.decoder}
        configs = Config({"G": g_cfg, "D": configs.D, "type": "gan_phone2char"})
        return super().create_model(configs, device, dtype, generator)

    def batch_inputs(self, batch: dict):
        return batch["phones"], batch["phone_lengths"]

    def fc_component_names(self) -> tuple:
        return ()

    # ------------------------------------------------------------ sub-losses

    def _g_probs(self, phones, phone_lengths, rng, empty_rows):
        logits, lens = self.module.G(phones, phone_lengths, rng, empty_rows)
        shrunk, len_shrunk = ctc_shrink_soft(logits, lens)
        return torch.softmax(shrunk, dim=-1), len_shrunk

    def supervised_loss(self, batch: dict, rng: Optional[TrainRNG] = None,
                        empty_rows: Optional[bool] = None) -> torch.Tensor:
        """The paired batch's summed CTC loss through G."""
        logits, lens = self.module.G(batch["phones"], batch["phone_lengths"], rng, empty_rows)
        return cal_ctc_loss(logits, lens, batch["labels"], target_lengths_of(batch["paddings"]))

    def loss_G(self, phones, phone_lengths, rng: Optional[TrainRNG] = None,
               empty_rows: Optional[bool] = None) -> torch.Tensor:
        """-sum D(G's shrunk softmax outputs), D's parameters detached."""
        probs, lens = self._g_probs(phones, phone_lengths, rng, empty_rows)
        frozen = {n: p.detach() for n, p in self.module.D.named_parameters()}
        return -torch.func.functional_call(self.module.D, frozen, (probs, lens)).sum()

    def loss_D(self, phones, phone_lengths, text, text_lengths,
               alpha: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None, gp_weight: float = 1.0,
               empty_rows: Optional[bool] = None, rows=(0, 1)) -> torch.Tensor:
        """D(fake) - D(real) + gp_weight * gradient penalty; G in eval mode
        without gradient.  `alpha` [B, 1, 1], else drawn from `generator`
        (a CPU generator).  Data-parallel rank `rows` = (rank, world): alpha
        is this rank's rows of one draw for the global batch, and the
        penalty's mean runs over the global batch (this rank's share)."""
        D = self.module.D
        with torch.no_grad():
            fake, len_fake = self._g_probs(phones, phone_lengths, None, empty_rows)
        real = F.one_hot(text.long(), fake.shape[-1]).to(fake.dtype)
        score_neg = D(fake, len_fake).sum()
        score_pos = D(real, text_lengths).sum()
        t = max(fake.shape[1], real.shape[1])
        fake = F.pad(fake, (0, 0, 0, t - fake.shape[1]))
        real = F.pad(real, (0, 0, 0, t - real.shape[1]))
        lengths = torch.minimum(len_fake, text_lengths.to(len_fake.dtype))
        if alpha is None:
            gen = generator if generator is not None else torch.Generator().manual_seed(0)
            alpha = rand_rows(gen, (fake.shape[0], 1, 1), 0, *rows)
        alpha = alpha.to(device=fake.device, dtype=fake.dtype)
        with torch.enable_grad():
            interp = (alpha * real + (1.0 - alpha) * fake).requires_grad_(True)
            grads, = torch.autograd.grad(D(interp, lengths).sum(), interp, create_graph=True)
            norms = torch.sqrt((grads ** 2).sum(dim=(1, 2)) + 1e-12)
            gp = ((norms - 1.0) ** 2).sum() / (norms.shape[0] * rows[1])
        return score_neg - score_pos + gp_weight * gp

    def loss(self, batch: dict, rng: Optional[TrainRNG] = None, label_smooth: float = 0.0,
             empty_rows: Optional[bool] = None, alpha: Optional[torch.Tensor] = None) -> dict:
        """{ctc_loss, n_tokens, n_seqs} of the paired batch, with `g_loss`
        when it carries `unpaired_phones` and `d_loss` when it carries
        `unpaired_text` (D's fakes from the unpaired phones, else the
        paired ones).  `empty_rows` covers every phone batch."""
        del label_smooth
        phones = batch["phones"]
        losses = {
            "ctc_loss": self.supervised_loss(batch, rng, empty_rows),
            "n_tokens": (1.0 - batch["paddings"].float()).sum(),
            "n_seqs": torch.tensor(float(phones.shape[0]), device=phones.device),
        }
        fake_in = (batch.get("unpaired_phones", phones),
                   batch.get("unpaired_phone_lengths", batch["phone_lengths"]))
        if "unpaired_phones" in batch:
            losses["g_loss"] = self.loss_G(*fake_in, rng, empty_rows)
        if "unpaired_text" in batch:
            if alpha is None and rng is not None:
                alpha = rng.rand_rows((fake_in[0].shape[0], 1, 1))
            losses["d_loss"] = self.loss_D(
                *fake_in, batch["unpaired_text"], batch["unpaired_text_lengths"], alpha,
                empty_rows=empty_rows, rows=(rng.rank, rng.world) if rng is not None else (0, 1))
        return losses

    @torch.inference_mode()
    def greedy_decode(self, phones, phone_lengths, empty_rows: Optional[bool] = None):
        """G's greedy CTC decode: (ids [B, P], counts [B])."""
        return ctc_greedy_decode(*self.module.G(phones, phone_lengths, None, empty_rows))

    def restore_G(self, pkg: dict) -> None:
        """Warm-start G from an Embed_Decoder_CTC package of either
        package."""
        from openasr_torch.convert import jax_components_to_state_dict

        state = jax_components_to_state_dict("Embed_Decoder_CTC", pkg["components"])
        self.module.G.load_state_dict(state, strict=True)
