"""phone2char solvers: seq2seq CE, CTC with the dev WER, and the WGAN-GP
alternation.

Counterpart of openasr_tpu/solvers/phone2char.py:
  Embed_Decoder      ce / n_tokens (CESolver);
  Embed_Decoder_CTC  ctc / n_tokens (not the speech CTC solver's
                     / n_seqs); every dev pass also greedy-decodes the dev
                     set and logs `dev_wer` (edit distance over reference
                     tokens) to metrics.jsonl;
  gan_phone2char     ctc / n_tokens + g_loss + d_loss.  Its training epoch
                     walks the unpaired-phone loader; each iteration also
                     draws one paired batch and one unpaired-text batch
                     (both loaders cycle), and the three terms add one
                     gradient.  `accumulate_grad_batch` iterations make an
                     optimizer step; a leftover steps at the epoch's end.
                     Its dev pass is the CTC one, through G.
"""

from __future__ import annotations

import itertools
import logging

import numpy as np
import torch

from openasr_torch.parallel.mesh import all_gather_host, reconcile_batch
from openasr_torch.solvers import SOLVER_REGISTRY, CESolver, Solver, batch_to_device
from openasr_torch.utils.metrics import batch_distance

logger = logging.getLogger(__name__)


class Phone2CharSolver(CESolver):
    """CE over phone->char batches."""


class Phone2CharCTCSolver(Solver):
    main_loss_key = "ctc_loss"

    def mix_losses(self, losses):
        return losses["ctc_loss"] / losses["n_tokens"]

    def iter_one_epoch(self, cross_valid: bool = False) -> float:
        loss = super().iter_one_epoch(cross_valid)
        if cross_valid and self.cv_loader:
            self._log_metrics({"phase": "cv", "epoch": self.epoch, "step": self.step,
                               "dev_wer": self.dev_wer()})
        return loss

    def dev_wer(self) -> float:
        """Greedy-decode the dev set: summed edit distance over reference
        tokens."""
        dist, n_ref = 0, 0
        for batch in self.cv_loader:
            batch = reconcile_batch(self.group, batch)
            arrays = batch_to_device(batch, self.device)
            ids, lens = self.model.greedy_decode(
                arrays["phones"], arrays["phone_lengths"],
                self.model.has_empty_rows(batch["phone_lengths"]))
            ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
            tlen = (1 - np.asarray(batch["paddings"])).sum(-1).astype(int)
            refs = [list(batch["labels"][i, : tlen[i]]) for i in range(len(tlen))]
            dist += batch_distance(refs, [list(ids[i, : lens[i]]) for i in range(len(lens))])
            n_ref += sum(len(r) for r in refs)
        dist, n_ref = all_gather_host(self.group, np.array([dist, n_ref], np.int64)).sum(0)
        wer = float(dist) / max(int(n_ref), 1)
        if self.is_rank0:
            logger.info("dev WER: %.2f%%", 100.0 * wer)
        return wer


class Phone2CharCTCGANSolver(Phone2CharCTCSolver):
    def __init__(self, model, config, tr_loader, cv_loader, phone_loader=None,
                 text_loader=None, **kw):
        self.phone_loader = phone_loader
        self.text_loader = text_loader
        super().__init__(model, config, tr_loader, cv_loader, **kw)

    def mix_losses(self, losses):
        loss = super().mix_losses(losses)
        for k in ("g_loss", "d_loss"):
            if k in losses:
                loss = loss + losses[k]
        return loss

    def iter_one_epoch(self, cross_valid: bool = False) -> float:
        if cross_valid or self.phone_loader is None:
            return super().iter_one_epoch(cross_valid)
        tot_main, tot_norm = 0.0, 0.0
        paired_cycle = itertools.cycle(iter(self.tr_loader))
        text_cycle = itertools.cycle(iter(self.text_loader))
        tot_iters = len(self.phone_loader)
        for niter, phone_batch in enumerate(self.phone_loader, start=1):
            if self._should_stop(niter):
                logger.warning("preemption: stopping epoch %d at batch %d/%d",
                               self.epoch, niter, tot_iters)
                break
            text = next(text_cycle)
            batch = {k: v for k, v in next(paired_cycle).items() if isinstance(v, np.ndarray)}
            batch.update(unpaired_phones=phone_batch["tokens"],
                         unpaired_phone_lengths=phone_batch["token_lengths"],
                         unpaired_text=text["tokens"],
                         unpaired_text_lengths=text["token_lengths"])
            batch = reconcile_batch(self.group, batch)
            empty_rows = any(self.model.has_empty_rows(batch[k])
                             for k in ("phone_lengths", "unpaired_phone_lengths"))
            self._niter = niter
            losses = self.grad_step(batch_to_device(batch, self.device), empty_rows)
            if niter % self.accumulate_grad_batch == 0 or niter == tot_iters:
                self.apply_update()
            tot_main = tot_main + losses["ctc_loss"]
            tot_norm = tot_norm + losses["n_tokens"]
            if niter % self.print_inteval == 0:
                ctc, n, g, d = self._global_sum(
                    [losses[k] for k in ("ctc_loss", "n_tokens", "g_loss", "d_loss")])
                if self.is_rank0:
                    logger.info("Epoch %d | Step %d | ctc %.3f g %.3f d %.3f | lr %.3e",
                                self.epoch, self.step, ctc / max(n, 1.0), g, d,
                                self.current_lr())
        tot_main, tot_norm = self._global_sum([tot_main, tot_norm])
        return tot_main / max(tot_norm, 1e-9)

    def _global_sum(self, values) -> list:
        """Host floats of `values` summed over the ranks."""
        v = torch.stack([torch.as_tensor(x, dtype=torch.float32, device=self.device)
                         for x in values])
        return self.group.all_reduce(v).tolist()


SOLVER_REGISTRY.update({
    "Embed_Decoder": Phone2CharSolver,
    "Embed_Decoder_CTC": Phone2CharCTCSolver,
    "gan_phone2char": Phone2CharCTCGANSolver,
})
