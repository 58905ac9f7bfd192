"""CIF solvers: the loss mixes of the CIF families, and CIF_MIX's epoch over
two loaders.

Counterpart of openasr_tpu/solvers/cif.py:
  CIF      ce / n_tokens + lambda_qua * qua / n_seqs
  ctc_cif  + lambda_ctc * ctc / n_seqs (CIF_FC and CIF_MIX the same, over
           the phone head's CE)
  CIF_MIX  + ce_char / n_char_tokens on paired batches.
CIF_MIX's training epoch walks an acoustic loader (features and phones)
and cycles the paired loader beside it: each (acoustic, paired) pair adds
both batches' gradients and makes ONE optimizer step and one schedule
tick; with `accumulate_grad_batch` k, k pairs make a step, and a leftover
is stepped at the epoch's end.  Its dev pass is the base loop's.
"""

from __future__ import annotations

import itertools
import logging
import time

from openasr_torch.parallel.mesh import reconcile_batch
from openasr_torch.solvers import SOLVER_REGISTRY, Solver, batch_to_device

logger = logging.getLogger(__name__)


class CIFSolver(Solver):
    def mix_losses(self, losses):
        lam_qua = float(self.config.get("lambda_qua", 1.0))
        return (losses["ce_loss"] / losses["n_tokens"]
                + lam_qua * losses["qua_loss"] / losses["n_seqs"])


class CIFCTCSolver(CIFSolver):
    def mix_losses(self, losses):
        lam_ctc = float(self.config.get("lambda_ctc", 1.0))
        return super().mix_losses(losses) + lam_ctc * losses["ctc_loss"] / losses["n_seqs"]


class CIFMIXSolver(CIFCTCSolver):
    def __init__(self, model, config, tr_loader, cv_loader, acoustic_loader=None, **kw):
        self.acoustic_loader = acoustic_loader
        super().__init__(model, config, tr_loader, cv_loader, **kw)

    def mix_losses(self, losses):
        total = super().mix_losses(losses)
        if "ce_char_loss" in losses:
            total = total + losses["ce_char_loss"] / losses["n_char_tokens"]
        return total

    def iter_one_epoch(self, cross_valid: bool = False) -> float:
        if cross_valid or self.acoustic_loader is None:
            return super().iter_one_epoch(cross_valid)
        t0 = time.time()
        totals = ({}, None, None)
        paired_cycle = itertools.cycle(iter(self.tr_loader))
        tot_iters = len(self.acoustic_loader)
        for niter, ac_batch in enumerate(self.acoustic_loader, start=1):
            if self._should_stop(niter):
                logger.warning("preemption: stopping epoch %d at batch %d/%d",
                               self.epoch, niter, tot_iters)
                break
            self._maybe_profile()
            for j, batch in enumerate((ac_batch, next(paired_cycle))):
                # each batch of the pair its own random streams
                self._niter = 2 * niter + j
                batch = reconcile_batch(self.group, batch)
                empty_rows = self.model.has_empty_rows(self.model.batch_inputs(batch)[1])
                losses = self.grad_step(batch_to_device(batch, self.device), empty_rows)
                totals = self._totals_update(totals, losses)
            if niter % self.accumulate_grad_batch == 0 or niter == tot_iters:
                self.apply_update()
            if niter % self.print_inteval == 0:
                self._totals_log(totals, t0, niter, tot_iters, "train")
        return self._totals_close(totals)


SOLVER_REGISTRY.update({
    "CIF": CIFSolver,
    "ctc_cif": CIFCTCSolver,
    "CIF_FC": CIFCTCSolver,
    "CIF_MIX": CIFMIXSolver,
})
