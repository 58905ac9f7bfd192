"""The CPC pretraining solver.

Counterpart of `CPCSolver` in openasr_tpu/solvers/phone2char.py: the
loss is cpc_loss / n_seqs, and the metrics add `acc`, the share of the
contrastive grid's positives above 0.5 and negatives below it, averaged
over the sequences of the print interval.
"""

from __future__ import annotations

from openasr_torch.solvers import SOLVER_REGISTRY, Solver


class CPCSolver(Solver):
    main_loss_key = "cpc_loss"
    main_loss_norm = "n_seqs"

    def mix_losses(self, losses):
        return losses["cpc_loss"] / losses["n_seqs"]

    def _totals_update(self, totals, losses):
        totals = super()._totals_update(totals, losses)
        tot = totals[0]
        acc = losses["acc"] * losses["n_seqs"]
        tot["acc"] = tot["acc"] + acc if "acc" in tot else acc
        return totals


SOLVER_REGISTRY["encoder_cpc"] = CPCSolver
