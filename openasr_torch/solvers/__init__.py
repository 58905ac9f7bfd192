"""Solvers: the training loop of one device.

Counterpart of openasr_tpu/solvers/__init__.py on one device: the epoch
loop with per-epoch `ep-NNNN.pkg` + `last.pkg` packages, the dev pass,
best-cv tracking, checkpoint retention, clip + Adam (ops/fused_adam.py)
under the decay-rate schedules, two-phase gradient accumulation (the
gradients of `accumulate_grad_batch` micro-batches summed, then one
update), and the loss normalizations: CE by tokens, CTC by sequences,
over each batch.

Batches carry offline features or raw waves, as the model's
`batch_inputs` reads them.  Each train step runs the model's loss forward
with a `TrainRNG` reseeded from the step (dropout, attention dropout,
SpecAugment, dither), then backward
through the Hopper kernels on the card.  `training.compute_dtype:
bfloat16` keeps the f32 weights, gradients and optimizer and runs the
forward under bf16 autocast, as the JAX package computes in bf16 over f32
parameters.  Totals stay on the device and are read back only at print
intervals and epoch ends.

The CTC solver logs the greedy decode of the first dev utterance
(`dev sample greedy ids: [...]`) after the first dev batch.

Not ported here (ROADMAP): the mesh and its parallelisms (data, tensor,
sequence, pipeline, ZeRO-1), MoE auxiliaries, batch_stats models, the
preemption handler, the profiler window, asynchronous checkpoint writes
and the stock-optax optimizers (sgd, fused_adam: false).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict

import numpy as np
import torch

from openasr_torch.models.layers import TrainRNG
from openasr_torch.ops.fused_adam import FusedClipAdam
from openasr_torch.ops.schedules import BobSchedule, get_schedule
from openasr_torch.utils.checkpoint import cleanup_ckpt, save_package

logger = logging.getLogger(__name__)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """The array fields of a collated batch as tensors on `device`."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in batch.items() if isinstance(v, np.ndarray)
    }


class Solver:
    """Base solver; subclasses define `mix_losses`."""

    main_loss_key = "ce_loss"
    main_loss_norm = "n_tokens"

    def __init__(self, model, config, tr_loader, cv_loader, device="cuda",
                 compute_dtype=torch.float32, seed: int = 0):
        self.model = model
        self.config = config
        self.tr_loader = tr_loader
        self.cv_loader = cv_loader
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype

        self.num_epoch = int(config["num_epoch"])
        self.exp_dir = config["exp_dir"]
        self.print_inteval = int(config.get("print_inteval", 100))
        self.accumulate_grad_batch = int(config.get("accumulate_grad_batch", 1))
        self.init_lr = float(config["init_lr"])
        self.grad_max_norm = float(config.get("grad_max_norm", 0.0))
        self.label_smooth = float(config.get("label_smooth", 0.0))
        self.num_last_ckpt_keep = config.get("num_last_ckpt_keep")

        self.schedule = get_schedule(config["lr_scheduler"])
        self.is_bob = isinstance(self.schedule, BobSchedule)

        self.epoch = 0
        self.step = 0
        self.tr_loss = []
        self.cv_loss = []

        self.seed = seed
        self.rng = TrainRNG(seed, self.device)
        self._niter = 0
        self.params = dict(model.module.named_parameters())
        self.optimizer = self._make_optimizer(config)
        os.makedirs(self.exp_dir, exist_ok=True)

    # ------------------------------------------------------------ optimizer

    def _make_optimizer(self, config) -> FusedClipAdam:
        opt_type = config.get("optimtype", "adam")
        if opt_type != "adam" or not config.get("fused_adam", True):
            raise NotImplementedError(
                f"training.optimtype={opt_type!r} / fused_adam=false: the port "
                "has the fused clip + Adam only (the stock optimizers are "
                "ROADMAP queue 1 item 6)"
            )

        def dtype_of(key, default):
            name = config.get(key, default)
            return None if name in (None, "float32", "f32") else DTYPES[name]

        def lr_fn(count):
            # the schedule steps before the lr is set: update k uses step k+1
            return self.init_lr * self.schedule(count + 1)

        return FusedClipAdam(
            self.params, lr_fn, b1=0.9, b2=0.999, eps=1e-8,
            max_norm=self.grad_max_norm,
            mu_dtype=dtype_of("adam_mu_dtype", "bfloat16"),
            nu_dtype=dtype_of("adam_nu_dtype", None),
            skip_nonfinite=bool(config.get("skip_nonfinite_grads", True)),
        )

    def current_lr(self) -> float:
        return float(self.init_lr * self.schedule(self.step + 1))

    # ----------------------------------------------------------- loss mixing

    def mix_losses(self, losses: Dict) -> torch.Tensor:
        raise NotImplementedError

    def model_losses(self, batch: dict, rng, empty_rows: bool) -> dict:
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            return self.model.loss(batch, rng, label_smooth=self.label_smooth,
                                   empty_rows=empty_rows)

    # ----------------------------------------------------------- the steps

    def grad_step(self, batch: dict, empty_rows: bool) -> dict:
        """Forward + backward of one (micro-)batch; the gradients add up in
        the parameters' .grad until `apply_update`.  `empty_rows` is the
        model's `has_empty_rows` of the host batch."""
        self.rng.reseed((self.seed << 32) + self.step * 8191 + self._niter)
        losses = self.model_losses(batch, self.rng, empty_rows)
        self.mix_losses(losses).backward()
        return {k: v.detach() for k, v in losses.items()}

    def apply_update(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params.values()]
        self.optimizer.step(grads)
        for p in self.params.values():
            p.grad = None
        self.step += 1

    @torch.no_grad()
    def eval_step(self, batch: dict, empty_rows: bool) -> dict:
        return self.model_losses(batch, None, empty_rows)

    def sample_decode(self, arrays: dict, empty_rows: bool) -> None:
        """Hook: log a sample decode of the first dev batch (none by
        default)."""

    # ----------------------------------------------------------- epoch loop

    def _totals_update(self, totals, losses):
        tot, tot_norm, tot_seqs = totals
        norm = losses[self.main_loss_norm]
        tot_norm = norm if tot_norm is None else tot_norm + norm
        seqs = losses["n_seqs"]
        tot_seqs = seqs if tot_seqs is None else tot_seqs + seqs
        for k in losses:
            if k.endswith("_loss"):
                tot[k] = tot[k] + losses[k] if k in tot else losses[k]
        return (tot, tot_norm, tot_seqs)

    def _totals_log(self, totals, t0, niter, tot_iters, phase) -> None:
        tot, tot_norm, tot_seqs = totals
        host_norm = max(float(tot_norm), 1.0)
        host_tot = {k: float(v) for k, v in tot.items()}
        sent_per_sec = float(tot_seqs) / max(time.time() - t0, 1e-9)
        skips = int(self.optimizer.notfinite) if phase == "train" else 0
        parts = " ".join(f"{k}: {v / host_norm:.3f}" for k, v in host_tot.items())
        logger.info(
            "Epoch %d | Step %d | Batch %d/%d | %s | lr %.3e | sent/sec %.2f",
            self.epoch, self.step, niter, tot_iters, parts, self.current_lr(),
            sent_per_sec,
        )
        self._log_metrics({
            "phase": phase,
            "epoch": self.epoch,
            "step": self.step,
            "batch": niter,
            "lr": self.current_lr(),
            "sent_per_sec": sent_per_sec,
            **({"nonfinite_skips": skips} if skips else {}),
            **{k: v / host_norm for k, v in host_tot.items()},
        })

    def _totals_close(self, totals) -> float:
        tot, tot_norm, _ = totals
        if tot_norm is None:
            return 0.0
        return float(tot[self.main_loss_key]) / max(float(tot_norm), 1e-9)

    def iter_one_epoch(self, cross_valid: bool = False) -> float:
        loader = self.cv_loader if cross_valid else self.tr_loader
        t0 = time.time()
        totals = ({}, None, None)
        tot_iters = len(loader)
        n_micro = 0
        for niter, batch in enumerate(loader, start=1):
            arrays = batch_to_device(batch, self.device)
            empty_rows = self.model.has_empty_rows(self.model.batch_inputs(batch)[1])
            if cross_valid:
                losses = self.eval_step(arrays, empty_rows)
                if niter == 1:
                    self.sample_decode(arrays, empty_rows)
            else:
                self._niter = niter
                losses = self.grad_step(arrays, empty_rows)
                n_micro += 1
                if n_micro % self.accumulate_grad_batch == 0 or niter == tot_iters:
                    self.apply_update()
            totals = self._totals_update(totals, losses)
            if niter % self.print_inteval == 0:
                self._totals_log(totals, t0, niter, tot_iters,
                                 "cv" if cross_valid else "train")
        return self._totals_close(totals)

    def _log_metrics(self, record: dict) -> None:
        """Append one JSON line to exp_dir/metrics.jsonl."""
        record = {"time": time.time(), **record}
        with open(os.path.join(self.exp_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")

    def train(self) -> None:
        best_cv = min(self.cv_loss) if self.cv_loss else 9e20
        while self.epoch < self.num_epoch:
            t0 = time.time()
            self.epoch += 1
            tr_loss = self.iter_one_epoch()
            self.save(os.path.join(self.exp_dir, f"ep-{self.epoch:04d}.pkg"))
            self.save(os.path.join(self.exp_dir, "last.pkg"))
            cv_loss = self.iter_one_epoch(cross_valid=True)
            best_cv = min(best_cv, cv_loss)
            if self.is_bob:
                self.schedule.update(cv_loss)
            minutes = (time.time() - t0) / 60.0
            logger.info("Epoch %d done: tr %.4f cv %.4f (best %.4f) in %.1f min",
                        self.epoch, tr_loss, cv_loss, best_cv, minutes)
            self._log_metrics({
                "phase": "epoch", "epoch": self.epoch, "step": self.step,
                "tr_loss": tr_loss, "cv_loss": cv_loss, "best_cv": best_cv,
                "minutes": minutes,
            })
            self.tr_loss.append(tr_loss)
            self.cv_loss.append(cv_loss)
            if self.num_last_ckpt_keep:
                cleanup_ckpt(self.exp_dir, int(self.num_last_ckpt_keep))

    # ------------------------------------------------------------ packaging

    def training_state(self) -> dict:
        return {
            "epoch": self.epoch,
            "step": self.step,
            "tr_loss": self.tr_loss,
            "cv_loss": self.cv_loss,
            "lr": self.current_lr(),
        }

    def package(self) -> dict:
        """The model in the JAX package layout, the solver state, and the
        optimizer state in the port's layout (moments keyed by parameter
        name)."""
        pkg = {
            "model": self.model.package(),
            "solver_config": (self.config.to_dict() if hasattr(self.config, "to_dict")
                              else dict(self.config)),
            "solver_state": self.training_state(),
            "optim_state": self.optimizer.state_dict(),
        }
        if self.is_bob:
            pkg["scheduler_state"] = self.schedule.pack_state()
        return pkg

    def save(self, path: str) -> None:
        save_package(self.package(), path)

    def restore(self, pkg: dict) -> None:
        """Solver and optimizer state of a package (the model is restored by
        the caller).  A package without optimizer state starts the
        optimizer afresh; one with the JAX package's optimizer state is
        refused (no bridge for it yet)."""
        state = pkg["solver_state"]
        self.epoch = state["epoch"]
        self.step = state["step"]
        self.tr_loss = list(state["tr_loss"])
        self.cv_loss = list(state["cv_loss"])
        optim = pkg.get("optim_state")
        if optim is not None:
            if not (isinstance(optim, dict) and "mu" in optim):
                raise NotImplementedError(
                    "this package holds the JAX package's optimizer state; the "
                    "port reads its own (the optimizer-state bridge is listed "
                    "in ROADMAP)"
                )
            self.optimizer.load_state_dict(optim)
        if self.is_bob and "scheduler_state" in pkg:
            self.schedule.restore_state(pkg["scheduler_state"])


class CESolver(Solver):
    """loss = ce / n_tokens."""

    def mix_losses(self, losses):
        return losses["ce_loss"] / losses["n_tokens"]


class CTCCESolver(Solver):
    """loss = ce / n_tokens + lambda_ctc * ctc / n_seqs."""

    def __init__(self, model, config, tr_loader, cv_loader, **kw):
        super().__init__(model, config, tr_loader, cv_loader, **kw)
        self.lambda_ctc = float(config.get("lambda_ctc", 1.0))

    def mix_losses(self, losses):
        return (losses["ce_loss"] / losses["n_tokens"]
                + self.lambda_ctc * losses["ctc_loss"] / losses["n_seqs"])


class CTCSolver(Solver):
    """loss = ctc / n_seqs."""

    main_loss_key = "ctc_loss"

    def mix_losses(self, losses):
        return losses["ctc_loss"] / losses["n_seqs"]

    def sample_decode(self, arrays: dict, empty_rows: bool) -> None:
        """Log the greedy ids of the batch's first utterance."""
        inputs, lengths = self.model.batch_inputs(arrays)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            ids, lens = self.model.greedy_decode(inputs, lengths, empty_rows)
        logger.info("dev sample greedy ids: %s", ids[0, : int(lens[0])].tolist())


SOLVER_REGISTRY = {
    "conv-transformer": CESolver,
    "conv-ctc-transformer": CTCCESolver,
    "conv-ctc": CTCSolver,
}


def get_solver_class(model_type: str):
    """Case- and -/_-insensitive, as model types resolve."""
    norm = model_type.lower().replace("-", "_")
    for name, cls in SOLVER_REGISTRY.items():
        if name.replace("-", "_") == norm:
            return cls
    raise ValueError(
        f"No solver for model type {model_type!r} in the port; it trains "
        f"{sorted(SOLVER_REGISTRY)} (CIF, CPC and phone2char solvers are "
        "ROADMAP queue 1 items 9 and 13)"
    )
