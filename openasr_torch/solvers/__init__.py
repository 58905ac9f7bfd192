"""Solvers: the training loop, on one device or over a grid of ranks.

Counterpart of openasr_tpu/solvers/__init__.py: the epoch
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
(`dev sample greedy ids: [...]`) after the first dev batch.  The CIF
families' solvers are in solvers/cif.py, CPC's in solvers/cpc.py, the
phone2char ones (and the GAN's epoch) in solvers/phone2char.py.

`optimtype: sgd` and `fused_adam: false` take the stock optimizers
(ops/optimizers.py).  Packages are written by an `AsyncCheckpointer`,
whose writes `train()` waits for before retention and before it returns.
SIGTERM or SIGUSR1 stops training at the next batch: the interrupted
epoch is not counted, `last.pkg` is written, and `--continue-training`
restarts that epoch.  `training.profile: {start_step, num_steps, logdir}`
opens a `torch.profiler` window over those steps and writes its Chrome
trace to `logdir` (default exp_dir/profile); `training.tensorboard: true`
or OPENASR_TENSORBOARD=1 mirrors metrics.jsonl into TensorBoard scalars.

BatchNorm models (the raw-wave families) update their running statistics
in every training forward, micro-batch by micro-batch, and read them in
the dev pass, as the JAX solver threads its `batch_stats`; the packages
carry them.  A model's `frozen_components` (GRU-CTC after
`load_splayer`) are left out of the optimizer: no update, no moments, no
share of the clip norm.  A model's `freeze_gate` (wav2vec's
`freeze_finetune_updates`) takes the stock optimizer, as in the JAX
solver, with the gate first in its chain.

The objective is `total_loss`: the family's `mix_losses` plus, for a
model with MoE layers, its weighted load-balance auxiliary
(`moe_aux_loss`, models/moe.py), in training; the dev pass logs it beside
the other losses.

Data parallelism (`group`, a `DataGroup` of openasr_torch/parallel, as the
JAX solvers take `mesh=`): each rank takes its rows of the global batch,
padded to the cross-rank shapes (`reconcile_batch`), and N ranks compute
what one process computes on the global batch, as the JAX solver's
sharded step does:
- every normalizer of a loss (the `n_*` counts) is all-reduced before the
  loss is formed, so each rank backpropagates its numerators over the
  global counts and the SUM of the ranks' gradients is the one-process
  gradient; BatchNorm statistics, the MoE auxiliary and the per-row host
  draws are the global batch's (models/);
- after the last micro-batch of an accumulation group the gradients are
  all-reduced in flat buckets, or with `training.zero1` (default on)
  reduce-scattered into each rank's shard of the optimizer state and the
  updated shards all-gathered; expert tables (expert parallelism, when the
  world size divides num_experts) stay on their owners; the clip's norm is
  global (parallel/data_parallel.py);
- the preemption flag is agreed by an all_reduce(MAX) every
  STOP_CHECK_INTERVAL batches and at each epoch's end, so a SIGTERM on one
  rank stops every rank at the same batch;
- every rank builds the package (gathering shards and expert tables) and
  rank 0 alone writes it, `metrics.jsonl`, TensorBoard and the progress
  lines; the dev pass's totals are all-reduced.

Tensor and sequence parallelism (`group` a `Grid` with a model group of M
> 1 ranks, as the JAX solvers take a (data, model) `mesh=`): every
collective above runs over the grid's data group (the ranks of this
rank's model index), the preemption agreement over every rank.  The
model's layers hold this rank's shards (`Framework.set_model_group`,
parallel/tensor_parallel.py), with `training.sequence_parallel` (default
on) putting the residual stream on T-shards where T divides by M.  Every
rank of a model group loads the same rows and backpropagates the whole
loss (not divided by M); before the data reduction the partial gradients
of the T-sharded sites are summed over the model group, and the package
gathers the shards over both axes.

Pipeline parallelism (`group` a `Grid` with a pipe group of S > 1 stages,
as the JAX solvers take a (pipe, data, model) `mesh=`): a model with a
stacked encoder (`encoder.pipeline`) keeps only this rank's stage of its
layers (`Framework.set_pipe_group`) and every forward runs under the
pipeline context (`pipeline_scope`: the pipe group and
`training.pipeline_microbatch`, 4 S by default), through `gpipe_apply`
(parallel/pipeline.py).  The ranks of a pipe group load the same rows
(the loader's rank is the data index), compute the same loss, and each
updates its stage's layers and the replicated rest; the gradients and
ZeRO-1 run over the data group of this rank's (p, m), the clip's norm
sums the stages' layers over the pipe group, and the package gathers
every stage's layers and moments into the whole stack.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from typing import Dict

import numpy as np
import torch

from openasr_torch.convert import jax_optim_state_to_port
from openasr_torch.models.layers import TrainRNG
from openasr_torch.ops.fused_adam import FusedClipAdam
from openasr_torch.ops.optimizers import StockOptimizer
from openasr_torch.ops.schedules import BobSchedule, get_schedule
from openasr_torch.parallel.data_parallel import DataParallel, full_expert_tables
from openasr_torch.parallel.mesh import Grid, reconcile_batch
from openasr_torch.parallel.pipeline import pipeline_scope
from openasr_torch.utils.checkpoint import AsyncCheckpointer, cleanup_ckpt

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
                 compute_dtype=torch.float32, seed: int = 0,
                 group=None):
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
        # `group`: the Grid of ranks (one rank when None)
        self.grid = group if group is not None else Grid.single(self.device)
        self.group = self.grid.data
        self.is_rank0 = self.grid.rank == 0
        self.rng = TrainRNG(seed, self.device, self.group.rank, self.group.world,
                            self.grid.model.rank, self.grid.model.world)
        self._niter = 0
        self._stop_agreed = False
        moe = model.moe_config() if hasattr(model, "moe_config") else None
        if moe is not None and int(moe.get("num_experts", 0)) % self.group.world:
            # correct numerics, but the tables replicate: no expert
            # parallelism (the JAX solver's warning)
            logger.warning(
                "moe: num_experts=%d does not divide the data axis (%d); expert "
                "tables will be REPLICATED on every chip (no expert parallelism). "
                "Use a multiple of the data-axis size for sharded experts.",
                int(moe["num_experts"]), self.group.world)
        stage = model.set_pipe_group(self.grid.pipe)
        pipe = self.grid.pipe.world
        self._pipe_ctx = ((self.grid.pipe, int(config.get("pipeline_microbatch", 4 * pipe)))
                          if pipe > 1 else None)
        self.tp_specs = model.set_model_group(self.grid.model,
                                              bool(config.get("sequence_parallel", True)))
        experts = model.set_data_group(self.group)
        frozen = tuple(getattr(model, "frozen_components", ()))
        self.params = {}
        for name, p in model.module.named_parameters():
            if name.split(".")[0] in frozen:
                p.requires_grad_(False)
            else:
                self.params[name] = p
        self.zero1 = bool(config.get("zero1", True))
        self.dp = DataParallel(self.grid, self.params, self.zero1, experts, self.tp_specs,
                               stage)
        self.optimizer = self._make_optimizer(config)
        os.makedirs(self.exp_dir, exist_ok=True)
        self._ckpt = AsyncCheckpointer()
        self._stop_requested = False
        self._profiler = None
        self._profiled = False
        self._tb_writer = None

    # ------------------------------------------------------------ optimizer

    def _make_optimizer(self, config):
        """The fused clip + Adam, or for `optimtype: sgd` / `fused_adam:
        false` / a model's `freeze_gate` the stock optimizers, each
        rejecting non-finite steps when `skip_nonfinite_grads` (default
        on)."""
        opt_type = config.get("optimtype", "adam")
        gate = getattr(self.model, "freeze_gate", None)

        def dtype_of(key, default):
            name = config.get(key, default)
            return None if name in (None, "float32", "f32") else DTYPES[name]

        def lr_fn(count):
            # the schedule steps before the lr is set: update k uses step k+1
            return self.init_lr * self.schedule(count + 1)

        mu_dtype = dtype_of("adam_mu_dtype", "bfloat16")
        nu_dtype = dtype_of("adam_nu_dtype", None)
        skip_nonfinite = bool(config.get("skip_nonfinite_grads", True))
        if opt_type == "adam" and not gate and config.get("fused_adam", True):
            return FusedClipAdam(
                self.dp.optimizer_params(), lr_fn, b1=0.9, b2=0.999, eps=1e-8,
                max_norm=self.grad_max_norm, mu_dtype=mu_dtype, nu_dtype=nu_dtype,
                skip_nonfinite=skip_nonfinite, norm_fn=self.dp.norm,
            )
        if nu_dtype is not None:
            logger.warning(
                "training.adam_nu_dtype=%s is ignored on the non-fused optimizer "
                "path (freeze_gate / fused_adam: false / optimtype!=adam): the "
                "second moment stays float32", config.get("adam_nu_dtype"),
            )
        if opt_type == "sgd" and "adam_mu_dtype" in config:
            logger.warning("training.adam_mu_dtype is ignored with optimtype=sgd")
        return StockOptimizer(
            self.dp.optimizer_params(), lr_fn, opt_type, max_norm=self.grad_max_norm,
            mu_dtype=mu_dtype if opt_type == "adam" else None,
            skip_nonfinite=skip_nonfinite, gate=gate, norm_fn=self.dp.norm,
        )

    def current_lr(self) -> float:
        return float(self.init_lr * self.schedule(self.step + 1))

    # ----------------------------------------------------------- loss mixing

    def mix_losses(self, losses: Dict) -> torch.Tensor:
        raise NotImplementedError

    def total_loss(self, losses: Dict) -> torch.Tensor:
        """The optimized objective: `mix_losses` plus the MoE routers'
        weighted auxiliary, which only a model with MoE layers returns."""
        total = self.mix_losses(losses)
        if "moe_aux_loss" in losses:
            total = total + losses["moe_aux_loss"]
        return total

    def model_losses(self, batch: dict, rng, empty_rows: bool) -> dict:
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16), \
                pipeline_scope(self._pipe_ctx):
            return self.model.loss(batch, rng, label_smooth=self.label_smooth,
                                   empty_rows=empty_rows)

    # ----------------------------------------------------------- the steps

    def grad_step(self, batch: dict, empty_rows: bool) -> dict:
        """Forward + backward of one (micro-)batch; the gradients add up in
        the parameters' .grad until `apply_update`.  `empty_rows` is the
        model's `has_empty_rows` of the host batch."""
        self.rng.reseed((self.seed << 32) + self.step * 8191 + self._niter)
        losses = self.model_losses(batch, self.rng, empty_rows)
        self.total_loss(self.global_counts(losses)).backward()
        return {k: v.detach() for k, v in losses.items()}

    def global_counts(self, losses: dict) -> dict:
        """`losses` with every normalizer (`n_*`) summed over the ranks (one
        all_reduce), the numerators this rank's own."""
        if self.group.world == 1:
            return losses
        keys = sorted(k for k in losses if k.startswith("n_"))
        counts = self.group.all_reduce(torch.stack([losses[k].detach().float() for k in keys]))
        return {**losses, **dict(zip(keys, counts.unbind()))}

    def apply_update(self) -> None:
        params = list(self.params.values())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if self.model.tp is not None:
            grads = self.model.tp.sink.reduce_into(params, grads, self.grid.model)
        self.optimizer.step(self.dp.reduce(grads))
        self.dp.gather_params()
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

    def _global_totals(self, totals):
        """The totals summed over the ranks (one all_reduce)."""
        tot, tot_norm, tot_seqs = totals
        if self.group.world == 1 or tot_norm is None:
            return totals
        keys = sorted(tot)
        v = self.group.all_reduce(torch.stack(
            [torch.as_tensor(x, dtype=torch.float32, device=self.device)
             for x in [tot[k] for k in keys] + [tot_norm, tot_seqs]]))
        return dict(zip(keys, v[:-2].unbind())), v[-2], v[-1]

    def _totals_log(self, totals, t0, niter, tot_iters, phase) -> None:
        tot, tot_norm, tot_seqs = self._global_totals(totals)
        if not self.is_rank0:
            return
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
        """Close a profiler window still open at the epoch's end; the
        epoch's mean main loss."""
        if self._profiler is not None:
            self._stop_profile("epoch end")
        tot, tot_norm, _ = self._global_totals(totals)
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
            if not cross_valid and self._should_stop(niter):
                logger.warning("preemption: stopping epoch %d at batch %d/%d",
                               self.epoch, niter, tot_iters)
                break
            batch = reconcile_batch(self.group, batch)
            arrays = batch_to_device(batch, self.device)
            empty_rows = self.model.has_empty_rows(self.model.batch_inputs(batch)[1])
            if cross_valid:
                losses = self.eval_step(arrays, empty_rows)
                if niter == 1:
                    self.sample_decode(arrays, empty_rows)
            else:
                self._maybe_profile()
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
        """Append one JSON line to exp_dir/metrics.jsonl (and mirror it to
        TensorBoard when asked); rank 0 alone writes."""
        if not self.is_rank0:
            return
        record = {"time": time.time(), **record}
        with open(os.path.join(self.exp_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")
        self._tb_log(record)

    def _tb_log(self, record: dict) -> None:
        """With `training.tensorboard: true` or OPENASR_TENSORBOARD=1, every
        numeric field of a metrics record becomes a `{phase}/{key}` scalar
        at the record's step.  Without a usable
        `torch.utils.tensorboard`, it warns once and logs nothing more."""
        if not (bool(self.config.get("tensorboard", False))
                or os.environ.get("OPENASR_TENSORBOARD") == "1"):
            return
        if self._tb_writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb_writer = SummaryWriter(os.path.join(self.exp_dir, "tb"))
            except Exception as e:  # no tensorboard package, or a broken one
                logger.warning("tensorboard logging unavailable: %s", e)
                self._tb_writer = False
        if self._tb_writer is False:
            return
        phase = str(record.get("phase", "train"))
        step = int(record.get("step", 0))
        for k, v in record.items():
            if k in ("phase", "epoch", "step", "batch", "time"):
                continue
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self._tb_writer.add_scalar(f"{phase}/{k}", float(v), step)
        self._tb_writer.flush()

    def _maybe_profile(self) -> None:
        """A `torch.profiler` window (CPU activities, and CUDA's on the
        card) over steps [start_step, start_step + num_steps) of
        `training.profile`, opened before a step and closed before the
        first step past it (or at the epoch's end)."""
        prof = self.config.get("profile")
        if not prof or not self.is_rank0:
            return
        start = int(prof.get("start_step", 10))
        num = int(prof.get("num_steps", 5))
        if self._profiler is None and not self._profiled and start <= self.step < start + num:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
            self._profile_path = os.path.join(
                prof.get("logdir", os.path.join(self.exp_dir, "profile")),
                f"steps_{self.step}_{start + num}.pt.trace.json")
            logger.info("profiler: trace started at step %d", self.step)
        elif self._profiler is not None and self.step >= start + num:
            self._stop_profile("window end")

    def _stop_profile(self, why: str) -> None:
        """Synchronise the card, close the window and write its trace."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        os.makedirs(os.path.dirname(self._profile_path), exist_ok=True)
        self._profiler.export_chrome_trace(self._profile_path)
        self._profiler = None
        self._profiled = True
        logger.info("profiler: trace stopped (%s) -> %s", why, self._profile_path)

    def _install_preemption_handler(self) -> dict:
        """SIGTERM and SIGUSR1 (a scheduler's preemption warning) set a flag
        that stops training at the next batch.  Only the main thread can
        take signals; there it returns the handlers it replaced."""
        if threading.current_thread() is not threading.main_thread():
            return {}

        def handler(signum, frame):
            del frame
            self._stop_requested = True
            logger.warning("received signal %d: will checkpoint and stop", signum)

        return {sig: signal.signal(sig, handler) for sig in (signal.SIGTERM, signal.SIGUSR1)}

    # the agreement is a collective, so ranks check it every N batches (and
    # at each epoch's end, niter 0), not every batch
    STOP_CHECK_INTERVAL = 8

    def _should_stop(self, niter: int = 0) -> bool:
        """The preemption flag, agreed across the ranks: every rank reaches
        the same batches (the same batch plan) and consults the agreement
        on the same schedule (niter % STOP_CHECK_INTERVAL == 0), so a
        SIGTERM on a subset of ranks stops them all at the same batch.  One
        process: its own flag."""
        everyone = self.grid.everyone
        if everyone.world == 1:
            return self._stop_requested
        if self._stop_agreed:
            return True
        if niter % self.STOP_CHECK_INTERVAL != 0:
            return False
        flag = torch.tensor([int(self._stop_requested)], device=everyone.comm_device)
        if int(everyone.all_reduce(flag, "max")[0]):
            self._stop_requested = self._stop_agreed = True
        return self._stop_agreed

    def train(self) -> None:
        previous = self._install_preemption_handler()
        try:
            self._train()
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)

    def _train(self) -> None:
        best_cv = min(self.cv_loss) if self.cv_loss else 9e20
        while self.epoch < self.num_epoch:
            t0 = time.time()
            self.epoch += 1
            tr_loss = self.iter_one_epoch()
            if self._should_stop():
                # preempted: the interrupted epoch restarts from its start
                # under --continue-training
                self.epoch -= 1
                self.save(os.path.join(self.exp_dir, "last.pkg"))
                self._ckpt.wait()
                logger.warning("preemption: saved last.pkg, exiting")
                return
            self.save(os.path.join(self.exp_dir, f"ep-{self.epoch:04d}.pkg"))
            self.save(os.path.join(self.exp_dir, "last.pkg"))
            cv_loss = self.iter_one_epoch(cross_valid=True)
            best_cv = min(best_cv, cv_loss)
            if self.is_bob:
                self.schedule.update(cv_loss)
            minutes = (time.time() - t0) / 60.0
            if self.is_rank0:
                logger.info("Epoch %d done: tr %.4f cv %.4f (best %.4f) in %.1f min",
                            self.epoch, tr_loss, cv_loss, best_cv, minutes)
            self._log_metrics({
                "phase": "epoch", "epoch": self.epoch, "step": self.step,
                "tr_loss": tr_loss, "cv_loss": cv_loss, "best_cv": best_cv,
                "minutes": minutes,
            })
            self.tr_loss.append(tr_loss)
            self.cv_loss.append(cv_loss)
            self._ckpt.wait()
            if self.num_last_ckpt_keep and self.is_rank0:
                cleanup_ckpt(self.exp_dir, int(self.num_last_ckpt_keep))
        self._ckpt.wait()

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
        name).  On a grid, expert tables, model shards, the stages' layers
        and sharded moments are gathered whole: every rank calls it."""
        with full_expert_tables(self.model.module), self.model.full_tables(), \
                self.model.full_stacks():
            model = self.model.package()
        pkg = {
            "model": model,
            "solver_config": (self.config.to_dict() if hasattr(self.config, "to_dict")
                              else dict(self.config)),
            "solver_state": self.training_state(),
            "optim_state": self.dp.full_state(self.optimizer.state_dict()),
        }
        if self.is_bob:
            pkg["scheduler_state"] = self.schedule.pack_state()
        return pkg

    def save(self, path: str) -> None:
        """Snapshot the package now (on every rank); rank 0 writes it, in
        the background."""
        pkg = self.package()
        if self.is_rank0:
            self._ckpt.save(pkg, path)

    def restore(self, pkg: dict) -> None:
        """Solver and optimizer state of a package (the model is restored by
        the caller).  A package without optimizer state starts the
        optimizer afresh; the JAX package's optimizer state is bridged
        (`convert.jax_optim_state_to_port`)."""
        state = pkg["solver_state"]
        self.epoch = state["epoch"]
        self.step = state["step"]
        self.tr_loss = list(state["tr_loss"])
        self.cv_loss = list(state["cv_loss"])
        optim = pkg.get("optim_state")
        if optim is not None:
            if not isinstance(optim, dict):
                optim = jax_optim_state_to_port(self.model.model_type, optim,
                                                self.model.configs)
            self.optimizer.load_state_dict(self.dp.shard_state(optim))
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
                            enabled=self.compute_dtype == torch.bfloat16), \
                pipeline_scope(self._pipe_ctx):
            ids, lens = self.model.greedy_decode(inputs, lengths, empty_rows)
        if self.is_rank0:
            logger.info("dev sample greedy ids: %s", ids[0, : int(lens[0])].tolist())


SOLVER_REGISTRY = {
    "conv-transformer": CESolver,
    "conv-ctc-transformer": CTCCESolver,
    "conv-ctc": CTCSolver,
    "gru_ctc": CTCSolver,
    "wav2vec_ctc": CTCSolver,
}


def get_solver_class(model_type: str):
    """Case- and -/_-insensitive, as model types resolve."""
    import openasr_torch.solvers.cif  # noqa: F401  (fills the registry)
    import openasr_torch.solvers.cpc  # noqa: F401
    import openasr_torch.solvers.phone2char  # noqa: F401

    norm = model_type.lower().replace("-", "_")
    for name, cls in SOLVER_REGISTRY.items():
        if name.lower().replace("-", "_") == norm:
            return cls
    raise ValueError(
        f"No solver for model type {model_type!r} in the port; it trains "
        f"{sorted(SOLVER_REGISTRY)}"
    )
