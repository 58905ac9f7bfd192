"""Learning-rate schedules as ``step -> decay_rate`` functions.

Counterpart of openasr_tpu/ops/schedules.py: the effective lr is
``init_lr * decay_rate(step)`` with the step 1-based, the decay rate a
float32 tensor computed as the JAX package computes it inside its step.  A
step given as a tensor keeps its device, so the optimizer can take the lr
of its on-device count without reading it back.  `bob` decays on dev-loss
plateaus and is a small host-side state machine, whose rate is a Python
float.
"""

from __future__ import annotations

from typing import Callable

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _interp_linear(x, x0, y0, x1, y1):
    x = _f32(x)
    f = (x - x0) / max(x1 - x0, 1e-8)
    y = y0 + f.clamp(0.0, 1.0) * (y1 - y0)
    return torch.where(x < x0, _f32(y0), torch.where(x > x1, _f32(y1), y))


def linear_schedule(cfg) -> Callable:
    x0, y0, x1, y1 = cfg["x0"], cfg["y0"], cfg["x1"], cfg["y1"]
    return lambda step: _interp_linear(step, x0, y0, x1, y1)


def warmup_linear_schedule(cfg) -> Callable:
    x0, y0, x1, y1 = cfg["x0"], cfg["y0"], cfg["x1"], cfg["y1"]
    warmup = cfg["warmup_step"]
    return lambda step: torch.minimum(_interp_linear(step, 0, 0.0, warmup, y0),
                                      _interp_linear(step, x0, y0, x1, y1))


def warmup_transformer_schedule(cfg) -> Callable:
    """Noam: d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)."""
    warmup = float(cfg["warmup_step"])
    d_model = float(cfg["d_model"])

    def decay(step):
        step = _f32(step).clamp(min=1.0)
        return d_model ** -0.5 * torch.minimum(step ** -0.5, step * warmup ** -1.5)

    return decay


class BobSchedule:
    """Dev-loss-plateau decay, applied between epochs."""

    def __init__(self, cfg):
        self.decay_coef = float(cfg["decay_coef"])
        self.tolerate = float(cfg["tolerate"])
        self.decay_rate = 1.0
        self.last_loss = -1.0

    def __call__(self, step):
        return self.decay_rate

    def update(self, dev_loss: float) -> None:
        if self.last_loss > 0:
            improvement = (self.last_loss - dev_loss) / self.last_loss
            if improvement < self.tolerate:
                self.decay_rate *= self.decay_coef
        self.last_loss = dev_loss

    def pack_state(self) -> dict:
        return {"decay_rate": self.decay_rate, "last_loss": self.last_loss}

    def restore_state(self, state: dict) -> None:
        self.decay_rate = state["decay_rate"]
        self.last_loss = state["last_loss"]


def get_schedule(cfg) -> Callable:
    kind = cfg["type"]
    if kind == "linear":
        return linear_schedule(cfg)
    if kind == "warmup_linear":
        return warmup_linear_schedule(cfg)
    if kind == "warmup_transformer":
        return warmup_transformer_schedule(cfg)
    if kind == "bob":
        return BobSchedule(cfg)
    raise ValueError(f"Unknown scheduler: {kind}")
