"""Learning-rate and α_P schedules and the three per-player Adams: the
port of ``triplegan_tpu/train/schedule.py``.

``Adam`` reproduces ``optax.adam`` (β1 = 0.5 in the configs): the moments
``mu = (1−β1)·g + β1·mu`` and ``nu = (1−β2)·g² + β2·nu``, bias correction
at the 1-based step t, ``eps`` outside the square root, and the learning
rate read from the schedule at the count before the update (t − 1). It is
functional, like optax: ``update`` returns new parameters and a new state
and changes neither input.

The train step does not read the schedules or the bias corrections in its
body: its caller computes them on the host in float64, as here, rounds
them once to float32 and hands them to the step on the device
(``train/step.py::TrainStep.scalars``), so a CUDA graph that captures the
step reads each replay's own values, and the eager step runs the same code.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import torch

Tree = Dict[str, Dict[str, torch.Tensor]]


def linear_decay_schedule(base_lr: float, decay_start: int, total_steps: int) -> Callable:
    """Constant lr, then linear decay to 0 over [decay_start, total_steps]."""

    def sched(count: int) -> float:
        frac = min(max((count - decay_start) / max(total_steps - decay_start, 1), 0.0), 1.0)
        return base_lr * (1.0 - frac)

    return sched


def alpha_p_schedule(alpha_p: float, warmup_steps: int, ramp_steps: int = 0) -> Callable:
    """R_P weight: 0 until warm-up completes, then a linear 0 → α_P ramp
    over ``ramp_steps`` (0: a hard step)."""

    def sched(step: int) -> float:
        if ramp_steps <= 0:
            return alpha_p if step >= warmup_steps else 0.0
        return alpha_p * min(max((step - warmup_steps) / ramp_steps, 0.0), 1.0)

    return sched


def anneal_every_schedule(base_sched: Callable, factor: float, every_steps: int) -> Callable:
    """lr(t) = base(t) · factor^⌊t / every⌋."""

    def sched(count: int) -> float:
        return base_sched(count) * factor ** (count // every_steps)

    return sched


@dataclasses.dataclass
class AdamState:
    count: int
    mu: Tree
    nu: Tree


def _map(fn, *trees: Tree) -> Tree:
    return {layer: {name: fn(*(t[layer][name] for t in trees)) for name in arrays}
            for layer, arrays in trees[0].items()}


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: Callable  # schedule: count -> learning rate
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Tree) -> AdamState:
        return AdamState(0, _map(torch.zeros_like, params), _map(torch.zeros_like, params))

    def scalars(self, count: int) -> Tuple[float, float, float]:
        """What an update at ``count`` reads: the lr at ``count`` and the
        bias corrections 1 − β1^t and 1 − β2^t at t = count + 1."""
        t = count + 1
        return self.lr(count), 1.0 - self.b1 ** t, 1.0 - self.b2 ** t

    def update(self, params: Tree, grads: Tree, state: AdamState,
               scalars: Sequence[torch.Tensor] = None):
        """One step: (new params, new state). ``scalars`` are
        ``self.scalars(state.count)`` rounded to float32, as 0-d tensors on
        the parameters' device (the train step passes its own); without
        them they are made here."""
        if scalars is None:
            dev = next(t for arrays in params.values() for t in arrays.values()).device
            scalars = torch.tensor(self.scalars(state.count), dtype=torch.float64).float().to(dev).unbind()
        lr, bc1, bc2 = scalars
        with torch.no_grad():
            mu = _map(lambda g, m: (1.0 - self.b1) * g + self.b1 * m, grads, state.mu)
            nu = _map(lambda g, v: (1.0 - self.b2) * (g * g) + self.b2 * v, grads, state.nu)
            new = _map(lambda p, m, v: p - lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)),
                       params, mu, nu)
        return new, AdamState(state.count + 1, mu, nu)


def make_optimizers(cfg, total_steps: int) -> Dict[str, Adam]:
    decay_start = int(cfg.lr_decay_start_frac * total_steps)

    def adam(lr, anneal_factor: float = 1.0, anneal_epochs: int = 0):
        sched = linear_decay_schedule(lr, decay_start, total_steps)
        if anneal_factor != 1.0 and anneal_epochs > 0:
            steps_per_epoch = max(total_steps // max(int(cfg.epochs), 1), 1)
            sched = anneal_every_schedule(sched, anneal_factor, anneal_epochs * steps_per_epoch)
        return Adam(lr=sched, b1=cfg.adam_b1, b2=cfg.adam_b2, eps=cfg.adam_eps)

    return {
        "gen": adam(cfg.lr_g),
        "disc": adam(cfg.lr_d),
        "clf": adam(cfg.lr_c, float(cfg.get("lr_c_anneal_factor", 1.0)),
                    int(cfg.get("lr_c_anneal_epochs", 0))),
    }
