"""The CNN trainers' optimizer: ``optax.chain(clip_by_global_norm(max_norm),
adamw(cosine_decay_schedule(lr, decay_steps)))`` as one
``torch.optim.Optimizer``, in optax's arithmetic:

* the gradients are clipped by their global norm ``n`` over every
  parameter: unchanged when ``n < max_norm``, else ``(g / n) * max_norm``
  (``torch.nn.utils.clip_grad_norm_`` divides by ``n + 1e-6`` instead);
* AdamW: ``m / (1 − b1^t) / (sqrt(v / (1 − b2^t)) + eps)`` (eps outside the
  square root), plus ``weight_decay · p`` on every parameter, norms and
  biases included (optax's default 1e-4, not torch's 1e-2);
* times the cosine schedule's rate at the update count BEFORE this
  update (the first step takes the full rate):
  ``lr · 0.5 · (1 + cos(π · min(t, T) / T))``.

The count is each parameter's ``step`` in the optimizer's state (all
equal), so ``state_dict`` carries the schedule's position and a resumed
run continues the schedule.
"""

from __future__ import annotations

import math
from typing import Iterable

import torch

__all__ = ["ClippedAdamW", "cosine_decay"]

# optax.adamw's defaults, which the CNN trainers use.
B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4


def cosine_decay(lr: float, decay_steps: int, count: int) -> float:
    """optax's ``cosine_decay_schedule(lr, decay_steps)`` at ``count``."""
    t = min(count, decay_steps)
    return lr * 0.5 * (1 + math.cos(math.pi * t / decay_steps))


class ClippedAdamW(torch.optim.Optimizer):
    """Global-norm clipping, then AdamW at a cosine-decayed rate (see the
    module's docstring); ``decay_steps`` must be positive."""

    def __init__(self, params: Iterable, lr: float, decay_steps: int,
                 max_norm: float = 1.0):
        if not decay_steps > 0:
            raise ValueError(f"decay_steps must be positive, got "
                             f"{decay_steps}")
        super().__init__(params, dict(lr=lr, decay_steps=decay_steps,
                                      max_norm=max_norm))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for g in self.param_groups for p in g["params"]
                  if p.grad is not None]
        if not params:
            return loss
        norm = torch.sqrt(sum(torch.sum(torch.square(p.grad.float()))
                              for p in params))
        keep = norm < self.param_groups[0]["max_norm"]
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = torch.where(keep, p.grad,
                                (p.grad / norm) * group["max_norm"])
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                count = int(state["step"].item())
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(B1).add_((1 - B1) * g)
                v.mul_(B2).add_((1 - B2) * torch.square(g))
                t = torch.tensor(float(count + 1))
                c1 = 1 - torch.tensor(B1) ** t
                c2 = 1 - torch.tensor(B2) ** t
                update = (m / c1.item()) / (torch.sqrt(v / c2.item()) + EPS)
                update = update + WEIGHT_DECAY * p
                rate = cosine_decay(group["lr"], group["decay_steps"], count)
                p.add_(update * -rate)
                state["step"] += 1
        return loss
