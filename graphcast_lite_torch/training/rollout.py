"""Autoregressive rollout: the shared core of training and inference
(torch counterpart of ``graphcast_lite_tpu.training.rollout``).

One rollout step:

  1. model(window.reshape(G, obs·C)) -> delta
  2. out = window[:, -1] + delta     (residual mode) | out = delta
  3. loss += weighted_mse(out, target_step)          (``rollout_loss``)
  4. carry-forward: static channels from the last input frame, forcing
     channels from the ground-truth target (known in advance)
  5. window <- [window[1:], out]

The AR steps run in a plain Python loop.  ``rollout_loss`` backpropagates
through all of them (BPTT); with ``spec.remat`` each step's model call
runs under ``torch.utils.checkpoint``, so the backward recomputes a step's
activations instead of keeping every step's.  A DIRECT multi-step model
(``spec.direct_steps > 1``) emits all P steps in one forward
(``_direct_forward``): no AR loop, no window feedback.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.fused_edge import training_trace
from .loss import weighted_mse

__all__ = ["RolloutSpec", "rollout_loss", "rollout_predict",
           "carry_forward"]


@dataclasses.dataclass(frozen=True)
class RolloutSpec:
    """Static configuration of the AR rollout.

    ``direct_steps > 1`` marks a DIRECT multi-step model (the decoder emits
    P·C channels in one forward)."""

    obs_window: int
    num_features: int
    use_residual: bool = True
    remat: bool = True
    static_channels: Tuple[int, ...] = ()
    forcing_channels: Tuple[int, ...] = ()
    direct_steps: int = 1

    def static_ch_mask(self) -> Optional[np.ndarray]:
        if not self.static_channels:
            return None
        m = np.zeros(self.num_features, np.float32)
        m[list(self.static_channels)] = 1.0
        return m

    def forcing_ch_mask(self) -> Optional[np.ndarray]:
        if not self.forcing_channels:
            return None
        m = np.zeros(self.num_features, np.float32)
        m[list(self.forcing_channels)] = 1.0
        return m


def carry_forward(
    out: torch.Tensor,
    last_input: torch.Tensor,
    target: Optional[torch.Tensor],
    spec: RolloutSpec,
) -> torch.Tensor:
    """Overwrite static channels from the last input frame and forcing
    channels from the ground-truth target (masks in ``out.dtype``: 0/1 are
    exact in bf16, and an fp32 mask would promote the AR window)."""
    sm = spec.static_ch_mask()
    if sm is not None:
        sm = torch.as_tensor(sm, dtype=out.dtype, device=out.device)
        out = out * (1 - sm) + last_input * sm
    fm = spec.forcing_ch_mask()
    if fm is not None and target is not None:
        fm = torch.as_tensor(fm, dtype=out.dtype, device=out.device)
        out = out * (1 - fm) + target * fm
    return out


def _one_step(
    model_fn: Callable,
    window: torch.Tensor,      # [..., G, obs, C]
    edge_mask: Optional[torch.Tensor],
    attention_threshold,
    prune: bool,
    spec: RolloutSpec,
):
    """Run the model once on the flattened window.  Returns (out_raw, mask')."""
    g = window.shape[-3]
    inp = window.reshape(window.shape[:-3]
                         + (g, spec.obs_window * spec.num_features))
    delta, new_mask = model_fn(inp, edge_mask, attention_threshold, prune)
    out = window[..., -1, :] + delta if spec.use_residual else delta
    return out, new_mask


def _trained_step(model_fn, window, edge_mask, attention_threshold, prune,
                  spec):
    """``_one_step`` inside ``training_trace()``: the checkpoint's
    recompute runs during the backward, outside ``rollout_loss``'s own
    ``training_trace()``, and must take the routes the forward took."""
    with training_trace():
        return _one_step(model_fn, window, edge_mask, attention_threshold,
                         prune, spec)


def _direct_forward(
    model_fn: Callable,
    window: torch.Tensor,        # [..., G, obs, C]
    steps: int,
    spec: RolloutSpec,
    edge_mask,
    attention_threshold,
    prune: bool,
    forcing: Optional[torch.Tensor],   # [..., G, P, C] targets/forcing
):
    """One forward of a direct multi-step model -> ([..., G, steps, C], mask).

    Residual mode adds the last observed frame to EVERY step's delta.
    Carry-forward: static channels from the last input frame and forcing
    channels from the known-in-advance targets, applied to every step (the
    window never advances)."""
    g = window.shape[-3]
    p, c = spec.direct_steps, spec.num_features
    inp = window.reshape(window.shape[:-3] + (g, spec.obs_window * c))
    delta, new_mask = model_fn(inp, edge_mask, attention_threshold, prune)
    if delta.shape[-1] != p * c:
        raise ValueError(f"direct_steps={p} x {c} features, model emitted "
                         f"{delta.shape[-1]}")
    out = delta.reshape(delta.shape[:-1] + (p, c))[..., :steps, :]
    last = window[..., -1, :][..., None, :]
    if spec.use_residual:
        out = last + out
    sm = spec.static_ch_mask()
    if sm is not None:
        sm = torch.as_tensor(sm, dtype=out.dtype, device=out.device)
        out = out * (1 - sm) + last * sm
    fm = spec.forcing_ch_mask()
    if fm is not None and forcing is not None:
        # Slice AFTER clipping out to `steps`, so a forcing window shorter
        # than direct_steps (but >= steps) cannot mismatch.
        fm = torch.as_tensor(fm, dtype=out.dtype, device=out.device)
        out = out * (1 - fm) + forcing[..., :steps, :] * fm
    return out, new_mask


def rollout_loss(
    model_fn: Callable,
    window: torch.Tensor,        # [..., G, obs, C] current state
    targets: torch.Tensor,       # [..., G, P, C]
    steps: int,
    spec: RolloutSpec,
    edge_mask: Optional[torch.Tensor] = None,
    attention_threshold=0.0,
    prune: bool = False,
    lat_weights: Optional[torch.Tensor] = None,
    chan_mask: Optional[torch.Tensor] = None,
    spatial_mask: Optional[torch.Tensor] = None,
    extra_loss_fn: Optional[Callable] = None,
):
    """Mean weighted-MSE over `steps` AR steps (BPTT through all of them).

    model_fn(inp [..., G, obs·C], edge_mask, thr, prune) -> (delta, mask').
    extra_loss_fn(out [..., G, C], target) -> scalar, added per step.
    Returns (loss, new_edge_mask).  Runs inside ``training_trace()``, so the
    model takes its differentiable routes."""
    if spec.direct_steps > 1:
        steps = min(steps, spec.direct_steps)
        with training_trace():
            out, edge_mask = _direct_forward(
                model_fn, window, steps, spec, edge_mask,
                attention_threshold, prune, targets,
            )
            total = 0.0
            for step in range(steps):
                o, t = out[..., step, :], targets[..., step, :]
                total = total + weighted_mse(
                    o, t, lat_weights, chan_mask, spatial_mask
                )
                if extra_loss_fn is not None:
                    total = total + extra_loss_fn(o, t)
        return total / steps, edge_mask

    total = 0.0
    with training_trace():
        for step in range(steps):
            if spec.remat:
                # No randomness in the model: the recompute needs no saved
                # RNG state.
                out, edge_mask = checkpoint(
                    _trained_step, model_fn, window, edge_mask,
                    attention_threshold, prune, spec,
                    use_reentrant=False, preserve_rng_state=False,
                )
            else:
                out, edge_mask = _one_step(
                    model_fn, window, edge_mask, attention_threshold, prune,
                    spec,
                )
            target = targets[..., step, :]
            total = total + weighted_mse(
                out, target, lat_weights, chan_mask, spatial_mask
            )
            if extra_loss_fn is not None:
                total = total + extra_loss_fn(out, target)
            out = carry_forward(out, window[..., -1, :], target, spec)
            window = torch.cat([window[..., 1:, :], out[..., None, :]],
                               dim=-2)
    return total / steps, edge_mask


def rollout_predict(
    model_fn: Callable,
    window: torch.Tensor,          # [..., G, obs, C]
    steps: int,
    spec: RolloutSpec,
    edge_mask: Optional[torch.Tensor] = None,
    attention_threshold=0.0,
    forcing: Optional[torch.Tensor] = None,   # [..., G, P, C] known-in-advance
) -> torch.Tensor:
    """Pure AR inference: returns predictions [..., G, P, C].

    ``model_fn(inp [..., G, obs·C], edge_mask, thr, prune) -> (delta, mask')``.
    """
    if spec.direct_steps > 1:
        if steps > spec.direct_steps:
            raise ValueError(
                f"direct model emits {spec.direct_steps} steps per forward; "
                f"{steps} requested — AR continuation of direct models is "
                "not defined (the window never advances)"
            )
        out, _ = _direct_forward(
            model_fn, window, steps, spec,
            edge_mask, attention_threshold, False, forcing,
        )
        return out

    outs = []
    for step in range(steps):
        out, edge_mask = _one_step(
            model_fn, window, edge_mask, attention_threshold, False, spec
        )
        tgt = forcing[..., step, :] if forcing is not None else None
        out = carry_forward(out, window[..., -1, :], tgt, spec)
        outs.append(out)
        window = torch.cat([window[..., 1:, :], out[..., None, :]], dim=-2)
    return torch.stack(outs, dim=-2)
