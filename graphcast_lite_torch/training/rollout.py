"""Autoregressive rollout for inference (torch counterpart of
``graphcast_lite_tpu.training.rollout``: ``RolloutSpec``, ``carry_forward``,
``_one_step`` and ``rollout_predict``).

One rollout step:

  1. model(window.reshape(G, obs·C)) -> delta
  2. out = window[:, -1] + delta     (residual mode) | out = delta
  3. carry-forward: static channels from the last input frame, forcing
     channels from the ground-truth target (known in advance)
  4. window <- [window[1:], out]

The AR steps run in a plain Python loop.  Direct multi-step models and
the training loss come in later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

__all__ = ["RolloutSpec", "rollout_predict", "carry_forward"]


@dataclasses.dataclass(frozen=True)
class RolloutSpec:
    """Static configuration of the AR rollout.

    ``direct_steps > 1`` marks a DIRECT multi-step model (the decoder emits
    P·C channels in one forward); that mode is not ported yet."""

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
        raise NotImplementedError(
            "direct multi-step models are not ported yet (see ROADMAP)"
        )
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
