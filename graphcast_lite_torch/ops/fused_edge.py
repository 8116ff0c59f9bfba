"""The training flag of the fused edge routes (torch counterpart of
``graphcast_lite_tpu.ops.fused_edge.training_trace``; the rest of that
module, the fused edge pipeline, is not ported).

The fused edge-step and edge-MLP kernels (``ops.edge_step``,
``ops.edge_mlp``) are forward only.  ``training.rollout.rollout_loss`` runs
the model inside ``training_trace()``, and the processor's route policy
(``models.gnn``) reads ``in_training()``, so the same model code takes the
composed, differentiable route when it is trained and the fused kernels
when it serves, as the JAX package does.
"""

from __future__ import annotations

import contextlib
import contextvars

__all__ = ["training_trace", "in_training"]

_TRAINING_TRACE = contextvars.ContextVar("gclt_training_trace",
                                         default=False)


@contextlib.contextmanager
def training_trace():
    """Mark the dynamic extent of a training computation."""
    token = _TRAINING_TRACE.set(True)
    try:
        yield
    finally:
        _TRAINING_TRACE.reset(token)


def in_training() -> bool:
    return _TRAINING_TRACE.get()
