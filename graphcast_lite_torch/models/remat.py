"""The train step's memory policies (torch counterpart of the JAX
package's ``nn.remat`` switches in ``models/weather.py`` and
``models/gnn.py``): which parts of a grad-enabled model call keep their
intermediates for the backward and which recompute them.

* ``GCLT_ENCDEC_REMAT`` (``encdec_remat``): the encoder and the decoder
  blocks each run under a checkpoint, so a call keeps only their inputs
  and recomputes the rest in the backward.  ``0``, ``false`` and ``off``
  turn it off, any other value on; unset, it takes the port's default
  (``ENCDEC_REMAT_DEFAULT``: off, where the JAX package's is on, which it
  needs to fit a TPU's memory; on the H100 the flagship's step fits
  without it, and the recompute cost 2-3% of the step).
* ``GCLT_SCAN_REMAT`` (``scan_remat``): each InteractionNet processor
  step (the plain ``(x, e)`` step or the lazy ``(x, v, a, c)`` step)

  - ``none`` (default): runs plainly and keeps everything its backward
    reads;
  - ``dots``: runs under a checkpoint that keeps the step's carries and
    the outputs of its matrix products without batch dimensions
    (``aten.mm``, ``aten.addmm``, ``aten.mv``, ``aten.dot``: every
    ``x @ W`` and ``F.linear`` with a shared weight, also on a
    ``[B, E, H]`` batch, which torch folds into one ``mm``), and
    recomputes the rest: gathers, activations, LayerNorms, the
    batched products (``bmm``) of a batch's per-sample folded weights,
    and everything inside the hand-written kernels, which are opaque to
    the policy as a ``pallas_call`` is to the JAX one
    (``dots_with_no_batch_dims_saveable``);
  - ``full``: runs under a checkpoint that keeps only the carries and
    recomputes the whole step.

Both checkpoints are non-reentrant and keep no RNG state (the model draws
no random numbers), so they nest inside the train step's per-AR-step
checkpoint (``training.rollout``): under ``full`` a processor step's
forward runs three times per AR step of a train step (the forward, the
AR step's recompute, the step's own recompute).  A checkpoint taken inside
``ops.fused_edge.training_trace()`` recomputes inside it, so the backward
replays the routes the forward took.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Callable

import torch
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, \
    create_selective_checkpoint_contexts

from ..ops.fused_edge import in_training, training_trace

__all__ = ["ENCDEC_REMAT_DEFAULT", "SCAN_REMAT_MODES", "checkpointed",
           "encdec_remat", "scan_remat"]

# The port's default for GCLT_ENCDEC_REMAT (the JAX package's is on).
ENCDEC_REMAT_DEFAULT = False
SCAN_REMAT_MODES = ("none", "dots", "full")
_OFF = ("0", "false", "off")
# The matrix products without batch dimensions, as torch dispatches them.
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.mv.default, torch.ops.aten.dot.default})


def encdec_remat() -> bool:
    """``GCLT_ENCDEC_REMAT``: checkpoint the encoder and decoder blocks."""
    v = os.environ.get("GCLT_ENCDEC_REMAT")
    if v is None:
        return ENCDEC_REMAT_DEFAULT
    return v not in _OFF


def scan_remat() -> str:
    """``GCLT_SCAN_REMAT``: ``none``, ``dots`` or ``full``."""
    mode = os.environ.get("GCLT_SCAN_REMAT", "none").lower()
    if mode not in SCAN_REMAT_MODES:
        raise ValueError(
            f"GCLT_SCAN_REMAT={mode!r}: expected one of {SCAN_REMAT_MODES} "
            "(the JAX package reads any value other than none or dots as "
            "full)")
    return mode


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(module: torch.nn.Module, fn: Callable, *args,
                 dots: bool = False):
    """``fn(*args)`` (``module`` or one of its methods) under a
    non-reentrant checkpoint; ``dots`` keeps the outputs of its products
    without batch dimensions.

    The recompute runs in the backward, outside the forward's context: it
    re-enters ``training_trace()`` where the forward ran in it, and binds
    the tensors that stood for ``module``'s parameters and buffers in the
    forward (the mixed-precision step's low-precision copies, bound by
    ``torch.func.functional_call``) in place of the module's own."""
    state = dict(module.named_parameters())
    state.update(module.named_buffers())
    trace = training_trace if in_training() else contextlib.nullcontext

    def run(*a):
        with trace(), _reparametrize_module(module, state):
            return fn(*a)

    context = {}
    if dots:
        # torch.matmul of a vector squeezes its mm's output in place, a
        # change of shape that the cache would otherwise refuse; values
        # are never written in place into a product's output.
        context["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy,
            allow_cache_entry_mutation=True)
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False, **context)
