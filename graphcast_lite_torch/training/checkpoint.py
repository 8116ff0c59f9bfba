"""Checkpoint / resume (torch counterpart of
``graphcast_lite_tpu.training.checkpoint``).

A checkpoint is a directory:

  <dir>/state.pt     the model's state dict, the optimizer's state dict
                     and SparseGAT's processing-edge mask (None for the
                     other families), one ``torch.save``
  <dir>/meta.json    epoch, ar_steps, best_val_loss, patience_counter and
                     the loss histories: the curriculum position (the same
                     keys as the JAX package's)

The best model is saved on its own as ``best_model.pt`` (params only).

The JAX package's files are read too, without flax or msgpack
(``utils.flax_msgpack``): ``load_flax_params`` reads its
``best_model.msgpack`` into a state dict, and ``load_flax_checkpoint`` its
``<dir>/state.msgpack`` + ``meta.json`` into a model, an optimizer and an
edge mask, so a JAX run can be served or resumed here.  The loaders copy a
saved edge mask into the caller's (``edge_mask=``, the ``Trainer``'s
``TrainState.edge_mask``) and refuse one that has no place there.  ``partial_restore`` copies only
the entries whose names and shapes match (the analogue of
``load_state_dict(strict=False)``) and reports the rest.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..utils.flax_msgpack import load_msgpack
from ..utils.params import from_flax_params, from_optax_adam_state, \
    from_optax_clipped_adamw_state
from .optim import ClippedAdamW

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "save_params",
    "load_params",
    "partial_restore",
    "load_flax_params",
    "load_flax_checkpoint",
]

STATE_FILE, FLAX_STATE_FILE, META_FILE = "state.pt", "state.msgpack", \
    "meta.json"


def save_params(path: str, model: nn.Module) -> None:
    torch.save(model.state_dict(), path)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """A state dict saved by ``save_params`` (a ``.pt`` file) or by the JAX
    package (a ``.msgpack`` file, through ``load_flax_params``)."""
    if path.endswith(".msgpack"):
        return load_flax_params(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(ckpt_dir: str, model: nn.Module,
                    optimizer: torch.optim.Optimizer,
                    meta: Dict[str, Any],
                    edge_mask: Optional[torch.Tensor] = None) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "edge_mask": (None if edge_mask is None
                              else edge_mask.detach().cpu())},
               os.path.join(ckpt_dir, STATE_FILE))
    with open(os.path.join(ckpt_dir, META_FILE), "w") as f:
        json.dump(meta, f)


def _meta(ckpt_dir: str) -> Dict[str, Any]:
    with open(os.path.join(ckpt_dir, META_FILE)) as f:
        return json.load(f)


def _restore_mask(saved, edge_mask: Optional[torch.Tensor]) -> None:
    """Copy a saved edge mask (None where the run had none) into
    ``edge_mask`` in place; raises where it has no place there."""
    if saved is None:
        return
    saved = torch.as_tensor(np.asarray(saved, np.float32))
    if edge_mask is None or tuple(edge_mask.shape) != tuple(saved.shape):
        raise ValueError(
            f"the checkpoint carries a SparseGAT edge mask of shape "
            f"{tuple(saved.shape)}, the state "
            f"{None if edge_mask is None else tuple(edge_mask.shape)}")
    with torch.no_grad():
        edge_mask.copy_(saved)


def load_checkpoint(ckpt_dir: str, model: nn.Module,
                    optimizer: torch.optim.Optimizer,
                    edge_mask: Optional[torch.Tensor] = None
                    ) -> Dict[str, Any]:
    """Load ``<dir>/state.pt`` into ``model``, ``optimizer`` and
    ``edge_mask`` (in place); returns the meta."""
    # Loaded onto the CPU: ``load_state_dict`` moves the moments to their
    # parameters' device and keeps Adam's ``step`` on the CPU, where the
    # non-capturable Adam wants it.
    blob = torch.load(os.path.join(ckpt_dir, STATE_FILE),
                      map_location="cpu", weights_only=True)
    _restore_mask(blob.get("edge_mask"), edge_mask)
    model.load_state_dict(blob["model"])
    optimizer.load_state_dict(blob["optimizer"])
    return _meta(ckpt_dir)


def load_flax_params(path: str) -> Dict[str, torch.Tensor]:
    """The JAX package's params file (``best_model.msgpack``) -> a state
    dict for this package's ``WeatherModel``."""
    return from_flax_params(load_msgpack(path))


def load_flax_checkpoint(ckpt_dir: str, model: nn.Module,
                         optimizer: torch.optim.Optimizer,
                         edge_mask: Optional[torch.Tensor] = None
                         ) -> Dict[str, Any]:
    """Load the JAX package's ``<dir>/state.msgpack`` (params, optax state,
    edge mask) into ``model``, ``optimizer`` (built by
    ``training.trainer.build_optimizer``: one parameter group, or two when
    the processor has its own learning rate, matching ``optax.adam`` and
    the JAX package's ``multi_transform``; or a ``ClippedAdamW``, matching
    the CNN trainers' clipped AdamW chain) and ``edge_mask`` (a SparseGAT
    run's; the JAX package saves an empty mapping for none); returns the
    meta."""
    blob = load_msgpack(os.path.join(ckpt_dir, FLAX_STATE_FILE))
    mask = blob["edge_mask"]
    if isinstance(mask, Mapping) and not mask:
        mask = None
    _restore_mask(mask, edge_mask)
    model.load_state_dict(from_flax_params(blob["params"]))
    groups = optimizer.param_groups
    if len(groups) not in (1, 2):
        raise ValueError(f"optimizer with {len(groups)} parameter groups")
    if isinstance(optimizer, ClippedAdamW):
        converted = from_optax_clipped_adamw_state(blob["opt_state"], model)
    else:
        factor = 1.0 if len(groups) == 1 \
            else groups[1]["lr"] / groups[0]["lr"]
        converted = from_optax_adam_state(blob["opt_state"], model, factor)
    state = optimizer.state_dict()
    if [g["params"] for g in state["param_groups"]] \
            != [g["params"] for g in converted["param_groups"]]:
        raise ValueError("the optimizer's parameter groups are not "
                         "build_optimizer's")
    state["state"] = converted["state"]
    optimizer.load_state_dict(state)
    return _meta(ckpt_dir)


def partial_restore(model: nn.Module, state: Mapping[str, torch.Tensor],
                    verbose: bool = True) -> Dict[str, list]:
    """Non-strict restore: copy the entries of ``state`` whose names and
    shapes match ``model``'s into it; report the rest as ``missing`` (in the
    model, not in ``state``), ``unexpected`` (in ``state`` only) and
    ``mismatched`` (both, other shapes)."""
    own = model.state_dict()
    missing, mismatched, loaded = [], [], {}
    for key, value in own.items():
        if key not in state:
            missing.append(key)
        elif tuple(state[key].shape) != tuple(value.shape):
            mismatched.append(key)
        else:
            loaded[key] = state[key]
    unexpected = [k for k in state if k not in own]
    model.load_state_dict(loaded, strict=False)
    if verbose and (missing or unexpected or mismatched):
        print(f"[partial_restore] missing={len(missing)} unexpected="
              f"{len(unexpected)} shape-mismatched={len(mismatched)}")
        for k in (missing + mismatched)[:10]:
            print(f"  - {k}")
    return {"missing": missing, "unexpected": unexpected,
            "mismatched": mismatched}
