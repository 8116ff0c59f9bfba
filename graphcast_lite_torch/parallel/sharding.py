"""The (data, space) process grid of multi-device training (torch
counterpart of ``graphcast_lite_tpu.parallel.sharding``).

The JAX package lays its chips out as a 2-D ``jax.sharding.Mesh`` with axes
``("data", "space")``; here the same grid is laid over the ranks of an
already initialised default process group (``torch.distributed``, one
process a rank, started by ``torchrun`` or ``torch.multiprocessing``):

* rank ``r`` sits at ``(r // space, r % space)``, data-major, as
  ``np.asarray(devices).reshape(data, space)`` orders the chips;
* the ``space`` group holds the ranks that share a data index (the halo
  exchanges, graph-mode LayerNorm statistics and the ACC moments run over
  it), the ``data`` group the ranks that share a space index;
* batches split as ``P("data", "space")`` does: the batch axis into
  contiguous blocks over ``data``, the next axis (the shard axis of the
  sharded node layout) into contiguous blocks over ``space``
  (``shard_batch``);
* parameters are replicated: ``replicated`` broadcasts them from rank 0.

The JAX package also trains a single-device step under GSPMD, which shards
it automatically from its input shardings (``jax.jit`` with in/out
shardings).  PyTorch has no counterpart of that propagation, so the port
has only the explicit path (``parallel.sharded_model``), which refuses
product-graph models as the JAX one does (``ShardedWeatherForward.
_validate``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .collectives import broadcast_

__all__ = ["ProcessMesh", "choose_mesh_shape", "make_mesh", "shard_batch",
           "replicated"]


def choose_mesh_shape(n_devices: int, data_parallel: Optional[int] = None):
    """(data, space) axis sizes.  Prefer a balanced split: data gets the
    largest power-of-two divisor ≤ sqrt(n), space the rest."""
    if data_parallel is not None:
        assert n_devices % data_parallel == 0
        return data_parallel, n_devices // data_parallel
    data = 1
    while data * 2 <= int(np.sqrt(n_devices)) and n_devices % (data * 2) == 0:
        data *= 2
    return data, n_devices // data


@dataclasses.dataclass
class ProcessMesh:
    """This rank's place in the (data, space) grid and the groups over its
    two axes (``world`` is the default group)."""

    shape: Tuple[int, int]      # (data, space)
    rank: int
    data_index: int
    space_index: int
    space_group: Any            # ranks with this rank's data index
    data_group: Any             # ranks with this rank's space index
    world_group: Any

    @property
    def data(self) -> int:
        return self.shape[0]

    @property
    def space(self) -> int:
        return self.shape[1]


def make_mesh(n_devices: Optional[int] = None,
              data_parallel: Optional[int] = None) -> ProcessMesh:
    """The (data, space) grid over the default process group, which must be
    initialised and hold ``n_devices`` ranks (default: all of them).  Every
    rank must call it, in the same order as its other group creations:
    each creates every subgroup (``torch.distributed.new_group``
    requires that)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the default process group "
                           "first (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh: {n} devices asked for, the process "
                         f"group holds {world} ranks")
    data, space = choose_mesh_shape(n, data_parallel)
    grid = np.arange(n).reshape(data, space)
    rank = dist.get_rank()
    d_idx, s_idx = divmod(rank, space)
    space_group = data_group = None
    # Every rank creates every group, rows (space groups) first.
    for d in range(data):
        g = _group(grid[d].tolist(), n)
        if d == d_idx:
            space_group = g
    for s in range(space):
        g = _group(grid[:, s].tolist(), n)
        if s == s_idx:
            data_group = g
    return ProcessMesh(shape=(data, space), rank=rank, data_index=d_idx,
                       space_index=s_idx, space_group=space_group,
                       data_group=data_group, world_group=dist.group.WORLD)


def _group(ranks, world: int):
    """The default group where ``ranks`` is all of them, else a new one."""
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks)


def shard_batch(x, mesh: ProcessMesh):
    """This rank's block of ``x`` [B, S, ...] (``P("data", "space")``):
    rows ``[d·B/data, (d+1)·B/data)`` of the batch axis and, of the next
    axis, the contiguous block of this rank's space index."""
    b, s = x.shape[0], x.shape[1]
    if b % mesh.data or s % mesh.space:
        raise ValueError(f"shard_batch: shape {tuple(x.shape)} does not "
                         f"split over the (data, space) grid {mesh.shape}")
    bl, sl = b // mesh.data, s // mesh.space
    return x[mesh.data_index * bl:(mesh.data_index + 1) * bl,
             mesh.space_index * sl:(mesh.space_index + 1) * sl]


def replicated(module: nn.Module, mesh: ProcessMesh) -> nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 to every
    rank (in place); returns the module."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            broadcast_(t, 0, mesh.world_group)
    return module
