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

The explicit sharded path (``parallel.sharded_model``) refuses some model
families, as the JAX one does: product-graph models, encoders and
decoders other than ConvGCN / GAT, graph-mode LayerNorm, direct multi-step
models and the CNN stacks (``ShardedWeatherForward._validate``).  The JAX
package trains those with its single-device step under GSPMD: the batch
sharded ``P("data")``, the parameters replicated, and XLA inserting the
gradient all-reduce over the data axis.  The port's counterpart is the
data-parallel step (``make_data_parallel_train_step``, and
``make_data_parallel_eval_step`` for evaluation): each rank runs the
one-device ``TrainStep`` on its block of the batch, the fp32 gradients are
averaged over the data group in one all-reduce, and every rank takes the
same optimizer step.  It needs a mesh whose space axis is 1; GSPMD's
propagation along the node axis (``P("data", "space")``) has no PyTorch
counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..build import resolve_device
from ..training.trainer import _as_tensor, eval_metrics, eval_sums
from .collectives import all_reduce_, broadcast_

__all__ = ["ProcessMesh", "choose_mesh_shape", "make_mesh", "shard_batch",
           "replicated", "DataParallelTrainStep",
           "make_data_parallel_train_step", "DataParallelEvalStep",
           "make_data_parallel_eval_step"]


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


# ---- data-parallel training (the GSPMD fallback's counterpart) -------------


def _data_only(mesh: ProcessMesh, what: str) -> None:
    if mesh.space != 1:
        raise NotImplementedError(
            f"{what}: the mesh's space axis is {mesh.space}; the "
            "data-parallel step splits the batch only (make_mesh("
            "data_parallel=world)).  Splitting the node axis of these "
            "families (GSPMD's P('data', 'space')) is not ported "
            "(ROADMAP.md, 'Node-axis GSPMD')")


def _block(x, mesh: ProcessMesh):
    """This rank's rows of the batch axis of ``x`` (numpy or tensor) for
    evaluation: ``shard_batch``'s, or as even a split where B does not
    divide (a partial last batch)."""
    b = x.shape[0]
    return x[mesh.data_index * b // mesh.data:
             (mesh.data_index + 1) * b // mesh.data]


class DataParallelTrainStep:
    """One data-parallel step of a ``training.trainer.TrainStep`` (built by
    ``make_data_parallel_train_step``): the one-device step's loss and
    backward on this rank's block of the batch, the fp32 gradients (and
    the loss) averaged over ``mesh.data_group`` in one all-reduce of a
    flat buffer, then the optimizer's step on every rank.  ``all_reduces``
    counts the step's gradient all-reduces, ``mask_broadcasts`` SparseGAT's
    pruned masks sent from data rank 0."""

    def __init__(self, step, mesh: ProcessMesh):
        self.step, self.mesh = step, mesh
        self.all_reduces = self.mask_broadcasts = 0

    def __call__(self, x, y) -> torch.Tensor:
        """One step on the global batch (x [B, G, obs·C], y [B, G, P·C],
        the same on every rank); returns the global batch's fp32 loss."""
        return self.run(x, y)[0]

    def _sync_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """Data rank 0's pruned mask on every rank: the batch prunes on its
        first sample, which data rank 0 holds."""
        self.mask_broadcasts += 1
        return broadcast_(mask.detach().float().contiguous(), 0,
                          self.mesh.data_group).to(mask.dtype)

    def run(self, x, y, edge_mask=None, attention_threshold=0.0,
            prune: bool = False):
        """``TrainStep.run`` on the global batch: (global fp32 loss, new
        edge mask or None), equal on every rank."""
        mesh, step = self.mesh, self.step
        if x.shape[0] % mesh.data:
            raise ValueError(
                f"data-parallel training needs batch ({x.shape[0]}) "
                f"divisible by the data-parallel axis ({mesh.data}); use "
                "drop_remainder batching or a compatible batch_size")
        sync = self._sync_mask if mesh.data > 1 else None
        loss, new_mask = step.backward(shard_batch(x, mesh),
                                       shard_batch(y, mesh), edge_mask,
                                       attention_threshold, prune, sync)
        params = list(step.model.parameters())
        flat = torch.cat([p.grad.reshape(-1) for p in params]
                         + [loss.reshape(1)])
        all_reduce_(flat, mesh.data_group)
        self.all_reduces += 1
        flat /= mesh.data
        offset = 0
        for p in params:
            n = p.numel()
            p.grad = flat[offset:offset + n].view_as(p)
            offset += n
        step.optimizer.step()
        return flat[-1].clone(), new_mask


def make_data_parallel_train_step(step, mesh: ProcessMesh) \
        -> DataParallelTrainStep:
    """``step`` (a ``training.trainer.TrainStep`` from ``make_train_step``,
    of any model it takes: ``WeatherModel`` of every family or
    ``GridImageModel``, with any optimizer) trained data-parallel over the
    ranks of ``mesh`` (a ``(data, 1)`` mesh: ``make_mesh(
    data_parallel=world)``), the port's counterpart of the JAX package's
    single-device step run under GSPMD on a ``P("data")`` batch.

    Each rank runs ``step``'s loss and backward on its block of the batch
    (rows ``[d·B/data, (d+1)·B/data)``); the fp32 master gradients, after
    ``step``'s zero-fill and processor freeze, are averaged over the data
    group in one all-reduce (the blocks are equal and the loss's weights
    the same for every sample, so the mean of the blocks' gradients is the
    whole batch's); then ``step.optimizer`` steps on every rank, so a
    global-norm clip (``ClippedAdamW``) sees the global gradient and the
    ranks stay bitwise equal.  SparseGAT prunes on the batch's first
    sample: each pruned mask is broadcast from data rank 0 as the rollout
    makes it.  Building the step broadcasts the model's parameters and
    buffers from rank 0 (``replicated``); the optimizer's state must start
    equal on every rank (fresh, or one checkpoint)."""
    _data_only(mesh, "make_data_parallel_train_step")
    replicated(step.model, mesh)
    return DataParallelTrainStep(step, mesh)


class DataParallelEvalStep:
    """The one-device ``Trainer``'s evaluation (``_eval_batch``: the fp32
    one-step rollout's weighted loss, ACC and raw RMSE) of a batch split
    over the data group (built by ``make_data_parallel_eval_step``): each
    rank's ``eval_sums`` of its block, added up in one all-reduce."""

    def __init__(self, model, graphs, spec, mesh: ProcessMesh, device,
                 masks: Sequence[Optional[torch.Tensor]],
                 exclude_channels: Tuple[int, ...]):
        self.model, self.graphs, self.spec = model, graphs, spec
        self.mesh, self.device, self.masks = mesh, device, tuple(masks)
        self.exclude = tuple(exclude_channels)

    def __call__(self, x, y, edge_mask=None):
        """(loss, ACC, raw RMSE) of the global batch (x [B, G, obs·C], y
        [B, G, P·C], the same on every rank), on every rank.  A batch that
        does not divide by the data axis splits as evenly as it can."""
        with torch.no_grad():
            sums = eval_sums(self.model, self.graphs, self.spec,
                             _block(x, self.mesh), _block(y, self.mesh),
                             edge_mask, self.masks, self.exclude,
                             self.device)
        return eval_metrics(all_reduce_(sums, self.mesh.data_group))


def make_data_parallel_eval_step(
    model: nn.Module,
    graphs,
    spec,
    mesh: ProcessMesh,
    lat_weights=None,
    chan_mask=None,
    spatial_mask=None,
    exclude_channels: Sequence[int] = (),
    device=None,
) -> DataParallelEvalStep:
    """``eval(x, y, edge_mask=None) -> (loss, acc, raw_rmse)``: the
    one-device ``Trainer``'s fp32 evaluation of a batch (the JAX package's
    ``Trainer._make_eval_step`` run on a ``P("data")`` batch), each rank
    evaluating its block of ``model`` (fp32, the same on every rank) on
    ``graphs`` (None for a ``GridImageModel``), the loss's and metrics'
    sums reduced over the data group in one all-reduce.  ``lat_weights``,
    ``chan_mask`` and ``spatial_mask`` weight the loss as ``Trainer``'s do;
    ``exclude_channels`` leave the ACC.  On the card unless ``device``
    says otherwise."""
    _data_only(mesh, "make_data_parallel_eval_step")
    dev = resolve_device(device)
    return DataParallelEvalStep(
        model.to(dev), None if graphs is None else graphs.to(dev), spec,
        mesh, dev, tuple(_as_tensor(a, dev) for a in (
            lat_weights, chan_mask, spatial_mask)),
        tuple(sorted(set(exclude_channels))))
