"""Training: the AR-P BPTT + Adam step in mixed precision and the epoch
loop around it (torch counterpart of ``graphcast_lite_tpu.training.trainer``,
without its sharded ``mesh=`` path).

``make_train_step(model, graphs, spec, cfg)`` returns a ``TrainStep``;
``step(x, y)`` runs one step on a batch and returns the loss:

* the fp32 master parameters are cast to ``cfg.tpu.compute_dtype`` for the
  forward (a differentiable cast, so the gradients land on the masters),
  and so are the graphs' float arrays (fp32 arrays would promote the
  whole forward back to fp32);
* the loss is ``training.rollout.rollout_loss`` over ``steps`` AR steps,
  taken in fp32 at the end;
* the gradients arrive in fp32 on the masters (the cast's adjoint), the
  processor's are zeroed when it is frozen, a parameter the loss does not
  reach gets a zero gradient (as in the JAX package's gradient tree, so
  Adam's step counts agree), and Adam updates the masters.

``Trainer`` owns the model, ONE optimizer (Adam's moments ride across
every AR level and the end of the processor freeze, as the JAX package's
``opt_state`` does in ``TrainState``) and one ``TrainStep`` per
(AR steps, freeze).  ``Trainer.fit`` runs the epoch loop: the AR
curriculum (``epochs_per_stage = max(num_epochs // max_ar, 1)``), the
processor freeze, early stopping, the fp32 evaluation of one-step
rollouts, ``best_model.pt``, a checkpoint every epoch (``training.
checkpoint``), resume (from this package's checkpoint or the JAX
package's), and the logs (``training_log.txt``, ``metrics.jsonl``,
``results.json``).  A batch is a Python loop over its samples; the JAX
package vmaps the model over it (the losses agree, the times do not).

The CNN stacks (``models.grid_adapter.GridImageModel``) train through
the same loop with ``graphs=None``, their own optimizer (``optimizer=``,
the CNN trainers' ``training.optim.ClippedAdamW``) and an extra loss term
(``extra_loss_fn=``, their spectral and Sobel losses), as in the JAX
package.

SparseGAT: ``TrainState.edge_mask`` carries the processing graph's pruned
edge mask from step to step and epoch to epoch (it starts as the graph's
own mask).  The epoch's ``attention_threshold_schedule`` threshold prunes
on the epoch's first batch only, once it is positive, with the mask of
the batch's first sample (as the JAX package does); evaluation and the
checkpoints carry the mask.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import time
from datetime import datetime
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..build import config_direct_steps, resolve_device, resolve_dtype
from ..config import ExperimentConfig, GraphLayerType
from ..data.dataset import BatchIterator, ChunkedTimeseriesDataset, \
    DatasetMetadata
from ..models.grid_adapter import GridImageModel
from ..models.unet import init_weights
from ..models.weather import ModelGraphs, WeatherModel
from . import checkpoint as ckpt_lib
from .loss import (
    anomaly_correlation,
    boundary_mask,
    channel_mask,
    combine_spatial_masks,
    lat_weights_from_axis,
    lat_weights_from_nodes,
    weighted_mse,
)
from .rollout import RolloutSpec, rollout_loss, rollout_predict

__all__ = ["TrainState", "TrainStep", "Trainer",
           "attention_threshold_schedule", "build_optimizer",
           "make_train_step"]


def attention_threshold_schedule(
    epoch: int,
    max_epochs: int = 30,
    start_epoch: int = 5,
    final_threshold: float = 0.1356,
) -> float:
    """Linear ramp 0 -> final between start_epoch and start_epoch+max_epochs
    (the SparseGAT pruning threshold of the epoch)."""
    if epoch < start_epoch:
        return 0.0
    if epoch > max_epochs + start_epoch:
        return final_threshold
    return min(
        final_threshold,
        (epoch - start_epoch) * final_threshold / (max_epochs - start_epoch),
    )


def _is_processor(name: str) -> bool:
    return "processor" in name.split(".")


def build_optimizer(model: nn.Module, learning_rate: float,
                    processor_lr_factor: float = 1.0) -> torch.optim.Adam:
    """Adam, with the processor's parameters in a second group at
    ``learning_rate * processor_lr_factor`` when the factor is not 1
    (differential-LR fine-tuning)."""
    named = list(model.named_parameters())
    if processor_lr_factor == 1.0:
        return torch.optim.Adam([p for _, p in named], lr=learning_rate)
    return torch.optim.Adam([
        {"params": [p for n, p in named if not _is_processor(n)],
         "lr": learning_rate},
        {"params": [p for n, p in named if _is_processor(n)],
         "lr": learning_rate * processor_lr_factor},
    ])


def _zero_processor_grads(model: nn.Module) -> None:
    """Zero (not drop) the processor's gradients: Adam still decays its
    moments, as the JAX package's zeroed gradient tree does."""
    for name, p in model.named_parameters():
        if _is_processor(name) and p.grad is not None:
            p.grad.zero_()


def _as_tensor(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


class TrainStep:
    """One BPTT + optimizer step of ``model`` (built by
    ``make_train_step``); ``graphs`` is None for a model that needs none
    (``GridImageModel``), ``extra_loss_fn`` as ``rollout_loss``'s."""

    def __init__(self, model: nn.Module, graphs: Optional[ModelGraphs],
                 spec: RolloutSpec, steps: int, device: torch.device,
                 compute_dtype: torch.dtype, optimizer: torch.optim.Optimizer,
                 lat_weights=None, chan_mask=None, spatial_mask=None,
                 freeze_processor: bool = False,
                 extra_loss_fn: Optional[Callable] = None):
        self.model, self.spec, self.steps = model, spec, steps
        self.device, self.compute_dtype = device, compute_dtype
        self.optimizer = optimizer
        self.freeze_processor = freeze_processor
        self.extra_loss_fn = extra_loss_fn
        low = compute_dtype != torch.float32
        self.graphs = None if graphs is None else graphs.to(
            device, compute_dtype if low else None)
        self.lat_weights = _as_tensor(lat_weights, device)
        self.chan_mask = _as_tensor(chan_mask, device)
        self.spatial_mask = _as_tensor(spatial_mask, device)

    def _batch(self, x, y):
        """[B, G, obs·C] / [B, G, P·C] -> window [B, G, obs, C] and targets
        [B, G, P, C] on the device in the compute dtype."""
        spec = self.spec
        x = torch.as_tensor(x).to(self.device, self.compute_dtype)
        y = torch.as_tensor(y).to(self.device, self.compute_dtype)
        b, g = x.shape[0], x.shape[1]
        window = x.reshape(b, g, spec.obs_window, spec.num_features)
        p = y.shape[-1] // spec.num_features
        return window, y.reshape(b, g, p, spec.num_features)

    def _loss(self, window, targets, edge_mask=None, thr=0.0,
              prune: bool = False):
        """(fp32 loss of one batch, differentiable in the masters; the new
        edge mask in fp32, or None)."""
        model, graphs = self.model, self.graphs
        if self.compute_dtype == torch.float32:
            def apply(*args):
                return model(*args)
        else:
            params = {n: p.to(self.compute_dtype)
                      for n, p in model.named_parameters()}
            if edge_mask is not None:
                edge_mask = edge_mask.to(self.compute_dtype)

            def apply(*args):
                return functional_call(model, params, args)

        def model_fn(inp, mask, t, p):
            # The single-sample model over the batch; the graphs and the
            # edge mask are shared, the new mask is the first sample's.
            outs = [apply(sample, graphs, mask, t, p) for sample in inp]
            return torch.stack([o for o, _ in outs]), outs[0][1]

        loss, new_mask = rollout_loss(
            model_fn, window, targets, self.steps, self.spec, edge_mask,
            thr, prune, lat_weights=self.lat_weights,
            chan_mask=self.chan_mask, spatial_mask=self.spatial_mask,
            extra_loss_fn=self.extra_loss_fn,
        )
        if new_mask is not None:
            new_mask = new_mask.detach().float()
        return loss.float(), new_mask

    def forward_loss(self, x, y) -> torch.Tensor:
        """The step's loss without gradients or an update."""
        with torch.no_grad():
            return self._loss(*self._batch(x, y))[0]

    def __call__(self, x, y) -> torch.Tensor:
        """One step on the batch (x [B, G, obs·C], y [B, G, P·C]); returns
        the fp32 loss before the update.  The fp32 gradients stay on the
        parameters' ``.grad`` until the next step."""
        return self.run(x, y)[0]

    def run(self, x, y, edge_mask=None, attention_threshold=0.0,
            prune: bool = False):
        """``__call__`` with the SparseGAT edge mask carried in and out:
        (loss, new mask or None); ``prune`` prunes at
        ``attention_threshold``."""
        window, targets = self._batch(x, y)
        self.optimizer.zero_grad(set_to_none=True)
        loss, new_mask = self._loss(window, targets, edge_mask,
                                    attention_threshold, prune)
        loss.backward()
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.freeze_processor:
            _zero_processor_grads(self.model)
        self.optimizer.step()
        return loss.detach(), new_mask


def make_train_step(
    model: nn.Module,
    graphs: Optional[ModelGraphs],
    spec: RolloutSpec,
    cfg: ExperimentConfig,
    steps: Optional[int] = None,
    device: Union[str, torch.device, None] = None,
    lat_weights=None,
    chan_mask=None,
    spatial_mask=None,
    processor_lr_factor: float = 1.0,
    freeze_processor: bool = False,
    optimizer: Optional[torch.optim.Optimizer] = None,
    extra_loss_fn: Optional[Callable] = None,
) -> TrainStep:
    """The train step of ``model`` (fp32 master parameters, moved to
    ``device`` in place) on ``graphs``, over ``steps`` AR steps (default
    ``cfg.max_ar_steps``), in ``cfg.tpu.compute_dtype``, with Adam at
    ``cfg.learning_rate`` (``build_optimizer``).  Runs on the card (default
    ``cuda``; raises without one unless ``device='cpu'``).
    ``lat_weights`` [G], ``chan_mask`` [C] and ``spatial_mask`` [G] weight
    the loss (``training.loss``); ``freeze_processor`` zeroes the
    processor's gradients.  ``optimizer`` (default: a new one) lets steps
    of other AR levels or freeze settings share one Adam state.
    ``extra_loss_fn(out [B, G, C], target) -> scalar`` is added to each AR
    step's loss."""
    dev = resolve_device(device)
    model.to(dev)
    bad = [n for n, p in model.named_parameters() if p.dtype != torch.float32]
    if bad:
        raise TypeError(f"make_train_step: master parameters must be fp32 "
                        f"({bad[0]} is not)")
    if optimizer is None:
        optimizer = build_optimizer(model, cfg.learning_rate,
                                    processor_lr_factor)
    return TrainStep(
        model, graphs, spec,
        steps=int(cfg.max_ar_steps if steps is None else steps),
        device=dev, compute_dtype=resolve_dtype(cfg.tpu.compute_dtype),
        optimizer=optimizer, lat_weights=lat_weights, chan_mask=chan_mask,
        spatial_mask=spatial_mask, freeze_processor=freeze_processor,
        extra_loss_fn=extra_loss_fn,
    )


@dataclasses.dataclass
class TrainState:
    """What training carries from step to step: the model (fp32 master
    parameters, on the device) and its optimizer (Adam's moments and step),
    both the ``Trainer``'s own, and SparseGAT's processing-edge mask
    ([E_pad] fp32 on the device; None for the other families)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    edge_mask: Optional[torch.Tensor] = None


class Trainer:
    """The epoch loop around one optimizer and the cached train steps."""

    def __init__(
        self,
        model: nn.Module,
        graphs: Optional[ModelGraphs],
        config: ExperimentConfig,
        metadata: DatasetMetadata,
        results_dir: str,
        processor_lr_factor: float = 1.0,
        optimizer: Optional[torch.optim.Optimizer] = None,
        extra_loss_fn: Optional[Callable] = None,
        mesh=None,
        graph_set=None,
        device: Union[str, torch.device, None] = None,
    ):
        """``model`` (fp32, a ``WeatherModel`` or a ``GridImageModel``) and
        ``graphs`` (None for a model that needs none) are moved to
        ``device`` (default ``cuda``; raises without a card unless
        ``device='cpu'``).  ``optimizer`` over the model's parameters
        replaces ``build_optimizer``'s Adam (the CNN trainers pass
        ``training.optim.ClippedAdamW``); ``extra_loss_fn(out [B, G, C],
        target)`` is added to each AR step's training loss."""
        if mesh is not None or graph_set is not None:
            raise NotImplementedError(
                "sharded training (mesh= / graph_set=) is not ported yet "
                "(ROADMAP A12: multi-device)")
        self.using_sparse_gat = (
            config.pipeline is not None
            and config.pipeline.processor.gcn.layer_type
            == GraphLayerType.SparseGATConv
        )
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.graphs = None if graphs is None else graphs.to(self.device)
        self.config = config
        self.metadata = metadata
        self.results_dir = results_dir
        os.makedirs(results_dir, exist_ok=True)
        self.spec = RolloutSpec(
            obs_window=config.data.obs_window_used,
            num_features=config.data.num_features_used,
            use_residual=config.use_residual,
            remat=config.tpu.remat_rollout,
            static_channels=tuple(config.static_channels),
            forcing_channels=tuple(config.forcing_channels),
            direct_steps=config_direct_steps(config),
        )

        # ---- loss weights / masks (NumPy, as the JAX package builds them)
        lw = None
        if config.use_latitude_weighting:
            if metadata.flat_grid and metadata.coordinates is not None:
                lw = lat_weights_from_nodes(metadata.coordinates[0])
            else:
                lw = lat_weights_from_axis(metadata.num_latitudes,
                                           metadata.num_longitudes)
        self.lat_weights = lw
        self.chan_mask = channel_mask(config.data.num_features_used,
                                      config.static_channels,
                                      config.forcing_channels)
        sm = None
        if config.boundary_mask_width > 0 and not metadata.flat_grid:
            sm = boundary_mask(metadata.num_latitudes,
                               metadata.num_longitudes,
                               config.boundary_mask_width)
        roi = None
        if config.roi_only_loss and metadata.is_regional is not None:
            roi = metadata.is_regional.astype(np.float32)
        self.spatial_mask = combine_spatial_masks(sm, roi)
        self._eval_masks = tuple(_as_tensor(a, self.device) for a in (
            self.lat_weights, self.chan_mask, self.spatial_mask))
        self._exclude = tuple(sorted(set(config.static_channels)
                                     | set(config.forcing_channels)))

        self.optimizer = optimizer if optimizer is not None else \
            build_optimizer(self.model, config.learning_rate,
                            processor_lr_factor)
        self.extra_loss_fn = extra_loss_fn
        self._train_steps: Dict[Tuple[int, bool], TrainStep] = {}
        self._graphs_cast: Optional[ModelGraphs] = None

    # ------------------------------------------------------------------ core
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Fresh weights (drawn as ``build_weather_model`` draws them, or a
        ``GridImageModel``'s as ``models.unet.init_weights`` draws them,
        from a ``torch.Generator`` seeded with ``seed``, default 42) and a
        fresh optimizer state."""
        gen = torch.Generator().manual_seed(seed if seed is not None
                                            else 42)
        if isinstance(self.model, GridImageModel):
            init_weights(self.model, gen)
        else:
            fresh = WeatherModel(
                self.config.pipeline, self.config.data,
                self.model.num_grid_nodes, self.model.num_mesh_nodes,
                generator=gen,
            )
            self.model.load_state_dict(fresh.state_dict())
        self.optimizer.state.clear()
        mask = None
        if self.using_sparse_gat:
            mask = self.graphs.processing.edge_mask.detach().clone().float()
        return TrainState(model=self.model, optimizer=self.optimizer,
                          edge_mask=mask)

    @property
    def _compute_dtype(self) -> torch.dtype:
        return resolve_dtype(self.config.tpu.compute_dtype or "float32")

    def _graphs_for(self, dtype: torch.dtype) -> Optional[ModelGraphs]:
        """The graphs with float arrays in the compute dtype (cast once)."""
        if dtype == torch.float32 or self.graphs is None:
            return self.graphs
        if self._graphs_cast is None:
            self._graphs_cast = self.graphs.to(self.device, dtype)
        return self._graphs_cast

    def train_step(self, state: TrainState, x, y, steps: int, thr=0.0,
                   prune: bool = False, freeze_processor: bool = False):
        """One BPTT + Adam step over ``steps`` AR steps on the batch ->
        (state, fp32 loss tensor); with ``prune``, SparseGAT prunes the
        state's edge mask at threshold ``thr``."""
        if state.model is not self.model or state.optimizer \
                is not self.optimizer:
            raise ValueError("the state is not this Trainer's "
                             "(use Trainer.init_state)")
        key = (int(steps), bool(freeze_processor))
        step = self._train_steps.get(key)
        if step is None:
            step = self._train_steps[key] = make_train_step(
                self.model, self._graphs_for(self._compute_dtype),
                self.spec, self.config, steps=steps, device=self.device,
                lat_weights=self.lat_weights, chan_mask=self.chan_mask,
                spatial_mask=self.spatial_mask,
                freeze_processor=freeze_processor, optimizer=self.optimizer,
                extra_loss_fn=self.extra_loss_fn,
            )
        loss, mask = step.run(x, y, state.edge_mask, thr, prune)
        return dataclasses.replace(state, edge_mask=mask), loss

    def _eval_batch(self, state: TrainState, x, y):
        """(loss, ACC, raw RMSE) of the one-step rollout of a batch, in fp32
        on the uncast graphs (as the JAX package evaluates)."""
        spec, model, graphs = self.spec, state.model, self.graphs
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
        b, g = x.shape[0], x.shape[1]
        window = x.reshape(b, g, spec.obs_window, spec.num_features)
        targets = y.reshape(b, g, -1, spec.num_features)

        def model_fn(inp, mask, thr, prune):
            # The single-sample model over the batch; the graphs are shared.
            return torch.stack([model(s, graphs, mask)[0] for s in inp]), None

        preds = rollout_predict(model_fn, window, 1, spec, state.edge_mask,
                                0.0, forcing=targets)
        out, tgt = preds[..., 0, :], targets[..., 0, :]
        loss = weighted_mse(out, tgt, *self._eval_masks)
        acc = anomaly_correlation(out, tgt, self._exclude)
        raw_rmse = torch.sqrt(torch.mean(torch.square(out - tgt)))
        return float(loss), float(acc), float(raw_rmse)

    def evaluate(self, state: TrainState, loader: BatchIterator):
        """(mean loss, mean ACC, RMS of the batches' raw RMSE)."""
        losses, accs, rmses = [], [], []
        with torch.no_grad():
            for x, y in loader:
                l, a, r = self._eval_batch(state, x, y)
                losses.append(l)
                accs.append(a)
                rmses.append(r ** 2)
        n = max(len(losses), 1)
        return sum(losses) / n, sum(accs) / n, (sum(rmses) / n) ** 0.5

    def load_checkpoint(self, state: TrainState) -> Dict[str, Any]:
        """Restore ``<results_dir>/checkpoint`` into the state's model,
        optimizer and edge mask (in place): this package's ``state.pt``
        or, failing that, the JAX package's ``state.msgpack``.  Returns the
        meta."""
        ckpt_dir = os.path.join(self.results_dir, "checkpoint")
        if os.path.exists(os.path.join(ckpt_dir, ckpt_lib.STATE_FILE)):
            load = ckpt_lib.load_checkpoint
        else:
            load = ckpt_lib.load_flax_checkpoint
        return load(ckpt_dir, state.model, state.optimizer, state.edge_mask)

    # ------------------------------------------------------------------ loop
    def fit(
        self,
        state: TrainState,
        train_ds: ChunkedTimeseriesDataset,
        val_ds: ChunkedTimeseriesDataset,
        resume: bool = False,
        print_losses: bool = True,
        max_steps_per_epoch: Optional[int] = None,
    ) -> Dict[str, Any]:
        cfg = self.config
        num_epochs = cfg.num_epochs
        max_ar = max(cfg.max_ar_steps, 1)
        epochs_per_stage = max(num_epochs // max_ar, 1)

        train_losses: List[float] = []
        val_losses: List[float] = []
        best_val = float("inf")
        patience = 0
        start_epoch = 0
        ar_steps = 1

        ckpt_dir = os.path.join(self.results_dir, "checkpoint")
        if resume and os.path.exists(os.path.join(ckpt_dir,
                                                  ckpt_lib.META_FILE)):
            meta = self.load_checkpoint(state)
            start_epoch = meta["epoch"] + 1
            ar_steps = meta["ar_steps"]
            best_val = meta["best_val_loss"]
            patience = meta["patience_counter"]
            train_losses = meta["train_losses"]
            val_losses = meta["val_losses"]
            print(f">>> Resumed from epoch {start_epoch}, AR={ar_steps}, "
                  f"best_val={best_val:.5f}")

        log_path = os.path.join(self.results_dir, "training_log.txt")

        def log(msg: str):
            with open(log_path, "a") as f:
                f.write(msg + "\n")

        from ..utils.logs import MetricsLogger

        metrics = MetricsLogger(self.results_dir)
        profile_dir = os.environ.get("GCLT_PROFILE_DIR")

        log(f"=== Training started: {datetime.now().isoformat()} ===")
        log(f"epochs={num_epochs}  max_ar={max_ar}  "
            f"epochs_per_stage={epochs_per_stage}")
        log(f"{'epoch':>5}  {'ar':>2}  {'train_loss':>10}  {'val_loss':>10}  "
            f"{'val_ACC':>8}  {'best_vl':>10}  {'patience':>8}  time")

        val_loader = BatchIterator(val_ds, cfg.batch_size, shuffle=False,
                                   drop_remainder=False)
        if start_epoch == 0 and len(val_ds):
            v_loss, v_acc, v_rmse = self.evaluate(state, val_loader)
            if print_losses:
                print(f"[Init] val_loss={v_loss:.5f} val_acc={v_acc:.4f} "
                      f"raw_RMSE={v_rmse:.4f}")
            log(f"{'init':>5}  {'--':>2}  {'--':>10}  {v_loss:10.5f}  "
                f"{v_acc:8.4f}  {'--':>10}  {'--':>8}  "
                f"{datetime.now().strftime('%H:%M:%S')}")

        for epoch in range(start_epoch, num_epochs):
            t_epoch = time.time()
            correct_ar = min(1 + epoch // epochs_per_stage, max_ar)
            if correct_ar > ar_steps:
                ar_steps = correct_ar
                patience = 0
                if print_losses:
                    print(f">>> Curriculum: AR level raised to {ar_steps}")

            thr = attention_threshold_schedule(epoch)
            freeze = (
                cfg.freeze_processor_epochs > 0
                and epoch < cfg.freeze_processor_epochs
            )

            # ---- train epoch: the same batch order every epoch (a new
            # iterator with the same seed), as in the JAX package.  The
            # batches past ``max_steps_per_epoch`` are never loaded.
            loader = BatchIterator(
                train_ds, cfg.batch_size, shuffle=True,
                seed=cfg.random_seed or 42,
            )
            total, n_batches = 0.0, 0
            for i, (x, y) in enumerate(
                    itertools.islice(loader, max_steps_per_epoch or None)):
                prune = self.using_sparse_gat and i == 0 and thr > 0
                p_avail = y.shape[-1] // self.spec.num_features
                steps = min(ar_steps, p_avail)
                args = (state, x, y, steps, thr, prune, freeze)
                if profile_dir and epoch == start_epoch and i == 1:
                    state, loss = self._profiled_step(profile_dir, *args)
                else:
                    state, loss = self.train_step(*args)
                total += float(loss)
                n_batches += 1
            train_loss = total / max(n_batches, 1)

            v_loss, v_acc, v_rmse = self.evaluate(state, val_loader)
            train_losses.append(train_loss)
            val_losses.append(v_loss)

            if print_losses:
                print(
                    f"[Epoch {epoch + 1}] train={train_loss:.5f} "
                    f"val={v_loss:.5f} ACC={v_acc:.4f} rawRMSE={v_rmse:.4f} "
                    f"AR={ar_steps} ({time.time() - t_epoch:.1f}s)"
                )

            metrics.log({
                "epoch": epoch + 1, "ar_steps": ar_steps,
                "train_loss": train_loss, "val_loss": v_loss,
                "val_acc": v_acc, "raw_rmse": v_rmse,
                "attention_threshold": thr,
                "epoch_seconds": time.time() - t_epoch,
            })

            if best_val - v_loss > cfg.early_stopping_delta:
                best_val = v_loss
                patience = 0
                ckpt_lib.save_params(
                    os.path.join(self.results_dir, "best_model.pt"),
                    state.model,
                )
            else:
                patience += 1

            log(f"{epoch + 1:5d}  {ar_steps:2d}  {train_loss:10.5f}  "
                f"{v_loss:10.5f}  {v_acc:8.4f}  {best_val:10.5f}  "
                f"{patience:8d}  {datetime.now().strftime('%H:%M:%S')}")

            ckpt_lib.save_checkpoint(
                ckpt_dir, state.model, state.optimizer,
                {
                    "epoch": epoch,
                    "ar_steps": ar_steps,
                    "best_val_loss": best_val,
                    "patience_counter": patience,
                    "train_losses": train_losses,
                    "val_losses": val_losses,
                },
                edge_mask=state.edge_mask,
            )

            if patience >= cfg.early_stopping_patience:
                if print_losses:
                    print("Early stopping.")
                log(f">>> Early stopping at epoch {epoch + 1}")
                break

        log(f"=== Training finished: {datetime.now().isoformat()} ===")
        results = {"train_losses": train_losses, "val_losses": val_losses}
        with open(os.path.join(self.results_dir, "results.json"), "w") as f:
            json.dump(results, f)
        self.final_state = state
        return results

    def _profiled_step(self, profile_dir, *args):
        """``train_step(*args)`` under ``torch.profiler``; the trace goes to
        ``<profile_dir>/train_step_trace.json`` (``GCLT_PROFILE_DIR``)."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            state, loss = self.train_step(*args)
            float(loss)
        path = os.path.join(profile_dir, "train_step_trace.json")
        prof.export_chrome_trace(path)
        print(f"[profiler] step trace -> {path}")
        return state, loss
