"""The training step: AR-P BPTT + Adam in mixed precision (torch
counterpart of ``graphcast_lite_tpu.training.trainer``: ``build_optimizer``,
``_zero_processor_grads`` and ``Trainer._make_train_step``).

``make_train_step(model, graphs, spec, cfg)`` returns a ``TrainStep``;
``step(x, y)`` runs one step on a batch and returns the loss:

* the fp32 master parameters are cast to ``cfg.tpu.compute_dtype`` for the
  forward (a differentiable cast, so the gradients land on the masters),
  and so are the graphs' float arrays (fp32 arrays would promote the
  whole forward back to fp32);
* the loss is ``training.rollout.rollout_loss`` over ``steps`` AR steps,
  taken in fp32 at the end;
* the gradients arrive in fp32 on the masters (the cast's adjoint), the
  processor's are zeroed when it is frozen, and Adam updates the masters.

The epoch loop, the AR curriculum, checkpoints and the CLI (the rest of
the JAX package's ``Trainer``) are not ported yet (ROADMAP A7).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..build import resolve_device, resolve_dtype
from ..config import ExperimentConfig
from ..models.weather import ModelGraphs, WeatherModel
from .rollout import RolloutSpec, rollout_loss

__all__ = ["TrainStep", "build_optimizer", "make_train_step"]


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
    """One BPTT + Adam step of ``model`` (built by ``make_train_step``)."""

    def __init__(self, model: WeatherModel, graphs: ModelGraphs,
                 spec: RolloutSpec, steps: int, device: torch.device,
                 compute_dtype: torch.dtype, optimizer: torch.optim.Optimizer,
                 lat_weights=None, chan_mask=None, spatial_mask=None,
                 freeze_processor: bool = False):
        self.model, self.spec, self.steps = model, spec, steps
        self.device, self.compute_dtype = device, compute_dtype
        self.optimizer = optimizer
        self.freeze_processor = freeze_processor
        low = compute_dtype != torch.float32
        self.graphs = graphs.to(device, compute_dtype if low else None)
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

    def _loss(self, window, targets) -> torch.Tensor:
        """The fp32 loss of one batch, differentiable in the masters."""
        model, graphs = self.model, self.graphs
        if self.compute_dtype == torch.float32:
            def apply(inp):
                return model(inp, graphs)[0]
        else:
            params = {n: p.to(self.compute_dtype)
                      for n, p in model.named_parameters()}

            def apply(inp):
                return functional_call(model, params, (inp, graphs))[0]

        def model_fn(inp, mask, thr, prune):
            # The single-sample model over the batch; the graphs are shared.
            return torch.stack([apply(sample) for sample in inp]), None

        loss, _ = rollout_loss(
            model_fn, window, targets, self.steps, self.spec,
            lat_weights=self.lat_weights, chan_mask=self.chan_mask,
            spatial_mask=self.spatial_mask,
        )
        return loss.float()

    def forward_loss(self, x, y) -> torch.Tensor:
        """The step's loss without gradients or an update."""
        with torch.no_grad():
            return self._loss(*self._batch(x, y))

    def __call__(self, x, y) -> torch.Tensor:
        """One step on the batch (x [B, G, obs·C], y [B, G, P·C]); returns
        the fp32 loss before the update.  The fp32 gradients stay on the
        parameters' ``.grad`` until the next step."""
        window, targets = self._batch(x, y)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(window, targets)
        loss.backward()
        if self.freeze_processor:
            _zero_processor_grads(self.model)
        self.optimizer.step()
        return loss.detach()


def make_train_step(
    model: WeatherModel,
    graphs: ModelGraphs,
    spec: RolloutSpec,
    cfg: ExperimentConfig,
    steps: Optional[int] = None,
    device: Union[str, torch.device, None] = None,
    lat_weights=None,
    chan_mask=None,
    spatial_mask=None,
    processor_lr_factor: float = 1.0,
    freeze_processor: bool = False,
) -> TrainStep:
    """The train step of ``model`` (fp32 master parameters, moved to
    ``device`` in place) on ``graphs``, over ``steps`` AR steps (default
    ``cfg.max_ar_steps``), in ``cfg.tpu.compute_dtype``, with Adam at
    ``cfg.learning_rate`` (``build_optimizer``).  Runs on the card (default
    ``cuda``; raises without one unless ``device='cpu'``).
    ``lat_weights`` [G], ``chan_mask`` [C] and ``spatial_mask`` [G] weight
    the loss (``training.loss``); ``freeze_processor`` zeroes the
    processor's gradients."""
    dev = resolve_device(device)
    model.to(dev)
    bad = [n for n, p in model.named_parameters() if p.dtype != torch.float32]
    if bad:
        raise TypeError(f"make_train_step: master parameters must be fp32 "
                        f"({bad[0]} is not)")
    optimizer = build_optimizer(model, cfg.learning_rate, processor_lr_factor)
    return TrainStep(
        model, graphs, spec,
        steps=int(cfg.max_ar_steps if steps is None else steps),
        device=dev, compute_dtype=resolve_dtype(cfg.tpu.compute_dtype),
        optimizer=optimizer, lat_weights=lat_weights, chan_mask=chan_mask,
        spatial_mask=spatial_mask, freeze_processor=freeze_processor,
    )
