"""Faults planted in the timed path, each a context manager that breaks
the program underneath the harness, to show that the comparison reads
them as not correct: at a small size in the tests, at a cell's own size on
the card by ``calibrate.py``."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["FAULTS"]


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def state_unchanged_serve():
    """Each forecast step returns its input state: the model's increment
    is zero."""
    from graphcast_lite_torch.models.weather import WeatherModel

    def make(orig):
        def forward(self, x, graphs, *args, **kw):
            out, mask = orig(self, x, graphs, *args, **kw)
            return torch.zeros_like(out), mask
        return forward
    return _patched(WeatherModel, "forward", make)


def answer_altered():
    """A forecast's AR steps 2 and 3 come back swapped."""
    from graphcast_lite_torch.training import rollout

    def make(orig):
        def rollout_predict(*args, **kw):
            out = orig(*args, **kw)
            return out[..., [0, 2, 1, 3], :] if out.shape[-2] == 4 else out
        return rollout_predict
    return _patched(rollout, "rollout_predict", make)


def half_batch_serve():
    """Half of a dispatch's members left out, the mean of the rest's
    forecasts returned for them."""
    from graphcast_lite_torch.training import rollout

    def make(orig):
        def rollout_predict(model_fn, window, *args, **kw):
            if window.dim() < 4 or window.shape[0] < 2:
                return orig(model_fn, window, *args, **kw)
            half = window.shape[0] // 2
            out = orig(model_fn, window[:half], *args, **kw)
            rest = out.mean(dim=0, keepdim=True).expand(
                (window.shape[0] - half,) + out.shape[1:])
            return torch.cat([out, rest])
        return rollout_predict
    return _patched(rollout, "rollout_predict", make)


def state_unchanged_train():
    """The optimizer's step leaves the weights and its state as they
    were."""
    return _patched(torch.optim.Adam, "step",
                    lambda orig: (lambda self, closure=None: None))


def half_batch_train():
    """Half of each batch left out, the loss the mean over the rest."""
    from graphcast_lite_torch.training.trainer import TrainStep

    def make(orig):
        def _batch(self, x, y):
            window, targets = orig(self, x, y)
            half = max(1, window.shape[0] // 2)
            return window[:half], targets[:half]
        return _batch
    return _patched(TrainStep, "_batch", make)


FAULTS = {
    "serve": {"state_unchanged": state_unchanged_serve,
              "answer_altered": answer_altered,
              "half_batch": half_batch_serve},
    "train": {"state_unchanged": state_unchanged_train,
              "half_batch": half_batch_train},
}
