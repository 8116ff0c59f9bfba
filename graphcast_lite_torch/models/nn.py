"""Basic neural building blocks with torch/PyG-parity semantics (torch
counterpart of ``graphcast_lite_tpu.models.nn``).

Parameter names and layouts follow the JAX package's flax modules, so that
its parameter tree maps onto these modules one to one
(``utils.params.from_flax_params``):

* ``TorchLinear`` — ``kernel`` [in, out] and ``bias`` [out], with
  torch.nn.Linear's init bounds U(±1/sqrt(fan_in));
* ``PReLU`` — ONE shared slope ``alpha`` [1], initialized to 0.25;
* ``PyGLayerNorm`` — torch_geometric.nn.LayerNorm, modes ``node`` (per-row
  over channels) and ``graph`` (one mean/var over every element of a
  sample, with an optional row mask; a leading batch axis keeps one pair
  per sample);
* ``MLPTower`` — Linear→PReLU per hidden layer (each with its own slope),
  final Linear, optional trailing PyGLayerNorm.

Initial values are drawn from an explicit ``torch.Generator`` (CPU).  They
are not the JAX package's numbers; parity tests load bridged weights.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "torch_linear_init",
    "glorot_uniform_pyg",
    "TorchLinear",
    "PReLU",
    "PyGLayerNorm",
    "MLPTower",
    "resolve_activation",
]


def _uniform(shape, bound: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return u * (2 * bound) - bound


def torch_linear_init(shape, generator: Optional[torch.Generator] = None):
    """torch.nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    fan_in = shape[0] for a [in, out] kernel (shape[-1] for a vector)."""
    fan_in = shape[0] if len(shape) == 2 else shape[-1]
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return _uniform(shape, bound, generator)


def glorot_uniform_pyg(shape, generator: Optional[torch.Generator] = None):
    """PyG `glorot`: U(±sqrt(6/(size(-2)+size(-1))))."""
    bound = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    return _uniform(shape, bound, generator)


class TorchLinear(nn.Module):
    """Linear layer with torch's default initialization. kernel: [in, out]."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(
            torch_linear_init((in_features, out_features), generator)
        )
        self.bias = None
        if use_bias:
            bound = 1.0 / math.sqrt(in_features) if in_features > 0 else 0.0
            self.bias = nn.Parameter(
                _uniform((out_features,), bound, generator)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y + self.bias if self.bias is not None else y


class PReLU(nn.Module):
    """torch.nn.PReLU(num_parameters=1, init=0.25)."""

    def __init__(self, init_value: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


class PyGLayerNorm(nn.Module):
    """torch_geometric.nn.LayerNorm (affine), modes 'node' | 'graph'.

    The statistics are taken in fp32 and cast back to the input's dtype
    before they are applied, as the JAX package's reductions do in bf16.
    """

    def __init__(self, channels: int, mode: str = "node", eps: float = 1e-5):
        super().__init__()
        if mode not in ("node", "graph"):
            raise ValueError(f"Unknown LayerNorm mode: {mode}")
        self.mode = mode
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = x.float()
        if self.mode == "node":
            mean = xf.mean(dim=-1, keepdim=True)
            var = xf.var(dim=-1, unbiased=False, keepdim=True)
        elif mask is None:
            # One sample's rows: the last two axes ([B, N, C] is B samples).
            mean = xf.mean(dim=(-2, -1), keepdim=True)
            var = xf.var(dim=(-2, -1), unbiased=False, keepdim=True)
        else:
            w = mask.float()[:, None]
            denom = torch.clamp(w.sum() * x.shape[-1], min=1.0)
            mean = (xf * w).sum(dim=(-2, -1), keepdim=True) / denom
            var = (torch.square(xf - mean) * w).sum(dim=(-2, -1),
                                                    keepdim=True) / denom
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        out = (x - mean) / torch.sqrt(var + self.eps)
        return out * self.weight + self.bias


def resolve_activation(name: Optional[str]) -> Callable | None:
    """Map an activation name to a stateless callable, or None for PReLU
    (which is a parameterized module and must be instantiated by the
    caller)."""
    name = (name or "prelu").lower()
    if name in ("swish", "silu"):
        return F.silu
    if name == "relu":
        return F.relu
    if name == "prelu":
        return None
    raise ValueError(f"Unknown activation: {name}")


class MLPTower(nn.Module):
    """Linear stack with PReLU after each hidden layer + optional PyG LN.

    Children are named as in the JAX package: ``lin_i``, ``prelu_i``,
    ``norm``.
    """

    def __init__(self, in_features: int, hidden_dims: Optional[Sequence[int]],
                 output_dim: int, use_layer_norm: bool = False,
                 layer_norm_mode: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = list(hidden_dims or [])
        self.num_hidden = len(hidden)
        dims = [in_features] + hidden + [output_dim]
        for i in range(len(hidden) + 1):
            setattr(self, f"lin_{i}",
                    TorchLinear(dims[i], dims[i + 1], generator=generator))
            if i < len(hidden):
                setattr(self, f"prelu_{i}", PReLU())
        self.norm = (PyGLayerNorm(output_dim, layer_norm_mode or "node")
                     if use_layer_norm else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_hidden):
            x = getattr(self, f"prelu_{i}")(getattr(self, f"lin_{i}")(x))
        x = getattr(self, f"lin_{self.num_hidden}")(x)
        if self.norm is not None:
            x = self.norm(x)
        return x
