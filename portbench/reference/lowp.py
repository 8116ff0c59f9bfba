"""The control's precision: the reference computed in fp8 (e4m3), as the
program computes in bf16.  Every value the reference stores is rounded
to fp8, each tensor scaled so that its largest magnitude is fp8's largest
finite value; matrix products take fp8 operands and accumulate in
float32, as the program's bf16 products do.  The rounding is a
straight-through estimator, so the backward pass differentiates the
rounded forward."""

from __future__ import annotations

import torch

from .interaction_net import Precision

__all__ = ["FP8"]

_FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = _FP8_MAX / x.detach().abs().amax().clamp(min=1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x).detach()


FP8 = Precision(mm=lambda a, b: _fp8(a) @ _fp8(b), q=_fp8)
