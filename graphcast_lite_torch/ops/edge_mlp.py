"""The edge-MLP tail fused with its segment sum: the hand-written CUDA kernel
and its plain version.

The counterpart of ``graphcast_lite_tpu/ops/pallas_edge_mlp.py:
edge_mlp_segment``.  ``edge_mlp(h_pre, w2, b2, mask, indptr, R, act)``
returns

* ``u = act(h_pre) @ w2 + b2`` [E_pad, De] in ``h_pre``'s dtype (the
  activation in fp32 and rounded, the product accumulated in fp32, ``b2``
  added in fp32, one cast), and
* ``agg_sum[r] = Σ_{e ∈ [indptr[r], indptr[r+1])} u[e] · mask[e]`` [R, De],
  summed in fp32 and cast once.

Rows are receiver-sorted; ``indptr`` is the graph's receiver CSR offsets,
which take the place of the reference's chunk schedule.

* On a CPU tensor the wrapper runs ``edge_mlp_reference``.
* On a CUDA tensor it launches ``csrc/edge_mlp.cu`` (built by
  ``ops.nvcc_build`` at first use) or raises; it never falls back.

``launches`` counts kernel launches (never plain-version calls).  There is
no backward: the reference kernel has none either.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch
import torch.nn.functional as F

from . import cuda_segment, nvcc_build

__all__ = ["SOURCE", "ACTIVATIONS", "MAX_SMEM", "launches", "act_fn",
           "supports", "check_inputs", "edge_mlp", "edge_mlp_reference"]

SOURCE = os.path.join(nvcc_build.CSRC, "edge_mlp.cu")
launches = 0

# The activations the kernels take, with their codes.
ACTIVATIONS = {"swish": 0, "silu": 0, "relu": 1}
MAX_SMEM = 232448  # dynamic shared memory one H100 block may use
_SIGNATURES = {
    "gclt_edge_mlp_smem": (ctypes.c_int, [ctypes.c_int] * 3),
    "gclt_edge_mlp": (ctypes.c_int, [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p]),
}


def act_fn(name: str):
    if name not in ACTIVATIONS:
        raise ValueError(f"unsupported fused activation: {name}")
    return F.relu if name == "relu" else F.silu


def supports(hidden_dim: int, out_dim: int, activation: str) -> bool:
    """The widths and activations the fused kernels take."""
    return (activation in ACTIVATIONS and hidden_dim % 128 == 0
            and out_dim % 128 == 0)


def edge_mlp_reference(h_pre: torch.Tensor, w2: torch.Tensor,
                       b2: torch.Tensor, mask: torch.Tensor,
                       indptr: torch.Tensor, num_receivers: int,
                       activation: str = "swish"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version, with the kernel's rounding points."""
    dt = h_pre.dtype
    a = act_fn(activation)(h_pre.float()).to(dt)
    u = (a.float() @ w2.float() + b2.float()).to(dt)
    msgs = u.float() * mask.float()[:, None]
    agg = cuda_segment.segment_sum_reference(msgs, indptr, num_receivers)
    return u, agg.to(dt)


def check_inputs(name: str, tensors, dtype, device) -> None:
    """Raise unless every tensor is on ``device``, of ``dtype``,
    contiguous and 32-byte aligned, and none needs a gradient while
    autograd records (the kernels have no backward)."""
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: inputs on {t.device} and {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{name}: inputs must be contiguous and "
                             "32-byte aligned")
        if torch.is_grad_enabled() and t.requires_grad:
            raise RuntimeError(f"{name}: the kernel has no backward; call "
                               "it under torch.no_grad()")


def edge_mlp(h_pre: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
             mask: torch.Tensor, indptr: torch.Tensor, num_receivers: int,
             activation: str = "swish"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u [E_pad, De], agg_sum [R, De]) of receiver-sorted rows h_pre
    [E_pad, H]."""
    if h_pre.device.type == "cpu":
        return edge_mlp_reference(h_pre, w2, b2, mask, indptr,
                                  num_receivers, activation)
    if h_pre.device.type != "cuda":
        raise ValueError(f"edge_mlp: unsupported device {h_pre.device}")
    if h_pre.dtype not in nvcc_build.DTYPE_CODES:
        raise TypeError(f"edge_mlp: dtype {h_pre.dtype} (fp32/bf16 only)")
    e_pad, hid = h_pre.shape
    de = w2.shape[-1]
    if not supports(hid, de, activation):
        raise ValueError(f"edge_mlp: H {hid} / De {de} not multiples of 128 "
                         f"or activation {activation!r} not taken")
    if (w2.shape != (hid, de) or b2.shape != (de,) or mask.shape != (e_pad,)
            or indptr.shape != (num_receivers + 1,) or num_receivers < 1):
        raise ValueError("edge_mlp: shapes h_pre {} w2 {} b2 {} mask {} "
                         "indptr {} R {}".format(
                             tuple(h_pre.shape), tuple(w2.shape),
                             tuple(b2.shape), tuple(mask.shape),
                             tuple(indptr.shape), num_receivers))
    check_inputs("edge_mlp", (h_pre, w2, b2, mask), h_pre.dtype,
                 h_pre.device)
    check_inputs("edge_mlp", (indptr,), torch.int32, h_pre.device)
    lib = nvcc_build.load(SOURCE, _SIGNATURES)
    code = nvcc_build.DTYPE_CODES[h_pre.dtype]
    smem = lib.gclt_edge_mlp_smem(code, hid, de)
    if smem > MAX_SMEM:
        raise ValueError(f"edge_mlp: H {hid} / De {de} need {smem} bytes of "
                         "shared memory per block")
    u = torch.empty((e_pad, de), dtype=h_pre.dtype, device=h_pre.device)
    agg = torch.empty((num_receivers, de), dtype=h_pre.dtype,
                      device=h_pre.device)
    with torch.cuda.device(h_pre.device):
        stream = torch.cuda.current_stream(h_pre.device).cuda_stream
        err = lib.gclt_edge_mlp(
            h_pre.data_ptr(), w2.data_ptr(), b2.data_ptr(), mask.data_ptr(),
            indptr.data_ptr(), u.data_ptr(), agg.data_ptr(), code,
            num_receivers, hid, de, ACTIVATIONS[activation], stream,
        )
    if err != 0:
        raise RuntimeError(f"edge_mlp kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return u, agg
