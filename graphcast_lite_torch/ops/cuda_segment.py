"""Sorted segment sum: the hand-written CUDA kernel and its plain version.

The counterpart of ``graphcast_lite_tpu/ops/pallas_segment.py:
segment_sum_sorted`` (forward).  ``segment_sum(msgs, indptr, R)`` returns
``out[..., r, :] = Σ_{e ∈ [indptr[r], indptr[r+1])} msgs[..., e, :]`` with
fp32 accumulation, in the messages' dtype.  Messages are receiver-sorted
and pre-masked (padding rows are zero); ``indptr`` is the graph's receiver
CSR offsets (``graphs.structure.Graph.indptr``).

* On a CPU tensor the wrapper runs ``segment_sum_reference``, the plain
  torch version (fp32 ``index_add_``, then a cast).
* On a CUDA tensor it launches ``csrc/segment_sum.cu`` or raises; it never
  falls back.  The kernel is built by ``ops.nvcc_build`` at first use.

``launches`` counts kernel launches (never plain-version calls).
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import nvcc_build

__all__ = [
    "SOURCE",
    "launches",
    "segment_sum",
    "segment_sum_reference",
]

SOURCE = os.path.join(nvcc_build.CSRC, "segment_sum.cu")
launches = 0

_SIGNATURES = {
    "gclt_segment_sum": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # msgs, indptr, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dtype, R, F, B
        ctypes.c_longlong, ctypes.c_longlong,                # batch strides
        ctypes.c_void_p,                                     # stream
    ]),
}


def segment_sum_reference(msgs: torch.Tensor, indptr: torch.Tensor,
                          num_receivers: int) -> torch.Tensor:
    """Plain torch version: fp32 ``index_add_`` over the rows
    ``[0, indptr[-1])``, then one cast to the messages' dtype."""
    counts = (indptr[1:] - indptr[:-1]).long()
    recv = torch.repeat_interleave(
        torch.arange(num_receivers, device=msgs.device), counts
    )
    n = recv.numel()
    out = torch.zeros(msgs.shape[:-2] + (num_receivers, msgs.shape[-1]),
                      dtype=torch.float32, device=msgs.device)
    out.index_add_(-2, recv, msgs[..., :n, :].float())
    return out.to(msgs.dtype)


def segment_sum(msgs: torch.Tensor, indptr: torch.Tensor,
                num_receivers: int) -> torch.Tensor:
    """Sum receiver-sorted messages [E, F] or [B, E, F] into [..., R, F]."""
    if msgs.device.type == "cpu":
        return segment_sum_reference(msgs, indptr, num_receivers)
    if msgs.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {msgs.device}")
    if indptr.device != msgs.device:
        raise ValueError("segment_sum: msgs and indptr on different devices")
    if msgs.dtype not in nvcc_build.DTYPE_CODES:
        raise TypeError(f"segment_sum: dtype {msgs.dtype} (fp32/bf16 only)")
    if indptr.dtype != torch.int32:
        raise TypeError("segment_sum: indptr must be int32")
    if msgs.dim() not in (2, 3) or indptr.dim() != 1 \
            or indptr.shape[0] != num_receivers + 1:
        raise ValueError(
            f"segment_sum: msgs {tuple(msgs.shape)} / indptr "
            f"{tuple(indptr.shape)} / R {num_receivers}"
        )
    if not (msgs.is_contiguous() and indptr.is_contiguous()):
        raise ValueError("segment_sum: msgs and indptr must be contiguous")
    batch = msgs.shape[0] if msgs.dim() == 3 else 1
    e, f = msgs.shape[-2], msgs.shape[-1]
    out = torch.empty(msgs.shape[:-2] + (num_receivers, f),
                      dtype=msgs.dtype, device=msgs.device)
    if out.numel() == 0:
        return out
    if batch > 65535:
        raise ValueError(f"segment_sum: batch {batch} > 65535")
    lib = nvcc_build.load(SOURCE, _SIGNATURES)
    with torch.cuda.device(msgs.device):
        stream = torch.cuda.current_stream(msgs.device).cuda_stream
        err = lib.gclt_segment_sum(
            msgs.data_ptr(), indptr.data_ptr(), out.data_ptr(),
            nvcc_build.DTYPE_CODES[msgs.dtype], num_receivers, f, batch,
            e * f, num_receivers * f, stream,
        )
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out
