"""One whole lazy-LN InteractionNet edge step: the hand-written CUDA kernel
and its plain version.

The counterpart of ``graphcast_lite_tpu/ops/pallas_edge_step.py:
edge_step_fused``.  Over receiver-sorted edge rows, in the working dtype T
of ``v``:

    h     = xsg + xr[recv] + T(v @ w1e) + b_eff
    u     = T(T(act(h)) @ w2) + b2
    v_new = T(a) ∘ v + T(c) + u
    agg   = segment_sum(u · mask)                  (fp32, cast once)
    stats = (Σ v_new·w, Σ v_new²·w, Σ w)  fp32,    w = mask per row

A batch of B samples on the graph is a leading axis of every input and
output but ``w2``, ``b2``, the mask and ``indptr``, which the samples
share: each sample folds its own LayerNorm statistics into ``w1e`` /
``b_eff``, so those are per sample ([B, De, H], [B, H]), and the stats are
[B, 3].  One launch takes the batch, its samples on a second grid axis
(the reference's ``pallas_call`` batches the kernel by a grid axis under
``vmap``).

``xsg = (x @ W1s)[senders]`` and ``xr = x @ W1r`` are computed outside, as
the reference leaves them to XLA.  ``indptr`` (the graph's receiver CSR
offsets) takes the place of the reference's step schedule
(``build_step_schedule``), whose overlapping windows and one-hot receiver
expand are TPU workarounds; the receiver of a row is read from the CSR
ranges.

* On a CPU tensor the wrapper runs ``edge_step_reference``.
* On a CUDA tensor it launches ``csrc/edge_step.cu`` (the step, then a
  fixed-order reduction of its per-block statistics) or raises; it never
  falls back.  Three designs (``design``, as ``edge_mlp.design``):

  - ``hopper_bf16``, bf16 at H and De in {128, 256} (the flagship's
    widths): ``wgmma`` products, W1e and W2 handed over as
    ``wgmma_b_image``s; persistent blocks walk groups of
    ``HOPPER_RECEIVERS`` receivers.
  - ``hopper_fp32``, fp32 at the same widths: 3xTF32 ``wgmma`` products,
    W1e and W2 streamed through shared memory in K-slabs of their
    ``tf32x3_b_image``s; persistent blocks take the receivers of equal
    shares of the rows (``edge_mlp.fp32_bounds``) in steps of
    ``F32_STEP_ROWS`` rows, with ``F32_STEP_ROWS`` rows of h a block in a
    workspace the wrapper allocates (``workspace_shape``).
  - ``tile16``, wider rows in either dtype: the 16-receiver design of
    ``edge_tile.cuh`` on row-major weights.

``launches`` counts wrapper calls that launched the kernel (never
plain-version calls).  There is no backward, as in the reference.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch

from . import cuda_segment, edge_mlp, nvcc_build
from .edge_mlp import ACTIVATIONS, DESIGNS, F32_STEP_ROWS, MAX_SMEM, \
    act_fn, check_inputs, supports, tf32x3_b_image, wgmma_b_image

__all__ = ["SOURCE", "SIGNATURES", "MIN_PADDED_EDGES", "DESIGNS",
           "TILE_RECEIVERS", "HOPPER_RECEIVERS", "F32_STEP_ROWS", "launches",
           "eligible", "design", "tile_receivers", "wgmma_b_image",
           "tf32x3_b_image", "launch_geometry", "workspace_shape",
           "edge_step", "edge_step_reference"]

SOURCE = os.path.join(nvcc_build.CSRC, "edge_step.cu")
launches = 0

# The reference builds its step schedule only for E_pad >= 1024 (one
# 1024-edge chunk) and takes the composed route below that; the port keeps
# the same condition so that both packages take the same route.
MIN_PADDED_EDGES = 1024

# Receivers per block of the 16-receiver design and per group of the
# Hopper bf16 design (csrc/edge_step.cu: kTileReceivers, kStepReceivers).
TILE_RECEIVERS = 16
HOPPER_RECEIVERS = 20
# The C interface of csrc/edge_step.cu.
SIGNATURES = {
    "gclt_edge_step_smem": (ctypes.c_int, [ctypes.c_int] * 3),
    "gclt_edge_step_design": (ctypes.c_int, [ctypes.c_int] * 3),
    "gclt_edge_step_tile_receivers": (ctypes.c_int, [ctypes.c_int] * 3),
    "gclt_edge_step_max_batch": (ctypes.c_int, []),
    "gclt_edge_step": (ctypes.c_int, [ctypes.c_void_p] * 16
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p]),
}


def eligible(padded_num_edges: int, hidden_dim: int, edge_dim: int,
             activation: str) -> bool:
    """The shape conditions of the reference's ``supports_edge_step`` and
    of its schedule (the span limit cannot arise: see the kernel source)."""
    return (supports(hidden_dim, edge_dim, activation)
            and padded_num_edges >= MIN_PADDED_EDGES)


def design(dtype: torch.dtype, hidden_dim: int, edge_dim: int) -> str:
    """The design a launch takes (csrc/edge_step.cu: ``design()``;
    ``gclt_edge_step_design`` answers for the built library): the edge
    MLP's selection, ``hopper_bf16`` or ``hopper_fp32`` by dtype at H and
    De in {128, 256}, else ``tile16``."""
    return edge_mlp.design(dtype, hidden_dim, edge_dim)


def tile_receivers(dtype: torch.dtype, hidden_dim: int,
                   edge_dim: int) -> int:
    """Receivers per block (``tile16``) or per group (``hopper_bf16``); 0
    for ``hopper_fp32``, whose blocks split the rows instead."""
    return {"tile16": TILE_RECEIVERS, "hopper_bf16": HOPPER_RECEIVERS,
            "hopper_fp32": 0}[design(dtype, hidden_dim, edge_dim)]


def launch_geometry(num_receivers: int, tile: int, sms: int = 0,
                    batch: int = 1) -> Tuple[int, tuple]:
    """(items a sample, shape of the per-item statistics scratch of
    ``batch`` samples).  ``tile`` > 0:
    group ``g`` owns receivers ``[g * tile, min((g + 1) * tile,
    num_receivers))``; the 16-receiver design runs a block per group, the
    Hopper bf16 kernel a persistent block per SM over them (``sms`` is not
    read).  ``tile`` 0 (``hopper_fp32``): ``min(num_receivers, sms)``
    persistent blocks, block ``b`` owning the receivers
    ``edge_mlp.fp32_bounds`` gives it; ``sms`` must be at least 1."""
    if tile > 0:
        items = -(-num_receivers // tile)
    elif sms >= 1:
        items = min(num_receivers, sms)
    else:
        raise ValueError(f"launch_geometry: tile 0 takes the SM count, "
                         f"got sms={sms}")
    return items, (batch * items, 3)


def workspace_shape(num_receivers: int, hidden_dim: int, sms: int,
                    batch: int = 1) -> tuple:
    """The ``hopper_fp32`` launch's h workspace: ``F32_STEP_ROWS`` rows of
    H fp32 for each of its ``min(num_receivers, sms)`` blocks of each of
    ``batch`` samples."""
    return (batch * min(num_receivers, sms), F32_STEP_ROWS, hidden_dim)


def _receivers(indptr: torch.Tensor, num_rows: int) -> torch.Tensor:
    counts = (indptr[1:] - indptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(counts.numel(), device=indptr.device), counts,
        output_size=num_rows)


def edge_step_reference(xsg, v, xr, w1e, b_eff, w2, b2, a, c, mask, indptr,
                        num_receivers: int, activation: str = "swish"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version, with the kernel's rounding points (a batch as
    ``edge_step`` takes it)."""
    dt = v.dtype
    recv = _receivers(indptr, v.shape[-2])
    ep = (v.float() @ w1e.float()).to(dt)
    h = xsg + xr.index_select(-2, recv) + ep + b_eff[..., None, :]
    act = act_fn(activation)(h.float()).to(dt)
    u = (act.float() @ w2.float()).to(dt) + b2
    v_new = a.to(dt)[..., None, :] * v + c.to(dt)[..., None, :] + u
    w = mask.float()[:, None]
    agg = cuda_segment.segment_sum_reference(u.float() * w, indptr,
                                             num_receivers).to(dt)
    vf = v_new.float()
    stats = torch.stack([(vf * w).sum(dim=(-2, -1)),
                         (vf.square() * w).sum(dim=(-2, -1)),
                         (w.sum() * torch.ones_like(vf[..., 0, 0]))], dim=-1)
    return v_new, agg, stats


def edge_step(xsg, v, xr, w1e, b_eff, w2, b2, a, c, mask, indptr,
              num_receivers: int, activation: str = "swish"
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(v_new [E_pad, De], agg_sum [R, De] in v's dtype, stats [3] fp32).

    Shapes: xsg [E_pad, H], v [E_pad, De], xr [R, H], w1e [De, H],
    b_eff [H], w2 [H, De], b2 [De], a and c [De] fp32, mask [E_pad],
    indptr [R + 1] int32.  A batch: xsg, v, xr, w1e, b_eff, a and c with a
    leading [B] (w2, b2, mask and indptr shared) -> ([B, E_pad, De], [B,
    R, De], [B, 3]), one launch."""
    if v.device.type == "cpu":
        return edge_step_reference(xsg, v, xr, w1e, b_eff, w2, b2, a, c,
                                   mask, indptr, num_receivers, activation)
    if v.device.type != "cuda":
        raise ValueError(f"edge_step: unsupported device {v.device}")
    if v.dtype not in nvcc_build.DTYPE_CODES:
        raise TypeError(f"edge_step: dtype {v.dtype} (fp32/bf16 only)")
    if v.dim() not in (2, 3):
        raise ValueError(f"edge_step: v {tuple(v.shape)}, expected "
                         "[E_pad, De] or [B, E_pad, De]")
    lead = v.shape[:-2]
    batch = v.shape[0] if lead else 1
    e_pad, de = v.shape[-2:]
    hid = xsg.shape[-1]
    if not supports(hid, de, activation):
        raise ValueError(f"edge_step: H {hid} / De {de} not multiples of "
                         f"128 or activation {activation!r} not taken")
    shapes = {"xsg": (xsg, lead + (e_pad, hid)),
              "xr": (xr, lead + (num_receivers, hid)),
              "w1e": (w1e, lead + (de, hid)), "b_eff": (b_eff, lead + (hid,)),
              "w2": (w2, (hid, de)), "b2": (b2, (de,)),
              "a": (a, lead + (de,)), "c": (c, lead + (de,)),
              "mask": (mask, (e_pad,)),
              "indptr": (indptr, (num_receivers + 1,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"edge_step: {name} {tuple(t.shape)}, "
                             f"expected {shape}")
    if num_receivers < 1:
        raise ValueError("edge_step: no receivers")
    check_inputs("edge_step", (xsg, v, xr, w1e, b_eff, w2, b2, mask),
                 v.dtype, v.device)
    check_inputs("edge_step", (a, c), torch.float32, v.device)
    check_inputs("edge_step", (indptr,), torch.int32, v.device)
    lib = nvcc_build.load(SOURCE, SIGNATURES)
    if batch > lib.gclt_edge_step_max_batch():
        raise ValueError(f"edge_step: batch {batch} > "
                         f"{lib.gclt_edge_step_max_batch()}")
    code = nvcc_build.DTYPE_CODES[v.dtype]
    smem = lib.gclt_edge_step_smem(code, hid, de)
    if smem > MAX_SMEM:
        raise ValueError(f"edge_step: H {hid} / De {de} need {smem} bytes "
                         "of shared memory per block")
    dev = v.device
    kind = DESIGNS[lib.gclt_edge_step_design(code, hid, de)]
    tile = lib.gclt_edge_step_tile_receivers(code, hid, de)
    work_ptr = None  # the h workspace, which only hopper_fp32 takes
    if kind == "hopper_fp32":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _, partials_shape = launch_geometry(num_receivers, tile, sms, batch)
        w1e, w2 = tf32x3_b_image(w1e), tf32x3_b_image(w2)
        work = torch.empty(workspace_shape(num_receivers, hid, sms, batch),
                           dtype=torch.float32, device=dev)
        work_ptr = work.data_ptr()
    else:
        _, partials_shape = launch_geometry(num_receivers, tile, 0, batch)
        if kind == "hopper_bf16":
            w1e, w2 = wgmma_b_image(w1e), wgmma_b_image(w2)
    v_new = torch.empty(lead + (e_pad, de), dtype=v.dtype, device=dev)
    agg = torch.empty(lead + (num_receivers, de), dtype=v.dtype, device=dev)
    partials = torch.empty(partials_shape, dtype=torch.float32, device=dev)
    stats = torch.empty(lead + (3,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gclt_edge_step(
            xsg.data_ptr(), v.data_ptr(), xr.data_ptr(), w1e.data_ptr(),
            b_eff.data_ptr(), w2.data_ptr(), b2.data_ptr(), a.data_ptr(),
            c.data_ptr(), mask.data_ptr(), indptr.data_ptr(),
            v_new.data_ptr(), agg.data_ptr(), partials.data_ptr(),
            stats.data_ptr(), work_ptr, code, num_receivers, hid, de,
            ACTIVATIONS[activation], e_pad, batch, stream,
        )
    if err != 0:
        raise RuntimeError(f"edge_step kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return v_new, agg, stats
