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
which take the place of the reference's chunk schedule.  A batch of B
samples on the graph (``h_pre`` [B, E_pad, H] -> u [B, E_pad, De], agg_sum
[B, R, De]) shares ``w2``, ``b2``, the mask and ``indptr`` and is one
launch: the reference's ``pallas_call`` batches the kernel by a grid axis
under ``vmap``.

* On a CPU tensor the wrapper runs ``edge_mlp_reference``.
* On a CUDA tensor it launches ``csrc/edge_mlp.cu`` (built by
  ``ops.nvcc_build`` at first use) or raises; it never falls back.  Three
  designs (``design``):

  - ``hopper_bf16``, bf16 at H and De in {128, 256} (the flagship's
    widths): W2 resident in shared memory as wgmma's B operand, handed
    over as a ``wgmma_b_image``; persistent blocks walk groups of
    ``HOPPER_RECEIVERS`` receivers (``hopper_geometry``), a batch's
    (sample, group) items in turn, W2 loaded once a block.
  - ``hopper_fp32``, fp32 at the same widths: 3xTF32 wgmma products, W2
    streamed through shared memory in K-slabs of its ``tf32x3_b_image``;
    persistent blocks take the receivers of equal shares of the rows
    (``fp32_bounds``) and walk them in steps of ``F32_STEP_ROWS`` rows.
  - ``tile16``, wider rows in either dtype: the 16-receiver design of
    ``edge_tile.cuh`` on row-major W2.

  ``hopper_fp32`` and ``tile16`` take a batch's samples on a second grid
  axis.

``launches`` counts kernel launches (never plain-version calls).  There is
no backward: the reference kernel has none either.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import torch
import torch.nn.functional as F

from . import cuda_segment, nvcc_build

__all__ = ["SOURCE", "SIGNATURES", "ACTIVATIONS", "MAX_SMEM", "DESIGNS",
           "TILE_RECEIVERS", "HOPPER_RECEIVERS", "F32_STEP_ROWS", "launches",
           "act_fn", "supports", "design", "tile_receivers",
           "hopper_geometry", "subtiles_per_block", "fp32_bounds",
           "fp32_steps_per_block", "wgmma_b_image", "tf32_round",
           "tf32_split", "tf32x3_b_image", "check_inputs", "edge_mlp",
           "edge_mlp_reference"]

SOURCE = os.path.join(nvcc_build.CSRC, "edge_mlp.cu")
launches = 0

# The activations the kernels take, with their codes.
ACTIVATIONS = {"swish": 0, "silu": 0, "relu": 1}
MAX_SMEM = 232448  # dynamic shared memory one H100 block may use
# The designs by the code csrc/edge_mlp.cu's gclt_edge_mlp_design returns.
DESIGNS = ("tile16", "hopper_bf16", "hopper_fp32")
# Receivers per block of the 16-receiver design, and per group of the
# Hopper bf16 design (csrc/edge_mlp.cu: kTileReceivers, kMlpReceivers).
TILE_RECEIVERS = 16
HOPPER_RECEIVERS = 32
SUB_ROWS = 64  # rows per sub-tile of the group designs
F32_STEP_ROWS = 128  # rows a step of the fp32 Hopper design (kF32StepRows)
# The C interface of csrc/edge_mlp.cu.
SIGNATURES = {
    "gclt_edge_mlp_smem": (ctypes.c_int, [ctypes.c_int] * 3),
    "gclt_edge_mlp_design": (ctypes.c_int, [ctypes.c_int] * 3),
    "gclt_edge_mlp_tile_receivers": (ctypes.c_int, [ctypes.c_int] * 3),
    "gclt_edge_mlp_max_batch": (ctypes.c_int, []),
    "gclt_edge_mlp": (ctypes.c_int, [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
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


def design(dtype: torch.dtype, hidden_dim: int, out_dim: int) -> str:
    """The design a launch takes (csrc/edge_mlp.cu: ``design()``;
    ``gclt_edge_mlp_design`` answers for the built library): at H and De in
    {128, 256} ``hopper_bf16`` or ``hopper_fp32`` by dtype, else
    ``tile16``.  Wider rows do not fit the Hopper designs' shared memory."""
    if hidden_dim in (128, 256) and out_dim in (128, 256):
        return "hopper_bf16" if dtype == torch.bfloat16 else "hopper_fp32"
    return "tile16"


def tile_receivers(dtype: torch.dtype, hidden_dim: int, out_dim: int) -> int:
    """Receivers per block (``tile16``) or per group (``hopper_bf16``); 0
    for ``hopper_fp32``, whose blocks split the rows instead."""
    return {"tile16": TILE_RECEIVERS, "hopper_bf16": HOPPER_RECEIVERS,
            "hopper_fp32": 0}[design(dtype, hidden_dim, out_dim)]


def hopper_geometry(num_receivers: int, sms: int) -> Tuple[int, int]:
    """(groups, blocks) of a Hopper launch: group ``g`` owns receivers
    ``[g * HOPPER_RECEIVERS, min((g + 1) * HOPPER_RECEIVERS, R))``;
    ``min(groups, sms)`` persistent blocks, block ``b`` walking groups
    ``b, b + blocks, ...``.  (A batch of B walks B · groups items, item
    ``k`` being group ``k % groups`` of sample ``k // groups``, on
    ``min(B · groups, sms)`` blocks.)"""
    groups = -(-num_receivers // HOPPER_RECEIVERS)
    return groups, min(groups, sms)


def subtiles_per_block(indptr: torch.Tensor, sms: int) -> torch.Tensor:
    """64-row sub-tiles each persistent block of a Hopper launch computes
    (a group's rows in ``ceil(rows / 64)`` sub-tiles): the launch's tail is
    its largest entry against the mean."""
    r = indptr.numel() - 1
    groups, blocks = hopper_geometry(r, sms)
    ends = torch.arange(1, groups + 1) * HOPPER_RECEIVERS
    bounds = indptr.cpu().long()[torch.cat([torch.zeros(1, dtype=torch.long),
                                            ends.clamp(max=r)])]
    tiles = (bounds[1:] - bounds[:-1] + SUB_ROWS - 1) // SUB_ROWS
    out = torch.zeros(blocks, dtype=torch.long)
    return out.index_add_(0, torch.arange(groups) % blocks, tiles)


def fp32_bounds(indptr: torch.Tensor, blocks: int) -> torch.Tensor:
    """[blocks + 1] receiver boundaries of an ``hopper_fp32`` launch of
    ``blocks`` blocks: block ``b`` owns receivers ``[rb[b], rb[b + 1])``,
    ``rb[b]`` the first receiver whose rows start at or after row
    ``b * E // blocks`` (E = ``indptr[-1]``), and ``rb[blocks] = R``.  A
    receiver's rows never split between blocks."""
    ip = indptr.cpu().long()
    e = int(ip[-1])
    starts = torch.arange(blocks, dtype=torch.long) * e // blocks
    rb = torch.searchsorted(ip, starts, side="left")
    return torch.cat([rb, torch.tensor([ip.numel() - 1])])


def fp32_steps_per_block(indptr: torch.Tensor, sms: int) -> torch.Tensor:
    """Steps of ``F32_STEP_ROWS`` rows each block of an ``hopper_fp32``
    launch (``min(R, sms)`` blocks) computes; each streams W2 once."""
    r = indptr.numel() - 1
    rb = fp32_bounds(indptr, min(r, sms))
    rows = indptr.cpu().long()[rb]
    return (rows[1:] - rows[:-1] + F32_STEP_ROWS - 1) // F32_STEP_ROWS


@functools.lru_cache(maxsize=None)
def _image_order(k: int, n: int, device: torch.device) -> torch.Tensor:
    """Flat index into a row-major [K, N] matrix of each place of its
    image (see ``wgmma_b_image``)."""
    cb, kb, nl, q, e = torch.meshgrid(
        torch.arange(n // 64), torch.arange(k // 64), torch.arange(64),
        torch.arange(8), torch.arange(8), indexing="ij")
    rows = 64 * kb + 8 * (q ^ (nl % 8)) + e
    return (rows * n + 64 * cb + nl).reshape(-1).to(device)


def wgmma_b_image(w: torch.Tensor) -> torch.Tensor:
    """``w`` [K, N] as the Hopper kernels' weight slabs: [N / 64, K / 64,
    64, 64]; a batch [B, K, N] -> one image a sample, [B, N / 64, ...].

    Slab ``cb`` is the shared-memory image of the column block
    ``w[:, 64 cb : 64 cb + 64]`` as wgmma's B operand in the
    128-byte-swizzled K-major layout: K blocks of 64, in each of them row
    ``n`` holds ``w[64 kb : 64 kb + 64, 64 cb + n]`` in 8 chunks of 8, chunk
    ``q`` stored at place ``q ^ (n % 8)``.  K and N are multiples of 64.
    One gather with a cached order: it runs on every call, since the edge
    step's caller folds the LayerNorm scale into W1e per step."""
    k, n = w.shape[-2:]
    lead = w.shape[:-2]
    order = _image_order(k, n, w.device)
    return w.reshape(lead + (-1,)).index_select(-1, order).view(
        lead + (n // 64, k // 64, 64, 64))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as the kernel's ``cvt.rna.tf32.f32``: add half of the
    13 dropped bits' unit to the magnitude, then clear them (finite
    inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small): ``big = tf32(x)``, ``small = tf32(x - big)``, the
    3xTF32 operand parts; ``x - big`` is exact in fp32."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


@functools.lru_cache(maxsize=None)
def _tf32_image_order(k: int, n: int, device: torch.device) -> torch.Tensor:
    """Flat index into a row-major [K, N] matrix of each place of one
    part of its ``tf32x3_b_image``: [K / 32, N, 32]."""
    ks, nl, q, e = torch.meshgrid(
        torch.arange(k // 32), torch.arange(n), torch.arange(8),
        torch.arange(4), indexing="ij")
    rows = 32 * ks + 4 * (q ^ (nl % 8)) + e
    return (rows * n + nl).reshape(-1).to(device)


def tf32x3_b_image(w: torch.Tensor) -> torch.Tensor:
    """fp32 ``w`` [K, N] as the fp32 Hopper kernel's W2 K-slabs: [K / 32,
    2, N, 32].

    Slab ``i``, part ``p`` (0: ``tf32_split``'s big part, 1: its small
    part) is the shared-memory image of ``part[32 i : 32 i + 32, :]`` as
    wgmma's tf32 B operand, K-major with the 128-byte swizzle: row ``n``
    holds the 32 values of column ``n`` in 8 chunks of 4, chunk ``q``
    stored at place ``q ^ (n % 8)``.  The kernel copies one slab (both
    parts, 256 N bytes) at a time.  K is a multiple of 32, N of 8.  A batch
    [B, K, N] -> one image a sample, [B, K / 32, 2, N, 32]."""
    k, n = w.shape[-2:]
    lead = w.shape[:-2]
    order = _tf32_image_order(k, n, w.device)
    parts = [p.reshape(lead + (-1,)).index_select(-1, order)
             .view(lead + (k // 32, n, 32)) for p in tf32_split(w.float())]
    return torch.stack(parts, -3)


def edge_mlp_reference(h_pre: torch.Tensor, w2: torch.Tensor,
                       b2: torch.Tensor, mask: torch.Tensor,
                       indptr: torch.Tensor, num_receivers: int,
                       activation: str = "swish"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version, with the kernel's rounding points (a batch
    [B, E_pad, H] -> [B, E_pad, De], [B, R, De])."""
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
    [E_pad, H]; a batch h_pre [B, E_pad, H] -> ([B, E_pad, De], [B, R,
    De]) in one launch."""
    if h_pre.device.type == "cpu":
        return edge_mlp_reference(h_pre, w2, b2, mask, indptr,
                                  num_receivers, activation)
    if h_pre.device.type != "cuda":
        raise ValueError(f"edge_mlp: unsupported device {h_pre.device}")
    if h_pre.dtype not in nvcc_build.DTYPE_CODES:
        raise TypeError(f"edge_mlp: dtype {h_pre.dtype} (fp32/bf16 only)")
    if h_pre.dim() not in (2, 3):
        raise ValueError(f"edge_mlp: h_pre {tuple(h_pre.shape)}, expected "
                         "[E_pad, H] or [B, E_pad, H]")
    lead = h_pre.shape[:-2]
    batch = h_pre.shape[0] if lead else 1
    e_pad, hid = h_pre.shape[-2:]
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
    lib = nvcc_build.load(SOURCE, SIGNATURES)
    if batch > lib.gclt_edge_mlp_max_batch():
        raise ValueError(f"edge_mlp: batch {batch} > "
                         f"{lib.gclt_edge_mlp_max_batch()}")
    code = nvcc_build.DTYPE_CODES[h_pre.dtype]
    smem = lib.gclt_edge_mlp_smem(code, hid, de)
    if smem > MAX_SMEM:
        raise ValueError(f"edge_mlp: H {hid} / De {de} need {smem} bytes of "
                         "shared memory per block")
    kind = DESIGNS[lib.gclt_edge_mlp_design(code, hid, de)]
    if kind == "hopper_bf16":
        w2 = wgmma_b_image(w2)
    elif kind == "hopper_fp32":
        w2 = tf32x3_b_image(w2)
    u = torch.empty(lead + (e_pad, de), dtype=h_pre.dtype,
                    device=h_pre.device)
    agg = torch.empty(lead + (num_receivers, de), dtype=h_pre.dtype,
                      device=h_pre.device)
    with torch.cuda.device(h_pre.device):
        stream = torch.cuda.current_stream(h_pre.device).cuda_stream
        err = lib.gclt_edge_mlp(
            h_pre.data_ptr(), w2.data_ptr(), b2.data_ptr(), mask.data_ptr(),
            indptr.data_ptr(), u.data_ptr(), agg.data_ptr(), code,
            num_receivers, hid, de, ACTIVATIONS[activation], e_pad, batch,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"edge_mlp kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return u, agg
