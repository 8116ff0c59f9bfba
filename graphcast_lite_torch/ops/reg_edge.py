"""Edge unit of the regular-block processor layout (torch counterpart of
``graphcast_lite_tpu.ops.reg_edge``: ``_tile_expand``, ``_slice_sum``,
``_fwd_impl`` and the custom VJP ``_fwd`` / ``_bwd``).

On the constant-degree per-level layout (``graphs.structure.RegularBlocks``)
the InteractionNet edge step needs no receiver gather and no segment sum:

  u       = act(take(xs, snd) + tile(xr) + v @ W1e' + b1') @ W2 + b2
  agg_sum = per-block k-slice sums of (u · mask)

``reg_edge_tail`` is an ``autograd.Function`` whose backward follows the
reference's ``_bwd`` step by step: it saves ``h_pre``, takes the receiver
adjoints structurally (the tile's adjoint is the slice sum, the slice
sum's is the tile times the mask) and sends the one irreducible scatter,
the sender side, through the segment-sum kernel over the blocks'
sender-sorted CSR (``RegularBlocks.s_perm`` / ``s_indptr``).  Padding rows
(mask 0) get exact zero cotangents, so that scatter needs no masking.

``reg_edge_step`` is the whole edge side of one lazy-LN step outside
autograd, the residual and the statistics included, in the hand-written
CUDA kernel ``csrc/reg_edge.cu`` (bf16 at H = De in {128, 256}); its
plain version is ``reg_edge_step_reference``.  ``step_engages`` says
whether a call takes it: the serving paths do, training (its forward runs
with grad enabled through ``reg_edge_tail``), fp32 and the CPU do not.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import List, Tuple

import torch
import torch.nn.functional as F

from . import cuda_segment, nvcc_build
from .edge_mlp import ACTIVATIONS, check_inputs, wgmma_b_image

__all__ = ["RegStatic", "reg_edge_tail", "SOURCE", "SIGNATURES",
           "TILE_RECEIVERS", "WIDTHS", "launches", "step_engages",
           "tiles", "work_items", "reg_edge_step_reference",
           "reg_edge_step"]

SOURCE = os.path.join(nvcc_build.CSRC, "reg_edge.cu")
launches = 0

# Receivers a work item of the kernel (csrc/reg_edge.cu: kTile), and the
# widths it takes, H = De each (every InteractionNet processor of the port
# builds H = De).
TILE_RECEIVERS = 64
WIDTHS = (128, 256)
# The C interface of csrc/reg_edge.cu.
SIGNATURES = {
    "gclt_reg_edge_smem": (ctypes.c_int, [ctypes.c_int]),
    "gclt_reg_edge_max_blocks": (ctypes.c_int, []),
    "gclt_reg_edge": (ctypes.c_int, [ctypes.c_void_p] * 17
                      + [ctypes.c_int] * 7 + [ctypes.c_void_p]),
}


@dataclasses.dataclass(frozen=True)
class RegStatic:
    block_recv: Tuple[int, ...]
    block_k: Tuple[int, ...]
    num_nodes: int
    activation: str


def _act_fn(name: str):
    if name in ("swish", "silu"):
        return F.silu
    if name == "relu":
        return F.relu
    raise ValueError(name)


def _tile_expand(static: RegStatic, nodes: torch.Tensor,
                 rows_pad: int) -> torch.Tensor:
    """[..., M, F] node rows -> [..., rows_pad, F] block rows (slot-major
    tiles)."""
    reps = (1,) * (nodes.dim() - 2)
    parts = [nodes[..., :v_sz, :].repeat(reps + (k, 1))
             for v_sz, k in zip(static.block_recv, static.block_k)]
    out = torch.cat(parts, dim=-2)
    if out.shape[-2] < rows_pad:
        out = F.pad(out, (0, 0, 0, rows_pad - out.shape[-2]))
    return out


def _slice_sum(static: RegStatic, rows: torch.Tensor) -> torch.Tensor:
    """[..., rows_pad, F] block rows -> [..., M, F] per-receiver sums (fp32
    within a block, then the blocks added in the rows' dtype)."""
    m = static.num_nodes
    total = None
    off = 0
    for v_sz, k in zip(static.block_recv, static.block_k):
        blk = rows[..., off:off + v_sz, :].float()
        for s_i in range(1, k):
            blk = blk + rows[..., off + s_i * v_sz:
                             off + (s_i + 1) * v_sz, :].float()
        blk = blk.to(rows.dtype)
        if v_sz < m:
            blk = F.pad(blk, (0, 0, 0, m - v_sz))
        total = blk if total is None else total + blk
        off += v_sz * k
    return total


def _fwd_impl(static, x, v, mask, snd, w1s, w1r, w1e_eff, b1_eff, w2, b2):
    act = _act_fn(static.activation)
    xs = x @ w1s
    xr = x @ w1r
    rows_pad = snd.shape[0]
    h_pre = (
        xs.index_select(-2, snd)
        + _tile_expand(static, xr, rows_pad)
        + v @ w1e_eff
        + b1_eff
    )
    u = act(h_pre) @ w2 + b2
    agg_sum = _slice_sum(static, u * mask[:, None].to(u.dtype))
    return u, agg_sum, h_pre


def _act_and_grad(name: str, h_pre: torch.Tensor):
    """(act(h_pre), d act / d h_pre) in h_pre's dtype."""
    if name in ("swish", "silu"):
        s = torch.sigmoid(h_pre)
        return h_pre * s, s * (1 + h_pre * (1 - s))
    if name == "relu":
        return F.relu(h_pre), (h_pre > 0).to(h_pre.dtype)
    raise ValueError(name)


class _RegEdgeTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, static, x, v, mask, snd, s_perm, s_indptr, w1s, w1r,
                w1e_eff, b1_eff, w2, b2):
        u, agg_sum, h_pre = _fwd_impl(
            static, x, v, mask, snd, w1s, w1r, w1e_eff, b1_eff, w2, b2
        )
        ctx.static = static
        ctx.b_shapes = (b1_eff.shape, b2.shape)
        ctx.save_for_backward(x, v, mask, s_perm, s_indptr, w1s, w1r,
                              w1e_eff, w2, h_pre)
        return u, agg_sum

    @staticmethod
    def backward(ctx, d_u, d_agg):
        (x, v, mask, s_perm, s_indptr, w1s, w1r, w1e_eff, w2,
         h_pre) = ctx.saved_tensors
        static = ctx.static
        rows_pad = h_pre.shape[-2]
        # d(agg_sum) enters u through the masked slice sum: its adjoint is
        # the tile-expand (a broadcast) times the mask.
        d_u_tot = d_u + mask[:, None].to(d_u.dtype) * _tile_expand(
            static, d_agg, rows_pad
        )
        h, act_grad = _act_and_grad(static.activation, h_pre)
        # A batch: the inputs the samples share (the weights; v and the
        # folded W1e / b1 on the first step) get the sum of their
        # gradients.
        d_w2 = (h.mT @ d_u_tot).sum_to_size(w2.shape)
        d_b2 = d_u_tot.sum_to_size(ctx.b_shapes[1])
        d_hp = (d_u_tot @ w2.T) * act_grad          # [rows_pad, H]
        d_b1 = d_hp.sum_to_size(ctx.b_shapes[0])
        d_v = (d_hp @ w1e_eff.mT).sum_to_size(v.shape)
        d_w1e = (v.mT @ d_hp).sum_to_size(w1e_eff.shape)
        # Receiver side: the slice sum (the tile's adjoint).  Sender side:
        # the one irreducible scatter, through the segment-sum kernel over
        # the sender-sorted rows.
        d_xr = _slice_sum(static, d_hp)
        d_xs = cuda_segment.segment_sum(d_hp.index_select(-2, s_perm),
                                        s_indptr, static.num_nodes)
        d_x = d_xs @ w1s.T + d_xr @ w1r.T
        d_w1s = (x.mT @ d_xs).sum_to_size(w1s.shape)
        d_w1r = (x.mT @ d_xr).sum_to_size(w1r.shape)
        return (None, d_x, d_v, None, None, None, None, d_w1s, d_w1r,
                d_w1e, d_b1, d_w2, d_b2)


def reg_edge_tail(static: RegStatic, x, v, mask, snd, s_perm, s_indptr,
                  w1s, w1r, w1e_eff, b1_eff, w2, b2):
    """Returns (u [rows_pad, De], agg_sum [M, De]) — mask pre-applied to
    the aggregation only (the caller divides by the degree).  A batch is a
    leading axis of ``x`` [B, M, d] -> ([B, rows_pad, De], [B, M, De]);
    ``v``, ``w1e_eff`` and ``b1_eff`` are per sample ([B, ...], ``b1_eff``
    as [B, 1, H]) or shared, and the sender scatter of the backward is one
    launch over the batch.
    ``s_perm`` / ``s_indptr``: the senders' sorted CSR over the M rows,
    read by the backward only."""
    args = (x, v, w1s, w1r, w1e_eff, b1_eff, w2, b2)
    if not (torch.is_grad_enabled() and any(a.requires_grad for a in args)):
        u, agg_sum, _ = _fwd_impl(static, x, v, mask, snd, w1s, w1r,
                                  w1e_eff, b1_eff, w2, b2)
        return u, agg_sum
    return _RegEdgeTail.apply(static, x, v, mask, snd, s_perm, s_indptr,
                              w1s, w1r, w1e_eff, b1_eff, w2, b2)


# ---------------------------------------------------------------------------
# The whole edge step outside autograd: csrc/reg_edge.cu and its plain
# version.


def _kernel_device(t: torch.Tensor) -> bool:
    """Whether ``t`` lies where the kernel runs: a CUDA card."""
    return t.is_cuda


def step_engages(x, v, hidden_dim: int, edge_dim: int, activation: str,
                 params) -> bool:
    """Whether a reg-block lazy step runs in the kernel: bf16 tensors on a
    CUDA card, H = De in ``WIDTHS``, an activation the kernel takes, and
    no gradient taken (``reg_edge_tail``'s own test over ``x``, ``v`` and
    ``params``, the weights the step reads)."""
    if not (_kernel_device(x) and x.dtype == torch.bfloat16
            and v.dtype == torch.bfloat16):
        return False
    if hidden_dim not in WIDTHS or edge_dim != hidden_dim \
            or activation not in ACTIVATIONS:
        return False
    return not (torch.is_grad_enabled()
                and any(t.requires_grad for t in (x, v, *params)))


def tiles(static: RegStatic) -> int:
    """Tiles of ``TILE_RECEIVERS`` receivers a sample: those below the
    largest block's size (the receivers past it have no rows)."""
    return -(-max(static.block_recv) // TILE_RECEIVERS)


def work_items(static: RegStatic, batch: int = 1
               ) -> List[Tuple[int, int, List[Tuple[int, int, int]]]]:
    """The kernel's items in the order it hands them out: (sample, tile,
    sub-tiles), item ``k`` = (``k % batch``, ``k // batch``), so tiles
    come in order and, the blocks being ascending in size, the heaviest
    first.  A sub-tile (row0, nvalid, receiver0) is one slot of one block
    holding the tile's first receiver: rows ``[row0, row0 + nvalid)``
    carry receivers ``receiver0 + [0, nvalid)``, in block order, then slot
    order (csrc/reg_edge.cu: ``sub_at``)."""
    offs, off = [], 0
    for v_sz, k in zip(static.block_recv, static.block_k):
        offs.append(off)
        off += v_sz * k
    out = []
    for k in range(tiles(static) * batch):
        tile, smp = divmod(k, batch)
        r0 = tile * TILE_RECEIVERS
        subs = [(o + s * v_sz + r0, min(TILE_RECEIVERS, v_sz - r0), r0)
                for o, v_sz, kk in zip(offs, static.block_recv,
                                       static.block_k)
                if v_sz > r0 for s in range(kk)]
        out.append((smp, tile, subs))
    return out


def _slice_sum_f32(static: RegStatic, rows: torch.Tensor) -> torch.Tensor:
    """[..., rows_pad, F] -> [..., M, F] per-receiver sums over every block
    and slot in fp32 (the kernel's aggregate, before its one cast)."""
    total = rows.new_zeros(rows.shape[:-2] + (static.num_nodes,
                                              rows.shape[-1]),
                           dtype=torch.float32)
    off = 0
    for v_sz, k in zip(static.block_recv, static.block_k):
        for s_i in range(k):
            total[..., :v_sz, :] += rows[..., off + s_i * v_sz:
                                         off + (s_i + 1) * v_sz, :].float()
        off += v_sz * k
    return total


def reg_edge_step_reference(static: RegStatic, xs, xr, v, mask, snd,
                            w1e_eff, b1_eff, w2, b2, a, c
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain torch version of ``reg_edge_step``, with the kernel's rounding
    points (the working dtype T of ``v``): h, u, the residual and the
    aggregate in fp32; act(h) cast to T as the second product's operand;
    v' and the aggregate cast to T once; the statistics over the cast v';
    v' zero on the rows past the last block."""
    dt = v.dtype
    act = _act_fn(static.activation)
    rows_pad = snd.shape[0]
    h = (xs.index_select(-2, snd.long()).float()
         + _tile_expand(static, xr, rows_pad).float()
         + v.float() @ w1e_eff.float() + b1_eff.float()[..., None, :])
    u = act(h).to(dt).float() @ w2.float() + b2.float()
    v_new = (a.float()[..., None, :] * v.float() + c.float()[..., None, :]
             + u).to(dt)
    total = sum(v_sz * k for v_sz, k in zip(static.block_recv,
                                            static.block_k))
    v_new[..., total:, :] = 0
    w = mask.float()[:, None]
    agg = _slice_sum_f32(static, u * w).to(dt)
    vf = v_new.float()
    stats = torch.stack([(vf * w).sum(dim=(-2, -1)),
                         (vf.square() * w).sum(dim=(-2, -1)),
                         w.sum() * torch.ones_like(vf[..., 0, 0])], dim=-1)
    return v_new, agg, stats


def reg_edge_step(static: RegStatic, xs, xr, v, mask, snd, w1e_eff, b1_eff,
                  w2, b2, a, c) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(v' [rows_pad, De], agg_sum [M, De] in v's dtype, stats [3] fp32 =
    (sum v' w, sum v'^2 w, sum w), w the mask) of one lazy-LN step on the
    RegularBlocks rows: h = xs[snd] + tile(xr) + v @ w1e_eff + b1_eff,
    u = act(h) @ w2 + b2, v' = a v + c + u, agg_sum the masked slice sum of
    u.

    Shapes: xs, xr [M, H] (= x @ W1s, x @ W1r); v [rows_pad, De]; w1e_eff
    [De, H]; b1_eff [H]; w2 [H, De]; b2 [De]; a, c [De] fp32; mask and snd
    [rows_pad].  A batch: xs and xr [B, M, H] -> ([B, rows_pad, De], [B, M,
    De], [B, 3]), v, w1e_eff, b1_eff, a and c each per sample (a leading
    [B]) or shared by the samples; one launch.  On a CPU tensor it runs
    ``reg_edge_step_reference``; on a CUDA tensor it launches the kernel
    or raises."""
    if v.device.type == "cpu":
        return reg_edge_step_reference(static, xs, xr, v, mask, snd,
                                       w1e_eff, b1_eff, w2, b2, a, c)
    if v.device.type != "cuda":
        raise ValueError(f"reg_edge_step: unsupported device {v.device}")
    if xs.dim() not in (2, 3):
        raise ValueError(f"reg_edge_step: xs {tuple(xs.shape)}, expected "
                         "[M, H] or [B, M, H]")
    lead = xs.shape[:-2]
    batch = xs.shape[0] if lead else 1
    m, hid = xs.shape[-2:]
    rows, de = v.shape[-2:]
    if hid not in WIDTHS or de != hid:
        raise ValueError(f"reg_edge_step: H {hid} / De {de}, expected H = De "
                         f"in {WIDTHS}")
    if static.activation not in ACTIVATIONS:
        raise ValueError(f"reg_edge_step: activation "
                         f"{static.activation!r} not taken")
    if m != static.num_nodes:
        raise ValueError(f"reg_edge_step: xs has {m} rows, the layout "
                         f"{static.num_nodes} receivers")

    def per_sample(name, t, shape):
        """Whether ``t`` is shared by the samples (raises unless it is
        ``shape`` or, on a batch, ``lead + shape``)."""
        if tuple(t.shape) == shape:
            return True
        if lead and tuple(t.shape) == tuple(lead) + shape:
            return False
        raise ValueError(f"reg_edge_step: {name} {tuple(t.shape)}, "
                         f"expected {shape} or {tuple(lead) + shape}")

    shared = (per_sample("v", v, (rows, de))
              | per_sample("w1e_eff", w1e_eff, (de, hid)) << 1
              | per_sample("b1_eff", b1_eff, (hid,)) << 2
              | per_sample("a", a, (de,)) << 3)
    if per_sample("c", c, (de,)) != bool(shared & 8):
        raise ValueError("reg_edge_step: a and c are both per sample or "
                         "both shared")
    for name, t, shape in (("xr", xr, tuple(lead) + (m, hid)),
                           ("w2", w2, (hid, de)), ("b2", b2, (de,)),
                           ("mask", mask, (rows,)), ("snd", snd, (rows,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"reg_edge_step: {name} {tuple(t.shape)}, "
                             f"expected {shape}")
    check_inputs("reg_edge_step", (xs, xr, v, w1e_eff, b1_eff, w2, b2, mask),
                 torch.bfloat16, v.device)
    check_inputs("reg_edge_step", (a, c), torch.float32, v.device)
    check_inputs("reg_edge_step", (snd,), torch.int32, v.device)
    lib = nvcc_build.load(SOURCE, SIGNATURES)
    nblocks = len(static.block_recv)
    if not 1 <= nblocks <= lib.gclt_reg_edge_max_blocks():
        raise ValueError(f"reg_edge_step: {nblocks} blocks, at most "
                         f"{lib.gclt_reg_edge_max_blocks()}")
    table = (ctypes.c_int * (2 * nblocks))(*static.block_recv,
                                          *static.block_k)
    dev = v.device
    n_tiles = tiles(static)
    v_new = torch.empty(tuple(lead) + (rows, de), dtype=v.dtype, device=dev)
    agg = torch.empty(tuple(lead) + (m, de), dtype=v.dtype, device=dev)
    if n_tiles * TILE_RECEIVERS < m:   # receivers past every block
        agg[..., n_tiles * TILE_RECEIVERS:, :] = 0
    partials = torch.empty((batch, n_tiles, 3), dtype=torch.float32,
                           device=dev)
    stats = torch.empty(tuple(lead) + (3,), dtype=torch.float32, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    w1e_img, w2_img = wgmma_b_image(w1e_eff), wgmma_b_image(w2)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gclt_reg_edge(
            xs.data_ptr(), xr.data_ptr(), v.data_ptr(), w1e_img.data_ptr(),
            b1_eff.data_ptr(), w2_img.data_ptr(), b2.data_ptr(),
            a.data_ptr(), c.data_ptr(), mask.data_ptr(), snd.data_ptr(),
            ctypes.addressof(table), v_new.data_ptr(), agg.data_ptr(),
            partials.data_ptr(), stats.data_ptr(), counter.data_ptr(),
            nblocks, hid, ACTIVATIONS[static.activation], m, rows,
            batch, shared, stream,
        )
    if err != 0:
        raise RuntimeError(f"reg_edge_step kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return v_new, agg, stats
