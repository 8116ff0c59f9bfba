"""Smoke run of the PyTorch port on one NVIDIA card: ``python3 chip_smoke.py``.

Builds the port's three hand-written CUDA kernels (nvcc, sm_90a, one nvcc
per source, all at once) from ``graphcast_lite_torch/csrc/``, then:

1. Holds each kernel against its plain PyTorch version on the card, in
   fp32 and bf16: the segment sum (``segment_sum.cu``), the edge-MLP tail
   fused with its aggregation (``edge_mlp.cu``) and the fused lazy-LN edge
   step (``edge_step.cu``), on empty receivers, padding rows, pruned edges,
   a receiver with thousands of edges and receiver counts that are not a
   multiple of the kernels' receiver tile.  The segment sum also on the
   shapes that cut its balanced design's tiles: no edges (R = 50,000),
   R = 1, a 50,000-edge receiver, long receivers that end exactly on tile
   boundaries and the encoder's layout (131,072 empty rows, then a skewed
   band), each at F in {19, 64, 256}, with PR 1's warp-per-row design on
   the same skew, two balanced launches compared bitwise, and the
   library's design and tile-size queries checked against the wrapper's
   Python mirror.  Both fused kernels also on the tilings their bf16
   Hopper kernels meet (in-degree 1, alternating in-degrees 0 and 13,
   receivers of exactly 64 and 128 rows, one receiver, R = 33) and on bf16
   rows wider than those kernels take (H = 384), which run the 16-receiver
   design.  Checks that the edge-MLP library's width selection
   (``gclt_edge_mlp_wgmma``) and group size agree with the wrapper's Python
   mirror and prints each layout's shared memory.
2. Serves the flagship forecast (``presets.interaction_net_512x256``: 19
   features, obs 2, AR 4, hidden 256, 12 InteractionNet steps, mesh [4, 6])
   in bf16 through the port's ``evaluate_model`` for 3 requests on a seeded
   synthetic 512x256 dataset with seeded random weights, on the default
   reg-block route, checks that every rollout launched the segment sum
   exactly 8 times (2 encoder GCNConv aggregations x 4 AR steps), and holds
   one request's bf16 rollout against the fp32 rollout of the same weights.
2b. Serves one request on each of the three COO routes (``GCLT_REG_EDGE=0``;
   plus ``GCLT_EDGE_STEP=1`` or ``GCLT_MEGA_EDGE=1``), checks each route's
   exact launch counts per rollout, and holds its bf16 rollout against the
   fp32 reg-block rollout; times each route and profiles one rollout of it
   (device busy time and idle share).
3. Times each kernel at the flagship shapes (the segment sum at the encoder
   and the processor shape, the two fused kernels at the processor shape)
   against its bound, its plain version and, where there is one, one
   PyTorch call; the segment sum in the design it picks and in PR 1's
   warp-per-row design, in turns; the fused kernels also against their
   earlier (wmma) times, and ``edge_mlp`` with the design it took
   (asserted: the Hopper one) and its persistent blocks' sub-tile counts;
   the segment sum also at the four sender-sorted scatters of phase 5a.
4. Runs the 64x32 flagship architecture in fp32 (TF32 off) on the card and
   on the CPU (the plain versions) with the same weights and inputs through
   AR-4, on the reg-block route and on each COO route, and compares them.
5. Training.  5a: the segment sum against its plain version, fp32 and
   bf16, on the sender-sorted CSRs of the train step's backward (the
   reg-edge unit's sender scatter, the encoder's and the decoder's GCNConv
   gather adjoints; a decoder sender reaches 696 edges), on the permuted
   cotangent rows the backward builds.  5b: the 64x32 architecture's fp32
   AR-4 train step (``make_train_step``) on the card against the CPU:
   loss, every gradient and the exact segment-sum launches, then the
   card's Adam update against its closed form.  5c: the flagship in bf16
   mixed precision, 5 train steps on one seeded batch through
   ``make_train_step`` on the default route: exact launches every step
   (80 segment sums, no fused kernel), the loss falls, step and
   forward-loss times, peak memory and one profiled step.

Prints the card's name and power limit, ``{"serve": ...}``,
``{"train": ...}`` and ``{"kernels": [...]}`` lines and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero without the last line; so does a machine without a
card.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Stated tolerance of the segment sum against its plain version, per
# element:
#   |kernel - plain| <= atol + rtol * |plain| + ORDER_RTOL * sum_e |msgs_e|.
# Both accumulate in fp32 and differ only in the order of the additions;
# that difference grows with the sum of magnitudes, not with the result,
# which cancels in a long row (a 2,500-edge row of N(0, 1) messages sums
# to about 1 while its partial sums reach about 50).  bf16 rounds the fp32
# sum once, so the two differ by at most one bf16 ulp (2^-8 relative) more.
FP32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-5, rtol=1e-2)
ORDER_RTOL = 1e-5
# The fused kernels (edge_mlp, edge_step) against their plain versions.
# Per output element, atol + rtol * |plain|; the aggregates add the order
# term above over their rows' |u|.  fp32: both accumulate products of up to
# 256 terms (magnitudes up to about 4) in fp32 in other orders, a few fp32
# roundings of the partial sums.  bf16: both round at the same points, but
# where the two fp32 accumulations fall on either side of a bf16 rounding
# boundary an intermediate differs by one bf16 ulp (2^-6 at magnitude 2-4),
# and the output by up to about two.
FUSED_FP32_TOL = dict(atol=1e-4, rtol=1e-4)
FUSED_BF16_TOL = dict(atol=2.0 ** -5, rtol=2.0 ** -6)
# The edge step's statistics are fp32 sums over up to 67M elements, in
# other orders: |kernel - plain| <= STATS_RTOL * (sum of the terms'
# magnitudes); the row count (sum of the mask) is exact.
STATS_RTOL = 1e-5
# The 64x32 model on the card against the CPU, fp32 with TF32 off.
E2E_TOL = dict(atol=1e-3, rtol=1e-3)
# The flagship bf16 serve against fp32 (TF32 off), same weights and request:
# per AR step, RMS(bf16 - fp32) <= BF16_SERVE_RTOL * RMS(fp32).  bf16 keeps
# 8 significant bits (a rounding is within 2^-9 relative); the bound allows
# about 16 such roundings' worth of drift.  The CPU tests hold the same
# serve at a small size to the JAX package's own bf16 error.
BF16_SERVE_RTOL = 2.0 ** -5
# H100 SXM data-sheet rates: HBM3 bytes/s and dense bf16 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
# edge_step at the flagship processor shape before its Hopper redesign:
# the wmma kernel of commit c6b0bb6, H100 80GB HBM3 at 700 W.
EDGE_STEP_EARLIER_MS = 2.1121
# edge_mlp there before its Hopper redesign: the 16-receiver wmma kernel of
# commit 14a3db7, two runs, H100 80GB HBM3 at 700 W.
EDGE_MLP_EARLIER_MS = (0.7095, 0.7006)
# The 64x32 model's train step on the card against the CPU, fp32 with TF32
# off: the loss within TRAIN_LOSS_RTOL relative, and each parameter's
# gradient within TRAIN_GRAD_RTOL of the leaf's largest CPU gradient
# (+ 1e-6).  fp32 rounding alone moves the encoder's first-layer gradients
# of the small CPU-test model (hidden 128, 2 steps) by about 1.2e-4 of
# their largest value (measured there against float64); the card and the
# CPU sum in other orders throughout a model twice as wide and six times
# as deep, so the bound allows about eight times that.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-3
# Train steps of the flagship on one batch: a warm-up, three timed, one
# profiled.
TRAIN_STEPS = 5
REQUESTS = 3
AR_STEPS = 4
# The COO routes of the processor, the switches that pick them (the JAX
# package's own), and their exact kernel launches per AR-4 rollout
# (48 = 12 processor steps x 4 AR steps; 8 = 2 encoder GCNConv x 4).
COO_ROUTES = {
    "composed": ({"GCLT_REG_EDGE": "0"},
                 {"segment_sum": 8 + 48, "edge_mlp": 0, "edge_step": 0}),
    "edge_step": ({"GCLT_REG_EDGE": "0", "GCLT_EDGE_STEP": "1"},
                  {"segment_sum": 8, "edge_mlp": 0, "edge_step": 48}),
    "mega": ({"GCLT_REG_EDGE": "0", "GCLT_MEGA_EDGE": "1"},
             {"segment_sum": 8, "edge_mlp": 48, "edge_step": 0}),
}
_SWITCHES = ("GCLT_REG_EDGE", "GCLT_EDGE_STEP", "GCLT_MEGA_EDGE")


def _log(*args):
    print(*args, flush=True)


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, flops: float):
    """(least ms, "bytes" | "operations"): the larger of the bytes over the
    HBM rate and the operations over the bf16 tensor-core rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_TC_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def _kernel_modules():
    from graphcast_lite_torch.ops import cuda_segment, edge_mlp, edge_step

    return {"segment_sum": cuda_segment, "edge_mlp": edge_mlp,
            "edge_step": edge_step}


def _reset_launches():
    for mod in _kernel_modules().values():
        mod.launches = 0
    _kernel_modules()["segment_sum"].launches_by_csr.clear()


def _launches():
    return {name: mod.launches for name, mod in _kernel_modules().items()}


@contextlib.contextmanager
def _route(env):
    """Set the processor's route switches for the block; restore after."""
    saved = {k: os.environ.get(k) for k in _SWITCHES}
    for k in _SWITCHES:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _sorted_case(gen, num_edges, num_receivers, f, dtype, batch=None,
                 recv=None):
    """Receiver-sorted messages padded to a multiple of 128 rows; padding
    rows are zero and belong to the last receiver.  Returns
    (msgs, indptr) on the card."""
    from graphcast_lite_torch.graphs.structure import indptr_from_receivers

    if recv is None:
        recv = torch.sort(torch.randint(0, num_receivers, (num_edges,),
                                        generator=gen)).values
    e = recv.numel()
    e_pad = ((e + 127) // 128) * 128
    full = torch.full((e_pad,), num_receivers - 1, dtype=torch.int64)
    full[:e] = recv
    shape = ((batch,) if batch else ()) + (e_pad, f)
    msgs = torch.randn(shape, generator=gen)
    msgs[..., e:, :] = 0.0
    indptr = indptr_from_receivers(full, num_receivers)
    return msgs.to("cuda", dtype), indptr.to("cuda")


def _check_kernel(label, msgs, indptr, num_receivers, design=None) -> float:
    """Segment-sum kernel (the design the library picks, or ``design``)
    against the plain version on the same card inputs; returns the max abs
    error."""
    from graphcast_lite_torch.ops import cuda_segment

    out = cuda_segment.segment_sum(msgs, indptr, num_receivers, design)
    ref = cuda_segment.segment_sum_reference(msgs, indptr, num_receivers)
    mag = cuda_segment.segment_sum_reference(msgs.float().abs(), indptr,
                                             num_receivers)
    torch.cuda.synchronize()
    tol = FP32_TOL if msgs.dtype == torch.float32 else BF16_TOL
    err = _close(f"{label} {msgs.dtype}", out, ref, tol, ORDER_RTOL * mag)
    took = design or cuda_segment.segment_design(msgs.dtype, msgs.shape[-1])
    _log(f"  {label:<44s} {str(msgs.dtype):<15s} max|err| {err:.3e} ok "
         f"({took})")
    return err


def _segment_design_check() -> None:
    """Raises unless the segment-sum library and the Python mirror agree on
    the balanced design's tile size and on the design of every dtype, width
    and alignment."""
    from graphcast_lite_torch.ops import cuda_segment, nvcc_build

    lib = nvcc_build.load(cuda_segment.SOURCE, cuda_segment.SIGNATURES)
    items = lib.gclt_segment_sum_tile_items()
    if items != cuda_segment.TILE_ITEMS:
        raise AssertionError(f"segment_sum: library tiles of {items} items, "
                             f"Python {cuda_segment.TILE_ITEMS}")
    for dtype, code in nvcc_build.DTYPE_CODES.items():
        for f in (19, 64, 128, 256, 512, 1024):
            for aligned in (True, False):
                lib_says = ("balanced" if lib.gclt_segment_sum_design(
                    code, f, int(aligned)) else "warp")
                py_says = cuda_segment.segment_design(dtype, f, aligned)
                if lib_says != py_says:
                    raise AssertionError(
                        f"segment_sum {dtype} F={f} aligned={aligned}: "
                        f"library {lib_says}, Python {py_says}")


def _skew_cases(gen):
    """(label, R, sorted receivers) that put receivers on and across the
    balanced design's tiles: no edges at all, one receiver, one receiver of
    50,000 edges among small ones, long receivers that end exactly on tile
    boundaries, and the encoder's layout (a long band of empty rows, then a
    skewed band with 300-edge rows in its middle)."""
    from graphcast_lite_torch.ops import cuda_segment

    small = torch.sort(torch.randint(1, 3_000, (6_000,),
                                     generator=gen)).values
    # 256 receivers of a tile's items (edges and end), one whole tile each,
    # long enough not to be moved (E = 256 x (TILE_ITEMS - 1) rows, a
    # multiple of 128: no padding rows).
    edges = cuda_segment.TILE_ITEMS - 1
    exact = torch.arange(256).repeat_interleave(edges)
    band = torch.randint(0, 10, (20_000,), generator=gen)
    band[9_990:10_010] = 300
    grid = 131_072
    encoder = grid + torch.arange(20_000).repeat_interleave(band)
    return [
        ("E=0, R=50000", 50_000, torch.zeros(0, dtype=torch.int64)),
        ("R=1", 1, torch.zeros(777, dtype=torch.int64)),
        ("receiver with 50000 edges", 3_000,
         torch.cat([torch.zeros(50_000, dtype=torch.int64), small])),
        (f"{edges}-edge receivers, ends on tile ends, R=256", 256, exact),
        ("encoder-shaped: 131072 empty rows, skewed band", grid + 20_000,
         encoder),
    ]


def phase_kernel_cases():
    from graphcast_lite_torch.ops import cuda_segment

    _log("phase 1: segment_sum kernel vs plain version on the card "
         f"(fp32 {FP32_TOL}, bf16 {BF16_TOL}, order term "
         f"{ORDER_RTOL} * sum|msgs|)")
    _segment_design_check()
    _log(f"  segment_sum design selection: library and Python agree on fp32 "
         f"and bf16 at F in {{19, 64, 128, 256, 512, 1024}}, aligned or "
         f"not, and on tiles of {cuda_segment.TILE_ITEMS} merge items")
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for f in (19, 64, 256):
            m, ip = _sorted_case(gen, 60_000, 20_000, f, dtype)
            _check_kernel(f"random sorted E=60000 R=20000 F={f}", m, ip,
                          20_000)
        m, ip = _sorted_case(gen, 30_000, 9_000, 64, dtype, batch=3)
        _check_kernel("batched [3, E, 64]", m, ip, 9_000)
        m, ip = _sorted_case(gen, 0, 50_000, 19, dtype,
                             recv=torch.sort(torch.randint(
                                 20_000, 30_000, (3_001,),
                                 generator=gen)).values)
        _check_kernel("empty receivers + padding rows, F=19", m, ip, 50_000)
        hog = torch.cat([torch.zeros(2_500, dtype=torch.int64),
                         torch.sort(torch.randint(1, 4_000, (8_000,),
                                                  generator=gen)).values])
        m, ip = _sorted_case(gen, 0, 4_000, 256, dtype, recv=hog)
        _check_kernel("receiver with 2500 edges, F=256", m, ip, 4_000)
        for label, r, recv in _skew_cases(gen):
            for f in (19, 64, 256):
                m, ip = _sorted_case(gen, 0, r, f, dtype, recv=recv)
                _check_kernel(f"{label}, F={f}", m, ip, r)
            if "ends on tile ends" in label:
                split = cuda_segment.split_rows(ip).numel()
                if split:
                    raise AssertionError(f"{label}: {split} split rows")
            # PR 1's design on the same skew, and the balanced design twice
            # on the same inputs: bitwise equal.
            _check_kernel(f"{label}, F=256", m, ip, r, design="warp")
            first = cuda_segment.segment_sum(m, ip, r, "balanced")
            again = cuda_segment.segment_sum(m, ip, r, "balanced")
            if not torch.equal(first, again):
                raise AssertionError(f"{label}: two balanced launches differ")
        m, ip = _sorted_case(gen, 30_000, 9_000, 128, dtype, batch=3)
        _check_kernel("batched [3, E, 128]", m, ip, 9_000)
        first = cuda_segment.segment_sum(m, ip, 9_000)
        if not torch.equal(first, cuda_segment.segment_sum(m, ip, 9_000)):
            raise AssertionError("batched: two launches differ")
        _log(f"  {dtype}: two balanced launches bitwise equal on every skew "
             "case at F=256 and batched at F=128")


def _fused_case(gen, num_edges, num_receivers, hid, de, dtype, recv=None):
    """Inputs of both fused kernels on the card: receiver-sorted rows padded
    to a multiple of 128 onto receiver R-1 (mask 0), every 7th real edge
    pruned (mask 0); a and c in fp32."""
    from graphcast_lite_torch.graphs.structure import indptr_from_receivers

    if recv is None:
        recv = torch.sort(torch.randint(0, num_receivers, (num_edges,),
                                        generator=gen)).values
    e = recv.numel()
    e_pad = ((e + 127) // 128) * 128
    full = torch.full((e_pad,), num_receivers - 1, dtype=torch.int64)
    full[:e] = recv
    mask = torch.zeros(e_pad)
    mask[:e] = 1.0
    mask[:e:7] = 0.0

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    t = dict(h_pre=randn(e_pad, hid, scale=2.0), xsg=randn(e_pad, hid),
             v=randn(e_pad, de), xr=randn(num_receivers, hid),
             w1e=randn(de, hid, scale=0.1), b_eff=randn(hid, scale=0.1),
             w2=randn(hid, de, scale=0.1), b2=randn(de, scale=0.1),
             mask=mask)
    out = {k: x.to("cuda", dtype) for k, x in t.items()}
    out["a"] = (1.0 + randn(de, scale=0.1)).cuda()
    out["c"] = randn(de, scale=0.1).cuda()
    out["indptr"] = indptr_from_receivers(full, num_receivers).cuda()
    return out


def _close(label, out, ref, tol, extra=None) -> float:
    """Raise unless |out - ref| <= atol + rtol |ref| (+ extra) everywhere
    and out is finite; returns the max abs error."""
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{label}: non-finite kernel output")
    diff = (out - ref).abs()
    allowed = tol["atol"] + tol["rtol"] * ref.abs()
    if extra is not None:
        allowed = allowed + extra
    if (diff > allowed).any():
        worst = int(torch.argmax(diff - allowed))
        raise AssertionError(
            f"{label}: {int((diff > allowed).sum())} elements out of "
            f"tolerance; worst |err| {diff.flatten()[worst]:.3e} > "
            f"{allowed.flatten()[worst]:.3e} at flat index {worst} (kernel "
            f"{out.flatten()[worst]:.6e}, plain {ref.flatten()[worst]:.6e})")
    return diff.max().item()


def _mlp_design(dtype, hid, de) -> str:
    """The design the built edge_mlp library takes at these widths
    ("hopper" or "tile16"); raises unless it and its receivers per group
    agree with the wrapper's Python mirror."""
    from graphcast_lite_torch.ops import edge_mlp, nvcc_build

    lib = nvcc_build.load(edge_mlp.SOURCE, edge_mlp.SIGNATURES)
    code = nvcc_build.DTYPE_CODES[dtype]
    wgmma = bool(lib.gclt_edge_mlp_wgmma(code, hid, de))
    tile = lib.gclt_edge_mlp_tile_receivers(code, hid, de)
    if (wgmma != edge_mlp.wgmma_design(dtype, hid, de)
            or tile != edge_mlp.tile_receivers(dtype, hid, de)):
        raise AssertionError(
            f"edge_mlp {dtype} H={hid} De={de}: library says wgmma {wgmma}, "
            f"{tile} receivers; Python says "
            f"{edge_mlp.wgmma_design(dtype, hid, de)}, "
            f"{edge_mlp.tile_receivers(dtype, hid, de)}")
    return "hopper" if wgmma else "tile16"


def _check_edge_mlp(label, t, r, act="swish", design=None):
    """edge_mlp kernel against its plain version, and the design it took
    against ``design`` where given; returns the max abs error over u and
    agg."""
    from graphcast_lite_torch.ops import cuda_segment, edge_mlp

    args = (t["h_pre"], t["w2"], t["b2"], t["mask"], t["indptr"], r, act)
    hid, de = t["w2"].shape
    took = _mlp_design(t["h_pre"].dtype, hid, de)
    if design is not None and took != design:
        raise AssertionError(f"edge_mlp {label}: design {took}, expected "
                             f"{design}")
    u, agg = edge_mlp.edge_mlp(*args)
    u_ref, agg_ref = edge_mlp.edge_mlp_reference(*args)
    mag = cuda_segment.segment_sum_reference(
        u_ref.float().abs() * t["mask"].float()[:, None], t["indptr"], r)
    torch.cuda.synchronize()
    tol = FUSED_FP32_TOL if u.dtype == torch.float32 else FUSED_BF16_TOL
    err = max(_close(f"edge_mlp {label} u", u, u_ref, tol),
              _close(f"edge_mlp {label} agg", agg, agg_ref, tol,
                     ORDER_RTOL * mag))
    _log(f"  edge_mlp  {label:<46s} {str(u.dtype):<15s} max|err| "
         f"{err:.3e} ok ({took})")
    return err


def _check_edge_step(label, t, r, act="swish"):
    """edge_step kernel against its plain version; returns the max abs
    error over v_new and agg, and that of the stats."""
    from graphcast_lite_torch.ops import cuda_segment, edge_step

    args = (t["xsg"], t["v"], t["xr"], t["w1e"], t["b_eff"], t["w2"],
            t["b2"], t["a"], t["c"], t["mask"], t["indptr"], r, act)
    v_new, agg, stats = edge_step.edge_step(*args)
    v_ref, agg_ref, stats_ref = edge_step.edge_step_reference(*args)
    w = t["mask"].float()[:, None]
    u_mag = (v_ref.float() - t["a"] * t["v"].float() - t["c"]).abs() * w
    agg_mag = cuda_segment.segment_sum_reference(u_mag, t["indptr"], r)
    vf = v_ref.float()
    stats_mag = torch.stack([(vf.abs() * w).sum(), (vf.square() * w).sum(),
                             w.sum()])
    torch.cuda.synchronize()
    tol = FUSED_FP32_TOL if v_new.dtype == torch.float32 else FUSED_BF16_TOL
    err = max(_close(f"edge_step {label} v_new", v_new, v_ref, tol),
              _close(f"edge_step {label} agg", agg, agg_ref, tol,
                     ORDER_RTOL * agg_mag))
    stats_err = _close(f"edge_step {label} stats", stats, stats_ref,
                       dict(atol=0.0, rtol=0.0), STATS_RTOL * stats_mag)
    if stats.dtype != torch.float32 or stats[2].item() != stats_ref[2].item():
        raise AssertionError(f"edge_step {label}: row count {stats[2]} "
                             f"!= {stats_ref[2]}")
    _log(f"  edge_step {label:<46s} {str(v_new.dtype):<15s} max|err| "
         f"{err:.3e}, stats {stats_err:.3e} ok")
    return err, stats_err


def phase_fused_cases():
    _log("phase 1b: edge_mlp and edge_step kernels vs plain versions on the "
         f"card (fp32 {FUSED_FP32_TOL}, bf16 {FUSED_BF16_TOL}; aggregates "
         f"+ {ORDER_RTOL} * sum|u|, stats {STATS_RTOL} * sum of magnitudes)")
    from graphcast_lite_torch.ops import edge_mlp, nvcc_build

    lib = nvcc_build.load(edge_mlp.SOURCE, edge_mlp.SIGNATURES)
    for dtype in (torch.float32, torch.bfloat16):
        for hid in (128, 256, 384, 512):
            for de in (128, 256, 384, 512):
                _mlp_design(dtype, hid, de)
    _log("  edge_mlp width selection: library and Python agree on fp32 and "
         "bf16 at H, De in {128, 256, 384, 512}; shared memory a block: "
         + ", ".join(
             f"{str(dt)[6:]} {hid}x{de} "
             f"{lib.gclt_edge_mlp_smem(nvcc_build.DTYPE_CODES[dt], hid, de)}"
             f" ({_mlp_design(dt, hid, de)})"
             for dt, hid, de in ((torch.bfloat16, 128, 128),
                                 (torch.bfloat16, 128, 256),
                                 (torch.bfloat16, 256, 128),
                                 (torch.bfloat16, 256, 256),
                                 (torch.bfloat16, 384, 384),
                                 (torch.bfloat16, 384, 128),
                                 (torch.float32, 256, 256))))
    gen = torch.Generator().manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        for hid, de in ((128, 128), (256, 256), (128, 256)):
            label = f"E=60000 R=20001 H={hid} De={de}"
            t = _fused_case(gen, 60_000, 20_001, hid, de, dtype)
            _check_edge_mlp(label, t, 20_001)
            _check_edge_step(label, t, 20_001)
        t = _fused_case(gen, 0, 12_003, 256, 256, dtype,
                        recv=torch.sort(torch.randint(
                            5_000, 7_000, (20_001,), generator=gen)).values)
        label = "empty receivers + padding rows, R=12003"
        _check_edge_mlp(label, t, 12_003, "relu")
        _check_edge_step(label, t, 12_003, "relu")
        hog = torch.cat([torch.zeros(2_500, dtype=torch.int64),
                         torch.sort(torch.randint(1, 4_001, (9_000,),
                                                  generator=gen)).values])
        t = _fused_case(gen, 0, 4_001, 256, 256, dtype, recv=hog)
        label = "receiver with 2500 edges, R=4001"
        _check_edge_mlp(label, t, 4_001)
        _check_edge_step(label, t, 4_001)
        for label, r, recv in _tiling_cases(gen):
            t = _fused_case(gen, 0, r, 256, 256, dtype, recv=recv)
            _check_edge_mlp(label, t, r)
            _check_edge_step(label, t, r)
    # bf16 rows wider than the Hopper kernels' shared memory holds take the
    # 16-receiver wmma design (fp32 at these widths needs more than a block
    # may have).
    for hid, de in ((384, 384), (384, 128)):
        t = _fused_case(gen, 20_000, 6_001, hid, de, torch.bfloat16)
        label = f"E=20000 R=6001 H={hid} De={de}"
        _check_edge_mlp(label, t, 6_001, design="tile16")
        _check_edge_step(label, t, 6_001)


def _tiling_cases(gen):
    """(label, R, sorted receivers) that put receiver runs on and across
    the fused kernels' 64-row sub-tiles and receiver groups."""
    def seq(*runs):
        return torch.cat([torch.full((n,), r, dtype=torch.int64)
                          for r, n in runs])

    rand = torch.sort(torch.randint(4, 50, (300,), generator=gen)).values
    return [
        ("in-degree 1, R=4096", 4_096, torch.arange(4_096)),
        ("in-degrees 0 / 13 alternating, R=4001", 4_001,
         torch.arange(0, 4_001, 2).repeat_interleave(13)),
        ("receivers of exactly 64 and 128 rows, R=50", 50,
         torch.cat([seq((0, 64), (1, 128), (2, 5), (3, 64)), rand])),
        ("one receiver, R=1", 1, torch.zeros(300, dtype=torch.int64)),
        ("R=33", 33, torch.sort(torch.randint(0, 33, (700,),
                                              generator=gen)).values),
    ]


def phase_serve(workdir):
    """The flagship bf16 AR-4 serve through the port's entry points, on the
    default (reg-block) route.  Returns what the later phases reuse."""
    from graphcast_lite_torch import presets
    from graphcast_lite_torch.build import build_weather_model
    from graphcast_lite_torch.data.dataset import load_chunked_datasets
    from graphcast_lite_torch.data.synthetic import generate_synthetic_dataset
    from graphcast_lite_torch.inference.predict import evaluate_model
    from graphcast_lite_torch.training.rollout import RolloutSpec

    _log("phase 2: flagship 512x256 AR-4 bf16 serve "
         "(presets.interaction_net_512x256, seeded random weights), "
         "default route (reg-block)")
    cfg = presets.interaction_net_512x256()
    n_feat, obs = cfg.data.num_features_used, cfg.data.obs_window_used
    t0 = time.perf_counter()
    # 36 frames: 31 windows of obs 2 + AR 4, 4 of them in the test split.
    data_dir = generate_synthetic_dataset(
        os.path.join(workdir, "data"), n_time=36, n_lon=512, n_lat=256,
        n_feat=n_feat, static_channels=list(cfg.static_channels), seed=0)
    _, _, test_ds, meta = load_chunked_datasets(
        data_dir, obs_window=obs, pred_steps=AR_STEPS, n_features=n_feat)
    if len(test_ds) < REQUESTS:
        raise AssertionError(f"test split holds {len(test_ds)} samples")
    _log(f"  synthetic dataset: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    model, graphs, gs = build_weather_model(cfg, meta, device="cuda",
                                            seed=0)
    torch.cuda.synchronize()
    enc, proc = gs.encoding, gs.processing
    _log(f"  graphs + model: {time.perf_counter() - t0:.1f} s; "
         f"G2M E={enc.num_edges} E_pad={enc.padded_num_edges} "
         f"R={enc.num_receivers} max in-degree "
         f"{int(enc.static_in_degree.max())}; multimesh E={proc.num_edges} "
         f"E_pad={proc.padded_num_edges} R={proc.num_receivers} in-degree "
         f"{int(proc.static_in_degree.min())}-"
         f"{int(proc.static_in_degree.max())}; "
         f"params {sum(p.numel() for p in model.parameters())}")
    kw = dict(ar_steps=AR_STEPS, use_residual=cfg.use_residual,
              static_channels=tuple(cfg.static_channels), device="cuda",
              dtype="bf16")

    # Warm-up request (cuBLAS handles, the kernel library), not counted.
    evaluate_model(model, graphs, test_ds, meta, max_samples=1, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    preds_path = os.path.join(workdir, "preds.npz")
    _reset_launches()
    report = evaluate_model(model, graphs, test_ds, meta,
                            max_samples=REQUESTS,
                            save_predictions=preds_path, **kw)
    torch.cuda.synchronize()
    counts = _launches()
    peak = torch.cuda.max_memory_allocated()
    # The same requests again, timed without the compressed .npz write.
    t0 = time.perf_counter()
    evaluate_model(model, graphs, test_ds, meta, max_samples=REQUESTS, **kw)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0

    g = gs.num_grid_nodes
    preds = np.load(preds_path)["predictions"]
    if preds.shape != (REQUESTS, g, AR_STEPS * n_feat):
        raise AssertionError(f"predictions shape {preds.shape}")
    if not np.isfinite(preds).all():
        raise AssertionError("non-finite predictions")
    if report.num_samples != REQUESTS or not np.isfinite(report.rmse):
        raise AssertionError(f"report {report.num_samples} {report.rmse}")
    expected = {"segment_sum": 8 * REQUESTS, "edge_mlp": 0, "edge_step": 0}
    if counts != expected:
        raise AssertionError(f"launches {counts} for {REQUESTS} rollouts "
                             f"(expected {expected})")
    launches = counts["segment_sum"]
    _log(f"  {REQUESTS} requests: predictions {preds.shape} finite; "
         f"RMSE {report.rmse:.6f}, persistence {report.baseline_rmse:.6f}, "
         f"skill {report.skill * 100:.2f}% (random weights)")
    _log(f"  segment_sum launches: {launches} "
         f"({launches // REQUESTS} per rollout)")
    _log(f"  evaluate_model wall time per request (host clock, incl. data "
         f"loading and metrics): {wall_s / REQUESTS * 1e3:.1f} ms")

    spec = RolloutSpec(obs_window=obs, num_features=n_feat,
                       use_residual=cfg.use_residual, remat=False,
                       static_channels=tuple(cfg.static_channels))
    ctx = dict(model=model, graphs=graphs, gs=gs, test_ds=test_ds,
               meta=meta, kw=kw, spec=spec, request=test_ds.get(0))
    # Device time of one AR-4 rollout (CUDA events, after a warm-up).
    rollout, smodel = _rollout(ctx, torch.bfloat16)
    rollout_ms = _time_ms(rollout, iters=5, warmup=1)
    stages = _stage_ms(smodel, rollout)
    busy_ms, wall_ms, top = _profile(rollout)
    # The fp32 rollout (TF32 off) that every route's bf16 serve is held to.
    ctx["p32"] = _rollout(ctx, torch.float32)[0]().float()
    bf16_rel_rms = _rel_rms(rollout().float(), ctx["p32"], "reg-block")
    serve = {
        "rollout_ms": rollout_ms,
        "grid_points_per_s": g * AR_STEPS / (rollout_ms / 1e3),
        "peak_mem_bytes": peak,
        "wall_ms_per_request": wall_s / REQUESTS * 1e3,
        "launches": launches,
        "stage_ms": stages,
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "bf16_vs_fp32_rel_rms": bf16_rel_rms,
    }
    _log(f"  AR-4 rollout (CUDA events, mean of 5): {rollout_ms:.2f} ms; "
         f"{serve['grid_points_per_s']:.4g} grid-points/s "
         f"({g} points x {AR_STEPS} steps); peak allocated "
         f"{peak / 2**30:.3f} GiB")
    _log("  one rollout by stage (CUDA events around the model's encoder, "
         "processor and decoder; rest = rollout loop): "
         + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items()))
    _log(f"  torch.profiler, one rollout: device busy {busy_ms:.2f} ms of "
         f"{wall_ms:.2f} ms wall (idle share "
         f"{serve['device_idle_share']:.3f}); top kernels by device time:")
    for name, n, ms in top:
        _log(f"    {ms:9.3f} ms  {n:5d} calls  {name[:90]}")
    return ctx, serve


def _rollout(ctx, dtype):
    """(rollout, serving model): one AR-4 rollout of the flagship request
    in ``dtype`` on the card, through ``rollout_predict``."""
    from graphcast_lite_torch.inference.predict import serving_copy
    from graphcast_lite_torch.training.rollout import rollout_predict

    smodel, sgraphs = serving_copy(ctx["model"], ctx["graphs"],
                                   torch.device("cuda"), dtype)
    spec, (x, y) = ctx["spec"], ctx["request"]
    g, obs, c = x.shape[0], spec.obs_window, spec.num_features
    window = torch.from_numpy(x.reshape(g, obs, c)).to("cuda", dtype)
    forcing = torch.from_numpy(y.reshape(g, AR_STEPS, c)).to("cuda", dtype)

    def model_fn(inp, m, t, p):
        return smodel(inp, sgraphs)[0], None

    def rollout():
        with torch.inference_mode():
            return rollout_predict(model_fn, window, AR_STEPS, spec,
                                   forcing=forcing)

    return rollout, smodel


def _rel_rms(p16, p32, label):
    """Relative RMS distance, per AR step, of a bf16 rollout from the fp32
    rollout of the same weights on the same request; raises above
    BF16_SERVE_RTOL or on a non-finite value."""
    if not torch.isfinite(p16).all():
        raise AssertionError(f"{label}: non-finite bf16 rollout")
    rel = [(torch.linalg.vector_norm(p16[:, s] - p32[:, s])
            / torch.linalg.vector_norm(p32[:, s])).item()
           for s in range(AR_STEPS)]
    _log(f"  {label}: bf16 against the fp32 reg-block rollout (TF32 off), "
         "same weights and request, RMS(bf16 - fp32) / RMS(fp32) per AR "
         "step: " + ", ".join(f"{r:.4e}" for r in rel)
         + f" (tolerance {BF16_SERVE_RTOL:.4e})")
    if not all(np.isfinite(rel)) or max(rel) > BF16_SERVE_RTOL:
        raise AssertionError(f"{label}: bf16 serve off the fp32 rollout: "
                             f"{rel}")
    return rel


def phase_coo_serve(ctx):
    """One flagship bf16 request through ``evaluate_model`` on each COO
    route: exact launch counts, finite predictions, bf16 against the fp32
    reg-block rollout, rollout time and peak memory."""
    from graphcast_lite_torch.inference.predict import evaluate_model

    _log("phase 2b: flagship 512x256 AR-4 bf16 serve on the COO routes "
         "(one request each)")
    g = ctx["gs"].num_grid_nodes
    out = {}
    for route, (env, expected) in COO_ROUTES.items():
        with _route(env):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            report = evaluate_model(ctx["model"], ctx["graphs"],
                                    ctx["test_ds"], ctx["meta"],
                                    max_samples=1, **ctx["kw"])
            torch.cuda.synchronize()
            counts = _launches()
            peak = torch.cuda.max_memory_allocated()
            # A non-finite prediction makes the RMSE non-finite.
            if report.num_samples != 1 or not np.isfinite(report.rmse):
                raise AssertionError(f"{route}: report {report.num_samples} "
                                     f"{report.rmse}")
            if counts != expected:
                raise AssertionError(f"{route}: launches per rollout "
                                     f"{counts}, expected {expected}")
            rollout, smodel = _rollout(ctx, torch.bfloat16)
            rollout_ms = _time_ms(rollout, iters=5, warmup=1)
            stages = _stage_ms(smodel, rollout)
            busy_ms, wall_ms, top = _profile(rollout, top_n=3)
            rel = _rel_rms(rollout().float(), ctx["p32"], route)
        out[route] = {
            "switches": env, "launches_per_rollout": counts,
            "rollout_ms": rollout_ms,
            "grid_points_per_s": g * AR_STEPS / (rollout_ms / 1e3),
            "peak_mem_bytes": peak, "stage_ms": stages,
            "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "bf16_vs_fp32_rel_rms": rel, "rmse": report.rmse,
        }
        _log(f"  {route} {env}: launches per rollout {counts}; RMSE "
             f"{report.rmse:.6f} (finite); rollout {rollout_ms:.2f} ms, "
             f"{out[route]['grid_points_per_s']:.4g} grid-points/s, peak "
             f"allocated {peak / 2**30:.3f} GiB; by stage "
             + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items()))
        _log(f"    torch.profiler, one rollout: device busy {busy_ms:.2f} ms "
             f"of {wall_ms:.2f} ms wall (idle share "
             f"{out[route]['device_idle_share']:.3f}); top kernels: "
             + "; ".join(f"{name[:40]} {n} calls {ms:.2f} ms"
                         for name, n, ms in top))
    return out


def _stage_ms(model, run):
    """Device ms of the encoder, processor and decoder over one run, from
    CUDA events recorded by forward hooks; ``rest`` is the remainder."""
    events = {name: [] for name in ("encoder", "processor", "decoder")}
    handles = []
    for name, evs in events.items():
        mod = getattr(model, name)

        def pre(_m, _args, evs=evs):
            evs.append([torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True)])
            evs[-1][0].record()

        def post(_m, _args, _out, evs=evs):
            evs[-1][1].record()

        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    out = {name: sum(a.elapsed_time(b) for a, b in evs)
           for name, evs in events.items()}
    out["rest"] = start.elapsed_time(end) - sum(out.values())
    return out


def _profile(run, top_n=12):
    """(device busy ms, wall ms, [(kernel, calls, device ms)]) of one run
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    top = [(e.key, e.count, e.self_device_time_total / 1e3)
           for e in kernels[:top_n]]
    return busy_ms, wall_ms, top


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _time_segment_sum(label, msgs, indptr, r):
    """The segment sum at one flagship shape: checked against the plain
    version in both designs, the design the library picks timed against
    its bound, PR 1's warp-per-row design (in turns: picked, warp, warp,
    picked), the plain version and one PyTorch call."""
    from graphcast_lite_torch.ops import cuda_segment

    design = cuda_segment.segment_design(msgs.dtype, msgs.shape[1])
    err = _check_kernel(f"{label} E_pad={msgs.shape[0]} R={r} "
                        f"F={msgs.shape[1]}", msgs, indptr, r)
    _check_kernel(f"{label} (warp design)", msgs, indptr, r, design="warp")
    # 50 launches a timing, as scripts/torch_segment_split.py times them:
    # the two designs differ by a few percent at the processor shape.
    picked = []
    warp = []
    for times in (picked, warp, warp, picked):
        which = design if times is picked else "warp"
        times.append(_time_ms(lambda: cuda_segment.segment_sum(
            msgs, indptr, r, which), iters=50, warmup=10))
    ms = sum(picked) / 2
    plain_ms = _time_ms(
        lambda: cuda_segment.segment_sum_reference(msgs, indptr, r))
    # The yardstick: one PyTorch call computing the same function.
    lengths = (indptr[1:] - indptr[:-1]).long()
    library_call = "torch.segment_reduce(msgs, 'sum', lengths)"
    library_ms = _time_ms(lambda: torch.segment_reduce(
        msgs, "sum", lengths=lengths, axis=0))
    nbytes = _nbytes(msgs, indptr) + r * msgs.shape[1] * msgs.element_size()
    bound_ms, bound_by = _bound(nbytes, msgs.numel())
    _log(f"  segment_sum {label}: {design} kernel "
         + ", ".join(f"{t * 1e3:.1f}" for t in picked)
         + " us (fraction " + ", ".join(f"{bound_ms / t:.3f}" for t in picked)
         + ") | warp-per-row kernel (PR 1) "
         + ", ".join(f"{t * 1e3:.1f}" for t in warp)
         + " us (fraction " + ", ".join(f"{bound_ms / t:.3f}" for t in warp)
         + f") | bound {bound_ms * 1e3:.1f} us ({bound_by}; "
         f"{nbytes / 1e6:.1f} MB) | plain {plain_ms * 1e3:.1f} us | "
         f"{library_call} {library_ms * 1e3:.1f} us")
    return {"max_abs_err": err, "ms": ms, "ms_runs": picked,
            "design": design, "earlier_ms": sum(warp) / 2,
            "earlier_ms_runs": warp, "earlier_design": "warp",
            "fraction_of_bound": bound_ms / ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_call": library_call}


def phase_kernel_flagship(gs, n_feat):
    """Each kernel at its flagship shapes in bf16: the segment sum at the
    encoder shape (the default route), at the processor shape (the COO
    composed route) and at the sender-sorted scatters of the train step's
    backward, the fused kernels at the processor shape."""
    from graphcast_lite_torch.ops import edge_mlp, edge_step

    _log("phase 3: kernel times at the flagship shapes, bf16 (CUDA events; "
         f"bound = max(bytes / {HBM_BYTES_PER_S:.3g} B/s, operations / "
         f"{BF16_TC_FLOPS:.3g} FLOP/s))")
    gen = torch.Generator().manual_seed(1)
    enc = gs.encoding.to("cuda")
    msgs = (torch.randn(enc.padded_num_edges, 256, generator=gen)
            * enc.edge_mask.cpu()[:, None]).to("cuda", torch.bfloat16)
    seg_enc = _time_segment_sum("flagship G2M", msgs, enc.indptr,
                                enc.num_receivers)

    proc = gs.processing.to("cuda", torch.bfloat16)
    r, e_pad, hid = proc.num_receivers, proc.padded_num_edges, 256
    t = _fused_case(gen, 0, r, hid, hid, torch.bfloat16,
                    recv=gs.processing.receivers.long())
    t["mask"] = proc.edge_mask
    mask2 = t["mask"][:, None]
    seg_proc = _time_segment_sum("flagship multimesh", (t["v"] * mask2),
                                 t["indptr"], r)
    seg_send = {}
    for label, perm, indptr, rows, n, f in _sender_csrs(gs, n_feat):
        seg_send[label] = _time_segment_sum(
            label, _sender_msgs(gen, perm, rows, f, torch.bfloat16),
            indptr.to("cuda"), n)

    label = f"flagship multimesh E_pad={e_pad} R={r} H=De={hid}"
    mlp_err = _check_edge_mlp(label, t, r, design="hopper")
    mlp_args = (t["h_pre"], t["w2"], t["b2"], t["mask"], t["indptr"], r,
                "swish")
    mlp_bytes = _nbytes(t["h_pre"], t["w2"], t["b2"], t["mask"],
                        t["indptr"]) + (e_pad + r) * hid * 2
    mlp_bound, mlp_by = _bound(mlp_bytes, 2 * e_pad * hid * hid)
    mlp = {"max_abs_err": mlp_err,
           "ms": _time_ms(lambda: edge_mlp.edge_mlp(*mlp_args)),
           "plain_ms": _time_ms(lambda: edge_mlp.edge_mlp_reference(
               *mlp_args), iters=5, warmup=1),
           "bound_ms": mlp_bound, "bound_by": mlp_by, "design": "hopper"}
    mlp["fraction_of_bound"] = mlp["bound_ms"] / mlp["ms"]

    step_err, stats_err = _check_edge_step(label, t, r)
    step_args = (t["xsg"], t["v"], t["xr"], t["w1e"], t["b_eff"], t["w2"],
                 t["b2"], t["a"], t["c"], t["mask"], t["indptr"], r,
                 "swish")
    step_bytes = _nbytes(*step_args[:11]) + (e_pad + r) * hid * 2 + 3 * 4
    step_bound, step_by = _bound(step_bytes, 4 * e_pad * hid * hid)
    step = {"max_abs_err": step_err, "stats_abs_err": stats_err,
            "ms": _time_ms(lambda: edge_step.edge_step(*step_args)),
            "plain_ms": _time_ms(lambda: edge_step.edge_step_reference(
                *step_args), iters=5, warmup=1),
            "bound_ms": step_bound, "bound_by": step_by}
    step["fraction_of_bound"] = step["bound_ms"] / step["ms"]
    for name, k, nbytes in (("edge_mlp", mlp, mlp_bytes),
                            ("edge_step", step, step_bytes)):
        k.update(library_ms=None, library_call=None)
        _log(f"  {name}: kernel {k['ms'] * 1e3:.1f} us | bound "
             f"{k['bound_ms'] * 1e3:.1f} us ({k['bound_by']}; "
             f"{nbytes / 1e6:.1f} MB) | plain {k['plain_ms'] * 1e3:.1f} us "
             "| no single PyTorch call computes this fused function")
    _log(f"  edge_step: bound / kernel = {step['fraction_of_bound']:.4f}; "
         f"earlier (wmma) kernel {EDGE_STEP_EARLIER_MS * 1e3:.1f} us")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = edge_mlp.subtiles_per_block(t["indptr"], sms)
    groups, blocks = edge_mlp.hopper_geometry(r, sms)
    _log(f"  edge_mlp: design {mlp['design']} (W2 resident, wgmma, "
         f"persistent blocks); bound / kernel = "
         f"{mlp['fraction_of_bound']:.4f}; earlier (16-receiver wmma) kernel "
         + ", ".join(f"{ms * 1e3:.1f}" for ms in EDGE_MLP_EARLIER_MS)
         + f" us; {groups} groups of {edge_mlp.HOPPER_RECEIVERS} receivers "
         f"on {blocks} blocks: {int(tiles.sum())} sub-tiles, "
         f"{int(tiles.max())} on the busiest block, "
         f"{tiles.float().mean().item():.1f} on average")
    return seg_enc, seg_proc, seg_send, mlp, step


def phase_numerics():
    """The 64x32 flagship architecture, fp32: card against CPU, on the
    reg-block route and on each COO route."""
    import copy

    from graphcast_lite_torch import presets
    from graphcast_lite_torch.graphs.build import build_graph_set
    from graphcast_lite_torch.models.weather import ModelGraphs, WeatherModel
    from graphcast_lite_torch.training.rollout import RolloutSpec, \
        rollout_predict

    _log("phase 4: 64x32 flagship architecture, fp32, card vs CPU, AR-4 "
         f"(matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
         f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, {E2E_TOL})")
    cfg = presets.interaction_net_64x32()
    lat, lon = presets.wb2_64x32_grid()
    gs = build_graph_set(lat, lon, cfg.graph.mesh_levels,
                         cfg.graph.grid2mesh_radius_query)
    c, obs = cfg.data.num_features_used, cfg.data.obs_window_used
    g = gs.num_grid_nodes
    model = WeatherModel(cfg.pipeline, cfg.data, g, gs.num_mesh_nodes,
                         generator=torch.Generator().manual_seed(0)).eval()
    graphs = ModelGraphs.from_graph_set(gs)
    rng = np.random.RandomState(0)
    window = torch.from_numpy(rng.randn(g, obs, c).astype(np.float32))
    spec = RolloutSpec(obs_window=obs, num_features=c, remat=False)

    def run(device):
        m = copy.deepcopy(model).to(device)
        gr = graphs.to(device)

        def model_fn(inp, mask, t, p):
            return m(inp, gr)[0], None

        with torch.inference_mode():
            out = rollout_predict(model_fn, window.to(device), AR_STEPS, spec)
        return out.cpu()

    routes = {"reg-block": ({}, {"segment_sum": 8, "edge_mlp": 0,
                                 "edge_step": 0})}
    routes.update(COO_ROUTES)
    for name, (env, expected) in routes.items():
        with _route(env):
            _reset_launches()
            card = run("cuda")
            counts = _launches()
            cpu = run("cpu")
        if card.shape != (g, AR_STEPS, c) or not torch.isfinite(card).all():
            raise AssertionError(f"{name}: card output {tuple(card.shape)} "
                                 "not finite")
        if counts != expected:
            raise AssertionError(f"{name}: launches {counts}, expected "
                                 f"{expected}")
        err = (card - cpu).abs().max().item()
        torch.testing.assert_close(card, cpu, **E2E_TOL)
        _log(f"  {name}: output {tuple(card.shape)}; launches {counts}; "
             f"max|card - cpu| {err:.3e} ok")


def _sender_csrs(gs, n_feat):
    """(label, perm, indptr, message rows, R, F) of the sender-sorted
    scatters in the flagship train step's backward: the reg-edge unit's
    sender scatter and the encoder's and decoder's GCNConv gather adjoints
    (the decoder's second conv at the output width ``n_feat``)."""
    rb = gs.processing.reg_blocks
    enc, dec = gs.encoding, gs.decoding
    return [
        ("reg-edge sender scatter F=256", rb.s_perm, rb.s_indptr,
         rb.rows_padded, rb.num_nodes, 256),
        ("encoder GCN gather adjoint F=256", enc.s_perm, enc.s_indptr,
         enc.padded_num_edges, enc.num_nodes, 256),
        ("decoder GCN gather adjoint F=256", dec.s_perm, dec.s_indptr,
         dec.padded_num_edges, dec.num_nodes, 256),
        (f"decoder GCN gather adjoint F={n_feat}", dec.s_perm,
         dec.s_indptr, dec.padded_num_edges, dec.num_nodes, n_feat),
    ]


def _sender_msgs(gen, perm, rows, f, dtype):
    """Random cotangent rows [rows, F] put in sender order on the card, as
    the backward builds them (an ``index_select`` by the sort)."""
    g = torch.randn(rows, f, generator=gen).to("cuda", dtype)
    return g.index_select(0, perm.to("cuda"))


def phase_sender_scatter_cases(gs, n_feat):
    """5a: the segment sum against its plain version, fp32 and bf16, on the
    sender-sorted CSRs of the flagship graphs, and two launches bitwise
    equal."""
    from graphcast_lite_torch.ops import cuda_segment

    _log("phase 5a: segment_sum on the train step's sender-sorted CSRs "
         "(permuted cotangent rows), fp32 and bf16")
    gen = torch.Generator().manual_seed(5)
    for label, perm, indptr, rows, r, f in _sender_csrs(gs, n_feat):
        deg = indptr[1:] - indptr[:-1]
        _log(f"  {label}: {rows} rows into R={r}; out-degree max "
             f"{int(deg.max())}, {int((deg == 0).sum())} empty rows")
        ip = indptr.to("cuda")
        for dtype in (torch.float32, torch.bfloat16):
            msgs = _sender_msgs(gen, perm, rows, f, dtype)
            _check_kernel(f"{label} F={f}", msgs, ip, r)
            first = cuda_segment.segment_sum(msgs, ip, r)
            if not torch.equal(first, cuda_segment.segment_sum(msgs, ip, r)):
                raise AssertionError(f"{label} {dtype}: two launches differ")


def _train_launches(model, graphs) -> dict:
    """The segment-sum launches one AR-4 train step (BPTT, a checkpoint per
    AR step) should make, by the CSR and shape the wrapper counts them at
    (``cuda_segment.launches_by_csr``): label -> [key, count].  Per AR
    step: each encoder GCNConv aggregates over the receiver CSR in the
    forward and again in the recompute (the decoder's constant in-degree
    aggregation is a reshape-sum); each reg-block processor step scatters
    over its senders' CSR; each GCNConv of the encoder and the decoder
    takes its gather adjoint over its graph's senders' CSR."""
    enc, dec = graphs.encoding, graphs.decoding
    rb = graphs.processing.reg_blocks
    if dec.const_in_degree <= 0:
        raise AssertionError("decoder graph without constant in-degree")
    out = {}

    def add(label, indptr, r, e, f, n):
        entry = out.setdefault(f"{label} F={f}",
                               [(indptr.data_ptr(), r, e, f), 0])
        entry[1] += AR_STEPS * n

    def widths(layer):
        return [getattr(layer, f"conv_{i}").kernel.shape[1]
                for i in range(layer.num_convs)]

    for f in widths(model.encoder.graph_layer):
        add("encoder aggregation (forward + recompute)", enc.indptr,
            enc.num_receivers, enc.padded_num_edges, f, 2)
    for s in model.processor.graph_layer.inet.steps:
        add("reg-edge sender scatter", rb.s_indptr, rb.num_nodes,
            rb.rows_padded, s.hidden_dim, 1)
    for f in widths(model.encoder.graph_layer):
        add("encoder GCN gather adjoint", enc.s_indptr, enc.num_nodes,
            enc.padded_num_edges, f, 1)
    for f in widths(model.decoder.graph_layer):
        add("decoder GCN gather adjoint", dec.s_indptr, dec.num_nodes,
            dec.padded_num_edges, f, 1)
    return out


def _csr_launches(expected: dict) -> dict:
    """The segment-sum launches counted since the last reset, by the labels
    of ``expected`` (``_train_launches``); raises on launches at a CSR or
    shape that ``expected`` does not name."""
    from graphcast_lite_torch.ops import cuda_segment

    counted = dict(cuda_segment.launches_by_csr)
    got = {label: counted.pop(key, 0) for label, (key, _) in expected.items()}
    if counted:
        raise AssertionError(f"segment_sum launched at unexpected CSRs or "
                             f"shapes (indptr, R, E, F): {counted}")
    return got


def _grads(model):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().cpu() for n, p in model.named_parameters()}


def phase_train_numerics():
    """5b: the 64x32 flagship architecture's fp32 train step (TF32 off) on
    the card against the CPU: loss and every gradient; then the card's Adam
    update against the closed form of a first Adam step on its own
    gradients."""
    import copy

    from graphcast_lite_torch import presets
    from graphcast_lite_torch.graphs.build import build_graph_set
    from graphcast_lite_torch.models.weather import ModelGraphs, WeatherModel
    from graphcast_lite_torch.training.loss import lat_weights_from_axis
    from graphcast_lite_torch.training.rollout import RolloutSpec
    from graphcast_lite_torch.training.trainer import make_train_step

    _log("phase 5b: 64x32 flagship architecture, fp32 AR-4 train step, card "
         f"vs CPU (loss rtol {TRAIN_LOSS_RTOL}, each gradient "
         f"{TRAIN_GRAD_RTOL} x its largest + 1e-6)")
    cfg = presets.interaction_net_64x32()
    lat, lon = presets.wb2_64x32_grid()
    gs = build_graph_set(lat, lon, cfg.graph.mesh_levels,
                         cfg.graph.grid2mesh_radius_query)
    c, obs, g = (cfg.data.num_features_used, cfg.data.obs_window_used,
                 gs.num_grid_nodes)
    model = WeatherModel(cfg.pipeline, cfg.data, g, gs.num_mesh_nodes,
                         generator=torch.Generator().manual_seed(0))
    graphs = ModelGraphs.from_graph_set(gs)
    spec = RolloutSpec(obs_window=obs, num_features=c,
                       use_residual=cfg.use_residual, remat=True)
    rng = np.random.RandomState(0)
    x = rng.randn(1, g, obs * c).astype(np.float32)
    y = rng.randn(1, g, AR_STEPS * c).astype(np.float32)
    lw = lat_weights_from_axis(len(lat), len(lon))
    out = {}
    for device in ("cuda", "cpu"):
        m = copy.deepcopy(model)
        step = make_train_step(m, graphs, spec, cfg, device=device,
                               lat_weights=lw)
        parts = _train_launches(m, step.graphs)
        before = {n: p.detach().cpu().clone()
                  for n, p in m.named_parameters()}
        _reset_launches()
        loss = step(x, y).item()
        counts = dict(_launches(), by_csr=_csr_launches(parts))
        out[device] = (loss, _grads(m), before,
                       {n: p.detach().cpu() for n, p in m.named_parameters()},
                       counts, parts)
    loss, grads, before, after, counts, parts = out["cuda"]
    loss_cpu, grads_cpu = out["cpu"][:2]
    by_csr = {label: n for label, (_, n) in parts.items()}
    expected = sum(by_csr.values())
    if counts != {"segment_sum": expected, "edge_mlp": 0, "edge_step": 0,
                  "by_csr": by_csr}:
        raise AssertionError(f"64x32 train step launches {counts}, expected "
                             f"{expected} segment sums ({by_csr})")
    if not (np.isfinite(loss)
            and abs(loss - loss_cpu) <= TRAIN_LOSS_RTOL * abs(loss_cpu)):
        raise AssertionError(f"64x32 train loss card {loss} cpu {loss_cpu}")
    worst = (0.0, "")
    for name, ref in grads_cpu.items():
        got = grads[name]
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite card gradient")
        err = (got - ref).abs().max().item()
        tol = TRAIN_GRAD_RTOL * ref.abs().max().item() + 1e-6
        if err > tol:
            raise AssertionError(f"{name}: card gradient off the CPU's by "
                                 f"{err:.3e} > {tol:.3e}")
        worst = max(worst, (err / tol, name))
    # A first Adam step moves each parameter by lr * g / (|g| + eps); the
    # fp32 result rounds it once more (2^-23 relative).
    lr, eps = cfg.learning_rate, 1e-8
    adam_err = 0.0
    for name, p0 in before.items():
        g64 = grads[name].double()
        expect = p0.double() - lr * g64 / (g64.abs() + eps)
        err = (after[name].double() - expect).abs()
        if (err > 1e-4 * lr + 2.0 ** -23 * expect.abs()).any():
            raise AssertionError(f"{name}: card Adam step off its closed "
                                 f"form by {err.max().item():.3e}")
        adam_err = max(adam_err, err.max().item())
    _log(f"  loss card {loss:.7f} cpu {loss_cpu:.7f}; {len(grads)} gradients, "
         f"largest error {worst[0]:.3f} of its tolerance ({worst[1]}); "
         f"segment_sum launches {expected}; Adam step within "
         f"{adam_err:.2e} of lr * g / (|g| + eps) (lr {lr})")
    return {"loss_card": loss, "loss_cpu": loss_cpu,
            "worst_grad_err_of_tol": worst[0], "worst_grad_leaf": worst[1],
            "adam_max_abs_err": adam_err, "launches": expected}


def phase_train(ctx):
    """5c: the flagship 512x256 train step in bf16 mixed precision through
    ``make_train_step`` on the default route: TRAIN_STEPS steps on one
    seeded batch; exact launch counts each step; the loss falls; step and
    forward-loss times, peak memory and one profiled step."""
    from graphcast_lite_torch import presets
    from graphcast_lite_torch.training.loss import channel_mask, \
        lat_weights_from_axis
    from graphcast_lite_torch.training.rollout import RolloutSpec
    from graphcast_lite_torch.training.trainer import make_train_step

    cfg = presets.interaction_net_512x256()
    cfg.tpu.compute_dtype = "bfloat16"
    n_feat, obs = cfg.data.num_features_used, cfg.data.obs_window_used
    meta, model, graphs = ctx["meta"], ctx["model"], ctx["graphs"]
    _log("phase 5c: flagship 512x256 AR-4 train step (BPTT, a checkpoint "
         "per AR step, Adam at lr "
         f"{cfg.learning_rate}), bf16 compute against fp32 masters, default "
         f"route, {TRAIN_STEPS} steps on one seeded batch")
    spec = RolloutSpec(obs_window=obs, num_features=n_feat,
                       use_residual=cfg.use_residual,
                       remat=cfg.tpu.remat_rollout,
                       static_channels=tuple(cfg.static_channels),
                       forcing_channels=tuple(cfg.forcing_channels))
    step = make_train_step(
        model, graphs, spec, cfg, device="cuda",
        lat_weights=lat_weights_from_axis(meta.num_latitudes,
                                          meta.num_longitudes),
        chan_mask=channel_mask(n_feat, cfg.static_channels,
                               cfg.forcing_channels))
    x, y = (torch.from_numpy(a[None]).cuda() for a in ctx["request"])
    parts = _train_launches(model, step.graphs)
    by_csr = {label: n for label, (_, n) in parts.items()}
    expected = {"segment_sum": sum(by_csr.values()), "edge_mlp": 0,
                "edge_step": 0, "by_csr": by_csr}
    losses, step_ms, step_counts = [], [], []
    busy_ms = wall_ms = top = None
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        if i == TRAIN_STEPS - 1:
            holder = []
            busy_ms, wall_ms, top = _profile(
                lambda: holder.append(step(x, y)))
            loss = holder[0]
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(x, y)
            end.record()
            torch.cuda.synchronize()
            if i > 0:
                step_ms.append(start.elapsed_time(end))
        if i == TRAIN_STEPS - 2:
            peak = torch.cuda.max_memory_allocated()
        counts = dict(_launches(), by_csr=_csr_launches(parts))
        if counts != expected:
            raise AssertionError(f"train step {i}: launches {counts}, "
                                 f"expected {expected}")
        step_counts.append(counts)
        losses.append(loss.item())
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train loss did not fall: {losses}")
    _reset_launches()
    fwd_ms = _time_ms(lambda: step.forward_loss(x, y), iters=3, warmup=1)
    fwd_launches = _launches()["segment_sum"] // 4
    ms = sum(step_ms) / len(step_ms)
    g = ctx["gs"].num_grid_nodes
    train = {
        "train_step_ms": ms, "train_step_ms_runs": step_ms,
        "train_grid_points_per_s": g * AR_STEPS / (ms / 1e3),
        "forward_loss_ms": fwd_ms, "peak_mem_bytes": peak,
        "losses": losses, "launches_per_step": step_counts[-1],
        "segment_sum_launches_by_csr": step_counts[-1]["by_csr"],
        "forward_loss_segment_sum_launches": fwd_launches,
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
    }
    _log("  losses (before each update): "
         + ", ".join(f"{v:.6f}" for v in losses))
    _log(f"  segment_sum launches counted in each step: "
         f"{step_counts[-1]['segment_sum']} ("
         + ", ".join(f"{k} {v}" for k, v in step_counts[-1]["by_csr"].items())
         + "); edge_step and edge_mlp 0")
    _log(f"  train step (CUDA events, steps 2-{TRAIN_STEPS - 1}): "
         + ", ".join(f"{t:.2f}" for t in step_ms)
         + f" ms, mean {ms:.2f} ms; {train['train_grid_points_per_s']:.4g} "
         f"grid-points/s ({g} points x {AR_STEPS} steps); forward loss "
         f"{fwd_ms:.2f} ms ({fwd_launches} segment sums); peak allocated "
         f"{peak / 2**30:.3f} GiB")
    _log(f"  torch.profiler, one train step: device busy {busy_ms:.2f} ms of "
         f"{wall_ms:.2f} ms wall (idle share "
         f"{train['device_idle_share']:.3f}); top kernels by device time:")
    for name, n, t in top:
        _log(f"    {t:9.3f} ms  {n:5d} calls  {name[:90]}")
    return train


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from graphcast_lite_torch.ops import nvcc_build

    # fp32 products in full fp32 everywhere (the plain versions included).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    _log(smi)
    _log(f"python {sys.version.split()[0]} | torch {torch.__version__} | "
         f"cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    mods = _kernel_modules()
    t0 = time.perf_counter()
    libs = nvcc_build.build(*(m.SOURCE for m in mods.values()))
    _log(f"kernel build (one nvcc per source, in parallel): "
         f"{time.perf_counter() - t0:.1f} s -> "
         + ", ".join(os.path.relpath(p) for p in libs))

    phase_kernel_cases()
    phase_fused_cases()
    with tempfile.TemporaryDirectory() as workdir:
        ctx, serve = phase_serve(workdir)
        serve["coo_routes"] = phase_coo_serve(ctx)
    n_feat = ctx["spec"].num_features
    seg_enc, seg_proc, seg_send, mlp, step = phase_kernel_flagship(
        ctx["gs"], n_feat)
    phase_numerics()
    phase_sender_scatter_cases(ctx["gs"], n_feat)
    train = phase_train_numerics()
    train = dict(phase_train(ctx), card_vs_cpu_64x32=train)

    coo = serve["coo_routes"]
    # Launches counted in a train step at each sender-sorted CSR and shape.
    by_csr = train["segment_sum_launches_by_csr"]
    if set(seg_send) - set(by_csr):
        raise AssertionError(f"timed sender shapes {sorted(seg_send)} not "
                             f"all launched in the train step {by_csr}")
    seg = dict(seg_enc, launches=serve["launches"],
               launches_per_rollout=serve["launches"] // REQUESTS,
               launches_per_train_step=train["launches_per_step"][
                   "segment_sum"],
               at_processor_shape=dict(
                   seg_proc, route="composed",
                   launches_per_rollout=coo["composed"][
                       "launches_per_rollout"]["segment_sum"]),
               at_sender_scatter={
                   label: dict(k, launches_per_train_step=by_csr[label])
                   for label, k in seg_send.items()})
    kernels = [("segment_sum", "segment_sum.cu", "pallas_segment.py:372",
                seg)]
    for name, src, tpu, k in (
            ("edge_mlp", "edge_mlp.cu", "pallas_edge_mlp.py:198", mlp),
            ("edge_step", "edge_step.cu", "pallas_edge_step.py:365", step)):
        n = coo["mega" if name == "edge_mlp" else "edge_step"][
            "launches_per_rollout"][name]
        kernels.append((name, src, tpu, dict(
            k, launches=n, launches_per_rollout=n,
            launches_per_train_step=train["launches_per_step"][name],
            library_note="no single PyTorch call computes this fused "
                         "function")))
    _log(json.dumps({"serve": serve}))
    _log(json.dumps({"train": train}))
    _log(json.dumps({"kernels": [dict({
        "name": name,
        "route": "cuda",
        "source": f"graphcast_lite_torch/csrc/{src}",
        "replaces": f"graphcast_lite_tpu/ops/{tpu}",
    }, **k) for name, src, tpu, k in kernels]}))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
