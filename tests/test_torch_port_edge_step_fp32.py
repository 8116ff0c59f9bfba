"""The arithmetic of the fp32 edge-step kernel (``csrc/edge_step.cu``, the
``hopper_fp32`` design) emulated in plain torch on the CPU.

The kernel forms both products in 3xTF32 on the tensor cores (v @ W1e,
then act(h) @ W2), each as ``torch_port_common.tf32x3_product`` emulates
the fp32 edge MLP's one: both operands split by ``edge_mlp.tf32_split``,
``a_s b_b``, ``a_b b_s`` and ``a_b b_b`` added per k8 step into one fp32
accumulator.  Around them it keeps the plain version's rounding points:
h = ((xsg + xr[recv]) + p) + b_eff and its activation in fp32, u = p2 +
b2, v' = (a v + c) + u with no fused multiply-add, and ``agg`` the fp32 sum
of u * mask by receiver in row order, a receiver whose rows cross a block's
128-row step adding its carried partial sum first (``kernel_agg``).  On
seeded inputs at a small CSR with empty receivers and padding rows it
holds:

* each product's error against an fp64 oracle at no more than twice that
  of the plain fp32 product (``edge_step_reference``'s), per element
  relative to the sum of the terms' magnitudes;
* v' and agg within chip_smoke.py's ``FUSED_FP32_TOL`` of the plain
  version (the aggregates + ``ORDER_RTOL`` times the sum of their rows'
  |u|, as on the card) and the statistics within ``STATS_RTOL`` of their
  magnitudes, also with h up to about |h| = 30 and W1e's and W2's columns
  scaled by 2^10 and 2^-10 (atol in each output column's unit: scaling W2's
  column by a power of two scales u's exactly).

The emulation adds in IEEE fp32; the card's tensor cores round their sums
otherwise, and on the card the kernel's error against float64 is several
times the plain fp32 version's (chip_smoke.py measures and prints it;
PERF.md).  So the first point holds for the emulated arithmetic only:
chip_smoke.py holds the kernel itself to the plain version at the same
tolerances.
"""

import os
import sys

import numpy as np
import pytest
import torch

from graphcast_lite_torch.graphs.structure import indptr_from_receivers
from graphcast_lite_torch.ops import cuda_segment, edge_mlp, edge_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from chip_smoke import FUSED_FP32_TOL, ORDER_RTOL, STATS_RTOL  # noqa: E402
from torch_port_common import tf32x3_product  # noqa: E402
from torch_port_common import \
    one_torch_thread  # noqa: F401 (an autouse fixture)

WIDTHS = [(128, 128), (256, 256), (128, 256), (256, 128)]
R = 160
BLOCKS = 3  # the persistent blocks kernel_agg splits the rows into


def make_case(seed, e, hid, de, scaled=False):
    """Receiver-sorted rows on R receivers, receivers [R/4, R/2) empty,
    padded to a multiple of 128 onto receiver R-1 (mask 0), every 7th real
    edge pruned; a and c as the lazy LayerNorm's affine.  ``scaled``: h up
    to about |h| = 30 (xsg and xr times 5, clipped to +-12) and W1e's
    columns 0, 4, 8, ... times 2^10 and 1, 5, 9, ... times 2^-10 (and all
    of W1e times 2^-10), W2's and b2's columns the same way (``unit``, the
    output columns' scale; ones otherwise)."""
    rng = np.random.RandomState(seed)
    recv = rng.randint(0, R - R // 4, e)
    recv[recv >= R // 4] += R // 4
    recv = np.sort(recv)
    e_pad = -(-e // 128) * 128
    full = np.full(e_pad, R - 1, np.int64)
    full[:e] = recv
    mask = np.zeros(e_pad, np.float32)
    mask[:e] = 1.0
    mask[:e:7] = 0.0
    a = dict(xsg=rng.randn(e_pad, hid), v=rng.randn(e_pad, de),
             xr=rng.randn(R, hid), w1e=rng.randn(de, hid) * 0.1,
             b_eff=rng.randn(hid) * 0.1, w2=rng.randn(hid, de) * 0.1,
             b2=rng.randn(de) * 0.1, a=1.0 + 0.1 * rng.randn(de),
             c=0.1 * rng.randn(de))
    unit = np.ones(de)
    if scaled:
        unit1 = np.ones(hid)
        unit1[0::4], unit1[1::4] = 2.0 ** 10, 2.0 ** -10
        unit[0::4], unit[1::4] = 2.0 ** 10, 2.0 ** -10
        a["xsg"] = np.clip(a["xsg"] * 5.0, -12.0, 12.0)
        a["xr"] = np.clip(a["xr"] * 5.0, -12.0, 12.0)
        a["w1e"] = a["w1e"] * unit1 * 2.0 ** -10
        a["w2"] = a["w2"] * unit
        a["b2"] = a["b2"] * unit
    t = {k: torch.from_numpy(np.asarray(x, np.float32)) for k, x in a.items()}
    t["mask"] = torch.from_numpy(mask)
    t["indptr"] = indptr_from_receivers(torch.from_numpy(full), R)
    return t, torch.from_numpy(unit.astype(np.float32))


def args(t, activation="swish"):
    return (t["xsg"], t["v"], t["xr"], t["w1e"], t["b_eff"], t["w2"],
            t["b2"], t["a"], t["c"], t["mask"], t["indptr"], R, activation)


def receivers(indptr, rows):
    counts = (indptr[1:] - indptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(counts.numel()), counts,
                                   output_size=rows)


def kernel_agg(msgs, indptr, blocks):
    """The kernel's aggregate: rows split into ``blocks`` row-balanced
    receiver ranges (``edge_mlp.fp32_bounds``), each walked in 128-row
    steps; per receiver and step the fp32 sum of its rows in row order,
    and the steps' sums added in order, each to the carried sum."""
    ip = indptr.long()
    e = int(ip[-1])
    rb = edge_mlp.fp32_bounds(indptr, blocks)
    starts = ip[rb[:-1]]
    rows = torch.arange(e)
    block = torch.searchsorted(starts, rows, right=True) - 1
    step = (rows - starts[block]) // 128
    recv = receivers(indptr, e)
    # Segments: runs of rows with one receiver and one step, in row order.
    new = torch.ones(e, dtype=torch.bool)
    new[1:] = (recv[1:] != recv[:-1]) | (step[1:] != step[:-1])
    seg = torch.cumsum(new.long(), 0) - 1
    seg_start = rows[new]
    seg_recv = recv[new]
    pos = rows - seg_start[seg]
    sums = torch.zeros(seg_start.numel(), msgs.shape[1])
    for k in range(int(pos.max()) + 1 if e else 0):
        at = pos == k
        sums[seg[at]] = sums[seg[at]] + msgs[:e][at]
    # Each receiver's segments in order: the carried sum first.
    agg = torch.zeros(indptr.numel() - 1, msgs.shape[1])
    first = torch.ones(seg_start.numel(), dtype=torch.bool)
    first[1:] = seg_recv[1:] != seg_recv[:-1]
    nth = torch.arange(seg_start.numel()) - torch.cummax(
        torch.where(first, torch.arange(seg_start.numel()), 0), 0).values
    for k in range(int(nth.max()) + 1 if seg_start.numel() else 0):
        at = nth == k
        agg[seg_recv[at]] = agg[seg_recv[at]] + sums[at]
    return agg


def emulate(xsg, v, xr, w1e, b_eff, w2, b2, a, c, mask, indptr, r,
            activation="swish"):
    """(v', agg, stats, h) with the kernel's products, rounding points and
    aggregate order."""
    recv = receivers(indptr, v.shape[0])
    p1 = tf32x3_product(v, w1e)
    h = ((xsg + xr.index_select(0, recv)) + p1) + b_eff
    act = edge_mlp.act_fn(activation)(h)
    u = tf32x3_product(act, w2) + b2
    v_new = (a * v + c) + u
    w = mask[:, None]
    agg = kernel_agg(u * w, indptr, BLOCKS)
    stats = torch.stack([(v_new * w).sum(), (v_new.square() * w).sum(),
                         mask.sum()])
    return v_new, agg, stats, h


def within(label, out, ref, allowed):
    bad = (out - ref).abs() > allowed
    assert not bad.any(), (
        f"{label}: {int(bad.sum())} out of tolerance, worst "
        f"{float(((out - ref).abs() - allowed).max()):.3e} over")


def test_kernel_agg_is_the_segment_sum():
    """``kernel_agg`` sums every row into its receiver once: against the
    float64 segment sum, and empty receivers exactly 0."""
    t, _ = make_case(7, 1_500, 128, 128)
    msgs = torch.from_numpy(np.random.RandomState(8).randn(
        t["mask"].numel(), 8).astype(np.float32))
    agg = kernel_agg(msgs, t["indptr"], BLOCKS)
    ref = cuda_segment.segment_sum_reference(msgs.double(), t["indptr"], R)
    torch.testing.assert_close(agg.double(), ref, atol=1e-5, rtol=1e-6)
    assert (agg[R // 4:R // 2] == 0).all()


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("hid,de", WIDTHS)
def test_tf32x3_products_error_against_fp64(hid, de, scaled):
    """Both emulated 3xTF32 products' error against an fp64 oracle is at
    most twice the plain fp32 product's, per element relative to the sum
    of the terms' magnitudes (max and RMS over the case): v @ W1e, and
    act(h) @ W2 on the emulation's own act(h)."""
    t, _ = make_case(hid + de + scaled, 700, hid, de, scaled)
    act = edge_mlp.act_fn("swish")(emulate(*args(t))[3])
    for a, w in ((t["v"], t["w1e"]), (act, t["w2"])):
        oracle = a.double() @ w.double()
        terms = a.abs().double() @ w.abs().double()
        emu = (tf32x3_product(a, w).double() - oracle).abs() / terms
        plain = ((a @ w).double() - oracle).abs() / terms
        assert emu.max() <= 2.0 * plain.max()
        assert (emu.square().mean().sqrt()
                <= 2.0 * plain.square().mean().sqrt())


@pytest.mark.parametrize("scaled,activation", [(False, "swish"),
                                               (False, "relu"),
                                               (True, "swish")])
@pytest.mark.parametrize("hid,de", WIDTHS)
def test_emulation_within_fp32_tolerance_of_plain(hid, de, scaled,
                                                  activation):
    """v', agg and the statistics of the emulation against
    ``edge_step_reference`` at ``FUSED_FP32_TOL`` (in each output column's
    unit) and ``STATS_RTOL``; padding rows get a v' row and add nothing,
    empty receivers aggregate to exactly 0."""
    t, unit = make_case(3 * hid + de + scaled, 900, hid, de, scaled)
    v_new, agg, stats, h = emulate(*args(t, activation))
    v_ref, agg_ref, stats_ref = edge_step.edge_step_reference(
        *args(t, activation))
    if scaled:  # the case reaches the range it is meant for
        assert 20.0 < float(h.abs().max()) < 40.0
    atol, rtol = FUSED_FP32_TOL["atol"], FUSED_FP32_TOL["rtol"]
    within("v_new", v_new, v_ref, atol * unit + rtol * v_ref.abs())
    w = t["mask"][:, None]
    u_mag = (v_ref - t["a"] * t["v"] - t["c"]).abs() * w
    mag = cuda_segment.segment_sum_reference(u_mag, t["indptr"], R)
    within("agg", agg, agg_ref,
           atol * unit + rtol * agg_ref.abs() + ORDER_RTOL * mag)
    stats_mag = torch.stack([(v_ref.abs() * w).sum(),
                             (v_ref.square() * w).sum(), t["mask"].sum()])
    within("stats", stats, stats_ref, STATS_RTOL * stats_mag)
    assert stats[2] == stats_ref[2] == t["mask"].sum()
    assert (agg[R // 4:R // 2] == 0).all()
    assert torch.isfinite(v_new).all() and (v_new[900:] != 0).any()
