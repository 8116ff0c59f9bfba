"""The arithmetic of the fp32 edge-MLP kernel (``csrc/edge_mlp.cu``, the
``hopper_fp32`` design) emulated in plain torch on the CPU.

The kernel multiplies in 3xTF32 on the tensor cores: the activated rows
and W2 are each split into a TF32 big part and the TF32 of the remainder
(``ops.edge_mlp.tf32_split``: round to nearest, ties away from zero, by
bit masking, as ``cvt.rna.tf32.f32``), and each k8 step adds
``a_s b_b``, ``a_b b_s`` and ``a_b b_b`` (small terms first) into one fp32
accumulator.  The emulation (``torch_port_common.tf32x3_product``, which
the edge step's emulation shares) adds the same parts in the same order,
each 8-deep product in fp32 (a product of two TF32 values is exact in
fp32).  On seeded inputs at a small CSR, with W2 columns scaled by 2^10
and 2^-10, it holds:

* the product's error against an fp64 oracle at no more than twice that of
  the plain fp32 product (``edge_mlp_reference``), per element relative to
  the sum of the terms' magnitudes;
* ``u`` and ``agg`` within chip_smoke.py's ``FUSED_FP32_TOL`` of the plain
  version (the aggregates + ``ORDER_RTOL`` times the sum of their rows'
  magnitudes, as on the card), in each column's own unit: scaling a column
  by a power of two scales both versions' results exactly, so ``atol``
  scales with the column.

The emulation adds in IEEE fp32; the card's tensor cores round their sums
otherwise, and on the card the kernel's error against float64 is several
times the plain fp32 version's (chip_smoke.py measures and prints it;
PERF.md).  So the first point holds for the emulated arithmetic only:
chip_smoke.py holds the kernel itself to the plain version at the same
tolerance.
"""

import os
import sys

import numpy as np
import pytest
import torch

from graphcast_lite_torch.graphs.structure import indptr_from_receivers
from graphcast_lite_torch.ops import cuda_segment, edge_mlp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from chip_smoke import FUSED_FP32_TOL, ORDER_RTOL  # noqa: E402
from torch_port_common import tf32x3_product  # noqa: E402

WIDTHS = [(128, 128), (256, 256), (128, 256), (256, 128)]


def emulate(h_pre, w2, b2, mask, indptr, r, activation="swish"):
    """(u, agg) with the kernel's products and rounding points: the
    activation in fp32, u = product + b2, agg the fp32 sum of u * mask
    over each receiver's rows."""
    a = edge_mlp.act_fn(activation)(h_pre)
    u = tf32x3_product(a, w2) + b2
    agg = cuda_segment.segment_sum_reference(u * mask[:, None], indptr, r)
    return u, agg


def make_case(seed, e, r, hid, de, h_scale=2.0):
    """Receiver-sorted rows padded to a multiple of 128 onto receiver R-1
    (mask 0), every 7th real edge pruned; W2 columns 0, 4, 8, ... scaled by
    2^10 and 1, 5, 9, ... by 2^-10 (``col_scale``)."""
    rng = np.random.RandomState(seed)
    recv = np.sort(rng.randint(0, r, e))
    e_pad = -(-e // 128) * 128
    full = np.full(e_pad, r - 1, np.int64)
    full[:e] = recv
    mask = np.zeros(e_pad, np.float32)
    mask[:e] = 1.0
    mask[:e:7] = 0.0
    col_scale = np.ones(de, np.float32)
    col_scale[0::4] = 2.0 ** 10
    col_scale[1::4] = 2.0 ** -10
    t = dict(
        h_pre=torch.from_numpy((rng.randn(e_pad, hid) * h_scale)
                               .astype(np.float32)),
        w2=torch.from_numpy((rng.randn(hid, de) * 0.1).astype(np.float32)
                            * col_scale),
        b2=torch.from_numpy((rng.randn(de) * 0.1).astype(np.float32)
                            * col_scale),
        mask=torch.from_numpy(mask),
        indptr=indptr_from_receivers(torch.from_numpy(full), r))
    return t, torch.from_numpy(col_scale)


def test_tf32_round_to_nearest_ties_away():
    """``tf32_round`` keeps 10 mantissa bits, rounds to the nearest TF32
    value, and breaks ties away from zero, against an fp64 rounding."""
    rng = np.random.RandomState(0)
    x = np.concatenate([
        rng.randn(20_000) * 10.0 ** rng.uniform(-30, 30, 20_000),
        [1.0, -1.0, 0.0, 3.0e38, -1.5e-38]]).astype(np.float32)
    # Exact ties: 1 + 2^-11 and its negative, and a tie that carries into
    # the exponent (2 - 2^-11).
    x = np.concatenate([x, np.float32([1 + 2.0 ** -11, -(1 + 2.0 ** -11),
                                       2 - 2.0 ** -11])])
    got = edge_mlp.tf32_round(torch.from_numpy(x)).numpy()
    assert (got.view(np.int32) & 0x1FFF == 0).all()
    xd = x.astype(np.float64)
    m, ex = np.frexp(np.abs(xd))  # |x| = m 2^ex, m in [0.5, 1)
    q = m * 2.0 ** 11  # the 11 significant bits TF32 keeps
    expect = np.sign(xd) * np.floor(q + 0.5) * 2.0 ** (ex - 11)
    np.testing.assert_array_equal(got.astype(np.float64), expect)
    assert got[-3] == np.float32(1 + 2.0 ** -10)
    assert got[-2] == -np.float32(1 + 2.0 ** -10)
    assert got[-1] == 2.0


def test_tf32_split_parts():
    """big + small is x to within 2^-22 |x|; both parts are TF32 values."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.randn(50_000) * 10.0 ** rng.uniform(
        -20, 20, 50_000)).astype(np.float32))
    big, small = edge_mlp.tf32_split(x)
    for part in (big, small):
        assert (part.view(torch.int32) & 0x1FFF == 0).all()
    xd = x.double()
    err = (big.double() + small.double() - xd).abs()
    assert (err <= 2.0 ** -22 * xd.abs()).all()


@pytest.mark.parametrize("hid,de", WIDTHS)
def test_tf32x3_product_error_against_fp64(hid, de):
    """The emulated 3xTF32 product's error against an fp64 oracle is at
    most twice the plain fp32 product's, per element relative to the sum
    of the terms' magnitudes (max and RMS over the case)."""
    t, _ = make_case(hid + de, 700, 90, hid, de)
    a = edge_mlp.act_fn("swish")(t["h_pre"])
    oracle = a.double() @ t["w2"].double()
    terms = a.abs().double() @ t["w2"].abs().double()
    emu = (tf32x3_product(a, t["w2"]).double() - oracle).abs() / terms
    plain = ((a @ t["w2"]).double() - oracle).abs() / terms
    assert emu.max() <= 2.0 * plain.max()
    assert emu.square().mean().sqrt() <= 2.0 * plain.square().mean().sqrt()


@pytest.mark.parametrize("activation", ["swish", "relu"])
@pytest.mark.parametrize("hid,de", WIDTHS)
def test_emulation_within_fp32_tolerance_of_plain(hid, de, activation):
    """u and agg of the emulation against ``edge_mlp_reference`` at
    ``FUSED_FP32_TOL`` in each column's unit, rows up to |h| = 30."""
    t, scale = make_case(3 * hid + de, 900, 120, hid, de, h_scale=10.0)
    t["h_pre"] = t["h_pre"].clamp(-30.0, 30.0)
    args = (t["h_pre"], t["w2"], t["b2"], t["mask"], t["indptr"], 120,
            activation)
    u, agg = emulate(*args)
    u_ref, agg_ref = edge_mlp.edge_mlp_reference(*args)
    atol, rtol = FUSED_FP32_TOL["atol"], FUSED_FP32_TOL["rtol"]
    allowed = atol * scale + rtol * u_ref.abs()
    assert ((u - u_ref).abs() <= allowed).all()
    mag = cuda_segment.segment_sum_reference(
        u_ref.abs() * t["mask"][:, None], t["indptr"], 120)
    allowed = atol * scale + rtol * agg_ref.abs() + ORDER_RTOL * mag
    assert ((agg - agg_ref).abs() <= allowed).all()
    # The padding rows (receiver R-1's tail, mask 0) get u rows and add
    # nothing.
    assert torch.isfinite(u).all()
