"""The port's fused edge-MLP tail (``graphcast_lite_torch.ops.edge_mlp``)
against the JAX package's ``edge_mlp_segment`` in interpret mode.

On the CPU the wrapper runs its plain version, which is what these tests
hold.  ``u`` is compared at the port's fp32 tolerance (ATOL 5e-5, RTOL
1e-4).  The Pallas kernel sums fp32 ``u`` as a hi/lo pair of bf16 halves
(about 1.5e-5 relative per term), so ``agg_sum`` is held at atol = rtol =
1e-4, as tests/test_torch_port_segment.py does for the segment kernel.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_lite_tpu.ops.pallas_edge_mlp import edge_mlp_segment
from graphcast_lite_tpu.ops.pallas_segment import build_schedule
from graphcast_lite_torch.graphs.structure import indptr_from_receivers
from graphcast_lite_torch.ops import edge_mlp
from torch_port_common import ATOL, RTOL, bf16_close

AGG_TOL = dict(atol=1e-4, rtol=1e-4)


def make_case(seed, e, r, h, de, recv_range=None, recv=None):
    """Receiver-sorted rows padded to a multiple of 128 onto receiver R-1
    (mask 0), with the first e // 7 real edges pruned (mask 0); ``recv``
    (sorted) replaces the random receivers."""
    rng = np.random.RandomState(seed)
    lo, hi = recv_range or (0, r)
    if recv is None:
        recv = np.sort(rng.randint(lo, hi, e)).astype(np.int32)
    e = len(recv)
    e_pad = ((e + 127) // 128) * 128
    r1 = np.full((e_pad,), r - 1, np.int32)
    r1[:e] = recv
    mask = np.zeros((e_pad,), np.float32)
    mask[:e] = 1.0
    mask[: e // 7] = 0.0
    hp = rng.randn(e_pad, h).astype(np.float32)
    w2 = (rng.randn(h, de) * 0.1).astype(np.float32)
    b2 = (rng.randn(de) * 0.1).astype(np.float32)
    return hp, w2, b2, mask, r1


def run_jax(hp, w2, b2, mask, r1, r, act, dtype=jnp.float32):
    base, tile = build_schedule(r1, r, 256)
    u, agg = edge_mlp_segment(
        jnp.asarray(hp, dtype), jnp.asarray(w2, dtype), jnp.asarray(b2, dtype),
        jnp.asarray(mask, dtype), jnp.asarray(r1), jnp.asarray(base),
        jnp.asarray(tile), r, 256, activation=act, interpret=True,
    )
    return (np.asarray(u.astype(jnp.float32)),
            np.asarray(agg.astype(jnp.float32)))


def run_port(hp, w2, b2, mask, r1, r, act, dtype=torch.float32):
    indptr = indptr_from_receivers(torch.from_numpy(r1), r)
    before = edge_mlp.launches
    u, agg = edge_mlp.edge_mlp(
        *(torch.from_numpy(t).to(dtype) for t in (hp, w2, b2, mask)),
        indptr, r, act)
    assert edge_mlp.launches == before  # the plain version ran
    assert u.dtype == dtype and agg.dtype == dtype
    return u.float().numpy(), agg.float().numpy()


@pytest.mark.parametrize("e,r,h,de,act", [
    (1000, 300, 128, 128, "swish"),
    (5000, 1000, 256, 128, "relu"),
    (4096, 256, 128, 256, "swish"),    # De = 256, one reference tile
])
def test_plain_matches_pallas_interpret(e, r, h, de, act):
    case = make_case(0, e, r, h, de)
    u, agg = run_port(*case, r, act)
    u_ref, agg_ref = run_jax(*case, r, act)
    np.testing.assert_allclose(u, u_ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(agg, agg_ref, **AGG_TOL)


def _runs(*runs):
    return np.concatenate([np.full(n, r, np.int32) for r, n in runs])


# The tilings the bf16 Hopper kernel meets (chip_smoke.py's _tiling_cases,
# at sizes the interpret mode runs quickly): receiver runs on and across its
# 64-row sub-tiles and 32-receiver groups.  (R, sorted receivers).
TILINGS = {
    "in-degree 1": (300, np.arange(300, dtype=np.int32)),
    "in-degrees 0 / 13 alternating": (
        201, np.repeat(np.arange(0, 201, 2, dtype=np.int32), 13)),
    "receivers of exactly 64 and 128 rows": (50, np.concatenate([
        _runs((0, 64), (1, 128), (2, 5), (3, 64)),
        np.sort(np.random.RandomState(5).randint(4, 50, 300))
        .astype(np.int32)])),
    "one receiver": (1, np.zeros(300, np.int32)),
    "R=33": (33, np.sort(np.random.RandomState(6).randint(0, 33, 700))
             .astype(np.int32)),
    "a receiver with 2500 edges": (300, np.concatenate([
        np.zeros(2500, np.int32),
        np.sort(np.random.RandomState(7).randint(1, 300, 900))
        .astype(np.int32)])),
}


@pytest.mark.parametrize("name", sorted(TILINGS))
def test_tilings_match_pallas_interpret(name):
    r, recv = TILINGS[name]
    case = make_case(4, 0, r, 128, 128, recv=recv)
    u, agg = run_port(*case, r, "swish")
    u_ref, agg_ref = run_jax(*case, r, "swish")
    np.testing.assert_allclose(u, u_ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(agg, agg_ref, **AGG_TOL)


def test_empty_receivers_and_padding_rows():
    """Edges on receivers 900-1099 of 2000 only: the other receivers are
    empty (exact zeros), and the padding rows of receiver R-1 get a ``u``
    row but add nothing to its aggregate."""
    r = 2000
    hp, w2, b2, mask, r1 = make_case(1, 3000, r, 128, 128, (900, 1100))
    assert (r1 == r - 1).sum() == len(r1) - 3000 > 0
    u, agg = run_port(hp, w2, b2, mask, r1, r, "swish")
    u_ref, agg_ref = run_jax(hp, w2, b2, mask, r1, r, "swish")
    np.testing.assert_allclose(u, u_ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(agg, agg_ref, **AGG_TOL)
    assert np.all(agg[:900] == 0) and np.all(agg[1100:] == 0)
    assert np.abs(u[3000:]).max() > 0


def test_bf16_held_to_reference_bf16_error():
    """bf16 inputs: the port's plain version and the Pallas kernel round in
    the same places; the port is held to the reference's own bf16 error
    against the fp32 result (``bf16_close``)."""
    r = 500
    case = make_case(2, 3000, r, 128, 128)
    u32, agg32 = run_jax(*case, r, "swish")
    u16, agg16 = run_jax(*case, r, "swish", jnp.bfloat16)
    pu16, pagg16 = run_port(*case, r, "swish", torch.bfloat16)
    bf16_close(pu16, u16, u32)
    bf16_close(pagg16, agg16, agg32)


def test_wrapper_contract():
    """Unsupported widths or activations raise on the card path; other
    devices raise; the CPU path never counts a launch."""
    hp, w2, b2, mask, r1 = make_case(3, 300, 50, 128, 128)
    indptr = indptr_from_receivers(torch.from_numpy(r1), 50)
    meta = [torch.from_numpy(t).to("meta") for t in (hp, w2, b2, mask)]
    with pytest.raises(ValueError):
        edge_mlp.edge_mlp(*meta, indptr.to("meta"), 50, "swish")
    assert edge_mlp.supports(128, 256, "relu")
    assert not edge_mlp.supports(128, 64, "swish")
    assert not edge_mlp.supports(128, 128, "gelu")
