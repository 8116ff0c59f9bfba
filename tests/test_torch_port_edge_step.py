"""The port's fused edge step (``graphcast_lite_torch.ops.edge_step``)
against the JAX package's ``edge_step_fused`` in interpret mode.

On the CPU the wrapper runs its plain version, which is what these tests
hold.  ``v_new`` and ``agg_sum`` are compared at the port's fp32 tolerance
(ATOL 5e-5, RTOL 1e-4; in interpret mode the reference's one-hot matmuls
are exact in fp32).  The stats are sums over up to 1.3M elements: their
tolerance is rtol 1e-5 of the sum of magnitudes (``_stats_close``), what
fp32 summation in two orders can differ by.  The CUDA kernel itself is
held against the plain version on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_lite_tpu.ops.pallas_edge_step import (
    TILE_EDGES,
    build_step_schedule,
    edge_step_fused,
)
from graphcast_lite_torch.graphs.structure import indptr_from_receivers
from graphcast_lite_torch.ops import edge_step
from torch_port_common import ATOL, RTOL
from torch_port_common import \
    one_torch_thread  # noqa: F401 (an autouse fixture)


def make_case(seed, e, r, h, de, recv_range=None, e_pad=None):
    """Receiver-sorted rows padded onto receiver R-1 (mask 0), the first
    e // 9 real edges pruned; random lazy-LN affine (a, c)."""
    rng = np.random.RandomState(seed)
    lo, hi = recv_range or (0, r)
    recv = np.sort(rng.randint(lo, hi, e)).astype(np.int32)
    e_pad = e_pad or max(((e + 127) // 128) * 128, TILE_EDGES)
    r1 = np.full((e_pad,), r - 1, np.int32)
    r1[:e] = recv
    mask = np.zeros((e_pad,), np.float32)
    mask[:e] = 1.0
    mask[: e // 9] = 0.0
    arrays = dict(
        xsg=rng.randn(e_pad, h), v=rng.randn(e_pad, de), xr=rng.randn(r, h),
        w1e=rng.randn(de, h) * 0.1, b_eff=rng.randn(h) * 0.1,
        w2=rng.randn(h, de) * 0.1, b2=rng.randn(de) * 0.1,
        a=1.0 + 0.1 * rng.randn(de), c=0.1 * rng.randn(de), mask=mask,
    )
    return {k: np.asarray(x, np.float32) for k, x in arrays.items()}, r1


ORDER = ("xsg", "v", "xr", "w1e", "b_eff", "w2", "b2", "a", "c", "mask")


def run_jax(arrays, r1, r, act):
    s = build_step_schedule(r1, r, 256)
    assert s is not None
    out = edge_step_fused(
        *(jnp.asarray(arrays[k]) for k in ORDER),
        jnp.asarray(s.base), jnp.asarray(s.tile), jnp.asarray(s.win_lo),
        jnp.asarray(s.win_hi), jnp.asarray(s.rwin), jnp.asarray(s.recv),
        r, 256, s.win_r, s.xr_rows, activation=act, interpret=True,
    )
    return [np.asarray(t) for t in out]


def run_port(arrays, r1, r, act):
    indptr = indptr_from_receivers(torch.from_numpy(r1), r)
    before = edge_step.launches
    out = edge_step.edge_step(*(torch.from_numpy(arrays[k]) for k in ORDER),
                              indptr, r, act)
    assert edge_step.launches == before  # the plain version ran
    return [t.numpy() for t in out]


def _stats_close(stats, expect, v_new, mask):
    w = mask[:, None]
    mag = np.array([np.abs(v_new * w).sum(), (v_new ** 2 * w).sum(),
                    mask.sum()])
    assert stats.dtype == np.float32 and stats.shape == (3,)
    np.testing.assert_array_less(np.abs(stats - expect), 1e-5 * mag + 1e-6)
    assert stats[2] == mask.sum()


def _check(arrays, r1, r, act):
    v_new, agg, stats = run_port(arrays, r1, r, act)
    v_ref, agg_ref, stats_ref = run_jax(arrays, r1, r, act)
    np.testing.assert_allclose(v_new, v_ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(agg, agg_ref, atol=ATOL, rtol=RTOL)
    _stats_close(stats, stats_ref, v_ref, arrays["mask"])
    return v_new, agg


@pytest.mark.parametrize("e,r,h,de,act", [
    (5000, 700, 128, 128, "swish"),
    (5000, 700, 128, 128, "relu"),
    (4000, 256, 128, 256, "swish"),    # De = 256, one reference tile
])
def test_plain_matches_pallas_interpret(e, r, h, de, act):
    arrays, r1 = make_case(0, e, r, h, de)
    _check(arrays, r1, r, act)


def test_empty_receivers_and_padding_rows():
    """Edges on receivers 900-1099 of 2000 only (the reference's inert
    tiles), 72 padding rows on receiver R-1: empty receivers aggregate to
    exact zeros, padding rows get a v' row and add nothing."""
    r = 2000
    arrays, r1 = make_case(1, 3000, r, 128, 128, (900, 1100),
                           e_pad=TILE_EDGES * 3)
    v_new, agg = _check(arrays, r1, r, "swish")
    assert np.all(agg[:900] == 0) and np.all(agg[1100:] == 0)
    assert np.abs(v_new[3000:]).max() > 0


def test_eligibility_mirrors_the_reference():
    """The reference builds no step schedule below 1024 padded edges and
    takes only swish / silu / relu at widths that are multiples of 128."""
    assert edge_step.eligible(1024, 128, 256, "silu")
    assert not edge_step.eligible(896, 128, 128, "swish")
    assert not edge_step.eligible(4096, 96, 128, "swish")
    assert not edge_step.eligible(4096, 128, 128, "gelu")
    r1 = np.zeros(896, np.int32)
    assert build_step_schedule(r1, 10, 256) is None
