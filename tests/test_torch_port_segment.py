"""The port's segment sum (``graphcast_lite_torch.ops.cuda_segment``) and
aggregation ops against the JAX package.

On the CPU the wrapper runs its plain version (fp32 ``index_add_``), which
is what these tests hold against the Pallas kernel in interpret mode and
against ``jax.ops.segment_sum``.  The Pallas fp32 path sums a hi/lo bf16
split (about 1.5e-5 relative), hence atol = rtol = 1e-4 against it, as
tests/test_pallas_segment.py uses; against ``jax.ops.segment_sum`` both
sides accumulate in fp32 and differ only in order (1e-5).  The CUDA kernel
itself is held against the plain version on the card by chip_smoke.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_lite_tpu.ops.pallas_segment import (
    build_schedule,
    build_schedule_clipped,
    segment_sum_sorted,
)
from graphcast_lite_torch.graphs.structure import indptr_from_receivers
from graphcast_lite_torch.ops import cuda_segment, edge_mlp, edge_step
from torch_port_common import \
    one_torch_thread  # noqa: F401 (an autouse fixture)


def _sorted_case(rng, e, r, f, recv=None, pad_recv=None):
    """Receiver-sorted, padded messages (padding rows zero)."""
    if recv is None:
        recv = np.sort(rng.randint(0, r, e)).astype(np.int32)
    e = len(recv)
    e_pad = ((e + 127) // 128) * 128
    m = np.zeros((e_pad, f), np.float32)
    m[:e] = rng.randn(e, f)
    r1 = np.full((e_pad,), r - 1 if pad_recv is None else pad_recv, np.int32)
    r1[:e] = recv
    return m, r1


def _port(m, r1, r):
    recv = torch.from_numpy(r1)
    indptr = indptr_from_receivers(recv, r)
    return cuda_segment.segment_sum(torch.from_numpy(m), indptr, r).numpy()


def _skewed(rng):
    # One receiver hogs most edges (the encoder's max in-degree is 346).
    return np.concatenate([
        np.zeros(3000, np.int32),
        np.sort(rng.randint(1, 512, 500)).astype(np.int32),
    ])


@pytest.mark.parametrize("case", [
    (1000, 300, 128),
    (5000, 1000, 128),
    (333, 700, 256),     # more receivers than edges (many empty segments)
    (4096, 256, 128),    # exactly one tile of receivers
    (20000, 300, 128),   # many chunks per tile
    "skewed",
])
def test_plain_matches_pallas_interpret(case):
    rng = np.random.RandomState(0)
    if case == "skewed":
        r, f = 512, 128
        m, r1 = _sorted_case(rng, 0, r, f, recv=_skewed(rng))
    else:
        e, r, f = case
        m, r1 = _sorted_case(rng, e, r, f)
    base, tile = build_schedule(r1, r, 256)
    expect = segment_sum_sorted(
        jnp.asarray(m), jnp.asarray(r1), jnp.asarray(base),
        jnp.asarray(tile), r, 256, interpret=True,
    )
    out = _port(m, r1, r)
    # The hi/lo split's error grows with the 3000-term sum of the skewed
    # row: atol 1e-3 there, as tests/test_pallas_segment.py uses.
    atol = 1e-3 if case == "skewed" else 1e-4
    np.testing.assert_allclose(out, np.asarray(expect), atol=atol, rtol=1e-4)
    # The plain version itself is fp32-exact up to summation order.
    exact = jax.ops.segment_sum(jnp.asarray(m), jnp.asarray(r1),
                                num_segments=r, indices_are_sorted=True)
    np.testing.assert_allclose(out, np.asarray(exact), atol=1e-5, rtol=1e-5)


def test_plain_matches_pallas_clipped_band():
    """Bipartite band (receivers concentrated mid-range, padding inside
    the band): rows outside the band are exact zeros on both sides."""
    rng = np.random.RandomState(1)
    e, r, f = 5000, 4000, 128
    recv = np.sort(rng.randint(1100, 1900, e)).astype(np.int32)
    m, r1 = _sorted_case(rng, e, r, f, recv=recv, pad_recv=recv[-1])
    base, tile, t_lo, t_hi = build_schedule_clipped(r1, r, 256)
    assert t_lo >= 4 and t_hi <= 8, (t_lo, t_hi)
    expect = np.asarray(segment_sum_sorted(
        jnp.asarray(m), jnp.asarray(r1), jnp.asarray(base),
        jnp.asarray(tile), r, 256, interpret=True,
        tile_lo=t_lo, tile_hi=t_hi,
    ))
    out = _port(m, r1, r)
    np.testing.assert_allclose(out, expect, atol=1e-4, rtol=1e-4)
    assert np.all(out[:1100] == 0) and np.all(out[1900:] == 0)


@pytest.mark.parametrize("f", [19, 64])
def test_plain_matches_xla_segment_sum(f):
    """Narrow / non-multiple-of-vector widths, empty receivers, padding."""
    rng = np.random.RandomState(2)
    e, r = 700, 900
    m, r1 = _sorted_case(rng, e, r, f)
    expect = jax.ops.segment_sum(jnp.asarray(m), jnp.asarray(r1),
                                 num_segments=r, indices_are_sorted=True)
    np.testing.assert_allclose(_port(m, r1, r), np.asarray(expect),
                               atol=1e-5, rtol=1e-5)


def test_batched_matches_vmap():
    """A leading batch dim [B, E, F] (the counterpart of the vmap fold)."""
    rng = np.random.RandomState(3)
    e, r, f, b = 600, 250, 64, 3
    _, r1 = _sorted_case(rng, e, r, f)
    m = rng.randn(b, r1.shape[0], f).astype(np.float32)
    m[:, e:] = 0.0
    expect = jax.vmap(lambda x: jax.ops.segment_sum(
        x, jnp.asarray(r1), num_segments=r, indices_are_sorted=True
    ))(jnp.asarray(m))
    out = _port(m, r1, r)
    assert out.shape == (b, r, f)
    np.testing.assert_allclose(out, np.asarray(expect), atol=1e-5, rtol=1e-5)


def test_bf16_rounds_once_from_fp32():
    """bf16 messages accumulate in fp32 and round once at the end."""
    rng = np.random.RandomState(4)
    m, r1 = _sorted_case(rng, 2000, 300, 64)
    mb = torch.from_numpy(m).to(torch.bfloat16)
    indptr = indptr_from_receivers(torch.from_numpy(r1), 300)
    out = cuda_segment.segment_sum(mb, indptr, 300)
    assert out.dtype == torch.bfloat16
    exact = cuda_segment.segment_sum(mb.float(), indptr, 300)
    assert torch.equal(out, exact.to(torch.bfloat16))


def test_indptr_and_wrapper_contract():
    """indptr brackets each receiver's rows; CPU tensors take the plain
    version without counting a launch; other devices raise."""
    rng = np.random.RandomState(5)
    m, r1 = _sorted_case(rng, 500, 80, 8)
    indptr = indptr_from_receivers(torch.from_numpy(r1), 80)
    ip = indptr.numpy()
    assert ip.dtype == np.int32 and ip[0] == 0 and ip[-1] == len(r1)
    for e_i, rv in enumerate(r1):
        assert ip[rv] <= e_i < ip[rv + 1]
    before = cuda_segment.launches
    cuda_segment.segment_sum(torch.from_numpy(m), indptr, 80)
    assert cuda_segment.launches == before
    with pytest.raises(ValueError):
        cuda_segment.segment_sum(torch.empty(len(r1), 8, device="meta"),
                                 indptr.to("meta"), 80)


def test_library_named_after_source_and_flags(monkeypatch, tmp_path):
    """The kernel library's file name hashes the source text, the headers
    beside it and the nvcc flags, so a build of another source or with
    other flags is never loaded; an existing build of this source is reused
    without nvcc."""
    from graphcast_lite_torch.ops import nvcc_build

    src = tmp_path / "segment_sum.cu"
    src.write_text("// version 1\n")
    monkeypatch.setattr(nvcc_build, "_BUILD", str(tmp_path / "_build"))
    first = nvcc_build.lib_path(str(src))
    assert first.startswith(str(tmp_path / "_build"))
    assert os.path.basename(first).startswith("libgclt_segment_sum-")
    src.write_text("// version 2\n")
    second = nvcc_build.lib_path(str(src))
    (tmp_path / "tile.cuh").write_text("// a header beside the source\n")
    with_header = nvcc_build.lib_path(str(src))
    monkeypatch.setattr(nvcc_build, "NVCC_FLAGS",
                        nvcc_build.NVCC_FLAGS + ("-lineinfo",))
    third = nvcc_build.lib_path(str(src))
    assert len({first, second, with_header, third}) == 4
    # Every kernel of the package goes through the one helper.
    for mod in (cuda_segment, edge_mlp, edge_step):
        assert os.path.dirname(mod.SOURCE) == nvcc_build.CSRC
        assert os.path.exists(mod.SOURCE)

    os.makedirs(os.path.dirname(third))
    open(third, "wb").close()

    def no_nvcc(*args, **kwargs):
        raise AssertionError("nvcc ran for an existing build")

    monkeypatch.setattr(nvcc_build.subprocess, "Popen", no_nvcc)
    assert nvcc_build.build(str(src)) == (third,)


@pytest.mark.parametrize("which", ["encoding", "decoding"])
def test_aggregate_sum_matches_jax(small_graph_set, which):
    """ops.segment.aggregate_sum on the real encoder (segment kernel path)
    and decoder (constant-degree reshape-sum) graphs."""
    from graphcast_lite_tpu.ops import segment as jseg
    from graphcast_lite_torch.graphs.build import build_graph_set
    from graphcast_lite_torch.ops import segment as tseg

    jg = getattr(small_graph_set, which)
    lat = np.linspace(-87.1875, 87.1875, 32).astype(np.float32)
    lon = np.arange(0, 360, 5.625).astype(np.float32)
    tg = getattr(build_graph_set(lat, lon, [1, 2], 0.6), which)
    msgs = np.random.RandomState(6).randn(jg.padded_num_edges, 32) \
        .astype(np.float32)
    expect = np.asarray(jseg.aggregate_mean(jnp.asarray(msgs), jg))
    out = tseg.aggregate_mean(torch.from_numpy(msgs), tg).numpy()
    np.testing.assert_allclose(out, expect, atol=1e-5, rtol=1e-5)
    if which == "decoding":
        assert tg.const_in_degree == 3
