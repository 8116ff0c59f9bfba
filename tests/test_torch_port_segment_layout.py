"""Host-side layout of the port's balanced segment-sum design
(``graphcast_lite_torch.ops.cuda_segment``): the merge-path partition of
row ends and edges into tiles of ``TILE_ITEMS`` items (boundaries moved
back to the start of a short row), the long rows that cross a tile
boundary, which shapes take the design, and a plain-torch replay of the
kernel's walk (fp32 sums in row order, a split row's pieces added in tile
order by the last tile to arrive) held against the plain version, against
``jax.ops.segment_sum`` and against the Pallas kernel in interpret mode,
at several tile sizes.  All of it runs on the CPU; chip_smoke.py checks
the design selection and tile size against the built library's own
queries and holds the kernel against its plain version on the card.

Tolerances: the replay and ``segment_sum_reference`` both accumulate in
fp32 and differ only in the order of the additions, as does
``jax.ops.segment_sum``: 1e-5 + 1e-5 * |ref| + ORDER_RTOL * sum_e |msgs_e|,
chip_smoke.py's stated bound (a 2,500-edge row of N(0, 1) messages reaches
partial sums of about 50, so its order error outgrows 1e-5).  The Pallas
fp32 path sums a hi/lo bf16 split (about 1.5e-5 relative), hence 1e-4, and
1e-3 where a row sums 2,500 terms, as tests/test_torch_port_segment.py
uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_lite_tpu.ops.pallas_segment import build_schedule, \
    segment_sum_sorted
from graphcast_lite_torch.graphs.structure import indptr_from_receivers
from graphcast_lite_torch.ops import cuda_segment

TILES = (4, 16, 64)  # TILE_ITEMS values the mirror is held at
ORDER_RTOL = 1e-5


def _assert_order_close(out, ref, mag):
    """|out - ref| <= 1e-5 + 1e-5 |ref| + ORDER_RTOL * mag everywhere."""
    out, ref = np.asarray(out), np.asarray(ref)
    allowed = 1e-5 + 1e-5 * np.abs(ref) + ORDER_RTOL * np.asarray(mag)
    worst = np.max(np.abs(out - ref) - allowed)
    assert worst <= 0, f"out of tolerance by {worst:.3e}"


@pytest.fixture(params=TILES, ids=lambda t: f"tile{t}")
def tile(request, monkeypatch):
    monkeypatch.setattr(cuda_segment, "TILE_ITEMS", request.param)
    return request.param


def _indptr(counts):
    return torch.from_numpy(np.concatenate([[0], np.cumsum(counts)])
                            .astype(np.int32))


def _items(indptr):
    """The merged sequence as (kind, index): ("e", edge) or ("r", row), in
    the order the merge path takes them (a row's edges, then its end)."""
    ip = indptr.tolist()
    out = []
    for r in range(len(ip) - 1):
        out += [("e", e) for e in range(ip[r], ip[r + 1])]
        out.append(("r", r))
    return out


def _graphs():
    """Skewed CSR layouts, as per-row edge counts."""
    rng = np.random.RandomState(0)
    hog = np.concatenate([[2_500], rng.randint(0, 4, 300)])
    band = np.concatenate([np.zeros(1_000, np.int64),
                           rng.randint(0, 12, 400)])
    band[1_000 + 200] = 300  # a 300-edge row in the middle of the band
    return {
        "2500-edge receiver": hog,
        "empty lower band": band,
        "E=0": np.zeros(500, np.int64),
        "R=1": np.array([777]),
        "one row per edge": np.ones(50, np.int64),
    }


@pytest.mark.parametrize("name", list(_graphs()))
def test_partition_covers_each_row_and_edge_once(name, tile):
    indptr = _indptr(_graphs()[name])
    r, e = indptr.numel() - 1, int(indptr[-1])
    part = cuda_segment.tile_partition(indptr)
    tiles = -(-(r + e) // tile)
    assert part.shape == (tiles + 1, 2)
    assert part[0].tolist() == [0, 0] and part[-1].tolist() == [r, e]
    # Before snapping, tile k begins at item k * TILE_ITEMS: the tiles
    # differ by at most one item (all but the last hold TILE_ITEMS).  A
    # boundary moves back only to the start of a row shorter than a tile.
    d = part.sum(dim=1)
    ip = indptr.long()
    for k in range(1, tiles):
        raw = k * tile
        assert raw - tile < d[k] <= raw
        if d[k] < raw:
            row = int(part[k, 0])
            assert int(part[k, 1]) == int(ip[row])
            assert int(ip[row + 1] - ip[row]) + 1 < tile
    assert (d[1:] > d[:-1]).all()
    # Tile k holds items [d_k, d_{k+1}) of the merge; its rows and
    # edges are exactly the row ends and edges among them.
    items = _items(indptr)
    row_owner = np.full(r, -1)
    edge_owner = np.full(e, -1)
    for k in range(tiles):
        rows = [i for kind, i in items[d[k]:d[k + 1]] if kind == "r"]
        edges = [i for kind, i in items[d[k]:d[k + 1]] if kind == "e"]
        assert rows == list(range(int(part[k, 0]), int(part[k + 1, 0])))
        assert edges == list(range(int(part[k, 1]), int(part[k + 1, 1])))
        row_owner[rows] = k
        edge_owner[edges] = k
    assert (row_owner >= 0).all() and (edge_owner >= 0).all()
    # A row is split when one of its edges lies in another tile than its
    # end; only rows of TILE_ITEMS items or more are.
    ipn = indptr.numpy()
    expect = [x for x in range(r)
              if (edge_owner[ipn[x]:ipn[x + 1]] != row_owner[x]).any()]
    assert cuda_segment.split_rows(indptr).tolist() == expect
    assert all(ipn[x + 1] - ipn[x] + 1 >= tile for x in expect)


def test_boundaries_on_row_ends(tile):
    """Rows of TILE_ITEMS items (edges and end) fill one tile each: no row
    is split.  One edge more and every row crosses a boundary."""
    indptr = _indptr(np.full(8, tile - 1))
    part = cuda_segment.tile_partition(indptr)
    assert part[:, 0].tolist() == list(range(9))
    assert cuda_segment.split_rows(indptr).numel() == 0
    assert cuda_segment.split_rows(_indptr(np.full(8, tile))).numel() > 0


def test_message_rows_past_indptr():
    """Message rows past indptr[R] (no receiver's) are items of the last
    tiles: they move the boundaries, not the rows' ownership."""
    indptr = _indptr(np.array([3, 0, 5]))
    part = cuda_segment.tile_partition(indptr, num_edges=200)
    assert part[-1].tolist() == [3, 200]
    assert part.shape[0] == -(-(3 + 200) // cuda_segment.TILE_ITEMS) + 1


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_design_selection(dtype, aligned):
    """The balanced design takes 16-byte aligned rows of 256-1024 bytes
    that are a multiple of 16: F = 64-256 in fp32 and 128-512 in bf16; the
    warp-per-row design takes the rest."""
    size = 4 if dtype == torch.float32 else 2
    for f in (19, 64, 256, 512):
        balanced = aligned and 256 <= f * size <= 1024
        assert cuda_segment.segment_design(dtype, f, aligned) == (
            "balanced" if balanced else "warp"), (dtype, f, aligned)
    assert cuda_segment.segment_design(dtype, 256) == "balanced"
    assert cuda_segment.segment_design(torch.float16, 256) == "warp"


def replay(msgs, indptr, num_receivers):
    """The balanced kernel's arithmetic in plain torch: each tile walks its
    items in row order with fp32 sums and stores the rows it began and
    ended; a long row that crosses tiles leaves an fp32 piece in each of
    them (slot 0: its end's tile; slot 1: the others), and the last tile to
    arrive sums the pieces in tile order and stores the row once."""
    part = cuda_segment.tile_partition(indptr, msgs.shape[-2]).tolist()
    ip = indptr.tolist()
    f = msgs.shape[-1]
    x = msgs.float()
    tiles = len(part) - 1
    out = torch.zeros(num_receivers, f, dtype=torch.float32)
    pieces = torch.zeros(tiles, 2, f, dtype=torch.float32)
    split = set(cuda_segment.split_rows(indptr).tolist())
    for k in range(tiles):
        (i0, j0), (i1, j1) = part[k], part[k + 1]
        acc = torch.zeros(f)
        r, e = i0, j0
        while True:
            # Row ends at this edge position, then the next edge.
            while r < i1 and ip[r + 1] == e:
                if r == i0 and ip[r] < j0:
                    assert r in split
                    pieces[k, 0] = acc
                else:
                    out[r] = acc
                acc = torch.zeros(f)
                r += 1
            if e == j1:
                break
            acc = acc + x[e]
            e += 1
        assert r == i1
        if i1 < num_receivers and ip[i1] < j1:
            assert i1 in split
            pieces[k, 1] = acc
    s = cuda_segment.TILE_ITEMS
    for row in split:
        first, last = (ip[row] + row) // s, (ip[row + 1] + row) // s
        acc = torch.zeros(f)
        for k in range(first, last):
            acc = acc + pieces[k, 1]
        out[row] = acc + pieces[last, 0]
    return out.to(msgs.dtype)


def _encoder_counts():
    """Per-row edge counts of the 64x32 model's encoder (G2M) graph."""
    from graphcast_lite_torch import presets
    from graphcast_lite_torch.graphs.build import build_graph_set

    cfg = presets.interaction_net_64x32()
    lat, lon = presets.wb2_64x32_grid()
    g = build_graph_set(lat, lon, cfg.graph.mesh_levels,
                        cfg.graph.grid2mesh_radius_query).encoding
    return np.diff(g.indptr.numpy())


@pytest.mark.parametrize("name", list(_graphs()) + ["64x32 encoder"])
def test_replay_matches_plain_jax_and_pallas(name, monkeypatch):
    counts = _encoder_counts() if name == "64x32 encoder" \
        else _graphs()[name]
    r = len(counts)
    recv = np.repeat(np.arange(r), counts).astype(np.int32)
    e = len(recv)
    e_pad = max(128, -(-e // 128) * 128)
    r1 = np.full(e_pad, r - 1, np.int32)
    r1[:e] = recv
    rng = np.random.RandomState(r)
    f = 128
    m = np.zeros((e_pad, f), np.float32)
    m[:e] = rng.randn(e, f)
    indptr = indptr_from_receivers(torch.from_numpy(r1), r)
    msgs = torch.from_numpy(m)
    plain = cuda_segment.segment_sum_reference(msgs, indptr, r)
    mag = cuda_segment.segment_sum_reference(msgs.abs(), indptr, r)
    exact = np.asarray(jax.ops.segment_sum(
        jnp.asarray(m), jnp.asarray(r1), num_segments=r,
        indices_are_sorted=True))
    base, tile = build_schedule(r1, r, 256)
    pallas = np.asarray(segment_sum_sorted(
        jnp.asarray(m), jnp.asarray(r1), jnp.asarray(base),
        jnp.asarray(tile), r, 256, interpret=True))
    atol = 1e-3 if counts.max() >= 1_000 else 1e-4
    for tile in TILES:
        monkeypatch.setattr(cuda_segment, "TILE_ITEMS", tile)
        out = replay(msgs, indptr, r)
        _assert_order_close(out, plain, mag)
        _assert_order_close(out, exact, mag)
        np.testing.assert_allclose(out.numpy(), pallas, atol=atol, rtol=1e-4)


def test_replay_bf16_rounds_once(tile):
    """bf16 messages: every row, the split ones too, is the fp32 sum of its
    pieces rounded once, as the plain version rounds its fp32 sum."""
    counts = _graphs()["2500-edge receiver"]
    r = len(counts)
    indptr = _indptr(counts)
    rng = np.random.RandomState(1)
    msgs = torch.from_numpy(rng.randn(int(indptr[-1]), 128)
                            .astype(np.float32)).to(torch.bfloat16)
    out = replay(msgs, indptr, r)
    assert out.dtype == torch.bfloat16
    fp32 = replay(msgs.float(), indptr, r)
    assert torch.equal(out, fp32.to(torch.bfloat16))
    plain = cuda_segment.segment_sum_reference(msgs.float(), indptr, r)
    mag = cuda_segment.segment_sum_reference(msgs.float().abs(), indptr, r)
    _assert_order_close(fp32, plain, mag)
