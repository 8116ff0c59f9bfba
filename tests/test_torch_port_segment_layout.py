"""Host-side layout of the port's merge-path segment-sum designs
(``graphcast_lite_torch.ops.cuda_segment``): the merge-path partition of
row ends and edges into tiles of ``TILE_ITEMS`` items (balanced) or
``narrow_tile_items`` items (narrow; boundaries moved back to the start
of a short row), the long rows that cross a tile boundary, which shapes
take which of the three designs, and plain-torch replays of both kernels'
walks held against the plain version, against ``jax.ops.segment_sum`` and
against the Pallas kernel in interpret mode, at several tile sizes: the
balanced walk (fp32 sums in row order, a split row's pieces added in tile
order by the last tile to arrive) and the narrow walk (the tile's message
run staged by 16-byte loads with scalar ends, flat (row, column) outputs
owned by the block's threads in turn, fp32 sums in edge order, split rows
as in the balanced walk).  All of it runs on the CPU; chip_smoke.py checks
the design selection and tile sizes against the built library's own
queries and holds the kernels against their plain version on the card.

Tolerances: the replay and ``segment_sum_reference`` both accumulate in
fp32 and differ only in the order of the additions, as does
``jax.ops.segment_sum``: 1e-5 + 1e-5 * |ref| + ORDER_RTOL * sum_e |msgs_e|,
chip_smoke.py's stated bound (a 2,500-edge row of N(0, 1) messages reaches
partial sums of about 50, so its order error outgrows 1e-5).  The Pallas
fp32 path sums a hi/lo bf16 split (about 1.5e-5 relative), hence 1e-4, and
1e-3 where a row sums 2,500 terms, as tests/test_torch_port_segment.py
uses.  In bf16 every version rounds an fp32 sum once, so two of them are
at most one bf16 rounding apart: 1e-5 + 1e-2 * |ref| + ORDER_RTOL * sum_e
|msgs_e| (chip_smoke.py's bf16 bound), and the narrow replay of bf16
messages is bitwise its fp32 replay rounded once.
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
# NARROW_BYTES values the narrow mirror is held at (the kernel's is 8192).
NARROW_TILE_BYTES = (256, 2048, 8192)
NARROW_THREADS = 128  # csrc/segment_sum.cu: kNarrowThreads
ORDER_RTOL = 1e-5


def _f32(x):
    """A torch tensor (fp32 or bf16) or an array as an fp32 array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_order_close(out, ref, mag, rtol=1e-5):
    """|out - ref| <= 1e-5 + rtol |ref| + ORDER_RTOL * mag everywhere."""
    out, ref = _f32(out), _f32(ref)
    allowed = 1e-5 + rtol * np.abs(ref) + ORDER_RTOL * np.asarray(mag)
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
    narrow design every row under 256 bytes, aligned or not: F <= 63 in
    fp32 and F <= 127 in bf16; the warp-per-row design takes the rest."""
    size = 4 if dtype == torch.float32 else 2
    for f in (1, 4, 19, 33, 63, 64, 65, 127, 128, 129, 256, 512, 1024):
        row = f * size
        if aligned and row % 16 == 0 and 256 <= row <= 1024:
            want = "balanced"
        elif row < 256:
            want = "narrow"
        else:
            want = "warp"
        assert cuda_segment.segment_design(dtype, f, aligned) == want, (
            dtype, f, aligned)
    assert cuda_segment.segment_design(dtype, 256) == "balanced"
    assert cuda_segment.segment_design(dtype, 19, aligned) == "narrow"
    assert cuda_segment.segment_design(torch.float16, 256) == "warp"
    assert cuda_segment.segment_design(torch.float16, 19) == "warp"
    assert cuda_segment.DESIGNS == {"warp": 0, "balanced": 1, "narrow": 2}


def test_narrow_tile_items():
    """A narrow tile holds NARROW_BYTES of message rows: 215 items at the
    decoder's bf16 F = 19, 62 at fp32 F = 33, 512 at fp32 F = 4, and at
    most NARROW_MAX_ITEMS (fp32 F = 1 and 2, bf16 F = 1-4)."""
    items = cuda_segment.narrow_tile_items
    assert cuda_segment.NARROW_BYTES == 8192
    assert items(torch.bfloat16, 19) == 215
    assert items(torch.float32, 33) == 62
    assert items(torch.float32, 4) == 512
    assert items(torch.float32, 1) == cuda_segment.NARROW_MAX_ITEMS == 1024
    assert items(torch.float32, 2) == items(torch.bfloat16, 4) == 1024
    assert items(torch.float32, 63) == 32 and items(torch.bfloat16, 127) == 32


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


def _stage_plan(offset, n, size):
    """The narrow kernel's loads of a run of n elements of ``size`` bytes
    whose first element sits ``offset`` bytes past a 16-byte boundary:
    (elements loaded by scalar loads, first elements of 16-byte loads)."""
    per = 16 // size
    lead = offset // size
    head = min(n, (per - lead) % per)
    nvec = (n - head) // per
    tail0 = head + nvec * per
    return (list(range(head)) + list(range(tail0, n)),
            [head + per * q for q in range(nvec)])


@pytest.mark.parametrize("size", [4, 2])
def test_narrow_stage_covers_the_run_once(size):
    """Every element of the tile's run is loaded once, by a 16-byte load
    from a 16-byte boundary or by one of at most 2 x (16 / size - 1)
    scalar loads at the run's ends, and nothing outside the run is read,
    whatever the run's offset within 16 bytes."""
    per = 16 // size
    for offset in range(0, 16, size):
        for n in list(range(0, 3 * per)) + [215 * 19, 8191 // size]:
            scalars, vectors = _stage_plan(offset, n, size)
            assert len(scalars) <= 2 * (per - 1)
            loaded = list(scalars)
            for v in vectors:
                assert (offset + v * size) % 16 == 0
                loaded += range(v, v + per)
            assert sorted(loaded) == list(range(n)), (offset, n)


def _narrow_owners(nflat, f, threads=NARROW_THREADS):
    """Flat output -> (thread, row, column) as the kernel's threads step
    through them: thread t starts at (t // F, t % F) and moves on by
    (threads // F, threads % F) with a carry."""
    owners = {}
    drow, dcol = divmod(threads, f)
    for t in range(threads):
        row, col = divmod(t, f)
        for flat in range(t, nflat, threads):
            assert flat not in owners
            owners[flat] = (t, row, col)
            row, col = row + drow, col + dcol
            if col >= f:
                row, col = row + 1, col - f
    return owners


@pytest.mark.parametrize("f", [1, 4, 19, 33, 63, 127])
def test_narrow_threads_own_flat_outputs(f):
    """Thread t owns flat outputs t, t + 128, ...: each (row, column) of
    the tile's rows once, consecutive threads on consecutive elements."""
    for nflat in (0, 1, f, 5 * f, 300 * f):
        owners = _narrow_owners(nflat, f)
        assert sorted(owners) == list(range(nflat))
        for flat, (t, row, col) in owners.items():
            assert t == flat % NARROW_THREADS
            assert (row, col) == divmod(flat, f)


def replay_narrow(msgs, indptr, num_receivers):
    """The narrow kernel's arithmetic in plain torch, tile by tile with the
    tile size it takes for this dtype and width: the tile's run of message
    elements [j0 * F, jend * F) (never past indptr[R]); the rows it ends and
    the piece of the long row under way at its end, each (row, column) in
    fp32 in edge order and stored once; a split row's pieces in its tiles'
    slots (0: the tile where it ends, 1: the others), summed in tile order
    and stored once.  [E, F] or [B, E, F]."""
    m3 = msgs[None] if msgs.dim() == 2 else msgs
    f = m3.shape[-1]
    items = cuda_segment.narrow_tile_items(msgs.dtype, f)
    part = cuda_segment.tile_partition(indptr, m3.shape[-2], items).tolist()
    split = set(cuda_segment.split_rows(indptr, items).tolist())
    ip = indptr.tolist()
    r_all, tiles = num_receivers, len(part) - 1
    outs = []
    for b in range(m3.shape[0]):
        flat_msgs = m3[b].reshape(-1)
        out = torch.zeros(r_all, f, dtype=torch.float32)
        stored = torch.zeros(r_all, dtype=torch.int64)
        pieces = torch.zeros(tiles, 2, f, dtype=torch.float32)
        for k in range(tiles):
            (i0, j0), (i1, j1) = part[k], part[k + 1]
            tail = i1 < r_all and ip[i1] < j1
            jend = j1 if i1 < r_all else min(j1, ip[r_all])
            run = flat_msgs[j0 * f:max(j0, jend) * f].float().reshape(-1, f)
            rows = i1 - i0
            lead_split = rows > 0 and ip[i0] < j0
            for x in range(rows + (1 if tail else 0)):
                r = i0 + x
                lo, hi = max(ip[r], j0) - j0, min(ip[r + 1], j1) - j0
                assert hi <= run.shape[0]
                acc = torch.zeros(f)
                for e in range(lo, hi):
                    acc = acc + run[e]
                if x == rows:
                    assert r in split
                    pieces[k, 1] = acc
                elif x == 0 and lead_split:
                    assert r in split
                    pieces[k, 0] = acc
                else:
                    out[r] = acc
                    stored[r] += 1
        for row in split:
            first = (ip[row] + row) // items
            last = (ip[row + 1] + row) // items
            acc = torch.zeros(f)
            for k in range(first, last + 1):
                acc = acc + pieces[k, 0 if k == last else 1]
            out[row] = acc
            stored[row] += 1
        assert (stored == 1).all()
        outs.append(out.to(msgs.dtype))
    return torch.stack(outs) if msgs.dim() == 3 else outs[0]


def _narrow_graph():
    """Per-row edge counts: a 2,500-edge row (several tiles at every tile
    size), runs of 300 and 40 empty rows, short rows of 0-6 edges."""
    rng = np.random.RandomState(7)
    return np.concatenate([rng.randint(0, 5, 60), [2_500],
                           np.zeros(300, np.int64), rng.randint(0, 7, 250),
                           np.zeros(40, np.int64), rng.randint(1, 4, 30)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("f", [1, 4, 19, 33])
def test_narrow_replay_matches_plain_jax_and_pallas(f, dtype, monkeypatch):
    """The narrow walk at three tile sizes, B = 2, with message rows past
    indptr[R], against the plain version, ``jax.ops.segment_sum`` and the
    Pallas kernel in interpret mode (each batch item)."""
    counts = _narrow_graph()
    r = len(counts)
    recv = np.repeat(np.arange(r), counts).astype(np.int32)
    e = len(recv)
    e_pad = -(-e // 128) * 128 + 128  # at least 128 rows past indptr[R]
    r1 = np.full(e_pad, r - 1, np.int32)
    r1[:e] = recv
    rng = np.random.RandomState(f)
    m = np.zeros((2, e_pad, f), np.float32)
    m[:, :e] = rng.randn(2, e, f)
    msgs = torch.from_numpy(m).to(dtype)
    exact32 = msgs.float().numpy()  # the values both sides sum
    # Rows [e, e_pad) are zero; they belong to row R - 1 in r1 (for JAX
    # and Pallas) and to no row in indptr (indptr[R] = e).
    indptr = _indptr(counts)
    plain = cuda_segment.segment_sum_reference(msgs, indptr, r)
    mag = cuda_segment.segment_sum_reference(msgs.float().abs(), indptr, r)
    base, tile = build_schedule(r1, r, 256)
    refs = []
    for b in range(2):
        jx = jax.ops.segment_sum(jnp.asarray(exact32[b]), jnp.asarray(r1),
                                 num_segments=r, indices_are_sorted=True)
        pallas = segment_sum_sorted(
            jnp.asarray(exact32[b]).astype(
                jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
            jnp.asarray(r1), jnp.asarray(base), jnp.asarray(tile), r, 256,
            interpret=True)
        refs.append((torch.from_numpy(np.array(jx)).to(dtype),
                     torch.from_numpy(np.array(pallas.astype(
                         jnp.float32)))))
    rtol = 1e-5 if dtype == torch.float32 else 1e-2
    for nbytes in NARROW_TILE_BYTES:
        monkeypatch.setattr(cuda_segment, "NARROW_BYTES", nbytes)
        items = cuda_segment.narrow_tile_items(dtype, f)
        assert cuda_segment.split_rows(indptr, items).numel() > 0
        out = replay_narrow(msgs, indptr, r)
        assert out.dtype == dtype and out.shape == (2, r, f)
        _assert_order_close(out, plain, mag, rtol)
        for b, (jx, pallas) in enumerate(refs):
            _assert_order_close(out[b], jx, mag[b], rtol)
            if dtype == torch.float32:
                np.testing.assert_allclose(out[b].numpy(), pallas.numpy(),
                                           atol=1e-3, rtol=1e-4)
            else:
                _assert_order_close(out[b], pallas, mag[b], rtol)
        if dtype == torch.bfloat16:
            monkeypatch.setattr(cuda_segment, "NARROW_BYTES", nbytes * 2)
            # The bf16 tile (half the row bytes) holds twice the items:
            # replay fp32 at the same items to compare bitwise.
            assert cuda_segment.narrow_tile_items(torch.float32, f) == items
            fp32 = replay_narrow(msgs.float(), indptr, r)
            assert torch.equal(out, fp32.to(torch.bfloat16))
