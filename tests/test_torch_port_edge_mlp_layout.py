"""Host-side layout of the port's edge-MLP kernels
(``graphcast_lite_torch.ops.edge_mlp``): which widths take which of the
three designs, the bf16 persistent blocks' walk over receiver groups, the
fp32 blocks' row-balanced receiver ranges, and W2's wgmma images (bf16, and
fp32's 3xTF32 K-slabs) as the kernels address them in shared memory.  All
of it is plain torch and Python, held here on the CPU; chip_smoke.py checks
the width selection against the built library's own query and holds the
kernels against their plain version on the card.
"""

import numpy as np
import pytest
import torch

from graphcast_lite_torch.mesh.icosphere import build_hierarchy, \
    edges_from_faces, merge_mesh_levels
from graphcast_lite_torch.ops import edge_mlp
from torch_port_common import \
    one_torch_thread  # noqa: F401 (an autouse fixture)

WIDTHS = (128, 256, 384, 512)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hid", WIDTHS)
def test_width_selection(hid, dtype):
    """H and De in {128, 256} take the Hopper design of their dtype (bf16:
    W2 resident; fp32: 3xTF32, W2 streamed); wider rows in either dtype the
    16-receiver one."""
    for de in WIDTHS:
        hopper = hid <= 256 and de <= 256
        expect = ("tile16" if not hopper else "hopper_bf16"
                  if dtype == torch.bfloat16 else "hopper_fp32")
        assert edge_mlp.design(dtype, hid, de) == expect
        assert edge_mlp.DESIGNS.index(expect) == (
            0 if not hopper else 1 if dtype == torch.bfloat16 else 2)
        assert edge_mlp.tile_receivers(dtype, hid, de) == {
            "tile16": edge_mlp.TILE_RECEIVERS,
            "hopper_bf16": edge_mlp.HOPPER_RECEIVERS,
            "hopper_fp32": 0}[expect]
        assert edge_mlp.supports(hid, de, "swish")


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("num_receivers", [1, 31, 32, 33, 4_001, 40_962])
def test_hopper_geometry_covers_each_receiver_once(num_receivers, sms):
    groups, blocks = edge_mlp.hopper_geometry(num_receivers, sms)
    g = edge_mlp.HOPPER_RECEIVERS
    assert groups == -(-num_receivers // g)
    assert 1 <= blocks <= min(groups, sms)
    covered = np.zeros(num_receivers, np.int64)
    for b in range(blocks):
        walk = range(b, groups, blocks)
        assert len(walk) >= 1  # no block without a group
        for k in walk:
            lo, hi = k * g, min((k + 1) * g, num_receivers)
            assert lo < hi
            covered[lo:hi] += 1
    np.testing.assert_array_equal(covered, 1)


def test_subtiles_per_block_counts_each_groups_rows():
    rng = np.random.RandomState(0)
    r = 1_000
    indptr = np.concatenate([[0], np.cumsum(rng.randint(0, 40, r))])
    tiles = edge_mlp.subtiles_per_block(
        torch.from_numpy(indptr.astype(np.int32)), 7)
    g = edge_mlp.HOPPER_RECEIVERS
    expect = np.zeros(7, np.int64)
    for k in range(-(-r // g)):
        rows = indptr[min((k + 1) * g, r)] - indptr[k * g]
        expect[k % 7] += -(-rows // 64)
    np.testing.assert_array_equal(tiles.numpy(), expect)


def test_flagship_groups_fill_their_subtiles():
    """At the flagship multimesh (levels [4, 6]) 32-receiver groups hold
    about 204 rows, close to three full sub-tiles: 4,082 sub-tiles for
    261,120 rows (4,080 at the least), at most 33 on one of 132 blocks."""
    mesh = merge_mesh_levels(build_hierarchy(6), [4, 6])
    recv = np.sort(edges_from_faces(mesh.faces)[1])
    r = int(recv.max()) + 1
    indptr = np.searchsorted(recv, np.arange(r + 1)).astype(np.int32)
    tiles = edge_mlp.subtiles_per_block(torch.from_numpy(indptr), 132)
    assert len(recv) == 261_120 and r == 40_962
    assert int(tiles.sum()) == 4_082 and int(tiles.max()) == 33


def _kernel_offset(k, n, hid, de):
    """Byte offset at which the kernel's wgmma reads W2[k, n] in shared
    memory: slab n // 64 of H * 128 bytes, K block k // 64 of 8 KB, row
    n % 64 of 128 bytes, 16-byte chunk ((k % 64) // 8) ^ (n % 8)."""
    return ((n // 64) * hid * 128 + (k // 64) * 8192 + (n % 64) * 128
            + ((((k % 64) // 8) ^ (n % 8)) << 4) + (k % 8) * 2)


@pytest.mark.parametrize("hid,de", [(128, 128), (256, 128), (128, 256),
                                    (256, 256)])
def test_w2_image_as_the_kernel_reads_it(hid, de):
    w2 = torch.from_numpy(np.random.RandomState(hid + de).randn(hid, de)
                          .astype(np.float32)).to(torch.bfloat16)
    image = edge_mlp.wgmma_b_image(w2)
    assert image.shape == (de // 64, hid // 64, 64, 64)
    flat = image.reshape(-1).float().numpy()
    kk, nn = np.meshgrid(np.arange(hid), np.arange(de), indexing="ij")
    np.testing.assert_array_equal(
        flat[_kernel_offset(kk, nn, hid, de) // 2], w2.float().numpy())
    # Warpgroup wg's slabs wg * NS + s hold the columns its epilogue
    # writes, [wg De / 2 + 64 s, wg De / 2 + 64 s + 64).
    ns = de // 128
    for wg in range(2):
        for s in range(ns):
            slab = wg * ns + s
            assert 64 * slab == wg * (de // 2) + 64 * s
            np.testing.assert_array_equal(
                np.sort(image[slab].float().numpy().ravel()),
                np.sort(w2[:, 64 * slab: 64 * slab + 64].float().numpy()
                        .ravel()))


def _f32_kernel_offset(k, n, hid, de):
    """Byte offset from the image's start at which the fp32 kernel reads
    W2[k, n]'s big part (the small part: + de * 128): K-slab k // 32 of
    2 * de * 128 bytes, row n of 128 bytes, 16-byte chunk
    ((k % 32) // 4) ^ (n % 8), 4 bytes an element."""
    return ((k // 32) * 2 * de * 128 + n * 128
            + ((((k % 32) // 4) ^ (n % 8)) << 4) + (k % 4) * 4)


@pytest.mark.parametrize("hid,de", [(128, 128), (256, 128), (128, 256),
                                    (256, 256)])
def test_tf32x3_image_as_the_kernel_reads_it(hid, de):
    """Every element of W2's big and small parts sits exactly once in the
    fp32 image, at the place the kernel's wgmma reads it."""
    w2 = torch.from_numpy(np.random.RandomState(hid * de).randn(hid, de)
                          .astype(np.float32))
    image = edge_mlp.tf32x3_b_image(w2)
    assert image.shape == (hid // 32, 2, de, 32)
    assert image.dtype == torch.float32
    flat = image.reshape(-1).numpy()
    big, small = (p.numpy() for p in edge_mlp.tf32_split(w2))
    kk, nn = np.meshgrid(np.arange(hid), np.arange(de), indexing="ij")
    off = _f32_kernel_offset(kk, nn, hid, de) // 4
    assert np.unique(off).size == hid * de  # each place once
    np.testing.assert_array_equal(flat[off], big)
    np.testing.assert_array_equal(flat[off + de * 32], small)
    # Every place of the image holds one of them: the offsets and their
    # small-part twins cover it.
    assert np.array_equal(np.sort(np.concatenate([off.ravel(),
                                                  off.ravel() + de * 32])),
                          np.arange(flat.size))


@pytest.mark.parametrize("blocks", [1, 5, 132])
def test_fp32_bounds_cover_each_receiver_once(blocks):
    """The fp32 blocks own consecutive receiver ranges covering [0, R)
    once, each starting at the first receiver at or after its share's first
    row; ranges may be empty (a receiver's rows never split)."""
    rng = np.random.RandomState(blocks)
    deg = rng.randint(0, 12, 3_000)
    deg[100] = 2_500  # one receiver longer than a share
    deg[2_000:2_400] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    rb = edge_mlp.fp32_bounds(torch.from_numpy(indptr), blocks).numpy()
    e = int(indptr[-1])
    assert rb[0] == 0 and rb[-1] == 3_000
    assert (np.diff(rb) >= 0).all()
    for b in range(blocks):
        t = b * e // blocks
        assert rb[b] == np.searchsorted(indptr, t, side="left")
        assert indptr[rb[b]] >= t
        assert rb[b] == 0 or indptr[rb[b] - 1] < t


@pytest.mark.parametrize("shape", ["flagship", "regional"])
def test_fp32_steps_fill_their_tiles(shape):
    """At the flagship multimesh (levels [4, 6]) and the regional head's
    reg-level-8 processing graph, 132 fp32 blocks take 15-16 (flagship)
    and 13-14 (regional) steps of 128 rows each: every step but a block's
    last is full."""
    if shape == "flagship":
        mesh = merge_mesh_levels(build_hierarchy(6), [4, 6])
        recv = np.sort(edges_from_faces(mesh.faces)[1])
        r = int(recv.max()) + 1
        indptr = np.searchsorted(recv, np.arange(r + 1)).astype(np.int32)
        assert indptr[-1] == 261_120 and r == 40_962
    else:
        indptr = _regional_indptr()
        assert indptr[-1] == 228_352 and indptr.size - 1 == 41_046
    steps = edge_mlp.fp32_steps_per_block(torch.from_numpy(indptr), 132)
    rows = indptr[edge_mlp.fp32_bounds(torch.from_numpy(indptr), 132)
                  .numpy()]
    assert steps.numel() == 132
    assert int(np.diff(rows).sum()) == indptr[-1]
    lo, hi = (15, 16) if shape == "flagship" else (13, 14)
    assert lo <= int(steps.min()) and int(steps.max()) <= hi
    # The rows fill 128-row steps to within a block's last step.
    assert int(steps.sum()) * 128 - int(indptr[-1]) < 132 * 128


def _regional_indptr():
    """Receiver CSR offsets of the regional head's processing graph (the
    reg-level-8 mesh over the README's ROI, as ``build_regional_graphs``
    builds it), the padding rows on the last receiver."""
    from graphcast_lite_torch.graphs.regional import create_regional_mesh
    from graphcast_lite_torch.graphs.structure import build_graph

    mesh, lats, _ = create_regional_mesh((20.0, 60.0, 60.0, 140.0), 8, 2.0,
                                         6)
    send, recv = edges_from_faces(mesh.faces)
    graph = build_graph(send, recv, num_nodes=len(lats))
    return graph.indptr.numpy().astype(np.int32)
