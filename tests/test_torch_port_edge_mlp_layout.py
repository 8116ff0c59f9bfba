"""Host-side layout of the port's bf16 edge-MLP kernel
(``graphcast_lite_torch.ops.edge_mlp``): which widths take the Hopper
design, the persistent blocks' walk over receiver groups, and W2's wgmma
image as the kernel addresses it in shared memory.  All of it is plain
torch and Python, held here on the CPU; chip_smoke.py checks the width
selection against the built library's own query and holds the kernel
against its plain version on the card.
"""

import numpy as np
import pytest
import torch

from graphcast_lite_torch.mesh.icosphere import build_hierarchy, \
    edges_from_faces, merge_mesh_levels
from graphcast_lite_torch.ops import edge_mlp

WIDTHS = (128, 256, 384, 512)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hid", WIDTHS)
def test_width_selection(hid, dtype):
    """bf16 with H and De in {128, 256} takes the Hopper design; fp32 and
    wider bf16 rows the 16-receiver one."""
    for de in WIDTHS:
        hopper = (dtype == torch.bfloat16 and hid <= 256 and de <= 256)
        assert edge_mlp.wgmma_design(dtype, hid, de) == hopper
        assert edge_mlp.tile_receivers(dtype, hid, de) == (
            edge_mlp.HOPPER_RECEIVERS if hopper else edge_mlp.TILE_RECEIVERS)
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
