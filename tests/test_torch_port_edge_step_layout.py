"""Host-side layout of the port's edge-step kernel
(``graphcast_lite_torch.ops.edge_step``): the design each dtype and width
takes, the weight repacks into the Hopper designs' shared-memory images
(bf16: ``wgmma_b_image``; fp32: W1e's ``tf32x3_b_image`` at K = De,
N = H), and the launch geometry (groups of receivers, or the fp32 design's
row-balanced persistent blocks with their statistics partials and h
workspace).  All are plain torch and Python, so they are held here on the
CPU; the kernel that reads them is held against its plain version on the
card by chip_smoke.py, which also checks the library's design query
against ``edge_step.design``.
"""

import numpy as np
import pytest
import torch

from graphcast_lite_torch.mesh.icosphere import build_hierarchy, \
    edges_from_faces, merge_mesh_levels
from graphcast_lite_torch.ops import edge_mlp, edge_step
from graphcast_lite_torch.ops.edge_step import launch_geometry, \
    wgmma_b_image


def unpack(image: np.ndarray, k: int, n: int) -> np.ndarray:
    """W [K, N] back out of its image: element (k, n) sits in slab n // 64,
    K block k // 64, row n % 64, 16-byte chunk ((k % 64) // 8) ^ (n % 8),
    place k % 8."""
    kk, nn = np.meshgrid(np.arange(k), np.arange(n), indexing="ij")
    return image[nn // 64, kk // 64, nn % 64,
                 (((kk % 64) // 8) ^ (nn % 8)) * 8 + kk % 8]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(128, 128), (256, 128), (128, 256),
                                 (256, 256)])
def test_wgmma_b_image_round_trip(k, n, dtype):
    w = torch.from_numpy(
        np.random.RandomState(k + n).randn(k, n).astype(np.float32)).to(dtype)
    image = wgmma_b_image(w)
    assert image.shape == (n // 64, k // 64, 64, 64)
    assert image.dtype == dtype and image.is_contiguous()
    np.testing.assert_array_equal(unpack(image.float().numpy(), k, n),
                                  w.float().numpy())
    # Each slab holds its 64 columns and nothing else: a slab is one
    # contiguous copy of K * 128 bytes.
    for cb in range(n // 64):
        np.testing.assert_array_equal(
            np.sort(image[cb].float().numpy().ravel()),
            np.sort(w[:, 64 * cb: 64 * cb + 64].float().numpy().ravel()))


@pytest.mark.parametrize("tile", [10, 16, 20])
@pytest.mark.parametrize("num_receivers", [1, 19, 20, 21, 40, 4_001,
                                           40_962])
def test_launch_geometry_covers_each_receiver_once(num_receivers, tile):
    groups, partials = launch_geometry(num_receivers, tile)
    assert partials == (groups, 3)
    covered = np.zeros(num_receivers, np.int64)
    for g in range(groups):
        lo, hi = g * tile, min((g + 1) * tile, num_receivers)
        assert lo < hi  # no group without receivers
        covered[lo:hi] += 1
    np.testing.assert_array_equal(covered, 1)


@pytest.mark.parametrize("hid", [128, 256, 384, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_design_selection(dtype, hid):
    """At H and De in {128, 256} each dtype takes its Hopper design (bf16
    in groups of 20 receivers, fp32 over row shares: 0 receivers a group);
    wider rows take the 16-receiver design; the edge MLP selects alike."""
    for de in (128, 256, 384, 512):
        hopper = hid in (128, 256) and de in (128, 256)
        expect = ("tile16" if not hopper else
                  "hopper_bf16" if dtype == torch.bfloat16 else
                  "hopper_fp32")
        assert edge_step.design(dtype, hid, de) == expect
        assert edge_step.design(dtype, hid, de) == edge_mlp.design(
            dtype, hid, de)
        assert edge_step.tile_receivers(dtype, hid, de) == {
            "tile16": 16, "hopper_bf16": 20, "hopper_fp32": 0}[expect]
    assert edge_step.DESIGNS == ("tile16", "hopper_bf16", "hopper_fp32")


@pytest.mark.parametrize("de,hid", [(128, 128), (256, 128), (128, 256),
                                    (256, 256)])
def test_w1e_tf32x3_image_round_trip(de, hid):
    """W1e [De, H] as the fp32 kernel's B operand of v @ W1e (K = De,
    N = H): [De / 32, 2, H, 32], K-slab k // 32, part (big, small), row n,
    16-byte chunk ((k % 32) // 4) ^ (n % 8), place k % 4; big is W1e's
    TF32 rounding, big + small W1e to within 2^-22, every place once."""
    w1e = torch.from_numpy(np.random.RandomState(de * hid).randn(de, hid)
                           .astype(np.float32))
    image = edge_step.tf32x3_b_image(w1e)
    assert image.shape == (de // 32, 2, hid, 32)
    assert image.dtype == torch.float32 and image.is_contiguous()
    kk, nn = np.meshgrid(np.arange(de), np.arange(hid), indexing="ij")
    place = (((kk % 32) // 4) ^ (nn % 8)) * 4 + kk % 4
    img = image.numpy()
    big, small = img[kk // 32, 0, nn, place], img[kk // 32, 1, nn, place]
    np.testing.assert_array_equal(big, edge_mlp.tf32_round(w1e).numpy())
    w = w1e.double().numpy()
    assert (np.abs(big.astype(np.float64) + small - w)
            <= 2.0 ** -22 * np.abs(w)).all()
    flat = (kk // 32) * 2 * hid * 32 + nn * 32 + place
    assert np.unique(flat).size == de * hid
    # A slab is one contiguous copy of 2 * H * 128 bytes.
    assert image[0].numel() * 4 == 2 * hid * 128


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("num_receivers", [1, 5, 132, 40_962])
def test_fp32_geometry(num_receivers, sms):
    """The fp32 design (0 receivers a group) runs min(R, SMs) blocks, one
    statistics partial and 128 rows of H of h workspace a block."""
    blocks, partials = launch_geometry(num_receivers, 0, sms)
    assert blocks == min(num_receivers, sms)
    assert partials == (blocks, 3)
    for hid in (128, 256):
        assert edge_step.workspace_shape(num_receivers, hid, sms) == (
            blocks, edge_step.F32_STEP_ROWS, hid)
    assert edge_step.F32_STEP_ROWS == 128


@pytest.mark.parametrize("sms", [0, -1])
def test_fp32_geometry_needs_the_sm_count(sms):
    """Tile 0 without an SM count has no valid geometry: it raises rather
    than give a launch of no blocks."""
    with pytest.raises(ValueError, match="SM count"):
        launch_geometry(40_962, 0, sms)
    assert launch_geometry(40_962, 16) == (2_561, (2_561, 3))


def _flagship_indptr():
    mesh = merge_mesh_levels(build_hierarchy(6), [4, 6])
    recv = np.sort(edges_from_faces(mesh.faces)[1])
    r = int(recv.max()) + 1
    indptr = np.searchsorted(recv, np.arange(r + 1)).astype(np.int32)
    assert indptr[-1] == 261_120 and r == 40_962
    return indptr


@pytest.mark.parametrize("case", ["skewed", "flagship"])
def test_fp32_row_shares_cover_each_receiver_once(case):
    """The fp32 blocks' row shares (``edge_mlp.fp32_bounds``) give every
    receiver to exactly one block, with all its rows; at the flagship
    multimesh the 132 blocks walk 16 steps of 128 rows each (2,112, each
    streaming W1e and W2 once), and the workspace holds 132 x 128 rows of
    H = 256 fp32 (17.3 MB)."""
    if case == "flagship":
        indptr, sms = _flagship_indptr(), 132
    else:
        rng = np.random.RandomState(3)
        deg = rng.randint(0, 9, 2_000)
        deg[10] = 2_500  # a receiver longer than a share
        deg[1_000:1_300] = 0  # empty receivers
        indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
        sms = 11
    r = indptr.size - 1
    blocks, partials = launch_geometry(r, 0, sms)
    rb = edge_mlp.fp32_bounds(torch.from_numpy(indptr), blocks).numpy()
    owner = np.zeros(r, np.int64)
    for b in range(blocks):
        owner[rb[b]:rb[b + 1]] += 1
    np.testing.assert_array_equal(owner, 1)
    rows = indptr[rb]
    assert rows[0] == 0 and rows[-1] == indptr[-1]
    assert (np.diff(rows) >= 0).all()
    if case == "flagship":
        steps = edge_mlp.fp32_steps_per_block(torch.from_numpy(indptr), sms)
        assert (steps == 16).all() and int(steps.sum()) == 2_112
        shape = edge_step.workspace_shape(r, 256, sms)
        assert np.prod(shape) * 4 == 132 * 128 * 256 * 4 == 17_301_504

