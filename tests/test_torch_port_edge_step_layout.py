"""Host-side layout of the port's bf16 edge-step kernel
(``graphcast_lite_torch.ops.edge_step``): the weight repack into wgmma's
shared-memory image and the launch geometry.  Both are plain torch and
Python, so they are held here on the CPU; the kernel that reads them is
held against its plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

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
