"""The differentiable collectives (``parallel.collectives``) on 2 gloo
ranks, in float64, on the CPU.

Each function's forward is what JAX's collective gives (the tiled
all-gather, the point-to-point round with zeros where no pair ends, the
sum), and its backward is the exact adjoint of its forward: summed over
the ranks, <f(x), y> equals <x, fᵀ(y)>, where fᵀ(y) is the gradient that
autograd returns for the cotangent y; fᵀ is also checked against its
closed form.  Over a group of one rank each is the identity.  The plain
in-place all-reduce and broadcast, and no host staging for CPU tensors.
"""

import numpy as np
import pytest
import torch

import torch_port_dist as tpd
from torch_port_common import \
    one_torch_thread  # noqa: F401 (an autouse fixture)

ROWS, COLS = 3, 4
PAIRS = {"one_way": [(0, 1)], "swap": [(0, 1), (1, 0)]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tpd.spawn(tpd.collective_cases, 2,
                     tmp_path_factory.mktemp("coll"),
                     {"rows": ROWS, "cols": COLS, "pairs": PAIRS},
                     timeout=180)


def _draw(seed, rows):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(rows, COLS, generator=g,
                       dtype=torch.float64).numpy()


X = [_draw(100 + r, ROWS) for r in range(2)]


def _adjoint_holds(got, key):
    lhs = sum(r[key][2] for r in got)
    rhs = sum(r[key][3] for r in got)
    assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs)), (key, lhs, rhs)


def test_all_gather_rows(ranks):
    y = [_draw(200 + r, 2 * ROWS) for r in range(2)]
    for r, res in enumerate(ranks):
        out, grad, _, _ = res["all_gather/world"]
        np.testing.assert_array_equal(out, np.concatenate(X))
        # The reduce-scatter of the cotangents: block r of their sum.
        np.testing.assert_allclose(
            grad, (y[0] + y[1])[r * ROWS:(r + 1) * ROWS], rtol=1e-15)
    _adjoint_holds(ranks, "all_gather/world")


def test_all_reduce_sum(ranks):
    y = [_draw(300 + r, ROWS) for r in range(2)]
    for res in ranks:
        out, grad, _, _ = res["all_reduce_sum/world"]
        np.testing.assert_allclose(out, X[0] + X[1], rtol=1e-15)
        np.testing.assert_allclose(grad, y[0] + y[1], rtol=1e-15)
    _adjoint_holds(ranks, "all_reduce_sum/world")


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_ppermute_rows(ranks, name):
    y = [_draw(400 + r, ROWS) for r in range(2)]
    pairs = PAIRS[name]
    for r, res in enumerate(ranks):
        out, grad, _, _ = res[f"ppermute/{name}"]
        src = [s for s, d in pairs if d == r]
        dst = [d for s, d in pairs if s == r]
        np.testing.assert_array_equal(
            out, X[src[0]] if src else np.zeros_like(X[r]))
        # The same round reversed: the cotangent of the destination.
        np.testing.assert_array_equal(
            grad, y[dst[0]] if dst else np.zeros_like(X[r]))
    _adjoint_holds(ranks, f"ppermute/{name}")


@pytest.mark.parametrize("key", ["all_gather/solo", "all_reduce_sum/solo"])
def test_one_rank_group_is_the_identity(ranks, key):
    seed = 200 if key.startswith("all_gather") else 300
    for r, res in enumerate(ranks):
        out, grad, _, _ = res[key]
        np.testing.assert_array_equal(out, X[r])
        np.testing.assert_array_equal(grad, _draw(seed + r, ROWS))


def test_ppermute_without_pairs_gives_zeros(ranks):
    for res in ranks:
        out, grad, _, _ = res["ppermute/solo"]
        assert not out.any() and not grad.any()


def test_in_place_collectives(ranks):
    for res in ranks:
        np.testing.assert_allclose(res["all_reduce_"], X[0] + X[1],
                                   rtol=1e-15)
        np.testing.assert_array_equal(res["broadcast_"], X[1])
        # CPU tensors under gloo are not staged.
        assert res["staged_bytes"] == 0
