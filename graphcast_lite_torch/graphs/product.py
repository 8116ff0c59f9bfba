"""Temporal product-graph construction, time-chain ⊗ spatial k-NN (torch
counterpart of ``graphcast_lite_tpu.graphs.product``, with no sklearn).

The edge set is built directly in sparse COO over T·N nodes, node id
t·N + i (time-major):

  s01 · (I_T ⊗ A_space):    (t, i) → (t, j)     for every spatial edge (i, j)
  s10 · (A_time ⊗ I_N):     (t, i) → (t+1, i)
  s11 · (A_time ⊗ A_space): (t, i) → (t+1, j)   for every spatial edge (i, j)

with (s01, s10, s11) chosen by the product type: KRONECKER (0, 0, 1),
CARTESIAN (1, 1, 0), STRONG (1, 1, 1).

The spatial k-NN is Euclidean in (lat, lon), without self, as the JAX
package's (sklearn's ``kneighbors_graph``).  On a regular grid many
neighbours lie at the same distance; this one keeps the lowest node ids
among equidistant candidates, where sklearn's KD-tree keeps whichever its
walk meets first.  So every node gets the same neighbour distances in
both, and the two edge sets differ only where a tie decides (on the WB2
64×32 grid at k = 4, 81 of the 8,192 edges of each set are not in the
other: 162 in their symmetric difference).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial import cKDTree

from ..config import ProductGraphType

__all__ = ["build_product_graph_edges", "spatial_knn_adjacency"]


def spatial_knn_adjacency(
    grid_lat: np.ndarray, grid_lon: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """k-NN spatial edges (senders, receivers) over the (lat, lon) points
    in the lat-major flatten order: each point sends to its k nearest
    other points, nearest first, ties to the lowest id.

    A KD-tree is queried for k + 1 + m points (the point itself among
    them), m doubled while some point's k-th neighbour is as far as the
    last point queried, so that every candidate at the k-th distance is
    seen before the lowest ids are kept."""
    lat = np.asarray(grid_lat)
    lon = np.asarray(grid_lon)
    pts = np.stack([np.repeat(lat, lon.size), np.tile(lon, lat.size)],
                   axis=1)
    n = pts.shape[0]
    if not 0 < k < n:
        raise ValueError(f"k = {k} neighbours among {n} points")
    tree = cKDTree(pts)
    extra = 1
    while True:
        q = min(k + 1 + extra, n)
        dist, idx = tree.query(pts, k=q)
        # Drop each point itself, then order by (distance, id).
        keep = idx != np.arange(n)[:, None]
        dist = dist[keep].reshape(n, q - 1)
        idx = idx[keep].reshape(n, q - 1)
        order = np.lexsort((idx, dist), axis=1)
        dist = np.take_along_axis(dist, order, axis=1)
        idx = np.take_along_axis(idx, order, axis=1)
        if q == n or (dist[:, k - 1] < dist[:, -1]).all():
            break
        extra *= 2
    senders = np.repeat(np.arange(n, dtype=np.int64), k)
    return senders, idx[:, :k].reshape(-1).astype(np.int64)


def build_product_graph_edges(
    grid_lat: np.ndarray,
    grid_lon: np.ndarray,
    obs_window: int,
    num_k: int,
    product_type: ProductGraphType,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse COO (senders, receivers) of the product graph over T·N nodes."""
    t_steps = obs_window
    sp_s, sp_r = spatial_knn_adjacency(grid_lat, grid_lon, num_k)
    n = len(grid_lat) * len(grid_lon)

    if product_type == ProductGraphType.KRONECKER:
        s01, s10, s11 = 0, 0, 1
    elif product_type == ProductGraphType.CARTESIAN:
        s01, s10, s11 = 1, 1, 0
    elif product_type == ProductGraphType.STRONG:
        s01, s10, s11 = 1, 1, 1
    else:
        raise ValueError(product_type)

    senders, receivers = [], []
    for t in range(t_steps):
        base = t * n
        if s01:
            senders.append(sp_s + base)
            receivers.append(sp_r + base)
        if t + 1 < t_steps:
            nxt = (t + 1) * n
            if s10:
                ids = np.arange(n, dtype=np.int64)
                senders.append(ids + base)
                receivers.append(ids + nxt)
            if s11:
                senders.append(sp_s + base)
                receivers.append(sp_r + nxt)
    return (
        np.concatenate(senders) if senders else np.zeros(0, np.int64),
        np.concatenate(receivers) if receivers else np.zeros(0, np.int64),
    )
