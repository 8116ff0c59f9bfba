"""Regional graph builders for the dual-mesh and ROI-residual stacks (torch
counterpart of ``graphcast_lite_tpu.graphs.regional``; NumPy and
``scipy.spatial.cKDTree`` through the port's own ``mesh`` modules, the
graphs in the port's layout, ``graphs.structure``).

Host-side graph compiler.  ~ reference ``src/dual_mesh.py``:

* ``create_regional_mesh`` (:43-124): level-L icosahedral vertices inside
  ROI+buffer that are NOT part of the global mesh prefix (level-6 vertex set
  is a prefix of level 7/8 — nested hierarchy), faces re-indexed.
* ``build_cross_edges`` (:129-202): k-NN bidirectional global↔regional mesh
  edges with 4-D GraphCast edge features in the unified coordinate list.
* ``build_regional_grid_mesh_edges`` (:207-297): mesh-centric k-NN encoding
  edges (every regional mesh node is fed) and grid-centric k-NN decoding
  edges with distances (every ROI grid point is covered) + normalized IDW
  weights (:560-567), in the decoding graph's padded, receiver-sorted
  order.
* ``build_roi_knn_graph`` (reference src/roi_residual.py:15-61): symmetric
  k-NN graph over the ROI *grid* points for the ROI-residual head.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..mesh.icosphere import TriMesh, build_hierarchy, edges_from_faces
from ..mesh.connectivity import knn_edges
from ..mesh.features import edge_spatial_features, lat_lon_to_cartesian
from .structure import Graph, build_graph

__all__ = [
    "RegionalGraphs",
    "create_regional_mesh",
    "build_cross_edges",
    "build_regional_grid_mesh_edges",
    "build_regional_graphs",
    "build_roi_knn_graph",
]


def create_regional_mesh(
    roi: Tuple[float, float, float, float],
    level: int = 7,
    buffer_deg: float = 2.0,
    global_level: int = 6,
) -> Tuple[TriMesh, np.ndarray, np.ndarray]:
    """Level-`level` vertices in ROI+buffer minus the global-mesh prefix."""
    lat_min, lat_max, lon_min, lon_max = roi
    meshes = build_hierarchy(level)
    finest = meshes[level]
    v = finest.vertices
    lats = np.degrees(np.arcsin(np.clip(v[:, 2], -1, 1)))
    lons = np.degrees(np.arctan2(v[:, 1], v[:, 0])) % 360.0

    n_global = meshes[min(level, global_level)].num_vertices
    in_roi = (
        (lats >= lat_min - buffer_deg) & (lats <= lat_max + buffer_deg)
        & (lons >= lon_min - buffer_deg) & (lons <= lon_max + buffer_deg)
    )
    new_only = np.zeros(len(v), bool)
    new_only[n_global:] = True
    mask = in_roi & new_only
    kept = np.flatnonzero(mask)
    if len(kept) == 0:
        raise ValueError(
            f"No regional mesh vertices in ROI {roi} (buffer {buffer_deg}°); "
            "increase buffer_deg or level."
        )
    old_to_new = np.full(len(v), -1, np.int64)
    old_to_new[kept] = np.arange(len(kept))
    face_ok = (old_to_new[finest.faces] >= 0).all(axis=1)
    new_faces = old_to_new[finest.faces[face_ok]].astype(np.int32)
    mesh = TriMesh(vertices=v[kept], faces=new_faces)
    return mesh, lats[kept].astype(np.float32), lons[kept].astype(np.float32)


def build_cross_edges(
    global_lats: np.ndarray,
    global_lons: np.ndarray,
    reg_lats: np.ndarray,
    reg_lons: np.ndarray,
    k: int = 3,
):
    """k-NN global→regional cross edges + 4-D edge features.

    The reference builds both directions but its CrossMessageLayer consumes
    only the global→regional half (reference src/dual_mesh.py:329-358); we
    build exactly that half.

    Returns (g2r_senders_global, g2r_receivers_regional, g2r_features).
    """
    g_xyz = lat_lon_to_cartesian(global_lats, global_lons)
    r_xyz = lat_lon_to_cartesian(reg_lats, reg_lons)
    g_idx, r_idx, _ = knn_edges(g_xyz, r_xyz, k)  # senders global, recv reg

    all_lats = np.concatenate([global_lats, reg_lats])
    all_lons = np.concatenate([global_lons, reg_lons])
    n_global = len(global_lats)

    g2r_feat = edge_spatial_features(
        all_lats, all_lons, all_lats, all_lons, g_idx, r_idx + n_global
    )
    return g_idx, r_idx, g2r_feat


def build_regional_grid_mesh_edges(
    grid_lats: np.ndarray,
    grid_lons: np.ndarray,
    reg_lats: np.ndarray,
    reg_lons: np.ndarray,
    roi: Tuple[float, float, float, float],
    k_encode: int = 4,
    k_decode: int = 3,
):
    """ROI mask + encoding (mesh-centric kNN) + decoding (grid-centric kNN
    with distances).  Grid coords are per-node (flattened) arrays."""
    lat_min, lat_max, lon_min, lon_max = roi
    roi_mask = (
        (grid_lats >= lat_min) & (grid_lats <= lat_max)
        & (grid_lons >= lon_min) & (grid_lons <= lon_max)
    )
    roi_idx = np.flatnonzero(roi_mask)
    if len(roi_idx) == 0:
        raise ValueError(f"No grid points in ROI {roi}")
    roi_xyz = lat_lon_to_cartesian(grid_lats[roi_idx], grid_lons[roi_idx])
    reg_xyz = lat_lon_to_cartesian(reg_lats, reg_lons)

    # Encoding: for each regional mesh node, its k nearest ROI grid points.
    enc_grid, enc_mesh, _ = knn_edges(roi_xyz, reg_xyz,
                                      min(k_encode, len(roi_idx)))
    # Decoding: for each ROI grid point, its k nearest regional mesh nodes.
    dec_mesh, dec_grid, dec_dist = knn_edges(
        reg_xyz, roi_xyz, min(k_decode, len(reg_lats))
    )
    return roi_mask, (enc_grid, enc_mesh), (dec_mesh, dec_grid), dec_dist


@dataclasses.dataclass
class RegionalGraphs:
    """The regional graph bundle (every Graph padded and static, on the
    host; ``models.dual_mesh.RegionalDeviceGraphs`` moves it)."""

    processing: Graph          # regional mesh ↔ regional mesh (+4-D features)
    cross_g2r: Graph           # global mesh -> regional mesh (+4-D features)
    encoding: Graph            # ROI grid (local ids) -> regional mesh
    decoding: Graph            # regional mesh -> ROI grid (local ids)
    dec_idw: np.ndarray        # [E_dec_pad] normalized IDW weights (padded 0)
    roi_mask: np.ndarray       # [G] bool
    roi_idx: np.ndarray        # [n_roi]
    n_reg_mesh: int
    n_roi: int
    reg_lats: np.ndarray
    reg_lons: np.ndarray


def build_regional_graphs(
    global_mesh_lats: np.ndarray,
    global_mesh_lons: np.ndarray,
    grid_lats: np.ndarray,
    grid_lons: np.ndarray,
    roi: Tuple[float, float, float, float],
    reg_mesh_level: int = 7,
    reg_mesh_buffer: float = 2.0,
    cross_k: int = 3,
    k_encode: int = 4,
    k_decode: int = 3,
    global_level: int = 6,
) -> RegionalGraphs:
    reg_mesh, reg_lats, reg_lons = create_regional_mesh(
        roi, reg_mesh_level, reg_mesh_buffer, global_level
    )
    n_reg = len(reg_lats)

    proc_edges = edges_from_faces(reg_mesh.faces)
    proc_feat = edge_spatial_features(
        reg_lats, reg_lons, reg_lats, reg_lons, proc_edges[0], proc_edges[1]
    )
    processing = build_graph(
        proc_edges[0], proc_edges[1], num_nodes=n_reg, edge_attr=proc_feat,
    )

    g_idx, r_idx, g2r_feat = build_cross_edges(
        global_mesh_lats, global_mesh_lons, reg_lats, reg_lons, cross_k
    )
    cross_g2r = build_graph(
        g_idx, r_idx, num_nodes=len(global_mesh_lats), num_receivers=n_reg,
        edge_attr=g2r_feat,
    )

    roi_mask, (enc_g, enc_m), (dec_m, dec_g), dec_dist = (
        build_regional_grid_mesh_edges(
            grid_lats, grid_lons, reg_lats, reg_lons, roi, k_encode, k_decode
        )
    )
    n_roi = int(roi_mask.sum())
    encoding = build_graph(enc_g, enc_m, num_nodes=n_roi,
                           num_receivers=n_reg)
    decoding = build_graph(dec_m, dec_g, num_nodes=n_reg,
                           num_receivers=n_roi)
    # IDW weights in the decoding graph's (receiver-sorted, padded) order.
    order = np.argsort(dec_g, kind="stable")
    inv = 1.0 / (dec_dist[order] + 1e-8)
    sums = np.zeros(n_roi)
    np.add.at(sums, dec_g[order], inv)
    idw = inv / (sums[dec_g[order]] + 1e-8)
    idw_pad = np.zeros(decoding.padded_num_edges, np.float32)
    idw_pad[: len(idw)] = idw
    return RegionalGraphs(
        processing=processing,
        cross_g2r=cross_g2r,
        encoding=encoding,
        decoding=decoding,
        dec_idw=idw_pad,
        roi_mask=roi_mask,
        roi_idx=np.flatnonzero(roi_mask),
        n_reg_mesh=n_reg,
        n_roi=n_roi,
        reg_lats=reg_lats,
        reg_lons=reg_lons,
    )


def build_roi_knn_graph(
    grid_lats: np.ndarray,
    grid_lons: np.ndarray,
    roi: Tuple[float, float, float, float],
    k: int = 8,
):
    """Symmetric k-NN graph over ROI grid points (+4-D edge features).

    Returns (roi_mask, Graph over n_roi local ids).
    ~ reference src/roi_residual.py:15-61."""
    lat_min, lat_max, lon_min, lon_max = roi
    roi_mask = (
        (grid_lats >= lat_min) & (grid_lats <= lat_max)
        & (grid_lons >= lon_min) & (grid_lons <= lon_max)
    )
    roi_idx = np.flatnonzero(roi_mask)
    if len(roi_idx) == 0:
        raise ValueError(f"No grid points in ROI {roi}")
    lats, lons = grid_lats[roi_idx], grid_lons[roi_idx]
    xyz = lat_lon_to_cartesian(lats, lons)
    k_eff = min(k + 1, len(roi_idx))
    s, r, _ = knn_edges(xyz, xyz, k_eff)
    keep = s != r  # drop self matches
    s, r = s[keep], r[keep]
    # Symmetrize.
    pairs = np.unique(
        np.sort(np.stack([s, r], axis=1), axis=1), axis=0
    )
    senders = np.concatenate([pairs[:, 0], pairs[:, 1]])
    receivers = np.concatenate([pairs[:, 1], pairs[:, 0]])
    feat = edge_spatial_features(lats, lons, lats, lons, senders, receivers)
    graph = build_graph(senders, receivers, num_nodes=len(roi_idx),
                        edge_attr=feat)
    return roi_mask, graph
