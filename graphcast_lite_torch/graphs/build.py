"""Build the three static graphs of the encode-process-decode pipeline
(torch counterpart of ``graphcast_lite_tpu.graphs.build``).

* encoding graph (Grid→Mesh): ε-ball query with radius
  ``grid2mesh_radius_query × max_edge_len(finest mesh)``, plus 6 static
  features per grid/mesh node;
* processing graph (Mesh↔Mesh): multi-mesh union of the selected levels'
  faces → undirected edge list with 4-D GraphCast edge features, and, on
  an unpruned global mesh, the constant-degree per-level blocks;
* decoding graph (Mesh→Grid): triangle containment, exactly 3 incoming mesh
  edges per grid node.

The grid is a regular lat/lon grid or, with ``flat_grid``, a list of
per-node coordinates; ``region_bounds`` prunes the mesh hierarchy to a
region (plus ``mesh_buffer_deg``).

Node-index convention: combined flat array, grid 0..N-1, mesh N..N+M-1.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..mesh.connectivity import containing_triangle_edges, radius_query_edges
from ..mesh.features import bipartite_spatial_features, edge_spatial_features
from ..mesh.icosphere import (
    TriMesh,
    build_hierarchy,
    edges_from_faces,
    max_edge_length,
    merge_mesh_levels,
    mesh_lat_lon,
    prune_hierarchy_to_region,
)
from .structure import Graph, build_graph

__all__ = ["GraphSet", "build_graph_set"]


@dataclasses.dataclass
class GraphSet:
    """Everything static the model needs about the spatial discretization."""

    encoding: Graph       # Grid→Mesh, combined node space [N+M]
    processing: Graph     # Mesh↔Mesh, mesh-local node space [M]
    decoding: Graph       # Mesh→Grid, combined node space [N+M]
    grid_static: np.ndarray   # [N, 6] float32 static grid-node features
    mesh_static: np.ndarray   # [M, 6] float32 static mesh-node features
    num_grid_nodes: int
    num_mesh_nodes: int
    grid_lat: np.ndarray      # per-node latitude [N] (flattened)
    grid_lon: np.ndarray      # per-node longitude [N]
    mesh_lat: np.ndarray
    mesh_lon: np.ndarray
    meshes: List[TriMesh]
    finest_mesh: TriMesh

    @property
    def num_nodes(self) -> int:
        return self.num_grid_nodes + self.num_mesh_nodes


def build_graph_set(
    grid_lat: np.ndarray,
    grid_lon: np.ndarray,
    mesh_levels: Sequence[int],
    grid2mesh_radius_query: float,
    flat_grid: bool = False,
    region_bounds: Optional[Tuple[float, float, float, float]] = None,
    mesh_buffer_deg: float = 15.0,
    with_processing_edge_features: bool = True,
) -> GraphSet:
    """Construct the full static graph set.

    Args:
      grid_lat/grid_lon: 1-D lat/lon axes (regular grid) or paired per-node
        coordinates (``flat_grid=True``).
      mesh_levels: icosahedral levels joined into the multi-mesh.
      grid2mesh_radius_query: multiplier on the finest mesh's max edge length
        for the ε-ball encoder edges.
      region_bounds: optional (lat_min, lat_max, lon_min, lon_max) to prune
        the mesh hierarchy to a region (+``mesh_buffer_deg``).  A pruned
        mesh has no constant-degree blocks: its processor takes the COO
        layout.
    """
    grid_lat = np.asarray(grid_lat, dtype=np.float32)
    grid_lon = np.asarray(grid_lon, dtype=np.float32)
    if flat_grid:
        num_grid = int(grid_lat.shape[0])
        grid_lat_flat, grid_lon_flat = grid_lat, grid_lon
    else:
        num_grid = int(grid_lat.shape[0] * grid_lon.shape[0])
        lon2d, lat2d = np.meshgrid(grid_lon, grid_lat)
        grid_lat_flat = lat2d.reshape(-1).astype(np.float32)
        grid_lon_flat = lon2d.reshape(-1).astype(np.float32)

    meshes = build_hierarchy(max(mesh_levels))
    if region_bounds is not None:
        meshes = prune_hierarchy_to_region(
            meshes, *region_bounds, buffer_deg=mesh_buffer_deg
        )
    finest = meshes[-1]
    num_mesh = finest.num_vertices
    mlat, mlon = mesh_lat_lon(finest)

    # --- encoding graph: grid -> mesh, ε-ball --------------------------------
    radius = max_edge_length(finest) * float(grid2mesh_radius_query)
    g_idx, m_idx = radius_query_edges(grid_lat, grid_lon, finest, radius,
                                      flat=flat_grid)
    enc_senders = g_idx
    enc_receivers = m_idx + num_grid  # combined node space
    grid_static, mesh_static, _ = bipartite_spatial_features(
        grid_lat_flat, grid_lon_flat, mlat, mlon, enc_senders, enc_receivers
    )
    encoding = build_graph(
        enc_senders, enc_receivers, num_nodes=num_grid + num_mesh,
    )

    # --- processing graph: multi-mesh ---------------------------------------
    multimesh = merge_mesh_levels(meshes, list(mesh_levels))
    proc_edges = edges_from_faces(multimesh.faces)
    proc_attr = None
    if with_processing_edge_features:
        proc_attr = edge_spatial_features(
            mlat, mlon, mlat, mlon, proc_edges[0], proc_edges[1]
        )
    # Per-level constant-degree blocks: level ℓ's vertex prefix of an
    # unpruned global mesh has exactly 10·4^ℓ+2 ids.  Regional pruning
    # re-indexes the vertices and breaks both the prefix and the degree
    # regularity, so a pruned mesh gets none (the COO layout).
    level_sizes = None
    if region_bounds is None:
        level_sizes = [10 * 4 ** int(l) + 2 for l in sorted(mesh_levels)]
    processing = build_graph(
        proc_edges[0], proc_edges[1], num_nodes=num_mesh,
        edge_attr=proc_attr, level_sizes=level_sizes,
    )

    # --- decoding graph: mesh -> grid, triangle containment ------------------
    dg_idx, dm_idx = containing_triangle_edges(grid_lat, grid_lon, finest,
                                               flat=flat_grid)
    decoding = build_graph(
        dm_idx + num_grid, dg_idx, num_nodes=num_grid + num_mesh,
    )

    return GraphSet(
        encoding=encoding,
        processing=processing,
        decoding=decoding,
        grid_static=grid_static,
        mesh_static=mesh_static,
        num_grid_nodes=num_grid,
        num_mesh_nodes=num_mesh,
        grid_lat=grid_lat_flat,
        grid_lon=grid_lon_flat,
        mesh_lat=mlat,
        mesh_lon=mlon,
        meshes=meshes,
        finest_mesh=finest,
    )
