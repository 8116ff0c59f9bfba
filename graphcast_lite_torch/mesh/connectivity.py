"""Grid↔mesh connectivity queries (host-side graph compiler).

Replaces the reference's hidden native dependencies:

* G2M ε-ball query: scipy ``cKDTree.query_ball_point`` (same C backend the
  reference uses, reference src/mesh/grid_mesh_connectivity.py:53-104).
* M2G face containment: the reference calls ``trimesh.proximity.closest_point``
  (C++/rtree).  Re-implemented here dependency-free: KD-tree over face
  centroids proposes candidate faces, an exact vectorized
  closest-point-on-triangle test (Ericson, *Real-Time Collision Detection*
  §5.1.5) picks the winner.  Results are cached by callers; this runs once per
  model build.
* k-NN builders used by the regional stacks (dual-mesh cross edges etc.).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial import cKDTree

from .icosphere import TriMesh
from .features import grid_lat_lon_to_cartesian

__all__ = [
    "radius_query_edges",
    "containing_triangle_edges",
    "closest_faces",
    "knn_edges",
]


def radius_query_edges(
    grid_lat: np.ndarray,
    grid_lon: np.ndarray,
    mesh: TriMesh,
    radius: float,
    flat: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """All (grid_index, mesh_index) pairs with chordal distance <= radius.

    Grid flattening order is lat-major via ``np.meshgrid(lon, lat)`` (regular
    mode).  Edge order: grouped by grid index ascending, mesh neighbors
    ascending.  Routed through the native spatial engine (csrc/spatial.cpp)
    with a SciPy fallback.
    """
    from . import native

    grid_pos = grid_lat_lon_to_cartesian(grid_lat, grid_lon, flat=flat)
    return native.ball_query(mesh.vertices, grid_pos, radius)


def _closest_point_on_triangles(
    p: np.ndarray, a: np.ndarray, b: np.ndarray, c: np.ndarray
) -> np.ndarray:
    """Vectorized closest point on triangle (abc) to point p.

    All inputs [N, 3]; returns [N, 3].  Branch-free formulation of Ericson's
    region test using np.where cascades.
    """
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = np.einsum("ij,ij->i", ab, ap)
    d2 = np.einsum("ij,ij->i", ac, ap)

    bp = p - b
    d3 = np.einsum("ij,ij->i", ab, bp)
    d4 = np.einsum("ij,ij->i", ac, bp)

    cp = p - c
    d5 = np.einsum("ij,ij->i", ab, cp)
    d6 = np.einsum("ij,ij->i", ac, cp)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    denom_ab = d1 - d3
    v_ab = np.where(denom_ab != 0, d1 / np.where(denom_ab != 0, denom_ab, 1.0), 0.0)
    denom_ac = d2 - d6
    w_ac = np.where(denom_ac != 0, d2 / np.where(denom_ac != 0, denom_ac, 1.0), 0.0)
    denom_bc = (d4 - d3) + (d5 - d6)
    w_bc = np.where(
        denom_bc != 0, (d4 - d3) / np.where(denom_bc != 0, denom_bc, 1.0), 0.0
    )

    # Interior (barycentric) case.
    denom = va + vb + vc
    safe = np.where(denom != 0, denom, 1.0)
    v_int = (vb / safe)[:, None]
    w_int = (vc / safe)[:, None]
    result = a + ab * v_int + ac * w_int

    # Edge BC region.
    in_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    result = np.where(in_bc[:, None], b + np.clip(w_bc, 0, 1)[:, None] * (c - b), result)
    # Edge AC region.
    in_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    result = np.where(in_ac[:, None], a + np.clip(w_ac, 0, 1)[:, None] * ac, result)
    # Edge AB region.
    in_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    result = np.where(in_ab[:, None], a + np.clip(v_ab, 0, 1)[:, None] * ab, result)
    # Vertex regions.
    in_c = (d6 >= 0) & (d5 <= d6)
    result = np.where(in_c[:, None], c, result)
    in_b = (d3 >= 0) & (d4 <= d3)
    result = np.where(in_b[:, None], b, result)
    in_a = (d1 <= 0) & (d2 <= 0)
    result = np.where(in_a[:, None], a, result)
    return result


def closest_faces(
    points: np.ndarray, mesh: TriMesh, num_candidates: int = 12
) -> np.ndarray:
    """Index of the mesh face closest to each query point [N, 3].

    Routed through the native engine (grid over centroids + exact
    closest-point-on-triangle, csrc/spatial.cpp) when available; the NumPy
    path below proposes `num_candidates` candidate faces via a KD-tree over
    centroids and picks the exact minimum.  Tie cases (point exactly on a
    shared edge) may pick either adjacent face, like any floating-point
    implementation.
    """
    from . import native

    if native.native_available():
        return native.closest_face(mesh.vertices, mesh.faces, points)

    faces = mesh.faces
    tri = mesh.vertices[faces]  # [F, 3, 3]
    centroids = tri.mean(axis=1)
    k = min(num_candidates, len(faces))
    _, cand = cKDTree(centroids).query(points, k=k)
    if k == 1:
        cand = cand[:, None]

    n, _ = cand.shape
    p_rep = np.repeat(points, k, axis=0)
    f_rep = cand.reshape(-1)
    cp = _closest_point_on_triangles(
        p_rep,
        tri[f_rep, 0].astype(np.float64),
        tri[f_rep, 1].astype(np.float64),
        tri[f_rep, 2].astype(np.float64),
    )
    d2 = np.einsum("ij,ij->i", p_rep - cp, p_rep - cp).reshape(n, k)
    best = np.argmin(d2, axis=1)
    return cand[np.arange(n), best]


def containing_triangle_edges(
    grid_lat: np.ndarray,
    grid_lon: np.ndarray,
    mesh: TriMesh,
    flat: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """M2G edges: each grid point connects to the 3 vertices of the mesh face
    containing (closest to) it.

    Returns (grid_indices [3G], mesh_indices [3G]) with the 3 face vertices
    per grid point laid out contiguously — the layout of reference
    src/mesh/grid_mesh_connectivity.py:139-184.
    """
    grid_pos = grid_lat_lon_to_cartesian(grid_lat, grid_lon, flat=flat)
    face_idx = closest_faces(grid_pos, mesh)
    mesh_idx = mesh.faces[face_idx].reshape(-1).astype(np.int64)
    grid_idx = np.repeat(np.arange(grid_pos.shape[0], dtype=np.int64), 3)
    return grid_idx, mesh_idx


def knn_edges(
    sender_pos: np.ndarray,
    receiver_pos: np.ndarray,
    k: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Receiver-centric k-NN: each receiver connects to its k nearest senders.

    Returns (senders [R*k], receivers [R*k], distances [R*k]).
    Used by the dual-mesh / ROI-residual regional builders.  Routed through
    the native spatial engine with a SciPy fallback.
    """
    from . import native

    k = min(k, len(sender_pos))
    idx, dist = native.knn_query(sender_pos, receiver_pos, k)
    receivers = np.repeat(np.arange(len(receiver_pos), dtype=np.int64), k)
    return idx.reshape(-1).astype(np.int64), receivers, dist.reshape(-1)
