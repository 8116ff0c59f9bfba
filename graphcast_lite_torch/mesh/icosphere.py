"""Icosahedral multi-mesh construction on the unit sphere.

Host-side "graph compiler" layer: everything here is NumPy, runs once at model
build time, and produces static arrays that are then padded and shipped to the
TPU.  No JAX below this line.

Semantics follow the reference implementation (reference:
``src/mesh/create_mesh.py``) so that vertex/face orderings — and therefore edge
lists and ported model weights — line up exactly:

* ``icosahedron()``           ~ reference ``get_icosahedron`` (:108-171)
* ``build_hierarchy()``       ~ reference
  ``get_hierarchy_of_triangular_meshes_for_sphere`` (:75-105)
* ``merge_mesh_levels()``     ~ reference ``filter_mesh`` (:210-223)
* ``prune_hierarchy_to_region()`` ~ reference ``prune_mesh_to_region``
  (:225-320)
* ``edges_from_faces()``      ~ reference ``get_edges_from_faces`` (:323-351)

The implementations are new (vectorized NumPy rather than Python loops), but
they reproduce the same deterministic orderings:

* The icosahedron vertex order follows the (c1, c2) sign enumeration and the
  20-face table is fixed combinatorial data (itself inherited from the public
  DeepMind GraphCast code, Apache-2.0).
* During a 4-way split, midpoint vertices are numbered in first-seen order of
  the (sorted) parent edge as faces are scanned in order — reproduced here with
  a stable vectorized dedup instead of a hash map.
* Vertex sets of the hierarchy are nested prefixes: V(k) = 10·4^k + 2.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

__all__ = [
    "TriMesh",
    "icosahedron",
    "split_mesh",
    "build_hierarchy",
    "merge_mesh_levels",
    "prune_hierarchy_to_region",
    "edges_from_faces",
    "faces_to_directed_edges",
    "max_edge_length",
    "mesh_lat_lon",
]


@dataclasses.dataclass(frozen=True)
class TriMesh:
    """Triangular mesh on the unit sphere.

    Attributes:
      vertices: [V, 3] float32 unit-norm positions.
      faces: [F, 3] int32 vertex indices, counter-clockwise from outside.
    """

    vertices: np.ndarray
    faces: np.ndarray

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def num_faces(self) -> int:
        return int(self.faces.shape[0])


# 20 faces of the regular icosahedron, CCW viewed from outside, against the
# vertex ordering produced by `icosahedron()`.  Fixed combinatorial data.
_ICOSAHEDRON_FACES = np.array(
    [
        (0, 1, 2), (0, 6, 1), (8, 0, 2), (8, 4, 0), (3, 8, 2),
        (3, 2, 7), (7, 2, 1), (0, 4, 6), (4, 11, 6), (6, 11, 5),
        (1, 5, 7), (4, 10, 11), (4, 8, 10), (10, 8, 3), (10, 3, 9),
        (11, 10, 9), (11, 9, 5), (5, 9, 7), (9, 3, 7), (1, 6, 5),
    ],
    dtype=np.int32,
)


def _rotation_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def icosahedron() -> TriMesh:
    """Regular icosahedron with circumscribed unit sphere.

    Vertices are enumerated as the cyclic permutations of (±1, ±phi, 0),
    ordered by (c1 ∈ {+1,-1}) × (c2 ∈ {+phi,-phi}) × the three cyclic axes,
    then rotated about y by (π − 2·asin(phi/√3))/2 so a face normal aligns
    with the pole axis (same canonical orientation as the reference,
    reference src/mesh/create_mesh.py:163-167).
    """
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = []
    for c1 in (1.0, -1.0):
        for c2 in (phi, -phi):
            verts.append((c1, c2, 0.0))
            verts.append((0.0, c1, c2))
            verts.append((c2, 0.0, c1))
    vertices = np.asarray(verts, dtype=np.float32)
    vertices /= np.linalg.norm([1.0, phi])

    angle_between_faces = 2.0 * np.arcsin(phi / np.sqrt(3.0))
    rotation_angle = (np.pi - angle_between_faces) / 2.0
    vertices = vertices @ _rotation_y(rotation_angle)
    return TriMesh(
        vertices=vertices.astype(np.float32),
        faces=_ICOSAHEDRON_FACES.copy(),
    )


def split_mesh(mesh: TriMesh) -> TriMesh:
    """One 4-way split of every face, re-projecting midpoints to the sphere.

    Midpoint vertices are deduplicated across faces sharing an edge and are
    numbered in first-seen order (scanning faces in order, edges within a face
    in the order (v0,v1), (v1,v2), (v2,v0)), matching the reference's hash-map
    bookkeeping (reference src/mesh/create_mesh.py:174-207) while being fully
    vectorized.
    """
    faces = mesh.faces.astype(np.int64)
    v0, v1, v2 = faces[:, 0], faces[:, 1], faces[:, 2]

    # Parent edge per midpoint, in scan order: for each face (m01, m12, m20).
    pairs = np.stack(
        [
            np.stack([v0, v1], axis=1),
            np.stack([v1, v2], axis=1),
            np.stack([v2, v0], axis=1),
        ],
        axis=1,
    ).reshape(-1, 2)  # [3F, 2] in first-seen scan order
    keys = np.sort(pairs, axis=1)
    nv = mesh.num_vertices
    flat = keys[:, 0] * nv + keys[:, 1]

    # Stable first-occurrence dedup: new vertex ids in order of first appearance.
    uniq, first_idx, inverse = np.unique(flat, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")  # unique ids by first-seen position
    rank_of_uniq = np.empty_like(order)
    rank_of_uniq[order] = np.arange(order.size)
    mid_ids = nv + rank_of_uniq[inverse]  # [3F] midpoint vertex index per slot

    # Midpoint positions (for the unique set, in first-seen order).  Arithmetic
    # stays in float32 to match the reference bit-for-bit.
    key_pairs = keys[np.sort(first_idx)]  # ordered by first occurrence
    mids = (
        mesh.vertices[key_pairs[:, 0]] + mesh.vertices[key_pairs[:, 1]]
    ).astype(np.float32) * np.float32(0.5)
    mids /= np.linalg.norm(mids, axis=1, keepdims=True).astype(np.float32)

    new_vertices = np.concatenate([mesh.vertices, mids], axis=0)

    m01 = mid_ids[0::3]
    m12 = mid_ids[1::3]
    m20 = mid_ids[2::3]
    # Child faces preserve CCW orientation.
    child = np.stack(
        [
            np.stack([v0, m01, m20], axis=1),
            np.stack([m01, v1, m12], axis=1),
            np.stack([m20, m12, v2], axis=1),
            np.stack([m01, m12, m20], axis=1),
        ],
        axis=1,
    ).reshape(-1, 3)
    return TriMesh(vertices=new_vertices, faces=child.astype(np.int32))


def build_hierarchy(splits: int) -> List[TriMesh]:
    """Hierarchy of icosahedral meshes, level 0 (icosahedron) .. `splits`.

    Vertex arrays are nested prefixes: the first V(k) vertices of level k+1
    are exactly the vertices of level k; V(k) = 10·4^k + 2.
    """
    meshes = [icosahedron()]
    for _ in range(splits):
        meshes.append(split_mesh(meshes[-1]))
    return meshes


def merge_mesh_levels(meshes: Sequence[TriMesh], levels: Sequence[int]) -> TriMesh:
    """GraphCast multi-mesh: faces of the selected levels over the finest
    level's vertex array (finest level's faces first, then coarser, matching
    reference src/mesh/create_mesh.py:210-223)."""
    levels = sorted(levels, reverse=True)
    faces = np.concatenate([meshes[lvl].faces for lvl in levels], axis=0)
    return TriMesh(vertices=meshes[levels[0]].vertices, faces=faces)


def prune_hierarchy_to_region(
    meshes: Sequence[TriMesh],
    lat_min: float,
    lat_max: float,
    lon_min: float,
    lon_max: float,
    buffer_deg: float = 15.0,
) -> List[TriMesh]:
    """Cut the hierarchy to a lat/lon bounding box (+buffer).

    Keeps finest-level vertices inside the buffered box (handling longitude
    wrap at 0/360), keeps faces whose three vertices all survive, and
    re-indexes every level against the pruned finest vertex set (valid because
    vertex sets are nested prefixes).  Mirrors reference
    src/mesh/create_mesh.py:225-320.
    """
    finest = meshes[-1]
    lats, lons = mesh_lat_lon(finest)

    lat_lo = max(lat_min - buffer_deg, -90.0)
    lat_hi = min(lat_max + buffer_deg, 90.0)
    lon_lo = lon_min - buffer_deg
    lon_hi = lon_max + buffer_deg

    lat_mask = (lats >= lat_lo) & (lats <= lat_hi)
    if lon_lo < 0:
        lon_mask = (lons >= (lon_lo % 360.0)) | (lons <= lon_hi)
    elif lon_hi > 360.0:
        lon_mask = (lons >= lon_lo) | (lons <= (lon_hi % 360.0))
    else:
        lon_mask = (lons >= lon_lo) & (lons <= lon_hi)
    mask = lat_mask & lon_mask

    n_kept = int(mask.sum())
    if n_kept == 0:
        raise ValueError(
            "No mesh vertices fall inside the requested region; check bounds."
        )

    old_to_new = np.full(finest.num_vertices, -1, dtype=np.int32)
    old_to_new[np.flatnonzero(mask)] = np.arange(n_kept, dtype=np.int32)
    pruned_vertices = finest.vertices[mask].astype(np.float32)

    out: List[TriMesh] = []
    for mesh in meshes:
        level_mask = mask[: mesh.num_vertices]
        keep = level_mask[mesh.faces].all(axis=1)
        new_faces = old_to_new[mesh.faces[keep]]
        out.append(TriMesh(vertices=pruned_vertices, faces=new_faces.astype(np.int32)))
    return out


def edges_from_faces(faces: np.ndarray) -> np.ndarray:
    """Undirected edge list [2, 2E] from faces.

    Unique (min,max)-sorted pairs in lexicographic order, interleaved with
    their reversed copies — identical layout to the reference
    (src/mesh/create_mesh.py:323-351): even columns are (lo, hi), odd columns
    the swapped duplicates.
    """
    f = faces.astype(np.int64)
    pairs = np.concatenate(
        [f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0
    )
    pairs = np.sort(pairs, axis=1)
    pairs = np.unique(pairs, axis=0)  # lexicographic (lo, hi)
    e = pairs.shape[0]
    out = np.empty((2, 2 * e), dtype=faces.dtype)
    out[:, 0::2] = pairs.T
    out[:, 1::2] = pairs.T[::-1]
    return out


def faces_to_directed_edges(faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-face directed edges (v0→v1, v1→v2, v2→v0) as (senders, receivers).

    For a closed, consistently oriented surface these come in both directions.
    ~ reference src/mesh/grid_mesh_connectivity.py:112-136.
    """
    senders = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    receivers = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    return senders, receivers


def max_edge_length(mesh: TriMesh) -> float:
    """Maximum chordal edge length of the mesh (R^3 distance on unit sphere)."""
    s, r = faces_to_directed_edges(mesh.faces)
    d = np.linalg.norm(mesh.vertices[s] - mesh.vertices[r], axis=-1)
    return float(d.max())


def mesh_lat_lon(mesh: TriMesh) -> tuple[np.ndarray, np.ndarray]:
    """Latitude [-90, 90] and longitude [0, 360) of mesh vertices, float32."""
    x, y, z = mesh.vertices[:, 0], mesh.vertices[:, 1], mesh.vertices[:, 2]
    phi = np.arctan2(y, x)
    with np.errstate(invalid="ignore"):
        theta = np.arccos(np.clip(z, -1.0, 1.0))
    lat = 90.0 - np.rad2deg(theta)
    lon = np.mod(np.rad2deg(phi), 360.0)
    return lat.astype(np.float32), lon.astype(np.float32)
