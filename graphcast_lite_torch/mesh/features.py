"""Spherical coordinate math and static node/edge feature construction.

Host-side NumPy (graph-compile time).  Matches the reference's feature
definitions (reference ``src/utils.py:64-437``):

* static node features (6 per node): unit xyz position, cos(theta)
  (= sin(lat)), and (cos(lon), sin(lon));
* static edge features (4 per edge): L2 edge length and the 3-D relative
  position of the sender in the *receiver-local* frame (receiver rotated to
  lat=0, lon=0), all normalized by the maximum edge length.

Euler rotations are implemented directly in vectorized NumPy instead of
scipy.spatial.transform (extrinsic convention, matching scipy's lowercase
sequences used by the reference).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "lat_lon_to_spherical",
    "spherical_to_cartesian",
    "cartesian_to_spherical",
    "spherical_to_lat_lon",
    "lat_lon_to_cartesian",
    "grid_lat_lon_to_cartesian",
    "receiver_local_rotation_matrices",
    "relative_position_in_receiver_frame",
    "spherical_node_features",
    "bipartite_spatial_features",
    "edge_spatial_features",
]


def lat_lon_to_spherical(lat_deg: np.ndarray, lon_deg: np.ndarray):
    """(lat, lon) degrees -> (phi azimuth, theta polar) radians."""
    phi = np.deg2rad(lon_deg)
    theta = np.deg2rad(90.0 - lat_deg)
    return phi, theta


def spherical_to_cartesian(phi: np.ndarray, theta: np.ndarray):
    """Unit-radius (phi, theta) -> (x, y, z)."""
    return (
        np.cos(phi) * np.sin(theta),
        np.sin(phi) * np.sin(theta),
        np.cos(theta),
    )


def cartesian_to_spherical(x: np.ndarray, y: np.ndarray, z: np.ndarray):
    phi = np.arctan2(y, x)
    with np.errstate(invalid="ignore"):
        theta = np.arccos(np.clip(z, -1.0, 1.0))
    return phi, theta


def spherical_to_lat_lon(phi: np.ndarray, theta: np.ndarray):
    lon = np.mod(np.rad2deg(phi), 360.0)
    lat = 90.0 - np.rad2deg(theta)
    return lat, lon


def lat_lon_to_cartesian(lat_deg: np.ndarray, lon_deg: np.ndarray) -> np.ndarray:
    """Paired (lat[i], lon[i]) -> xyz [N, 3] on the unit sphere."""
    phi, theta = lat_lon_to_spherical(lat_deg, lon_deg)
    return np.stack(spherical_to_cartesian(phi, theta), axis=-1)


def grid_lat_lon_to_cartesian(
    grid_lat: np.ndarray, grid_lon: np.ndarray, flat: bool = False
) -> np.ndarray:
    """Grid coordinates -> xyz [N, 3].

    Regular mode: 1-D lat/lon axes are expanded with ``np.meshgrid(lon, lat)``
    ordering, i.e. flattened lat-major (all longitudes for lat[0] first) —
    matching reference src/mesh/grid_mesh_connectivity.py:10-50.
    Flat mode: lat/lon are already paired per-node arrays.
    """
    if flat:
        return lat_lon_to_cartesian(grid_lat, grid_lon)
    lon2d, lat2d = np.meshgrid(grid_lon, grid_lat)
    return lat_lon_to_cartesian(lat2d.reshape(-1), lon2d.reshape(-1))


def _rot_z(a: np.ndarray) -> np.ndarray:
    """[..., 3, 3] rotation about z by angle a (radians)."""
    c, s = np.cos(a), np.sin(a)
    zero, one = np.zeros_like(a), np.ones_like(a)
    return np.stack(
        [
            np.stack([c, -s, zero], axis=-1),
            np.stack([s, c, zero], axis=-1),
            np.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )


def _rot_y(a: np.ndarray) -> np.ndarray:
    """[..., 3, 3] rotation about y by angle a (radians)."""
    c, s = np.cos(a), np.sin(a)
    zero, one = np.zeros_like(a), np.ones_like(a)
    return np.stack(
        [
            np.stack([c, zero, s], axis=-1),
            np.stack([zero, one, zero], axis=-1),
            np.stack([-s, zero, c], axis=-1),
        ],
        axis=-2,
    )


def receiver_local_rotation_matrices(
    reference_phi: np.ndarray,
    reference_theta: np.ndarray,
    rotate_latitude: bool,
    rotate_longitude: bool,
) -> np.ndarray:
    """Per-receiver rotation matrices to the receiver-local frame.

    Semantics of reference src/utils.py:344-417 (extrinsic Euler sequences):
      * lon+lat: Rz(-phi) then Ry(pi/2 - theta)        — receiver -> (lat0,lon0)
      * lon only: Rz(-phi)
      * lat only: Rz(-phi), Ry(pi/2 - theta), Rz(phi)  — keeps polar geodesic
        aligned after undoing the azimuthal rotation.
    """
    az = -reference_phi
    polar = np.pi / 2.0 - reference_theta
    if rotate_longitude and rotate_latitude:
        return _rot_y(polar) @ _rot_z(az)
    if rotate_longitude:
        return _rot_z(az)
    if rotate_latitude:
        return _rot_z(-az) @ _rot_y(polar) @ _rot_z(az)
    raise ValueError("At least one of longitude/latitude must be rotated.")


def relative_position_in_receiver_frame(
    senders_phi: np.ndarray,
    senders_theta: np.ndarray,
    senders: np.ndarray,
    receivers_phi: np.ndarray,
    receivers_theta: np.ndarray,
    receivers: np.ndarray,
    latitude_local: bool = True,
    longitude_local: bool = True,
) -> np.ndarray:
    """Per-edge 3-D relative position sender-minus-receiver, rotated into the
    receiver-local coordinate frame.  ~ reference src/utils.py:248-341."""
    sender_pos = np.stack(spherical_to_cartesian(senders_phi, senders_theta), axis=-1)
    recv_pos = np.stack(
        spherical_to_cartesian(receivers_phi, receivers_theta), axis=-1
    )
    if not (latitude_local or longitude_local):
        return sender_pos[senders] - recv_pos[receivers]

    rot = receiver_local_rotation_matrices(
        receivers_phi, receivers_theta, latitude_local, longitude_local
    )
    edge_rot = rot[receivers]  # [E, 3, 3]
    rel = np.einsum("eji,ei->ej", edge_rot, sender_pos[senders]) - np.einsum(
        "eji,ei->ej", edge_rot, recv_pos[receivers]
    )
    return rel


def spherical_node_features(lat_deg: np.ndarray, lon_deg: np.ndarray) -> np.ndarray:
    """Static 6-feature vector per node: (x, y, z, cos(theta), cos(phi),
    sin(phi)).  ~ reference src/utils.py:138-169."""
    phi, theta = lat_lon_to_spherical(lat_deg, lon_deg)
    x, y, z = spherical_to_cartesian(phi, theta)
    return np.stack(
        [x, y, z, np.cos(theta), np.cos(phi), np.sin(phi)], axis=-1
    ).astype(np.float32)


def edge_spatial_features(
    senders_lat: np.ndarray,
    senders_lon: np.ndarray,
    receivers_lat: np.ndarray,
    receivers_lon: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_normalization_factor: Optional[float] = None,
) -> np.ndarray:
    """4-feature vector per edge: [|d| , d_x, d_y, d_z] with d the
    receiver-local relative position, normalized by the max edge length
    (or the given factor).  ~ reference src/utils.py:171-207 and the mesh-edge
    variant src/create_graphs.py:37-91 (which guards max_dist == 0)."""
    s_phi, s_theta = lat_lon_to_spherical(senders_lat, senders_lon)
    r_phi, r_theta = lat_lon_to_spherical(receivers_lat, receivers_lon)
    rel = relative_position_in_receiver_frame(
        s_phi, s_theta, senders, r_phi, r_theta, receivers,
        latitude_local=True, longitude_local=True,
    )
    dist = np.linalg.norm(rel, axis=-1, keepdims=True)
    norm = edge_normalization_factor
    if norm is None:
        norm = float(dist.max()) if dist.size else 1.0
        if norm == 0.0:
            norm = 1.0
    return np.concatenate([dist / norm, rel / norm], axis=-1).astype(np.float32)


def bipartite_spatial_features(
    senders_lat: np.ndarray,
    senders_lon: np.ndarray,
    receivers_lat: np.ndarray,
    receivers_lon: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    add_edge_features: bool = False,
    edge_normalization_factor: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static (sender_node_feats [S,6], receiver_node_feats [R,6],
    edge_feats [E,4 or 0]) for a bipartite graph.
    ~ reference src/utils.py:64-209 with the default flag set used by
    create_encoding_graph (positions+lat+lon on, relative positions off)."""
    sender_feats = spherical_node_features(senders_lat, senders_lon)
    receiver_feats = spherical_node_features(receivers_lat, receivers_lon)
    if add_edge_features:
        edge_feats = edge_spatial_features(
            senders_lat, senders_lon, receivers_lat, receivers_lon,
            senders, receivers, edge_normalization_factor,
        )
    else:
        edge_feats = np.zeros((len(senders), 0), dtype=np.float32)
    return sender_feats, receiver_feats, edge_feats
