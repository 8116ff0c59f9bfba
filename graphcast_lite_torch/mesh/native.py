"""ctypes bindings for the native spatial-query engine (csrc/spatial.cpp).

Auto-builds ``libgclt_spatial.so`` with g++ on first use (cached in the
package's ``_build/`` directory); every entry point has an exact SciPy-based
fallback so the package works without a toolchain.  ``GCLT_NATIVE=0``
forces the fallback.

These are the framework's first-party replacements for the reference's
hidden native dependencies (scipy cKDTree, trimesh/rtree — SURVEY §2.9).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "native_available",
    "ball_query",
    "knn_query",
    "closest_face",
]

_SRC = os.path.join(os.path.dirname(__file__), "..", "csrc", "spatial.cpp")
_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "_build",
                         "libgclt_spatial.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    src = os.path.abspath(_SRC)
    out = os.path.abspath(_LIB_PATH)
    if not os.path.exists(src):
        return False
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return True
    # Build under a per-process name, then rename: concurrent test workers
    # never load a half-written library.
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-std=c++17", src, "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)
        return True
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("GCLT_NATIVE", "1") in ("0", "false", "off"):
        return None
    if not _build():
        return None
    try:
        lib = ctypes.CDLL(os.path.abspath(_LIB_PATH))
    except OSError:
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.ball_query.restype = ctypes.c_int
    lib.ball_query.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int,
                               ctypes.c_float, ctypes.c_void_p,
                               ctypes.c_void_p]
    lib.knn_query.restype = None
    lib.knn_query.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int,
                              ctypes.c_int, i32p, f32p]
    lib.closest_face.restype = None
    lib.closest_face.argtypes = [f32p, ctypes.c_int, i32p, ctypes.c_int,
                                 f32p, ctypes.c_int, i32p]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def _c3(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float32)


def ball_query(
    targets: np.ndarray, queries: np.ndarray, radius: float
) -> Tuple[np.ndarray, np.ndarray]:
    """(query_idx, target_idx) pairs with |q - t| <= radius; grouped by query
    index, targets ascending within a group."""
    lib = _load()
    t, q = _c3(targets), _c3(queries)
    if lib is not None:
        total = lib.ball_query(t, len(t), q, len(q), radius, None, None)
        pairs = np.empty((max(total, 1), 2), np.int32)
        lib.ball_query(
            t, len(t), q, len(q), radius, None,
            pairs.ctypes.data_as(ctypes.c_void_p),
        )
        pairs = pairs[:total]
        return pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
    from scipy.spatial import cKDTree

    neighbors = cKDTree(t).query_ball_point(q, r=radius)
    counts = np.fromiter((len(n) for n in neighbors), np.int64,
                         count=len(neighbors))
    qi = np.repeat(np.arange(len(q), dtype=np.int64), counts)
    ti = (np.concatenate([np.sort(np.asarray(n, np.int64)) for n in neighbors])
          if counts.sum() else np.zeros(0, np.int64))
    return qi, ti


def knn_query(
    targets: np.ndarray, queries: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(indices [n_q, k], distances [n_q, k]) of nearest targets."""
    lib = _load()
    t, q = _c3(targets), _c3(queries)
    k = min(k, len(t))
    if lib is not None:
        idx = np.empty((len(q), k), np.int32)
        dist = np.empty((len(q), k), np.float32)
        lib.knn_query(t, len(t), q, len(q), k, idx, dist)
        return idx.astype(np.int64), dist.astype(np.float64)
    from scipy.spatial import cKDTree

    dist, idx = cKDTree(t).query(q, k=k)
    if k == 1:
        dist, idx = dist[:, None], idx[:, None]
    return idx.astype(np.int64), dist


def closest_face(
    vertices: np.ndarray, faces: np.ndarray, queries: np.ndarray
) -> np.ndarray:
    """Index of the closest triangle per query point [n_q]."""
    lib = _load()
    if lib is not None:
        v = _c3(vertices)
        f = np.ascontiguousarray(faces, np.int32)
        q = _c3(queries)
        out = np.empty(len(q), np.int32)
        lib.closest_face(v, len(v), f, len(f), q, len(q), out)
        return out.astype(np.int64)
    from .connectivity import closest_faces as _py_closest
    from .icosphere import TriMesh

    mesh = TriMesh(vertices=np.asarray(vertices, np.float32),
                   faces=np.asarray(faces, np.int32))
    return _py_closest(np.asarray(queries, np.float64), mesh)
