"""The comparisons that decide ``correct``: the program's graphs judged
against the reference's construction, forecasts against the reference's
forecasts, and a training run's losses, first gradients and parameter
changes against the reference's, each reduced to one number that its
limit (``limits/<cell>.json``) bounds."""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["fp32_exact", "program_edges", "judge_graphs", "reference_graphs",
           "forecast_step_gaps", "leaf_gap", "kept_leaves"]

# Two positions that the program and the reference compute in different
# precisions differ by a few float32 roundings on the unit sphere.
_TIE = 2e-6


@contextlib.contextmanager
def fp32_exact():
    """float32 matrix products without TF32, for the reference."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _keys(s, r, nodes):
    return np.asarray(s, np.int64) * nodes + np.asarray(r, np.int64)


def program_edges(graphs) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """The real edges (mask 1) of the program's encoder, processor and
    decoder graphs as the timed path holds them, on the host."""
    def real(gr):
        keep = gr.edge_mask.float() > 0
        return (gr.senders[keep].long().cpu().numpy(),
                gr.receivers[keep].long().cpu().numpy())
    return {"enc": real(graphs.encoding), "proc": real(graphs.processing),
            "dec": real(graphs.decoding)}


def reference_graphs(cfg: dict, prog, device):
    """(faults in the program's graphs, the reference's graphs on
    ``device``): the reference's own construction, judged against the
    program's edges ``prog`` (``judge_graphs``)."""
    from portbench.harness import system
    from portbench.reference import mesh

    faults, graphs = judge_graphs(mesh.build_graphs(cfg), prog)
    return faults, system.reference_module(cfg).RefGraphs(graphs, device)


def judge_graphs(ref: dict, prog: Dict[str, Tuple[np.ndarray, np.ndarray]]):
    """(faults, graphs to run the reference on).

    ``prog`` holds the program's real edges (senders, receivers) of
    ``enc``, ``proc`` and ``dec``.  An edge is a fault unless the
    reference's own construction makes it, or it differs only where the
    construction is a tie: a grid point at the radius of a mesh vertex
    (grid-to-mesh), or on the edge of two equally close faces
    (mesh-to-grid).  With no fault the reference runs on the program's
    choice at those ties, which its own rule leaves open; with faults, on
    its own graphs."""
    n, m = ref["num_grid"], ref["num_mesh"]
    nodes = n + m
    faults = 0

    # Grid -> mesh.
    pk = _keys(*prog["enc"], nodes)
    rk = _keys(*ref["enc"], nodes)
    faults += pk.size - np.unique(pk).size
    for diff in (np.setdiff1d(pk, rk), np.setdiff1d(rk, pk)):
        s, r = diff // nodes, diff % nodes
        ok = (s < n) & (r >= n)
        s, r = np.where(ok, s, 0), np.where(ok, r - n, 0)
        dist = np.linalg.norm(ref["grid_xyz"][s] - ref["mesh_xyz"][r], axis=-1)
        faults += int((~ok | (np.abs(dist - ref["radius"]) > _TIE)).sum())

    # Mesh <-> mesh: exact.
    pk = _keys(*prog["proc"], m)
    rk = _keys(*ref["proc"], m)
    faults += pk.size - np.unique(pk).size
    faults += np.setdiff1d(pk, rk).size + np.setdiff1d(rk, pk).size

    # Mesh -> grid: three mesh vertices a grid point, a closest face.
    s, r = (np.asarray(a, np.int64) for a in prog["dec"])
    bad = (s < n) | (s >= nodes) | (r < 0) | (r >= n)
    faults += int(bad.sum())
    s, r = s[~bad], r[~bad]
    count = np.bincount(r, minlength=n)
    faults += int((count != 3).sum())
    if (count == 3).all():
        order = np.argsort(r, kind="stable")
        tri_p = np.sort((s[order] - n).reshape(n, 3), axis=1)
        tri_r = np.sort(np.asarray(ref["dec"][0], np.int64).reshape(n, 3)
                        - n, axis=1)
        rows = np.flatnonzero((tri_p != tri_r).any(axis=1))
        if rows.size:
            faces = np.sort(ref["fine_faces"], axis=1)
            fkey = (faces[:, 0] * m + faces[:, 1]) * m + faces[:, 2]
            tkey = (tri_p[rows, 0] * m + tri_p[rows, 1]) * m + tri_p[rows, 2]
            from portbench.reference import mesh
            dist = mesh.face_distance(ref["grid_xyz"][rows], ref["mesh_xyz"],
                                      tri_p[rows])
            faults += int((~np.isin(tkey, fkey)
                           | (dist > ref["dec_dist"][rows] + _TIE)).sum())
    if faults:
        return faults, ref
    adopted = dict(ref)
    adopted["enc"] = tuple(np.asarray(a, np.int64) for a in prog["enc"])
    adopted["dec"] = tuple(np.asarray(a, np.int64) for a in prog["dec"])
    return 0, adopted


def forecast_step_gaps(prog: torch.Tensor, ref: torch.Tensor,
                       last: torch.Tensor):
    """[(relative RMS, relative widest gap)] of each AR step of one
    forecast [N, steps, C] against the reference's: the gap over the RMS
    of the reference's change from the last input frame [N, C]."""
    out = []
    for k in range(ref.shape[1]):
        scale = torch.sqrt(torch.mean((ref[:, k] - last) ** 2))
        diff = prog[:, k].float() - ref[:, k]
        out.append((float(torch.sqrt(torch.mean(diff ** 2)) / scale),
                    float(diff.abs().max() / scale)))
    return out


def kept_leaves(ref_grads: Dict[str, torch.Tensor]):
    """The leaves whose reference gradient is not nought to rounding:
    norm at least a thousandth of the median leaf's."""
    norms = {k: float(g.norm()) for k, g in ref_grads.items()}
    med = float(np.median(list(norms.values())))
    return sorted(k for k, v in norms.items() if v >= 1e-3 * med)


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             leaves) -> Tuple[float, str]:
    """(worst gap, its leaf): per leaf |‖prog‖ − ‖ref‖| over the larger of
    the reference's norm of the leaf and of the median leaf."""
    rn = {k: float(ref[k].double().norm()) for k in leaves}
    med = float(np.median(list(rn.values())))
    worst, at = -1.0, ""
    for k in leaves:
        gap = abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med)
        if gap > worst:
            worst, at = gap, k
    return worst, at
