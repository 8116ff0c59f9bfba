"""The kernels' wrappers of an earlier tree against this tree's, in one
process on the card: the fused kernels' (``ops/edge_step.edge_step``,
``ops/edge_mlp.edge_mlp``) at the flagship processor shape (the 512x256
model's multimesh, levels [4, 6]: E_pad 261,120, R 40,962, H = De = 256;
CUDA events), and the segment sum's (``ops/cuda_segment.segment_sum``)
host time a call at the 64x32 BASELINE layers' shapes.

    python3 scripts/torch_wrapper_ab.py --parent DIR [--cycles N]
        [--only fused|segment] [--out PATH]

``DIR`` holds the earlier tree's ``graphcast_lite_torch/`` (e.g. unpacked
by ``git archive <commit> graphcast_lite_torch | tar -x -C DIR`` into a
gitignored directory); its package is imported under another name, and
builds its kernels from its own sources into its own ``_build/``.  Each
wrapper call is timed as a user makes it: the weight images, the output
and scratch allocations and the host-side checks included.  For bf16 and
fp32, ``edge_step`` and ``edge_mlp`` are timed ``--cycles`` times
(default 2) in the order parent, change, change, parent, 50 calls a
timing; the two trees' outputs are compared (bitwise where their kernels
compute alike).

The segment sum, fp32 at each shape of chip_smoke's phase 3b (the 64x32
multimesh and product graphs, F = 1-256): the host microseconds a call
(``time.perf_counter`` around 2,000 calls made back to back without a
synchronisation, after a warm-up; at these shapes the card finishes each
launch before the host makes the next call, so this is the host's
time), in turns parent, change, change, parent (``--cycles`` times), of
the parent's wrapper, this tree's wrapper in the design the parent takes
there, this tree's wrapper in the design it picks, and a raw call of this
tree's library (``lib.gclt_segment_sum`` through ctypes with its 15
arguments, output and scratch made once: ``chip_smoke._segment_raw``).
The parent's outputs are compared with this tree's in the parent's design
(bitwise) and in this tree's (max |diff|) there, and at the other shapes
``chip_smoke.py`` holds the segment sum at: phase 1's (random sorted rows,
the skew cases at F = 1, 4, 19, 33, 64, 256, batched [2, E, F], fp32 and
bf16) and the flagship's (the encoder and processor CSRs, the train
step's four sender scatters, bf16 and fp32).  Prints the card's name and
power limit and one JSON line, which ``--out PATH`` also writes to a file.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from graphcast_lite_torch.mesh.icosphere import build_hierarchy, \
    edges_from_faces, merge_mesh_levels  # noqa: E402
from graphcast_lite_torch.ops import cuda_segment, edge_mlp, \
    edge_step  # noqa: E402


def _parent_ops(parent_dir):
    """(edge_step, edge_mlp, cuda_segment) of the package under
    ``parent_dir``, imported as the package ``gclt_parent``."""
    pkg = os.path.join(parent_dir, "graphcast_lite_torch")
    spec = importlib.util.spec_from_file_location(
        "gclt_parent", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["gclt_parent"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("gclt_parent.ops.edge_step"),
            importlib.import_module("gclt_parent.ops.edge_mlp"),
            importlib.import_module("gclt_parent.ops.cuda_segment"))


def _flagship_recv() -> torch.Tensor:
    mesh = merge_mesh_levels(build_hierarchy(6), [4, 6])
    recv = edges_from_faces(mesh.faces)[1]
    return torch.from_numpy(np.sort(recv).astype(np.int64))


def _host_us(fn, calls: int = 2000) -> float:
    """Host microseconds a call of ``fn``, made back to back without a
    synchronisation (the synchronisation after the timed calls is not
    timed)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def _segment_rows(p_seg, cycles):
    """The segment sum's wrappers at the 64x32 shapes, fp32."""
    _, graphs = chip_smoke._baseline_graphs()
    gen = torch.Generator().manual_seed(10)
    rows = {}
    for label, perm, indptr, n_rows, r, f in chip_smoke._new_shapes(graphs):
        msgs = chip_smoke._new_shape_msgs(gen, perm, n_rows, f,
                                          torch.float32)
        ip = indptr.to("cuda")
        was = p_seg.segment_design(torch.float32, f)
        now = cuda_segment.segment_design(torch.float32, f)
        calls = {
            "parent": lambda: p_seg.segment_sum(msgs, ip, r),
            "change_parent_design": lambda: cuda_segment.segment_sum(
                msgs, ip, r, was),
            "change": lambda: cuda_segment.segment_sum(msgs, ip, r),
            "raw": chip_smoke._segment_raw(msgs, ip, r, now),
        }
        outs = {k: fn().clone() for k, fn in calls.items()}
        torch.cuda.synchronize()
        same = torch.equal(outs["parent"], outs["change_parent_design"])
        diff = (outs["parent"] - outs["change"]).abs().max().item()
        us = {k: [] for k in calls}
        for _ in range(cycles):
            for who in ("parent", "change_parent_design", "change", "raw",
                        "raw", "change", "change_parent_design", "parent"):
                us[who].append(_host_us(calls[who]))
        rows[label] = {"parent_design": was, "design": now,
                       "host_us": us, "bitwise_equal_in_parent_design": same,
                       "max_abs_diff_in_own_design": diff}
        print(f"  {label:<52s} host us a call: parent ({was}) "
              + " ".join(f"{x:6.2f}" for x in us["parent"])
              + f" | change ({was}) " + " ".join(
                  f"{x:6.2f}" for x in us["change_parent_design"])
              + f" | change ({now}) " + " ".join(
                  f"{x:6.2f}" for x in us["change"])
              + " | raw " + " ".join(f"{x:6.2f}" for x in us["raw"])
              + f" | bitwise equal in the parent's design {same}, "
              f"max |diff| in its own {diff:.3e}", flush=True)
    return rows


def _segment_cases():
    """(label, msgs, indptr, R) of phase 1's cases and the flagship's
    CSRs, fp32 and bf16, on the card."""
    from graphcast_lite_torch import presets
    from graphcast_lite_torch.graphs.build import build_graph_set

    cfg = presets.interaction_net_512x256()
    lat, lon = presets.wb2_512x256_grid()
    gs = build_graph_set(lat, lon, cfg.graph.mesh_levels,
                         cfg.graph.grid2mesh_radius_query)
    gen = torch.Generator().manual_seed(0)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for f in (19, 64, 256):
            m, ip = chip_smoke._sorted_case(gen, 60_000, 20_000, f, dtype)
            out.append((f"random sorted F={f}", m, ip, 20_000))
        for label, r, recv in chip_smoke._skew_cases(gen):
            for f in (1, 4, 19, 33, 64, 256):
                m, ip = chip_smoke._sorted_case(gen, 0, r, f, dtype,
                                                recv=recv)
                out.append((f"{label}, F={f}", m, ip, r))
            m, ip = chip_smoke._sorted_case(gen, 0, r, 19, dtype, batch=2,
                                            recv=recv)
            out.append((f"{label}, batched [2, E, 19]", m, ip, r))
        for name, g in (("encoder", gs.encoding), ("processor",
                                                   gs.processing)):
            m = torch.randn(g.padded_num_edges, 256, generator=gen)
            m = (m * g.edge_mask[:, None]).to("cuda", dtype)
            out.append((f"flagship {name} F=256", m, g.indptr.to("cuda"),
                        g.num_receivers))
        for label, perm, ip, rows, r, f in chip_smoke._sender_csrs(gs, 19):
            out.append((f"flagship {label}", chip_smoke._sender_msgs(
                gen, perm, rows, f, dtype), ip.to("cuda"), r))
    return out


def _segment_bitwise(p_seg):
    """The parent's segment sum against this tree's at every case of
    ``_segment_cases``: bitwise in the parent's design, max |diff| in this
    tree's."""
    rows, unequal = {}, []
    for label, msgs, ip, r in _segment_cases():
        was = p_seg.segment_design(msgs.dtype, msgs.shape[-1])
        now = cuda_segment.segment_design(msgs.dtype, msgs.shape[-1])
        parent = p_seg.segment_sum(msgs, ip, r)
        same = torch.equal(parent,
                           cuda_segment.segment_sum(msgs, ip, r, was))
        diff = (parent.float() - cuda_segment.segment_sum(
            msgs, ip, r).float()).abs().max().item()
        key = f"{label} {str(msgs.dtype)[6:]}"
        rows[key] = {"parent_design": was, "design": now,
                     "bitwise_equal_in_parent_design": same,
                     "max_abs_diff_in_own_design": diff}
        if not same:
            unequal.append(key)
    print(f"  segment_sum outputs at {len(rows)} cases (phase 1's, the "
          "flagship's; fp32 and bf16): bitwise equal to the parent's in the "
          f"parent's design at {len(rows) - len(unequal)}"
          + (f"; NOT at {unequal}" if unequal else "")
          + "; largest |diff| in this tree's own design "
          f"{max(v['max_abs_diff_in_own_design'] for v in rows.values()):.3e}",
          flush=True)
    return rows, not unequal


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="directory holding the earlier graphcast_lite_torch")
    ap.add_argument("--cycles", type=int, default=2,
                    help="rounds of parent, change, change, parent")
    ap.add_argument("--only", choices=("fused", "segment"),
                    help="time only these wrappers")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    p_step, p_mlp, p_seg = _parent_ops(args.parent)
    result = {"device": smi}
    ok = True
    if args.only != "fused":
        result["segment_sum"] = _segment_rows(p_seg, args.cycles)
        result["segment_sum_outputs"], ok = _segment_bitwise(p_seg)
    if args.only == "segment":
        line = json.dumps(result)
        print(line)
        if args.out:
            with open(args.out, "w") as f:
                f.write(line + "\n")
        return 0 if ok else 1
    recv = _flagship_recv()
    r = int(recv.max()) + 1
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator().manual_seed(3)
        t = chip_smoke._fused_case(gen, 0, r, 256, 256, dtype, recv=recv)
        step_args = chip_smoke._step_args(t, r)
        mlp_args = (t["h_pre"], t["w2"], t["b2"], t["mask"], t["indptr"], r,
                    "swish")
        calls = {
            "edge_step": {"parent": lambda: p_step.edge_step(*step_args),
                          "change": lambda: edge_step.edge_step(*step_args)},
            "edge_mlp": {"parent": lambda: p_mlp.edge_mlp(*mlp_args),
                         "change": lambda: edge_mlp.edge_mlp(*mlp_args)},
        }
        for kernel, pair in calls.items():
            outs = {k: fn() for k, fn in pair.items()}
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in
                       zip(outs["parent"], outs["change"]))
            diff = [(x.float() - y.float()).abs().max().item()
                    for x, y in zip(outs["parent"], outs["change"])]
            del outs
            ms = {"parent": [], "change": []}
            for who in ("parent", "change", "change",
                        "parent") * args.cycles:
                ms[who].append(chip_smoke._time_ms(pair[who], iters=50,
                                                   warmup=5))
            name = f"{kernel} {str(dtype)[6:]}"
            rows[name] = {"parent_ms": ms["parent"],
                          "change_ms": ms["change"], "bitwise_equal": same,
                          "max_abs_diff": diff}
            print(f"  {name:<18s} parent "
                  + " ".join(f"{x * 1e3:8.1f}" for x in ms["parent"])
                  + " us  change "
                  + " ".join(f"{x * 1e3:8.1f}" for x in ms["change"])
                  + f" us  outputs bitwise equal {same} (max |diff| of "
                  "each output " + ", ".join(f"{d:.3e}" for d in diff) + ")",
                  flush=True)
    result.update(E_pad=int(t["v"].shape[0]), R=r, wrappers=rows)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
