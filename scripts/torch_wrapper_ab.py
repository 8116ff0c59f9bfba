"""The fused kernels' wrappers (``ops/edge_step.edge_step``,
``ops/edge_mlp.edge_mlp``) of an earlier tree against this tree's, in one
process on the card, at the flagship processor shape (the 512x256 model's
multimesh, levels [4, 6]: E_pad 261,120, R 40,962, H = De = 256; CUDA
events).

    python3 scripts/torch_wrapper_ab.py --parent DIR [--cycles N]
        [--out PATH]

``DIR`` holds the earlier tree's ``graphcast_lite_torch/`` (e.g. unpacked
by ``git archive <commit> graphcast_lite_torch | tar -x -C DIR`` into a
gitignored directory); its package is imported under another name, and
builds its kernels from its own sources into its own ``_build/``.  Each
wrapper call is timed as a user makes it: the weight images, the output
and scratch allocations and the host-side checks included.  For bf16 and
fp32, ``edge_step`` and ``edge_mlp`` are timed ``--cycles`` times
(default 2) in the order parent, change, change, parent, 50 calls a
timing; the two trees' outputs are compared (bitwise where their kernels
compute alike).  Prints the card's name and power limit and one JSON
line, which ``--out PATH`` also writes to a file.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from graphcast_lite_torch.mesh.icosphere import build_hierarchy, \
    edges_from_faces, merge_mesh_levels  # noqa: E402
from graphcast_lite_torch.ops import edge_mlp, edge_step  # noqa: E402


def _parent_ops(parent_dir):
    """(edge_step, edge_mlp) of the package under ``parent_dir``, imported
    as the package ``gclt_parent``."""
    pkg = os.path.join(parent_dir, "graphcast_lite_torch")
    spec = importlib.util.spec_from_file_location(
        "gclt_parent", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["gclt_parent"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("gclt_parent.ops.edge_step"),
            importlib.import_module("gclt_parent.ops.edge_mlp"))


def _flagship_recv() -> torch.Tensor:
    mesh = merge_mesh_levels(build_hierarchy(6), [4, 6])
    recv = edges_from_faces(mesh.faces)[1]
    return torch.from_numpy(np.sort(recv).astype(np.int64))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="directory holding the earlier graphcast_lite_torch")
    ap.add_argument("--cycles", type=int, default=2,
                    help="rounds of parent, change, change, parent")
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
    p_step, p_mlp = _parent_ops(args.parent)
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
    result = {"device": smi, "E_pad": int(t["v"].shape[0]), "R": r,
              "wrappers": rows}
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
