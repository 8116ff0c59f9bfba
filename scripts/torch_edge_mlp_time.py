"""The fused edge-MLP tail's time on the card at the flagship processor
shape (the 512x256 model's multimesh, levels [4, 6]: E_pad 261,120,
R 40,962, in-degree 6-12; H = De = 256; bf16; CUDA events), for builds of
``edge_mlp.cu`` compared in one call.

    python3 scripts/torch_edge_mlp_time.py [--old EDGE_MLP_CU]
        [--split-current] [--receivers 16,24,32] [--compare CU,...]
        [--out PATH]

* ``--old``: an earlier ``edge_mlp.cu`` whose C interface takes W2
  row-major and has no design query, e.g. commit 14a3db7's (``git show
  14a3db7:graphcast_lite_torch/csrc/edge_mlp.cu``, the 16-receiver wmma
  kernel), built as it is.
* ``--split-current``: the current kernel with parts cut out by text
  edits: the activation's arithmetic, the wgmma instructions, the register
  epilogue, the u row stores, the aggregate loop, and all five (row and W2
  copies and barriers only); and with a fast activation (``__expf``,
  ``__fdividef``).  The differences of their times bound each part; the
  parts overlap, so they do not add up.
* ``--receivers``: the current kernel with each receivers-per-group value
  (at most 32: the flagship layout fits no more).
* ``--compare``: other ``edge_mlp.cu`` files of the current C interface.

Every variant is written beside copies of the package's ``*.cuh`` headers
under its gitignored build directory and built by ``ops/nvcc_build.build``
(one nvcc each, all at once).  An edit whose text is not found exactly as
often as expected stops the script.  Every complete build is held against
the plain version first (chip_smoke's bf16 tolerances).  W2's wgmma image
is made once, outside the timed calls, so the times are the kernel's
launches alone.  Each build is timed twice, the second round in reverse
order.  Prints the card's name and power limit and one JSON line, which
``--out PATH`` also writes to a file.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import shutil
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
    nvcc_build  # noqa: E402

# Text edits of the current kernel: (text, replacement, occurrences).
_NO_ACT = ("for (int c = 0; c < 4; ++c) {", "for (int c = 0; c < 0; ++c) {", 1)
_NO_MMA = ("wgmma_m64n64k16(", "if (0) wgmma_m64n64k16(", 1)
_NO_EPI = ("for (int j = 0; j < 8; ++j) {", "for (int j = 0; j < 0; ++j) {",
           2)
_NO_STORE = ("q < nrows * (DE / 8);", "q < 0;", 1)
_NO_AGG = ("for (int row = rg.x; row < rg.y; ++row) {",
           "for (int row = rg.x; row < rg.x; ++row) {", 1)
_FAST_ACT = ("activate_bf16<ACT>(f.x)", "__fdividef(f.x, 1.0f + __expf(-f.x))",
             1)
_FAST_ACT2 = ("activate_bf16<ACT>(f.y)",
              "__fdividef(f.y, 1.0f + __expf(-f.y))", 1)
VARIANTS = {
    "no_activation": (_NO_ACT,),
    "no_mma": (_NO_MMA,),
    "no_epilogue": (_NO_EPI,),
    "no_u_store": (_NO_STORE,),
    "no_aggregate": (_NO_AGG,),
    "copies_only": (_NO_ACT, _NO_MMA, _NO_EPI, _NO_STORE, _NO_AGG),
    "fast_activation": (_FAST_ACT, _FAST_ACT2),
}
_RECEIVERS = "constexpr int kMlpReceivers = 32;"
# Variants whose output is checked (the others compute something else).
_CHECKED = ("old", "cur", "cmp", "new_r", "fast_activation")


def _flagship_recv() -> torch.Tensor:
    """The flagship multimesh's receivers, sorted (as the graph keeps
    them)."""
    mesh = merge_mesh_levels(build_hierarchy(6), [4, 6])
    recv = edges_from_faces(mesh.faces)[1]
    return torch.from_numpy(np.sort(recv).astype(np.int64))


def _variant(workdir, name, text, edits) -> str:
    """``text`` with ``edits`` applied, written to ``workdir/name.cu``."""
    for old, new, n in edits:
        if text.count(old) != n:
            raise RuntimeError(f"{name}: {old!r} found {text.count(old)} "
                               f"times, not {n}")
        text = text.replace(old, new)
    path = os.path.join(workdir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def _caller(path, t, r):
    """A call of the library built from ``path`` on the inputs ``t`` (W2 as
    the library takes it), and the library's receivers per group."""
    lib = ctypes.CDLL(path)
    for name, (restype, argtypes) in edge_mlp.SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype, fn.argtypes = restype, list(argtypes)
    hid, de = t["w2"].shape
    w2 = t["w2"]
    tile = edge_mlp.TILE_RECEIVERS
    if getattr(lib, "gclt_edge_mlp_wgmma", None) is not None:
        if lib.gclt_edge_mlp_wgmma(1, hid, de):
            w2 = edge_mlp.wgmma_b_image(w2)
        tile = lib.gclt_edge_mlp_tile_receivers(1, hid, de)
    u = torch.empty((t["h_pre"].shape[0], de), dtype=torch.bfloat16,
                    device="cuda")
    agg = torch.empty((r, de), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.gclt_edge_mlp(
            t["h_pre"].data_ptr(), w2.data_ptr(), t["b2"].data_ptr(),
            t["mask"].data_ptr(), t["indptr"].data_ptr(), u.data_ptr(),
            agg.data_ptr(), 1, r, hid, de, 0, stream)
        if err != 0:
            raise RuntimeError(f"{path}: CUDA error {err}")
        return u, agg

    return call, tile


def _check(label, out, t, r):
    """Max abs error of (u, agg) against the plain version, raising outside
    chip_smoke's bf16 tolerances (aggregates: + ORDER_RTOL * sum |u|)."""
    u_ref, agg_ref = edge_mlp.edge_mlp_reference(
        t["h_pre"], t["w2"], t["b2"], t["mask"], t["indptr"], r, "swish")
    mag = cuda_segment.segment_sum_reference(
        u_ref.float().abs() * t["mask"].float()[:, None], t["indptr"], r)
    torch.cuda.synchronize()
    return max(chip_smoke._close(f"{label} u", out[0], u_ref,
                                 chip_smoke.FUSED_BF16_TOL),
               chip_smoke._close(f"{label} agg", out[1], agg_ref,
                                 chip_smoke.FUSED_BF16_TOL,
                                 chip_smoke.ORDER_RTOL * mag))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="an earlier edge_mlp.cu (row-major W2)")
    ap.add_argument("--split-current", action="store_true",
                    help="time the current kernel with parts cut out")
    ap.add_argument("--receivers", default="",
                    help="receivers-per-group values of the current kernel")
    ap.add_argument("--compare", default="",
                    help="comma-separated edge_mlp.cu files to time as-is")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    workdir = os.path.join(
        os.path.dirname(nvcc_build.lib_path(edge_mlp.SOURCE)), "mlp_time")
    os.makedirs(workdir, exist_ok=True)
    for header in glob.glob(os.path.join(nvcc_build.CSRC, "*.cuh")):
        shutil.copy(header, workdir)
    with open(edge_mlp.SOURCE) as f:
        current = f.read()
    sources = {"cur": _variant(workdir, "cur", current, [])}
    if args.old:
        with open(args.old) as f:
            sources["old"] = _variant(workdir, "old", f.read(), [])
    if args.split_current:
        for name, edits in VARIANTS.items():
            sources[name] = _variant(workdir, name, current, edits)
    for g in [int(x) for x in args.receivers.split(",") if x]:
        sources[f"new_r{g}"] = _variant(
            workdir, f"new_r{g}", current,
            [(_RECEIVERS, f"constexpr int kMlpReceivers = {g};", 1)])
    for i, path in enumerate(x for x in args.compare.split(",") if x):
        with open(path) as f:
            sources[f"cmp{i}"] = _variant(workdir, f"cmp{i}", f.read(), [])
    t0 = time.perf_counter()
    libs = dict(zip(sources, nvcc_build.build(*sources.values())))
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)

    recv = _flagship_recv()
    r = int(recv.max()) + 1
    gen = torch.Generator().manual_seed(1)
    t = chip_smoke._fused_case(gen, 0, r, 256, 256, torch.bfloat16,
                               recv=recv)
    nbytes = chip_smoke._nbytes(*(t[k] for k in (
        "h_pre", "w2", "b2", "mask", "indptr"))) + (recv.numel() + r) * 512
    bound_ms, bound_by = chip_smoke._bound(nbytes,
                                           2 * recv.numel() * 256 * 256)
    rows, calls = {}, {}
    for name, path in libs.items():
        call, tile = _caller(path, t, r)
        calls[name] = call
        err = None
        if name.startswith(_CHECKED):
            try:
                err = _check(name, call(), t, r)
            except AssertionError as exc:  # reported, and timed all the same
                err = f"FAILED: {exc}"
        rows[name] = {"ms": [], "receivers_per_group": tile,
                      "max_abs_err": err}
    for names in (list(libs), list(reversed(libs))):
        for name in names:
            rows[name]["ms"].append(chip_smoke._time_ms(calls[name],
                                                        iters=50, warmup=5))
    for name, row in rows.items():
        print(f"  {name:<16s} " + " ".join(f"{ms * 1e3:8.1f}"
                                           for ms in row["ms"])
              + f" us  receivers/group {row['receivers_per_group']:3d}  "
              f"err {row['max_abs_err']}", flush=True)
    print(f"  bound {bound_ms * 1e3:.1f} us ({bound_by}; {nbytes / 1e6:.1f} "
          "MB)", flush=True)
    result = {"device": smi, "E_pad": recv.numel(), "R": r,
              "bound_ms": bound_ms, "bound_by": bound_by, "variants": rows}
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
