"""Where the fused edge step's time goes on the card, at the flagship
processor shape (the 512x256 model's multimesh, levels [4, 6]: E_pad
261,120, R 40,962, in-degree 6-12; H = De = 256; bf16; CUDA events).

    python3 scripts/torch_edge_step_split.py [--old EDGE_STEP_CU]
        [--split-current] [--receivers 10,16,20] [--compare CU,...]

Every variant is a copy of a kernel source with parts cut out by text
edits, written beside copies of the package's ``*.cuh`` headers under its
gitignored build directory and built by ``ops/nvcc_build.build`` (one nvcc
each, all at once).  An edit whose text is not found exactly as often as
expected stops the script, so a kernel edit that moves an anchor fails
loudly instead of timing the wrong cut.

* ``--old``: the ``edge_step.cu`` of commit c6b0bb6 (``git show
  c6b0bb6:graphcast_lite_torch/csrc/edge_step.cu``, the kernel built on
  ``wmma`` with fp32 product tiles in shared memory), as it is and with the
  aggregate loop, the two elementwise epilogues, the four product passes,
  and all three (loads only) cut out.  The differences of their times split
  that kernel's time.
* ``--split-current``: the current kernel with the same kind of cuts: the
  wgmma instructions (the weight ring and its waits stay), the two register
  epilogues, the aggregate loop, and all three (row and weight copies and
  barriers only), that last also with 16-byte weight slabs or without row
  reads (zero-filled); and with a fast activation (``__expf``,
  ``__fdividef``).
* ``--receivers``: the current kernel with each receivers-per-group value.
* ``--compare``: other ``edge_step.cu`` files of the current C interface,
  built as they are.

Every complete build is held against the plain version first (chip_smoke's
bf16 tolerances).  Each build is timed twice, the second round in reverse
order, so that a drift of the card's clock shows as a spread and not as a
difference.  Prints the card's name and power limit and one JSON line,
which ``--out PATH`` also writes to a file.
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
from graphcast_lite_torch.ops import cuda_segment, edge_step, \
    nvcc_build  # noqa: E402

# Text edits: (text, replacement, occurrences).  Of c6b0bb6's kernel:
_NO_AGG = ("      aggregate_rows(c_s, recv_s, nrows, agg_s, de, col0);\n", "",
           1)
_NO_EPI = ("for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {",
           "for (int i = threadIdx.x; i < 0; i += kThreads) {", 2)
_NO_MMA = ("tile_product<T>(", "if (0) tile_product<T>(", 2)
OLD_VARIANTS = {
    "full": (),
    "no_aggregate": (_NO_AGG,),
    "no_epilogues": (_NO_EPI,),
    "no_products": (_NO_MMA,),
    "products_only": (_NO_EPI, _NO_AGG),
    "loads_only": (_NO_EPI, _NO_AGG, _NO_MMA),
}
# Of the current kernel:
_CUR_NO_MMA = ("      wgmma_m64n64k16(acc, sw128_desc(a_tile + kb * kAtom + "
               "32 * k),\n                      sw128_desc(ws.slot + kb * "
               "kAtom + 32 * k), (kb | k) != 0);\n", "", 1)
_CUR_NO_EPI = ("for (int j = 0; j < 8; ++j) {",
               "for (int j = 0; j < 0; ++j) {", 2)
_CUR_NO_AGG = ("for (int row0 = 0; row0 < nrows; row0 += 8) {",
               "for (int row0 = 0; row0 < 0; row0 += 8) {", 1)
_CUR_NO_W = ("(first ? DE : H) * 128, full);", "16, full);", 1)
_CUR_NO_ROWS = ("ok ? 16 : 0);", "0);", 2)
_CUR_FAST_ACT = ("activate_bf16<ACT>(f.x)",
                 "__fdividef(f.x, 1.0f + __expf(-f.x))", 1)
_CUR_FAST_ACT2 = ("activate_bf16<ACT>(f.y)",
                  "__fdividef(f.y, 1.0f + __expf(-f.y))", 1)
CURRENT_VARIANTS = {
    "no_mma": (_CUR_NO_MMA,),
    "no_epilogues": (_CUR_NO_EPI,),
    "no_aggregate": (_CUR_NO_AGG,),
    "fast_activation": (_CUR_FAST_ACT, _CUR_FAST_ACT2),
    "copies_only": (_CUR_NO_MMA, _CUR_NO_EPI, _CUR_NO_AGG),
    "copies_no_weights": (_CUR_NO_MMA, _CUR_NO_EPI, _CUR_NO_AGG, _CUR_NO_W),
    "copies_no_rows": (_CUR_NO_MMA, _CUR_NO_EPI, _CUR_NO_AGG, _CUR_NO_ROWS),
}
_RECEIVERS = "constexpr int kStepReceivers = 20;"


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


def _caller(path, old):
    """A call of the library built from ``path`` on the inputs ``t``, and
    its receivers per group.  c6b0bb6's kernel takes row-major weights and
    has one receiver tile for every dtype and width."""
    lib = ctypes.CDLL(path)
    for name, (restype, argtypes) in edge_step.SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype, fn.argtypes = restype, list(argtypes)
    if old:
        lib.gclt_edge_step_tile_receivers.argtypes = []
        tile = lib.gclt_edge_step_tile_receivers()
    else:
        tile = lib.gclt_edge_step_tile_receivers(1, 256, 256)

    def call(t, r):
        w1e, w2 = t["w1e"], t["w2"]
        if not old:
            w1e = edge_step.wgmma_b_image(w1e)
            w2 = edge_step.wgmma_b_image(w2)
        de = t["v"].shape[1]
        hid = t["xsg"].shape[1]
        _, partials_shape = edge_step.launch_geometry(r, tile)
        v_new = torch.empty_like(t["v"])
        agg = torch.empty((r, de), dtype=t["v"].dtype, device="cuda")
        partials = torch.empty(partials_shape, device="cuda")
        stats = torch.empty(3, device="cuda")
        err = lib.gclt_edge_step(
            t["xsg"].data_ptr(), t["v"].data_ptr(), t["xr"].data_ptr(),
            w1e.data_ptr(), t["b_eff"].data_ptr(), w2.data_ptr(),
            t["b2"].data_ptr(), t["a"].data_ptr(), t["c"].data_ptr(),
            t["mask"].data_ptr(), t["indptr"].data_ptr(), v_new.data_ptr(),
            agg.data_ptr(), partials.data_ptr(), stats.data_ptr(), 1, r, hid,
            de, 0, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{path}: CUDA error {err}")
        return v_new, agg, stats

    return call, tile


def _check(label, out, t, r):
    """Max abs error of (v_new, agg) against the plain version, raising
    outside chip_smoke's bf16 tolerances (aggregates: + ORDER_RTOL
    * sum |u|)."""
    ref = edge_step.edge_step_reference(
        t["xsg"], t["v"], t["xr"], t["w1e"], t["b_eff"], t["w2"], t["b2"],
        t["a"], t["c"], t["mask"], t["indptr"], r, "swish")
    w = t["mask"].float()[:, None]
    u_mag = (ref[0].float() - t["a"] * t["v"].float() - t["c"]).abs() * w
    agg_mag = cuda_segment.segment_sum_reference(u_mag, t["indptr"], r)
    torch.cuda.synchronize()
    return max(chip_smoke._close(f"{label} v_new", out[0], ref[0],
                                 chip_smoke.FUSED_BF16_TOL),
               chip_smoke._close(f"{label} agg", out[1], ref[1],
                                 chip_smoke.FUSED_BF16_TOL,
                                 chip_smoke.ORDER_RTOL * agg_mag))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="c6b0bb6's edge_step.cu, to split")
    ap.add_argument("--receivers", default="",
                    help="receivers-per-group values of the current kernel")
    ap.add_argument("--split-current", action="store_true",
                    help="time the current kernel with parts cut out")
    ap.add_argument("--compare", default="",
                    help="comma-separated edge_step.cu files to time as-is")
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
        os.path.dirname(nvcc_build.lib_path(edge_step.SOURCE)), "split")
    os.makedirs(workdir, exist_ok=True)
    for header in glob.glob(os.path.join(nvcc_build.CSRC, "*.cuh")):
        shutil.copy(header, workdir)
    with open(edge_step.SOURCE) as f:
        current = f.read()
    sources = {}
    if args.old:
        with open(args.old) as f:
            old = f.read()
        for name, edits in OLD_VARIANTS.items():
            sources[f"old_{name}"] = _variant(workdir, f"old_{name}", old,
                                              edits)
    if args.split_current:
        for name, edits in CURRENT_VARIANTS.items():
            sources[f"cur_{name}"] = _variant(workdir, f"cur_{name}", current,
                                              edits)
    for g in [int(x) for x in args.receivers.split(",") if x]:
        sources[f"new_r{g}"] = _variant(
            workdir, f"new_r{g}", current,
            [(_RECEIVERS, f"constexpr int kStepReceivers = {g};", 1)])
    for i, path in enumerate(x for x in args.compare.split(",") if x):
        with open(path) as f:
            sources[f"cmp{i}"] = _variant(workdir, f"cmp{i}", f.read(), [])
    if not sources:
        sources["current"] = edge_step.SOURCE
    t0 = time.perf_counter()
    libs = dict(zip(sources, nvcc_build.build(*sources.values())))
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)

    recv = _flagship_recv()
    r = int(recv.max()) + 1
    gen = torch.Generator().manual_seed(1)
    t = chip_smoke._fused_case(gen, 0, r, 256, 256, torch.bfloat16,
                               recv=recv)
    t["mask"] = torch.ones_like(t["mask"])
    step_bytes = chip_smoke._nbytes(*(t[k] for k in (
        "xsg", "v", "xr", "w1e", "b_eff", "w2", "b2", "a", "c", "mask",
        "indptr"))) + (recv.numel() + r) * 256 * 2 + 12
    bound_ms, bound_by = chip_smoke._bound(step_bytes,
                                           4 * recv.numel() * 256 * 256)
    rows, calls = {}, {}
    for name, path in libs.items():
        call, tile = _caller(path, name.startswith("old"))
        calls[name] = call
        err = None
        if name == "old_full" or name.startswith(("new", "cmp", "current")):
            try:
                err = _check(name, call(t, r), t, r)
            except AssertionError as exc:  # reported, and timed all the same
                err = f"FAILED: {exc}"
        rows[name] = {"ms": [], "receivers_per_group": tile,
                      "max_abs_err": err}
    for names in (list(libs), list(reversed(libs))):
        for name in names:
            call = calls[name]
            rows[name]["ms"].append(chip_smoke._time_ms(lambda: call(t, r),
                                                        iters=50, warmup=5))
    for name, row in rows.items():
        print(f"  {name:<20s} " + " ".join(f"{ms * 1e3:8.1f}"
                                           for ms in row["ms"])
              + f" us  receivers/group {row['receivers_per_group']:3d}  "
              f"err {row['max_abs_err']}", flush=True)
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
