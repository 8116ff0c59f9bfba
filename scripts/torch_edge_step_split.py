"""Where the fused edge step's time goes on the card, at the flagship
processor shape (the 512x256 model's multimesh, levels [4, 6]: E_pad
261,120, R 40,962, in-degree 6-12; H = De = 256; CUDA events).

    python3 scripts/torch_edge_step_split.py [--dtype bfloat16|float32]
        [--old EDGE_STEP_CU] [--split-current] [--receivers 10,16,20]
        [--compare CU,...] [--out PATH]

Every variant is a copy of a kernel source and of the package's ``*.cuh``
headers, in a directory of its own under the gitignored build directory,
with parts cut out by text edits (``ops/nvcc_build.edited_copy``: an edit
applies to the source and the headers together, since the fp32 kernels'
product pass and aggregate live in ``hopper.cuh``), built by
``ops/nvcc_build.build`` (one nvcc each, all at once).  An edit whose
text is not found exactly as often as expected stops the script, so a
kernel edit that moves an anchor fails loudly instead of timing the wrong
cut.

* ``--dtype`` (default bfloat16): bf16 times the ``hopper_bf16`` design,
  float32 the ``hopper_fp32`` one.
* ``--old``: an earlier ``edge_step.cu``, of any of the C interfaces the
  port has had (c6b0bb6's, with row-major weights and one receiver tile;
  14a3db7's to 86e6225's, with ``gclt_edge_step_wgmma``).  In bf16, e.g.
  c6b0bb6's (``git show c6b0bb6:graphcast_lite_torch/csrc/edge_step.cu``,
  the kernel built on ``wmma`` with fp32 product tiles in shared memory),
  as it is and with the aggregate loop, the two elementwise epilogues, the
  four product passes, and all three (loads only) cut out: the differences
  of their times split that kernel's time.  In fp32, e.g. 86e6225's (the
  16-receiver FMA design), as it is.
* ``--split-current``: the current kernel with parts cut out.  bf16: the
  wgmma instructions (the weight ring and its waits stay), the two
  register epilogues, the aggregate loop, and all three (row and weight
  copies and barriers only), that last also with 16-byte weight slabs or
  without row reads (zero-filled); and with a fast activation
  (``__expf``, ``__fdividef``).  fp32: the wgmma instructions
  (``no_mma``), the weight slab copies (``no_w``: the producer arrives
  without copying), the h workspace's stores and loads
  (``no_h_workspace``: product 2 multiplies zeros), epilogue 1 (h from
  xsg, xr and the product, its activation and store: ``no_epilogue1``),
  epilogue 2's v' rows and statistics (``no_epilogue2``), the aggregate
  sums (``no_aggregate``), and all but the products and the tiles they
  are staged into (``mma_only``).  The parts overlap, so the savings do
  not add up.
* ``--receivers``: the current bf16 kernel with each receivers-per-group
  value.
* ``--compare``: other ``edge_step.cu`` files of the current C interface,
  built as they are.

``--old`` and ``--compare`` sources build with the headers beside them
where there are any (an earlier tree's ``csrc/``), else the package's.

Every complete build is held against the plain version first (chip_smoke's
tolerances of the dtype); in fp32 each, and the plain version, is also
measured against the step in float64 (``chip_smoke._step_fp64``: max and
RMS over v' and agg of the per-element error over the terms'
magnitudes).  The weights' images and the workspace are made
once, outside the timed calls, so the times are the kernels' launches (the
step and its statistics reduction) alone.  Each build is timed twice, the
second round in reverse order, so that a drift of the card's clock shows
as a spread and not as a difference.  Prints the card's name and power
limit and one JSON line, which ``--out PATH`` also writes to a file.
"""

from __future__ import annotations

import argparse
import ctypes
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
# Of the current bf16 kernel:
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
# Of the current fp32 kernel:
_F32_NO_MMA = ("wgmma_tf32(acc", "if (0) wgmma_tf32(acc", 3)
_F32_NO_W = ("mbar_expect_tx(full + (s & 1), 2 * part);\n"
             "    bulk_copy(dst, src, part, full + (s & 1));\n"
             "    bulk_copy(dst + part, src + part / 4, part, "
             "full + (s & 1));",
             "mbar_arrive(full + (s & 1));\n"
             "    (void)src;\n"
             "    (void)dst;", 1)
_F32_NO_H_STORE = ("__stcg(w4, hv);", "", 1)
_F32_NO_H_LOAD = ("x[k] = __ldcg(", "if (0) x[k] = __ldcg(", 1)
_F32_NO_EPI1 = ("b0 < kSubRows * 32 / 128; b0 += kEpiBatch) {",
                "b0 < 0; b0 += kEpiBatch) {", 1)
_F32_NO_EPI2 = ("b0 < kF32StepRows / 8; b0 += kEpiBatch) {",
                "b0 < 0; b0 += kEpiBatch) {", 1)
_F32_NO_AGG = ("for (int e = max(r_lo, e0); e < hi; ++e) {",
               "for (int e = hi; e < hi; ++e) {", 1)
F32_VARIANTS = {
    "no_mma": (_F32_NO_MMA,),
    "no_w": (_F32_NO_W,),
    "no_h_workspace": (_F32_NO_H_STORE, _F32_NO_H_LOAD),
    "no_epilogue1": (_F32_NO_EPI1,),
    "no_epilogue2": (_F32_NO_EPI2,),
    "no_aggregate": (_F32_NO_AGG,),
    "mma_only": (_F32_NO_W, _F32_NO_EPI1, _F32_NO_EPI2, _F32_NO_AGG),
}
_RECEIVERS = "constexpr int kStepReceivers = 20;"


def _checked(name) -> bool:
    """Whether the variant computes the step (the cuts compute something
    else)."""
    return (name in ("cur", "old", "old_full", "fast_activation")
            or name.startswith(("new_r", "cmp")))


def _flagship_recv() -> torch.Tensor:
    """The flagship multimesh's receivers, sorted (as the graph keeps
    them)."""
    mesh = merge_mesh_levels(build_hierarchy(6), [4, 6])
    recv = edges_from_faces(mesh.faces)[1]
    return torch.from_numpy(np.sort(recv).astype(np.int64))


def _caller(path, t, r):
    """A call of the library built from ``path`` on the inputs ``t`` (the
    weights as the library takes them, made once), and its receivers per
    group.  Three C interfaces: the current one (``gclt_edge_step_design``,
    a workspace pointer), 14a3db7's to 86e6225's (``gclt_edge_step_wgmma``)
    and c6b0bb6's (row-major weights, one receiver tile)."""
    lib = ctypes.CDLL(path)
    dtype = t["v"].dtype
    code = nvcc_build.DTYPE_CODES[dtype]
    de, hid = t["w1e"].shape
    ints3 = [ctypes.c_int] * 3
    current = getattr(lib, "gclt_edge_step_design", None) is not None
    if current:
        for name, (restype, argtypes) in edge_step.SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, list(argtypes)
        kind = edge_step.DESIGNS[lib.gclt_edge_step_design(code, hid, de)]
        tile = lib.gclt_edge_step_tile_receivers(code, hid, de)
    else:
        lib.gclt_edge_step.restype = ctypes.c_int
        lib.gclt_edge_step.argtypes = ([ctypes.c_void_p] * 15
                                       + [ctypes.c_int] * 5
                                       + [ctypes.c_void_p])
        wgmma = getattr(lib, "gclt_edge_step_wgmma", None)
        if wgmma is not None:
            wgmma.argtypes = lib.gclt_edge_step_tile_receivers.argtypes = \
                ints3
            kind = "hopper_bf16" if wgmma(code, hid, de) else "tile16"
            tile = lib.gclt_edge_step_tile_receivers(code, hid, de)
        else:
            lib.gclt_edge_step_tile_receivers.argtypes = []
            kind, tile = "tile16", lib.gclt_edge_step_tile_receivers()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    w1e, w2 = t["w1e"], t["w2"]
    work = torch.empty(0, device="cuda")
    if kind == "hopper_bf16":
        w1e, w2 = edge_step.wgmma_b_image(w1e), edge_step.wgmma_b_image(w2)
    elif kind == "hopper_fp32":
        w1e, w2 = edge_step.tf32x3_b_image(w1e), edge_step.tf32x3_b_image(w2)
        work = torch.empty(edge_step.workspace_shape(r, hid, sms),
                           device="cuda")
    _, partials_shape = edge_step.launch_geometry(r, tile, sms)
    v_new = torch.empty_like(t["v"])
    agg = torch.empty((r, de), dtype=dtype, device="cuda")
    partials = torch.empty(partials_shape, device="cuda")
    stats = torch.empty(3, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t["xsg"].data_ptr(), t["v"].data_ptr(), t["xr"].data_ptr(),
            w1e.data_ptr(), t["b_eff"].data_ptr(), w2.data_ptr(),
            t["b2"].data_ptr(), t["a"].data_ptr(), t["c"].data_ptr(),
            t["mask"].data_ptr(), t["indptr"].data_ptr(), v_new.data_ptr(),
            agg.data_ptr(), partials.data_ptr(), stats.data_ptr()]
    if current:
        ptrs.append(work.data_ptr())

    # Every buffer behind ``ptrs`` lives as long as the call: a freed
    # weight image or scratch would be reused by the next allocation.
    keep = (w1e, w2, work, partials, v_new, agg, stats)

    def call():
        err = lib.gclt_edge_step(*ptrs, code, r, hid, de, 0, stream)
        if err != 0:
            raise RuntimeError(f"{path}: CUDA error {err}")
        return keep[4:]

    return call, tile, kind


def _check(label, out, t, r):
    """Max abs error of (v_new, agg) against the plain version, raising
    outside chip_smoke's tolerances of the dtype (aggregates: +
    ORDER_RTOL * sum |u|)."""
    ref = edge_step.edge_step_reference(*chip_smoke._step_args(t, r))
    w = t["mask"].float()[:, None]
    u_mag = (ref[0].float() - t["a"] * t["v"].float() - t["c"]).abs() * w
    agg_mag = cuda_segment.segment_sum_reference(u_mag, t["indptr"], r)
    torch.cuda.synchronize()
    tol = (chip_smoke.FUSED_FP32_TOL if ref[0].dtype == torch.float32
           else chip_smoke.FUSED_BF16_TOL)
    return max(chip_smoke._close(f"{label} v_new", out[0], ref[0], tol),
               chip_smoke._close(f"{label} agg", out[1], ref[1], tol,
                                 chip_smoke.ORDER_RTOL * agg_mag))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--old", help="an earlier edge_step.cu")
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
    dtype = getattr(torch, args.dtype)
    # fp32 products in full fp32 in the plain version.
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    workdir = os.path.join(
        os.path.dirname(nvcc_build.lib_path(edge_step.SOURCE)), "split")
    os.makedirs(workdir, exist_ok=True)
    with open(edge_step.SOURCE) as f:
        current = f.read()
    sources = {"cur": nvcc_build.edited_copy(workdir, "cur", current, [])}
    if args.old:
        with open(args.old) as f:
            old = f.read()
        beside = os.path.dirname(os.path.abspath(args.old))
        if dtype == torch.float32:
            sources["old"] = nvcc_build.edited_copy(workdir, "old", old, [],
                                                    beside)
        else:
            for name, edits in OLD_VARIANTS.items():
                sources[f"old_{name}"] = nvcc_build.edited_copy(
                    workdir, f"old_{name}", old, edits, beside)
    if args.split_current:
        variants = (F32_VARIANTS if dtype == torch.float32
                    else CURRENT_VARIANTS)
        for name, edits in variants.items():
            sources[name] = nvcc_build.edited_copy(workdir, name, current,
                                                   edits)
    for g in [int(x) for x in args.receivers.split(",") if x]:
        sources[f"new_r{g}"] = nvcc_build.edited_copy(
            workdir, f"new_r{g}", current,
            [(_RECEIVERS, f"constexpr int kStepReceivers = {g};", 1)])
    for i, path in enumerate(x for x in args.compare.split(",") if x):
        with open(path) as f:
            sources[f"cmp{i}"] = nvcc_build.edited_copy(
                workdir, f"cmp{i}", f.read(), [],
                os.path.dirname(os.path.abspath(path)))
    t0 = time.perf_counter()
    libs = dict(zip(sources, nvcc_build.build(*sources.values())))
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)

    recv = _flagship_recv()
    r = int(recv.max()) + 1
    gen = torch.Generator().manual_seed(1)
    t = chip_smoke._fused_case(gen, 0, r, 256, 256, dtype, recv=recv)
    t["mask"] = torch.ones_like(t["mask"])
    e_pad = t["v"].shape[0]
    step_bytes = chip_smoke._nbytes(*chip_smoke._step_args(t, r)[:11]) + (
        (e_pad + r) * 256 * t["v"].element_size() + 12)
    flops = 4 * e_pad * 256 * 256
    bound = (chip_smoke._bound if dtype == torch.bfloat16
             else chip_smoke._bound_tf32x3)
    bound_ms, bound_by = bound(step_bytes, flops)
    rows, calls = {}, {}
    # fp32: each checked build's and the plain version's error against the
    # step in float64, (v' max, v' RMS, agg max, agg RMS) of the per-element
    # error over the terms' magnitudes (chip_smoke._fp64_step_check).
    oracle = (chip_smoke._step_fp64(t, r) if dtype == torch.float32
              else None)

    def fp64_errs(out):
        v64, vmag, agg64, aggmag = oracle
        return (chip_smoke._rel_errs(out[0], v64, vmag)
                + chip_smoke._rel_errs(out[1], agg64, aggmag))

    plain_fp64 = None
    if oracle is not None:
        plain_fp64 = fp64_errs(edge_step.edge_step_reference(
            *chip_smoke._step_args(t, r)))
        print("  plain fp32 vs fp64 (v' max, v' RMS, agg max, agg RMS): "
              + ", ".join(f"{x:.3e}" for x in plain_fp64), flush=True)
    for name, path in libs.items():
        call, tile, kind = _caller(path, t, r)
        calls[name] = call
        err = fp64 = None
        if _checked(name):
            try:
                err = _check(name, call(), t, r)
            except AssertionError as exc:  # reported, and timed all the same
                err = f"FAILED: {exc}"
            if oracle is not None:
                fp64 = fp64_errs(call())
        rows[name] = {"ms": [], "design": kind, "receivers_per_group": tile,
                      "max_abs_err": err, "fp64_errs": fp64}
    del oracle
    for names in (list(libs), list(reversed(libs))):
        for name in names:
            rows[name]["ms"].append(chip_smoke._time_ms(calls[name],
                                                        iters=50, warmup=5))
    print(f"flagship E_pad {e_pad} R {r} {args.dtype}:", flush=True)
    for name, row in rows.items():
        print(f"  {name:<20s} " + " ".join(f"{ms * 1e3:8.1f}"
                                           for ms in row["ms"])
              + f" us  {row['design']:<12s} receivers/group "
              f"{row['receivers_per_group']:3d}  err {row['max_abs_err']}"
              + ("" if row["fp64_errs"] is None else "  vs fp64 " + ", ".join(
                  f"{x:.3e}" for x in row["fp64_errs"])), flush=True)
    print(f"  bound {bound_ms * 1e3:.1f} us ({bound_by}; "
          f"{step_bytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)", flush=True)
    result = {"device": smi, "dtype": args.dtype, "E_pad": e_pad, "R": r,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "plain_fp64_errs": plain_fp64, "variants": rows}
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
