"""The fused edge-MLP tail's time on the card (H = De = 256; CUDA events),
for builds of ``edge_mlp.cu`` compared in one call, at the flagship
processor shape (the 512x256 model's multimesh, levels [4, 6]: E_pad
261,120, R 40,962, in-degree 6-12) and the regional head's (the reg-level-8
mesh over the README's ROI: E_pad 228,352, R 41,046).

    python3 scripts/torch_edge_mlp_time.py [--dtype bfloat16|float32]
        [--shapes flagship,regional] [--old EDGE_MLP_CU] [--split-current]
        [--receivers 16,24,32] [--compare CU,...] [--out PATH]

* ``--dtype`` (default bfloat16): bf16 times the ``hopper_bf16`` design,
  float32 the ``hopper_fp32`` one.
* ``--shapes`` (default flagship): the shapes to time.
* ``--old``: an earlier ``edge_mlp.cu`` whose C interface takes W2
  row-major where it has no design query or ``gclt_edge_mlp_wgmma`` says
  0, e.g. commit 14a3db7's (the 16-receiver wmma kernel) or 01a8eb8's
  (``git show 01a8eb8:graphcast_lite_torch/csrc/edge_mlp.cu``: fp32 on the
  16-receiver FMA design), built as it is.
* ``--split-current``: the current kernel with parts cut out by text
  edits.  bf16: the activation's arithmetic, the wgmma instructions, the
  register epilogue, the u row stores, the aggregate loop, and all five
  (row and W2 copies and barriers only); and with a fast activation
  (``__expf``, ``__fdividef``).  fp32: the products (``no_mma``), the W2
  slab copies (``no_w2``: the producer arrives without copying), the
  activation (``no_activation``: the split of the raw rows), the u row
  stores and the aggregate (``no_epilogue_out``), and all but the products
  (``mma_only``).  The differences of their times bound each part; the
  parts overlap, so they do not add up.
* ``--receivers``: the current bf16 kernel with each receivers-per-group
  value (at most 32: the flagship layout fits no more).
* ``--compare``: other ``edge_mlp.cu`` files of the current C interface.

``--old`` and ``--compare`` sources build with the headers beside them
where there are any (an earlier tree's ``csrc/``), else the package's.

Every variant is a copy of the source and of the package's ``*.cuh``
headers in a directory of its own under the gitignored build directory,
the edits applied to all of them (``ops/nvcc_build.edited_copy``: the fp32
product pass and aggregate live in ``hopper.cuh``), built by
``ops/nvcc_build.build`` (one nvcc each, all at once).  An edit whose text
is not found exactly as often as expected stops the script.  Every
complete build is held against the plain version first (chip_smoke's
tolerances of the dtype).  W2's image is made once, outside the timed
calls, so the times are the kernel's launches alone.  Each build is
timed twice, the second round in reverse order.  Prints the card's name
and power limit and one JSON line, which ``--out PATH`` also writes to a
file.
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
from graphcast_lite_torch.graphs.regional import \
    create_regional_mesh  # noqa: E402
from graphcast_lite_torch.graphs.structure import build_graph  # noqa: E402
from graphcast_lite_torch.mesh.icosphere import build_hierarchy, \
    edges_from_faces, merge_mesh_levels  # noqa: E402
from graphcast_lite_torch.ops import cuda_segment, edge_mlp, \
    nvcc_build  # noqa: E402

# Text edits of the current kernel: (text, replacement, occurrences).
_NO_ACT = ("for (int c = 0; c < 4; ++c) {", "for (int c = 0; c < 0; ++c) {", 1)
_NO_MMA = ("            wgmma_m64n64k16(",
           "            if (0) wgmma_m64n64k16(", 1)
_NO_EPI = ("for (int j = 0; j < 8; ++j) {", "for (int j = 0; j < 0; ++j) {",
           2)
_NO_STORE = ("q < nrows * (DE / 8);", "q < 0;", 1)
_NO_AGG = ("for (int row = rg.x; row < rg.y; ++row) {",
           "for (int row = rg.x; row < rg.x; ++row) {", 1)
_FAST_ACT = ("activate_bf16<ACT>(f.x)", "__fdividef(f.x, 1.0f + __expf(-f.x))",
             1)
_FAST_ACT2 = ("activate_bf16<ACT>(f.y)",
              "__fdividef(f.y, 1.0f + __expf(-f.y))", 1)
BF16_VARIANTS = {
    "no_activation": (_NO_ACT,),
    "no_mma": (_NO_MMA,),
    "no_epilogue": (_NO_EPI,),
    "no_u_store": (_NO_STORE,),
    "no_aggregate": (_NO_AGG,),
    "copies_only": (_NO_ACT, _NO_MMA, _NO_EPI, _NO_STORE, _NO_AGG),
    "fast_activation": (_FAST_ACT, _FAST_ACT2),
}
# The fp32 kernel's cuts.
_F32_NO_MMA = ("wgmma_tf32(acc", "if (0) wgmma_tf32(acc", 3)
_F32_NO_W2 = ("mbar_expect_tx(full + (c & 1), L::kSlab);\n"
              "    bulk_copy(dst, src, L::kPart, full + (c & 1));\n"
              "    bulk_copy(dst + L::kPart, src + L::kPart / 4, L::kPart, "
              "full + (c & 1));",
              "mbar_arrive(full + (c & 1));\n"
              "    (void)src;\n"
              "    (void)dst;", 1)
_F32_NO_ACT = ("[](float v) { return activate(v, ACT); }",
               "[](float v) { return v; }", 1)
_F32_NO_STORE = ("q < (e1 - e0) * 32;", "q < 0;", 1)
_F32_NO_AGG = ("for (int e = max(r_lo, e0); e < hi; ++e) {",
               "for (int e = hi; e < hi; ++e) {", 1)
F32_VARIANTS = {
    "no_mma": (_F32_NO_MMA,),
    "no_w2": (_F32_NO_W2,),
    "no_activation": (_F32_NO_ACT,),
    "no_epilogue_out": (_F32_NO_STORE, _F32_NO_AGG),
    "mma_only": (_F32_NO_W2, _F32_NO_ACT, _F32_NO_STORE, _F32_NO_AGG),
}
_RECEIVERS = "constexpr int kMlpReceivers = 32;"
# Variants whose output is checked (the others compute something else).
_CHECKED = ("old", "cur", "cmp", "new_r", "fast_activation")


def _recv(shape) -> torch.Tensor:
    """The receivers of the flagship multimesh or of the regional head's
    processing graph, sorted (as the graphs keep them; the padding rows
    are added by chip_smoke._fused_case)."""
    if shape == "flagship":
        mesh = merge_mesh_levels(build_hierarchy(6), [4, 6])
        recv = edges_from_faces(mesh.faces)[1]
        return torch.from_numpy(np.sort(recv).astype(np.int64))
    mesh, lats, _ = create_regional_mesh((20.0, 60.0, 60.0, 140.0), 8, 2.0,
                                         6)
    send, recv = edges_from_faces(mesh.faces)
    graph = build_graph(send, recv, num_nodes=len(lats))
    return graph.receivers[:graph.num_edges].long()


def _caller(path, t, r):
    """A call of the library built from ``path`` on the inputs ``t`` (W2 as
    the library takes it), and the library's receivers per group."""
    lib = ctypes.CDLL(path)
    sigs = dict(edge_mlp.SIGNATURES,
                gclt_edge_mlp_wgmma=(ctypes.c_int, [ctypes.c_int] * 3))
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype, fn.argtypes = restype, list(argtypes)
    dtype = t["h_pre"].dtype
    code = nvcc_build.DTYPE_CODES[dtype]
    hid, de = t["w2"].shape
    w2 = t["w2"]
    tile = edge_mlp.TILE_RECEIVERS
    if getattr(lib, "gclt_edge_mlp_design", None) is not None:
        kind = edge_mlp.DESIGNS[lib.gclt_edge_mlp_design(code, hid, de)]
        if kind == "hopper_bf16":
            w2 = edge_mlp.wgmma_b_image(w2)
        elif kind == "hopper_fp32":
            w2 = edge_mlp.tf32x3_b_image(w2)
        tile = lib.gclt_edge_mlp_tile_receivers(code, hid, de)
    elif getattr(lib, "gclt_edge_mlp_wgmma", None) is not None:
        if lib.gclt_edge_mlp_wgmma(code, hid, de):
            w2 = edge_mlp.wgmma_b_image(w2)
        tile = lib.gclt_edge_mlp_tile_receivers(code, hid, de)
    u = torch.empty((t["h_pre"].shape[0], de), dtype=dtype, device="cuda")
    agg = torch.empty((r, de), dtype=dtype, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.gclt_edge_mlp(
            t["h_pre"].data_ptr(), w2.data_ptr(), t["b2"].data_ptr(),
            t["mask"].data_ptr(), t["indptr"].data_ptr(), u.data_ptr(),
            agg.data_ptr(), code, r, hid, de, 0, stream)
        if err != 0:
            raise RuntimeError(f"{path}: CUDA error {err}")
        return u, agg

    return call, tile


def _check(label, out, t, r):
    """Max abs error of (u, agg) against the plain version, raising outside
    chip_smoke's tolerances of the dtype (aggregates: + ORDER_RTOL *
    sum |u|)."""
    u_ref, agg_ref = edge_mlp.edge_mlp_reference(
        t["h_pre"], t["w2"], t["b2"], t["mask"], t["indptr"], r, "swish")
    mag = cuda_segment.segment_sum_reference(
        u_ref.float().abs() * t["mask"].float()[:, None], t["indptr"], r)
    torch.cuda.synchronize()
    tol = (chip_smoke.FUSED_FP32_TOL if u_ref.dtype == torch.float32
           else chip_smoke.FUSED_BF16_TOL)
    return max(chip_smoke._close(f"{label} u", out[0], u_ref, tol),
               chip_smoke._close(f"{label} agg", out[1], agg_ref, tol,
                                 chip_smoke.ORDER_RTOL * mag))


def _time_shape(shape, dtype, libs):
    """Every library checked (where it computes the function) and timed
    twice, the second round in reverse order, at ``shape``."""
    recv = _recv(shape)
    r = int(recv.max()) + 1
    gen = torch.Generator().manual_seed(1)
    t = chip_smoke._fused_case(gen, 0, r, 256, 256, dtype, recv=recv)
    e_pad = t["h_pre"].shape[0]
    nbytes = chip_smoke._nbytes(*(t[k] for k in (
        "h_pre", "w2", "b2", "mask", "indptr"))) + (
            (e_pad + r) * 256 * t["h_pre"].element_size())
    flops = 2 * e_pad * 256 * 256
    bound = (chip_smoke._bound if dtype == torch.bfloat16
             else chip_smoke._bound_tf32x3)
    bound_ms, bound_by = bound(nbytes, flops)
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
    print(f"{shape} E_pad {e_pad} R {r} {str(dtype)[6:]}:", flush=True)
    for name, row in rows.items():
        print(f"  {name:<16s} " + " ".join(f"{ms * 1e3:8.1f}"
                                           for ms in row["ms"])
              + f" us  receivers/group {row['receivers_per_group']:3d}  "
              f"err {row['max_abs_err']}", flush=True)
    print(f"  bound {bound_ms * 1e3:.1f} us ({bound_by}; {nbytes / 1e6:.1f} "
          f"MB, {flops / 1e9:.1f} GFLOP)", flush=True)
    return {"E_pad": e_pad, "R": r, "bound_ms": bound_ms,
            "bound_by": bound_by, "variants": rows}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--shapes", default="flagship",
                    help="comma-separated: flagship, regional")
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
    dtype = getattr(torch, args.dtype)
    shapes = [s for s in args.shapes.split(",") if s]
    if set(shapes) - {"flagship", "regional"}:
        ap.error(f"unknown shapes {shapes}")
    # fp32 products in full fp32 in the plain version.
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    workdir = os.path.join(
        os.path.dirname(nvcc_build.lib_path(edge_mlp.SOURCE)), "mlp_time")
    os.makedirs(workdir, exist_ok=True)
    with open(edge_mlp.SOURCE) as f:
        current = f.read()
    sources = {"cur": nvcc_build.edited_copy(workdir, "cur", current, [])}
    if args.old:
        with open(args.old) as f:
            sources["old"] = nvcc_build.edited_copy(
                workdir, "old", f.read(), [],
                os.path.dirname(os.path.abspath(args.old)))
    if args.split_current:
        variants = (F32_VARIANTS if dtype == torch.float32
                    else BF16_VARIANTS)
        for name, edits in variants.items():
            sources[name] = nvcc_build.edited_copy(workdir, name, current,
                                                   edits)
    for g in [int(x) for x in args.receivers.split(",") if x]:
        sources[f"new_r{g}"] = nvcc_build.edited_copy(
            workdir, f"new_r{g}", current,
            [(_RECEIVERS, f"constexpr int kMlpReceivers = {g};", 1)])
    for i, path in enumerate(x for x in args.compare.split(",") if x):
        with open(path) as f:
            sources[f"cmp{i}"] = nvcc_build.edited_copy(
                workdir, f"cmp{i}", f.read(), [],
                os.path.dirname(os.path.abspath(path)))
    t0 = time.perf_counter()
    libs = dict(zip(sources, nvcc_build.build(*sources.values())))
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    result = {"device": smi, "dtype": args.dtype,
              "shapes": {s: _time_shape(s, dtype, libs) for s in shapes}}
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
