"""Where the segment sum's time goes at the flagship encoder shape (the
512x256 model's G2M graph, mesh levels [4, 6]: E_pad 203,648, R 172,034,
rows 0-131,071 empty, in-degree up to 346 in the mesh band; F = 256, bf16;
CUDA events), for the designs of ``segment_sum.cu`` in one call, and the
same at the flagship processor shape and at the narrow rows' shapes.

    python3 scripts/torch_segment_split.py [--tile-items 16,32]
        [--warps 2,8] [--stages 2,4] [--chunk-bytes 2048,4096]
        [--narrow-bytes 2048,8192] [--narrow-threads 64,256]
        [--compare CU,...] [--timeline] [--senders] [--narrow]
        [--out PATH]

Five cases, each on two designs (``warp``: the warp-per-row kernel of the
first port; ``balanced``: the merge-path kernel):

* ``whole``: the encoder graph as it is;
* ``band``: its mesh band alone, ``indptr[131072:]`` rebased (R 40,962),
  which is the edge work;
* ``zero_rows``: 131,072 rows with no edges, which is the zero writes;
* ``even``: the same E and R as ``whole`` with the band's degrees spread
  evenly (E // 40,962 or one more a row), which takes the skew away;
* ``processor``: the multimesh (E_pad 261,120, R 40,962, in-degree 6-12),
  which the COO composed route sums 48 times a rollout.

``--senders`` adds the sender-sorted scatters of the train step's backward
(``graphs.structure.sender_csr``): ``reg_senders`` (the reg-block rows into
40,962 mesh rows), ``enc_senders`` (the G2M edges into 172,034 rows,
40,962 of them empty) and ``dec_senders`` (the M2G edges into 172,034
rows, 131,072 empty, out-degree up to 696) at F = 256, and
``dec_senders_f19`` at the decoder's output width, F = 19.  ``--narrow``
adds ``dec_senders_f19`` and the narrow rows of the 64x32 BASELINE
layers in fp32 (chip_smoke's phase 3b shapes): ``mm_softmax_f4`` and
``mm_degrees_f1`` (the multimesh's softmax denominators and masked
degrees), ``mm_asrc_adj_f4`` (its senders' a_src gather adjoint),
``product_gcn_f33`` and ``product_adj_f33`` (the product graph's GCN
aggregation and gather adjoint).  Those take the ``narrow`` design, timed
beside ``warp``.

``--tile-items``, ``--warps``, ``--stages`` and ``--chunk-bytes`` time the
balanced design with other values of ``kTileItems``, ``kWarps``,
``kStages`` and ``kChunkBytes``, ``--narrow-bytes`` and
``--narrow-threads`` the narrow design with other values of
``kNarrowBytes`` and ``kNarrowThreads`` (text edits of the source);
``--compare`` times other ``segment_sum.cu`` files of the current C
interface, each named by its file's stem (a stem ``cut_...`` is timed
unchecked, a stem ``warp_...`` in the warp-per-row design, and a stem
``tl_...`` must carry the timeline instrumentation and prints it); every
other build runs each case in the merge-path design it takes.
``--timeline`` builds the current balanced and narrow kernels with
timestamps (%globaltimer) per balanced warp (entry, start of the first
walk, end, and the cycles spent waiting for chunks) and per narrow block
(entry, end of the staging, end of the flat outputs) and prints their
spread for each case.

Every build is written beside copies of the package's ``*.cuh`` headers
under the gitignored build directory and built by ``ops/nvcc_build.build``
(one nvcc each, all at once).  Each (build, design, case) is held against
the plain version first (chip_smoke's tolerance), then timed twice, the
second round in reverse order; the launches are raw (``chip_smoke.
_segment_raw``: output, workspace and counters allocated once, sized by
the build's own tile queries) and timed with CUDA events over 50
back-to-back launches (``ms``) and, for every case whose merge-path design
is narrow, also alone (``kernel_ms``: 50 launches queued behind a sleep
kernel, ``chip_smoke._device_ms``), beside the launch floor (an empty
kernel on the narrow grid, timed alike).
Prints the card's name and power limit and one JSON line, which ``--out
PATH`` also writes to a file.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from graphcast_lite_torch import presets  # noqa: E402
from graphcast_lite_torch.graphs.build import build_graph_set  # noqa: E402
from graphcast_lite_torch.ops import cuda_segment, nvcc_build  # noqa: E402

F = 256
GRID_ROWS = 131_072  # the 512x256 grid: receivers with no G2M edge
# Text added to the balanced kernel to record each warp's timeline.
_TIMELINE_DECL = """
__device__ unsigned long long g_timeline[5 * 65536];

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
"""
_TIMELINE_EXPORT = """
extern "C" int gclt_timeline(void* dst, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      dst, g_timeline, n * 5 * sizeof(unsigned long long)));
}

extern "C" int gclt_timeline_clear() {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, g_timeline);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemset(p, 0, sizeof(g_timeline)));
}
"""
# Text added to the narrow kernel: per block, its entry, the end of its
# staging and the end of its flat outputs.
_NARROW_TIMELINE = (
    ("  __shared__ int done[2];\n",
     "  __shared__ int done[2];\n"
     "  const unsigned long long t_entry = now_ns();\n"),
    ("  // Flat outputs: the rows [i0, i1) the tile ends, then row i1's "
     "piece.\n",
     "  const unsigned long long t_walk = now_ns();\n"
     "  // Flat outputs: the rows [i0, i1) the tile ends, then row i1's "
     "piece.\n"),
    ("  if (!lead_split && !tail) return;\n",
     "  __syncthreads();\n"
     "  if (blockIdx.y == 0 && tid == 0 && blockIdx.x < 65536) {\n"
     "    unsigned long long* t = g_timeline + 5 * blockIdx.x;\n"
     "    t[0] = t_entry; t[1] = t_walk; t[2] = now_ns();\n"
     "    t[3] = 0; t[4] = 1;\n  }\n"
     "  if (!lead_split && !tail) return;\n"),
)


def _timeline_text(text: str) -> str:
    """``text`` with its balanced kernel recording, for each warp, its
    entry, the start of its first walk and its end (%globaltimer ns), and
    the cycles it waited for chunks; and its narrow kernel recording, for
    each block, its entry, the end of its staging and the end of its flat
    outputs."""
    for old, new in _NARROW_TIMELINE:
        if text.count(old) != 1:
            raise RuntimeError(f"timeline: {old!r} found {text.count(old)} "
                               "times")
        text = text.replace(old, new)
    head = "balanced_kernel(const T* __restrict__ msgs"
    a = text.index(head)
    body_end = text.index("\n}\n", a)
    kernel = text[a:body_end]
    edits = (
        (r"unsigned char smem\[\];\n",
         "unsigned char smem[];\n"
         "  const unsigned long long t_entry = now_ns();\n"
         "  unsigned long long t_walk = 0;\n"
         "  long long waited = 0;\n"),
        (r"w\.close\(j0\);",
         "if (t_walk == 0) t_walk = now_ns();\n  w.close(j0);"),
        (r"mbar_wait\(&full\[[^;]*;",
         lambda mt: ("{ const long long t_wait = clock64(); " + mt.group(0)
                     + " waited += clock64() - t_wait; }")),
    )
    for pattern, new in edits:
        kernel, n = re.subn(pattern, new, kernel)
        if n != 1:
            raise RuntimeError(f"timeline: {pattern!r} found {n} times")
    kernel += ("\n  {\n    const int k = blockIdx.x * kWarps + warp;\n"
               "    if (blockIdx.y == 0 && lane == 0 && k < 65536) {\n"
               "      unsigned long long* t = g_timeline + 5 * k;\n"
               "      t[0] = t_entry; t[1] = t_walk; t[2] = now_ns();\n"
               "      t[3] = waited; t[4] = 1;\n    }\n  }")
    ns = text.index("namespace {\n") + len("namespace {\n")
    return (text[:ns] + _TIMELINE_DECL + text[ns:a] + kernel
            + text[body_end:] + _TIMELINE_EXPORT)


# The constants that --tile-items, --warps, --stages and --chunk-bytes
# (balanced) and --narrow-bytes and --narrow-threads (narrow) edit.
_KNOBS = {"tile_items": "kTileItems", "warps": "kWarps",
          "stages": "kStages", "chunk_bytes": "kChunkBytes",
          "narrow_bytes": "kNarrowBytes", "narrow_threads": "kNarrowThreads"}


def flagship_graphs():
    cfg = presets.interaction_net_512x256()
    lat, lon = presets.wb2_512x256_grid()
    return build_graph_set(lat, lon, cfg.graph.mesh_levels,
                           cfg.graph.grid2mesh_radius_query)


def sender_cases(gs):
    """{name: sender CSR offsets} of the train step's sender scatters."""
    return {"reg_senders": gs.processing.reg_blocks.s_indptr,
            "enc_senders": gs.encoding.s_indptr,
            "dec_senders": gs.decoding.s_indptr,
            "dec_senders_f19": gs.decoding.s_indptr}


# The narrow rows of the 64x32 BASELINE layers (chip_smoke._new_shapes):
# case -> (chip_smoke's label, F); fp32, as those layers train and serve.
NARROW_64X32 = {
    "mm_softmax_f4": ("multimesh GAT softmax denominators H=4 F=4", 4),
    "mm_degrees_f1": ("multimesh denominators H=1, degrees under a mask F=1",
                      1),
    "mm_asrc_adj_f4": ("multimesh GAT a_src gather adjoint F=4", 4),
    "product_gcn_f33": ("product GCN aggregation F=33", 33),
    "product_adj_f33": ("product GCN gather adjoint F=33", 33),
}


def narrow_cases():
    """{name: (indptr, F)} of the 64x32 narrow rows."""
    _, graphs = chip_smoke._baseline_graphs()
    shapes = {label: (indptr, f) for label, _, indptr, _, _, f
              in chip_smoke._new_shapes(graphs)}
    return {name: shapes[label] for name, (label, _) in NARROW_64X32.items()}


def cases(indptr: torch.Tensor, processor: torch.Tensor):
    """{name: indptr} of the five cases (int32, on the host)."""
    ip = indptr.to(torch.int64)
    r = ip.numel() - 1
    e = int(ip[-1])
    band = ip[GRID_ROWS:] - ip[GRID_ROWS]
    nb = r - GRID_ROWS
    even = torch.full((nb,), e // nb, dtype=torch.int64)
    even[:e % nb] += 1
    spread = torch.cat([torch.zeros(GRID_ROWS + 1, dtype=torch.int64),
                        torch.cumsum(even, 0)])
    out = {"whole": ip, "band": band,
           "zero_rows": torch.zeros(GRID_ROWS + 1, dtype=torch.int64),
           "even": spread, "processor": processor.to(torch.int64)}
    return {k: v.to(torch.int32) for k, v in out.items()}


def _variant(workdir, name, text, edits) -> str:
    """``text`` with ``edits`` applied, written to ``workdir/name.cu``."""
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} found {text.count(old)} "
                               "times, not once")
        text = text.replace(old, new)
    path = os.path.join(workdir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def _print_timelines(lib, runs):
    """One launch of the timeline build per case: the spread over balanced
    warps or narrow blocks of each phase (us; percentiles 10/50/90 and
    max), from the first one's entry.  ``runs``: {case: (design, msgs,
    indptr)} on the card."""
    import numpy as np

    n = 65536
    buf = np.zeros(5 * n, dtype=np.uint64)
    lib.gclt_timeline.restype = ctypes.c_int
    lib.gclt_timeline.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gclt_timeline_clear.restype = ctypes.c_int
    mhz = torch.cuda.get_device_properties(0).clock_rate / 1e3
    for case, (design, m, ip) in runs.items():
        call = chip_smoke._segment_raw(m, ip, ip.numel() - 1, design,
                                       lib=lib)
        if lib.gclt_timeline_clear() != 0:
            raise RuntimeError("timeline: clear failed")
        call()
        call()
        torch.cuda.synchronize()
        lib.gclt_timeline(buf.ctypes.data, n)
        t = buf.reshape(n, 5).astype(np.float64)
        t = t[t[:, 2] > 0]
        t0 = t[:, 0].min()
        cols = {"entry": (t[:, 0] - t0) / 1e3,
                "to_walk": (t[:, 1] - t[:, 0]) / 1e3,
                "end": (t[:, 2] - t0) / 1e3,
                "duration": (t[:, 2] - t[:, 0]) / 1e3,
                "waiting": t[:, 3] / mhz}
        unit = "blocks" if design == "narrow" else "warps"
        print(f"  timeline {case} ({design}, {len(t)} {unit}): " + "; ".join(
            f"{k} " + "/".join(f"{np.percentile(v, q):.1f}"
                               for q in (10, 50, 90, 100))
            for k, v in cols.items()), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    for knob, name in _KNOBS.items():
        ap.add_argument("--" + knob.replace("_", "-"), default="",
                        help=f"values of {name}")
    ap.add_argument("--compare", default="",
                    help="comma-separated segment_sum.cu files to time as-is")
    ap.add_argument("--timeline", action="store_true",
                    help="print each case's timeline spread")
    ap.add_argument("--senders", action="store_true",
                    help="add the train step's sender-sorted scatters")
    ap.add_argument("--narrow", action="store_true",
                    help="add dec_senders_f19 and the 64x32 narrow rows")
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
        os.path.dirname(nvcc_build.lib_path(cuda_segment.SOURCE)),
        "segment_split")
    os.makedirs(workdir, exist_ok=True)
    for header in glob.glob(os.path.join(nvcc_build.CSRC, "*.cuh")):
        shutil.copy(header, workdir)
    with open(cuda_segment.SOURCE) as f:
        current = f.read()
    sources = {"cur": _variant(workdir, "cur", current, [])}
    for knob, name in _KNOBS.items():
        text = re.search(rf"constexpr int {name} = \d+;", current).group(0)
        for v in [int(x) for x in getattr(args, knob).split(",") if x]:
            sources[f"{knob}{v}"] = _variant(
                workdir, f"{knob}{v}", current,
                [(text, f"constexpr int {name} = {v};")])
    if args.timeline:
        sources["timeline"] = _variant(workdir, "timeline",
                                       _timeline_text(current), [])
    for path in (x for x in args.compare.split(",") if x):
        # Named by its file's stem; a stem "cut_..." is timed unchecked.
        stem = os.path.splitext(os.path.basename(path))[0]
        with open(path) as f:
            sources[stem] = _variant(workdir, stem, f.read(), [])
    t0 = time.perf_counter()
    libs = {}
    for name, path in zip(sources, nvcc_build.build(*sources.values())):
        lib = ctypes.CDLL(path)
        for fn, (restype, argtypes) in cuda_segment.SIGNATURES.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = list(argtypes)
        libs[name] = lib
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)

    t0 = time.perf_counter()
    gs = flagship_graphs()
    # case -> (indptr, F, dtype)
    table = {k: (ip, F, torch.bfloat16) for k, ip in
             cases(gs.encoding.indptr, gs.processing.indptr).items()}
    if args.senders or args.narrow:
        for k, ip in sender_cases(gs).items():
            if args.senders or k == "dec_senders_f19":
                table[k] = (ip, 19 if k.endswith("_f19") else F,
                            torch.bfloat16)
    if args.narrow:
        for k, (ip, f) in narrow_cases().items():
            table[k] = (ip, f, torch.float32)
    print(f"graphs: {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator().manual_seed(1)
    e_pad = max(int(ip[-1]) for ip, _, _ in table.values())
    msgs = {torch.bfloat16: torch.randn(e_pad, F, generator=gen).to(
        "cuda", torch.bfloat16)}
    msgs[torch.float32] = torch.randn(e_pad, 64, generator=gen).to("cuda")
    runs, rows, narrow_runs, timeline_runs = {}, {}, {}, {}
    for case, (ip, f, dtype) in table.items():
        ip = ip.to(torch.int32).cuda()
        r = ip.numel() - 1
        m = msgs[dtype][:int(ip[-1]), :f].contiguous()
        ref = cuda_segment.segment_sum_reference(m, ip, r)
        mag = cuda_segment.segment_sum_reference(m.float().abs(), ip, r)
        tol = chip_smoke.FP32_TOL if dtype == torch.float32 \
            else chip_smoke.BF16_TOL
        nbytes = chip_smoke._nbytes(m, ip) + r * f * m.element_size()
        bound_ms, _ = chip_smoke._bound(nbytes, m.numel())
        merge = cuda_segment.segment_design(dtype, f)
        timeline_runs[case] = (merge if merge != "warp" else "balanced", m,
                               ip)
        for name, lib in libs.items():
            designs = (("warp", merge) if name == "cur" else
                       ("warp",) if name.startswith("warp_") else (merge,))
            for design in designs:
                if design == "warp" and name != "cur" \
                        and not name.startswith("warp_"):
                    continue
                key = f"{name}/{design}/{case}"
                call = chip_smoke._segment_raw(m, ip, r, design, lib=lib)
                rows[key] = {"ms": [], "bound_ms": bound_ms, "R": r,
                             "E": int(ip[-1]), "F": f,
                             "dtype": str(dtype)[6:]}
                try:
                    out = call()
                    torch.cuda.synchronize()
                    rows[key]["max_abs_err"] = None if name.startswith(
                        "cut_") else chip_smoke._close(
                            key, out, ref, tol, chip_smoke.ORDER_RTOL * mag)
                except (AssertionError, RuntimeError) as exc:
                    # Reported and not timed; the script exits non-zero.
                    rows[key]["max_abs_err"] = f"FAILED: {exc}"
                    continue
                runs[key] = call
                if merge == "narrow":
                    narrow_runs[key] = call
                    rows[key]["kernel_ms"] = []
        if merge == "narrow":
            floor = chip_smoke._segment_raw(m, ip, r, "narrow", floor=True,
                                            lib=libs["cur"])
            rows[f"floor/narrow/{case}"] = {
                "kernel_ms": [chip_smoke._device_ms(floor)],
                "bound_ms": bound_ms, "R": r, "E": int(ip[-1]), "F": f,
                "dtype": str(dtype)[6:], "ms": []}
    for name, lib in libs.items():
        if name == "timeline" or name.startswith("tl_"):
            print(f"  timelines of {name}:", flush=True)
            _print_timelines(lib, timeline_runs)
    for keys in (list(runs), list(reversed(runs))):
        for key in keys:
            rows[key]["ms"].append(chip_smoke._time_ms(runs[key], iters=50,
                                                       warmup=5))
            if key in narrow_runs:
                rows[key]["kernel_ms"].append(
                    chip_smoke._device_ms(narrow_runs[key]))
    for key, row in rows.items():
        alone = row.get("kernel_ms", [])
        print(f"  {key:<36s} " + " ".join(f"{ms * 1e3:8.2f}"
                                          for ms in row["ms"])
              + (" us; alone " + " ".join(f"{ms * 1e3:7.2f}" for ms in alone)
                 if alone else "")
              + f" us  bound {row['bound_ms'] * 1e3:6.2f} us  fraction "
              + " ".join(f"{row['bound_ms'] / ms:.3f}"
                         for ms in row["ms"] + alone)
              + f"  err {row.get('max_abs_err')}", flush=True)
    part = cuda_segment.tile_partition(table["whole"][0])
    split = cuda_segment.split_rows(table["whole"][0])
    print(f"  balanced partition at the encoder shape: {part.shape[0] - 1} "
          f"tiles of {cuda_segment.TILE_ITEMS} items before snapping, "
          f"{split.numel()} split rows", flush=True)
    result = {"device": smi, "runs": rows, "split_rows": split.numel()}
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if len(runs) == sum(1 for k in rows
                                 if not k.startswith("floor/")) else 1


if __name__ == "__main__":
    sys.exit(main())
