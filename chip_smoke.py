"""Smoke run of the PyTorch port on one NVIDIA card: ``python3 chip_smoke.py``.

1. Builds the hand-written CUDA segment-sum kernel (nvcc, sm_90a) from
   ``graphcast_lite_torch/csrc/segment_sum.cu`` and holds it against its
   plain PyTorch version on the card, in fp32 and bf16.
2. Serves the flagship forecast (``presets.interaction_net_512x256``: 19
   features, obs 2, AR 4, hidden 256, 12 InteractionNet steps, mesh [4, 6])
   in bf16 through the port's ``evaluate_model`` for 3 requests on a seeded
   synthetic 512x256 dataset with seeded random weights, and checks that
   every rollout launched the kernel exactly 8 times (2 encoder GCNConv
   aggregations x 4 AR steps), and holds one request's bf16 rollout against
   the fp32 rollout of the same weights.  Then times the kernel at the
   flagship encoder shape against its bound, its plain version and one
   PyTorch call.
3. Runs the 64x32 flagship architecture in fp32 (TF32 off) on the card and
   on the CPU (the plain versions) with the same weights and inputs through
   AR-4, and compares them.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero without the last line; so does a machine without a
card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Stated tolerance of the kernel against its plain version, per element:
#   |kernel - plain| <= atol + rtol * |plain| + ORDER_RTOL * sum_e |msgs_e|.
# Both accumulate in fp32 and differ only in the order of the additions;
# that difference grows with the sum of magnitudes, not with the result,
# which cancels in a long row (a 2,500-edge row of N(0, 1) messages sums
# to about 1 while its partial sums reach about 50).  bf16 rounds the fp32
# sum once, so the two differ by at most one bf16 ulp (2^-8 relative) more.
FP32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-5, rtol=1e-2)
ORDER_RTOL = 1e-5
# The 64x32 model on the card against the CPU, fp32 with TF32 off.
E2E_TOL = dict(atol=1e-3, rtol=1e-3)
# The flagship bf16 serve against fp32 (TF32 off), same weights and request:
# per AR step, RMS(bf16 - fp32) <= BF16_SERVE_RTOL * RMS(fp32).  bf16 keeps
# 8 significant bits (a rounding is within 2^-9 relative); the bound allows
# about 16 such roundings' worth of drift.  The CPU tests hold the same
# serve at a small size to the JAX package's own bf16 error.
BF16_SERVE_RTOL = 2.0 ** -5
# H100 SXM data-sheet rates: HBM3 bytes/s and fp32 (non-tensor) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
REQUESTS = 3
AR_STEPS = 4


def _log(*args):
    print(*args, flush=True)


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _sorted_case(gen, num_edges, num_receivers, f, dtype, batch=None,
                 recv=None):
    """Receiver-sorted messages padded to a multiple of 128 rows; padding
    rows are zero and belong to the last receiver.  Returns
    (msgs, indptr) on the card."""
    from graphcast_lite_torch.graphs.structure import indptr_from_receivers

    if recv is None:
        recv = torch.sort(torch.randint(0, num_receivers, (num_edges,),
                                        generator=gen)).values
    e = recv.numel()
    e_pad = ((e + 127) // 128) * 128
    full = torch.full((e_pad,), num_receivers - 1, dtype=torch.int64)
    full[:e] = recv
    shape = ((batch,) if batch else ()) + (e_pad, f)
    msgs = torch.randn(shape, generator=gen)
    msgs[..., e:, :] = 0.0
    indptr = indptr_from_receivers(full, num_receivers)
    return msgs.to("cuda", dtype), indptr.to("cuda")


def _check_kernel(label, msgs, indptr, num_receivers) -> float:
    """Kernel against the plain version on the same card inputs; returns
    the max abs error."""
    from graphcast_lite_torch.ops import cuda_segment

    out = cuda_segment.segment_sum(msgs, indptr, num_receivers).float()
    ref = cuda_segment.segment_sum_reference(msgs, indptr,
                                             num_receivers).float()
    mag = cuda_segment.segment_sum_reference(msgs.float().abs(), indptr,
                                             num_receivers)
    torch.cuda.synchronize()
    tol = FP32_TOL if msgs.dtype == torch.float32 else BF16_TOL
    diff = (out - ref).abs()
    allowed = tol["atol"] + tol["rtol"] * ref.abs() + ORDER_RTOL * mag
    err = diff.max().item()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{label}: non-finite kernel output")
    if (diff > allowed).any():
        worst = int(torch.argmax(diff - allowed))
        raise AssertionError(
            f"{label} {msgs.dtype}: {int((diff > allowed).sum())} elements "
            f"out of tolerance; worst |err| {diff.flatten()[worst]:.3e} > "
            f"{allowed.flatten()[worst]:.3e}")
    _log(f"  {label:<44s} {str(msgs.dtype):<15s} max|err| {err:.3e} ok")
    return err


def phase_kernel_cases():
    _log("phase 1: segment_sum kernel vs plain version on the card "
         f"(fp32 {FP32_TOL}, bf16 {BF16_TOL}, order term "
         f"{ORDER_RTOL} * sum|msgs|)")
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for f in (19, 64, 256):
            m, ip = _sorted_case(gen, 60_000, 20_000, f, dtype)
            _check_kernel(f"random sorted E=60000 R=20000 F={f}", m, ip,
                          20_000)
        m, ip = _sorted_case(gen, 30_000, 9_000, 64, dtype, batch=3)
        _check_kernel("batched [3, E, 64]", m, ip, 9_000)
        m, ip = _sorted_case(gen, 0, 50_000, 19, dtype,
                             recv=torch.sort(torch.randint(
                                 20_000, 30_000, (3_001,),
                                 generator=gen)).values)
        _check_kernel("empty receivers + padding rows, F=19", m, ip, 50_000)
        hog = torch.cat([torch.zeros(2_500, dtype=torch.int64),
                         torch.sort(torch.randint(1, 4_000, (8_000,),
                                                  generator=gen)).values])
        m, ip = _sorted_case(gen, 0, 4_000, 256, dtype, recv=hog)
        _check_kernel("receiver with 2500 edges, F=256", m, ip, 4_000)


def phase_serve(workdir):
    """The flagship bf16 AR-4 serve through the port's entry points."""
    from graphcast_lite_torch import presets
    from graphcast_lite_torch.build import build_weather_model
    from graphcast_lite_torch.data.dataset import load_chunked_datasets
    from graphcast_lite_torch.data.synthetic import generate_synthetic_dataset
    from graphcast_lite_torch.inference.predict import evaluate_model, \
        serving_copy
    from graphcast_lite_torch.ops import cuda_segment
    from graphcast_lite_torch.training.rollout import RolloutSpec, \
        rollout_predict

    _log("phase 2: flagship 512x256 AR-4 bf16 serve "
         "(presets.interaction_net_512x256, seeded random weights)")
    cfg = presets.interaction_net_512x256()
    n_feat, obs = cfg.data.num_features_used, cfg.data.obs_window_used
    t0 = time.perf_counter()
    # 36 frames: 31 windows of obs 2 + AR 4, 4 of them in the test split.
    data_dir = generate_synthetic_dataset(
        os.path.join(workdir, "data"), n_time=36, n_lon=512, n_lat=256,
        n_feat=n_feat, static_channels=list(cfg.static_channels), seed=0)
    _, _, test_ds, meta = load_chunked_datasets(
        data_dir, obs_window=obs, pred_steps=AR_STEPS, n_features=n_feat)
    if len(test_ds) < REQUESTS:
        raise AssertionError(f"test split holds {len(test_ds)} samples")
    _log(f"  synthetic dataset: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    model, graphs, gs = build_weather_model(cfg, meta, device="cuda",
                                            seed=0)
    torch.cuda.synchronize()
    enc = gs.encoding
    _log(f"  graphs + model: {time.perf_counter() - t0:.1f} s; "
         f"G2M E={enc.num_edges} E_pad={enc.padded_num_edges} "
         f"R={enc.num_receivers} max in-degree "
         f"{int(enc.static_in_degree.max())}; "
         f"params {sum(p.numel() for p in model.parameters())}")
    kw = dict(ar_steps=AR_STEPS, use_residual=cfg.use_residual,
              static_channels=tuple(cfg.static_channels), device="cuda",
              dtype="bf16")

    # Warm-up request (cuBLAS handles, the kernel library), not counted.
    evaluate_model(model, graphs, test_ds, meta, max_samples=1, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    preds_path = os.path.join(workdir, "preds.npz")
    cuda_segment.launches = 0
    report = evaluate_model(model, graphs, test_ds, meta,
                            max_samples=REQUESTS,
                            save_predictions=preds_path, **kw)
    torch.cuda.synchronize()
    launches = cuda_segment.launches
    peak = torch.cuda.max_memory_allocated()
    # The same requests again, timed without the compressed .npz write.
    t0 = time.perf_counter()
    evaluate_model(model, graphs, test_ds, meta, max_samples=REQUESTS, **kw)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0

    g = gs.num_grid_nodes
    preds = np.load(preds_path)["predictions"]
    if preds.shape != (REQUESTS, g, AR_STEPS * n_feat):
        raise AssertionError(f"predictions shape {preds.shape}")
    if not np.isfinite(preds).all():
        raise AssertionError("non-finite predictions")
    if report.num_samples != REQUESTS or not np.isfinite(report.rmse):
        raise AssertionError(f"report {report.num_samples} {report.rmse}")
    if launches != 8 * REQUESTS:
        raise AssertionError(f"segment_sum launched {launches} times for "
                             f"{REQUESTS} rollouts (expected 8 each)")
    _log(f"  {REQUESTS} requests: predictions {preds.shape} finite; "
         f"RMSE {report.rmse:.6f}, persistence {report.baseline_rmse:.6f}, "
         f"skill {report.skill * 100:.2f}% (random weights)")
    _log(f"  segment_sum launches: {launches} "
         f"({launches // REQUESTS} per rollout)")
    _log(f"  evaluate_model wall time per request (host clock, incl. data "
         f"loading and metrics): {wall_s / REQUESTS * 1e3:.1f} ms")

    # Device time of one AR-4 rollout (CUDA events, after a warm-up).
    smodel, sgraphs = serving_copy(model, graphs, torch.device("cuda"),
                                   torch.bfloat16)
    spec = RolloutSpec(obs_window=obs, num_features=n_feat,
                       use_residual=cfg.use_residual, remat=False,
                       static_channels=tuple(cfg.static_channels))
    x, y = test_ds.get(0)
    window = torch.from_numpy(x.reshape(g, obs, n_feat)).to("cuda",
                                                              torch.bfloat16)
    forcing = torch.from_numpy(y.reshape(g, AR_STEPS, n_feat)).to(
        "cuda", torch.bfloat16)

    def model_fn(inp, m, t, p):
        return smodel(inp, sgraphs)[0], None

    def rollout():
        with torch.inference_mode():
            return rollout_predict(model_fn, window, AR_STEPS, spec,
                                   forcing=forcing)

    rollout_ms = _time_ms(rollout, iters=5, warmup=1)
    stages = _stage_ms(smodel, rollout)
    busy_ms, wall_ms, top = _profile(rollout)
    bf16_rel_rms = _bf16_against_fp32(model, graphs, spec, x, y, rollout)
    serve = {
        "rollout_ms": rollout_ms,
        "grid_points_per_s": g * AR_STEPS / (rollout_ms / 1e3),
        "peak_mem_bytes": peak,
        "wall_ms_per_request": wall_s / REQUESTS * 1e3,
        "launches": launches,
        "stage_ms": stages,
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "bf16_vs_fp32_rel_rms": bf16_rel_rms,
    }
    _log(f"  AR-4 rollout (CUDA events, mean of 5): {rollout_ms:.2f} ms; "
         f"{serve['grid_points_per_s']:.4g} grid-points/s "
         f"({g} points x {AR_STEPS} steps); peak allocated "
         f"{peak / 2**30:.3f} GiB")
    _log("  one rollout by stage (CUDA events around the model's encoder, "
         "processor and decoder; rest = rollout loop): "
         + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items()))
    _log(f"  torch.profiler, one rollout: device busy {busy_ms:.2f} ms of "
         f"{wall_ms:.2f} ms wall (idle share "
         f"{serve['device_idle_share']:.3f}); top kernels by device time:")
    for name, n, ms in top:
        _log(f"    {ms:9.3f} ms  {n:5d} calls  {name[:90]}")
    return gs, serve


def _bf16_against_fp32(model, graphs, spec, x, y, rollout_bf16):
    """Relative RMS distance, per AR step, of the bf16 serve's rollout from
    the fp32 rollout of the same weights on the same request."""
    from graphcast_lite_torch.inference.predict import serving_copy
    from graphcast_lite_torch.training.rollout import rollout_predict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m32, g32 = serving_copy(model, graphs, torch.device("cuda"),
                            torch.float32)
    g, obs, c = x.shape[0], spec.obs_window, spec.num_features
    window = torch.from_numpy(x.reshape(g, obs, c)).to("cuda", torch.float32)
    forcing = torch.from_numpy(y.reshape(g, AR_STEPS, c)).to(
        "cuda", torch.float32)

    def model_fn(inp, m, t, p):
        return m32(inp, g32)[0], None

    with torch.inference_mode():
        p32 = rollout_predict(model_fn, window, AR_STEPS, spec,
                              forcing=forcing)
    p16 = rollout_bf16().float()
    rel = [(torch.linalg.vector_norm(p16[:, s] - p32[:, s])
            / torch.linalg.vector_norm(p32[:, s])).item()
           for s in range(AR_STEPS)]
    _log("  bf16 against fp32 (TF32 off), same weights and request, "
         "RMS(bf16 - fp32) / RMS(fp32) per AR step: "
         + ", ".join(f"{r:.4e}" for r in rel)
         + f" (tolerance {BF16_SERVE_RTOL:.4e})")
    if not all(np.isfinite(rel)) or max(rel) > BF16_SERVE_RTOL:
        raise AssertionError(f"bf16 serve off its fp32 rollout: {rel}")
    return rel


def _stage_ms(model, run):
    """Device ms of the encoder, processor and decoder over one run, from
    CUDA events recorded by forward hooks; ``rest`` is the remainder."""
    events = {name: [] for name in ("encoder", "processor", "decoder")}
    handles = []
    for name, evs in events.items():
        mod = getattr(model, name)

        def pre(_m, _args, evs=evs):
            evs.append([torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True)])
            evs[-1][0].record()

        def post(_m, _args, _out, evs=evs):
            evs[-1][1].record()

        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    out = {name: sum(a.elapsed_time(b) for a, b in evs)
           for name, evs in events.items()}
    out["rest"] = start.elapsed_time(end) - sum(out.values())
    return out


def _profile(run, top_n=12):
    """(device busy ms, wall ms, [(kernel, calls, device ms)]) of one run
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    top = [(e.key, e.count, e.self_device_time_total / 1e3)
           for e in kernels[:top_n]]
    return busy_ms, wall_ms, top


def phase_kernel_flagship(gs):
    """The kernel at the flagship encoder shape (bf16, F 256): checked
    against the plain version, timed against its bound and one PyTorch
    call."""
    from graphcast_lite_torch.ops import cuda_segment

    enc = gs.encoding.to("cuda")
    r, e_pad, f = enc.num_receivers, enc.padded_num_edges, 256
    gen = torch.Generator().manual_seed(1)
    msgs = (torch.randn(e_pad, f, generator=gen)
            * enc.edge_mask.cpu()[:, None]).to("cuda", torch.bfloat16)
    indptr = enc.indptr
    err = _check_kernel(f"flagship G2M E_pad={e_pad} R={r} F={f}", msgs,
                        indptr, r)

    ms = _time_ms(lambda: cuda_segment.segment_sum(msgs, indptr, r))
    plain_ms = _time_ms(
        lambda: cuda_segment.segment_sum_reference(msgs, indptr, r))
    # The yardstick: one PyTorch call computing the same function.
    lengths = (indptr[1:] - indptr[:-1]).long()
    library_call = "torch.segment_reduce(msgs, 'sum', lengths)"
    library_ms = _time_ms(lambda: torch.segment_reduce(
        msgs, "sum", lengths=lengths, axis=0))

    nbytes = (msgs.numel() * msgs.element_size() + indptr.numel() * 4
              + r * f * msgs.element_size())
    flops = enc.num_edges * f
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    _log(f"  kernel {ms * 1e3:.1f} us | bound {max(bytes_ms, ops_ms) * 1e3:.1f}"
         f" us ({nbytes / 1e6:.1f} MB at 3.35 TB/s) | plain "
         f"{plain_ms * 1e3:.1f} us | {library_call} {library_ms * 1e3:.1f} us")
    return {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms, "library_call": library_call,
    }


def phase_numerics():
    """The 64x32 flagship architecture, fp32: card against CPU."""
    import copy

    from graphcast_lite_torch import presets
    from graphcast_lite_torch.graphs.build import build_graph_set
    from graphcast_lite_torch.models.weather import ModelGraphs, WeatherModel
    from graphcast_lite_torch.training.rollout import RolloutSpec, \
        rollout_predict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log("phase 3: 64x32 flagship architecture, fp32, card vs CPU, AR-4 "
         f"(matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
         f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, {E2E_TOL})")
    cfg = presets.interaction_net_64x32()
    lat, lon = presets.wb2_64x32_grid()
    gs = build_graph_set(lat, lon, cfg.graph.mesh_levels,
                         cfg.graph.grid2mesh_radius_query)
    c, obs = cfg.data.num_features_used, cfg.data.obs_window_used
    g = gs.num_grid_nodes
    model = WeatherModel(cfg.pipeline, cfg.data, g, gs.num_mesh_nodes,
                         generator=torch.Generator().manual_seed(0)).eval()
    graphs = ModelGraphs.from_graph_set(gs)
    rng = np.random.RandomState(0)
    window = torch.from_numpy(rng.randn(g, obs, c).astype(np.float32))
    spec = RolloutSpec(obs_window=obs, num_features=c, remat=False)

    def run(device):
        m = copy.deepcopy(model).to(device)
        gr = graphs.to(device)

        def model_fn(inp, mask, t, p):
            return m(inp, gr)[0], None

        with torch.inference_mode():
            out = rollout_predict(model_fn, window.to(device), AR_STEPS, spec)
        return out.cpu()

    card = run("cuda")
    cpu = run("cpu")
    if card.shape != (g, AR_STEPS, c) or not torch.isfinite(card).all():
        raise AssertionError(f"card output {tuple(card.shape)} not finite")
    err = (card - cpu).abs().max().item()
    torch.testing.assert_close(card, cpu, **E2E_TOL)
    _log(f"  output {tuple(card.shape)}; max|card - cpu| {err:.3e} ok")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from graphcast_lite_torch.ops import cuda_segment

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    _log(smi)
    _log(f"python {sys.version.split()[0]} | torch {torch.__version__} | "
         f"cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = cuda_segment.build()
    _log(f"kernel build: {time.perf_counter() - t0:.1f} s -> "
         f"{os.path.relpath(lib)}")

    phase_kernel_cases()
    with tempfile.TemporaryDirectory() as workdir:
        gs, serve = phase_serve(workdir)
    kernel = phase_kernel_flagship(gs)
    phase_numerics()

    _log(json.dumps({"serve": serve}))
    _log(json.dumps({"kernels": [{
        "name": "segment_sum",
        "route": "cuda",
        "source": "graphcast_lite_torch/csrc/segment_sum.cu",
        "replaces": "graphcast_lite_tpu/ops/pallas_segment.py:372",
        "launches": serve["launches"],
        "launches_per_rollout": serve["launches"] // REQUESTS,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"],
        "library_ms": kernel["library_ms"],
        "library_call": kernel["library_call"],
    }]}))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
