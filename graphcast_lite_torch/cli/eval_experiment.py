"""One-command experiment evaluation: predict + report + maps + figures
(torch counterpart of ``graphcast_lite_tpu.cli.eval_experiment``: the
forecasts run through this package's ``cli.predict`` on ``--device``,
default ``cuda``; the maps and the sweep are NumPy).

~ reference ``scripts/eval_real_freeze6.py`` (one-shot eval of a trained
checkpoint with tables and plots).  Runs the AR evaluation once
(``cli.predict`` engine, predictions saved), then renders:

  <exp>/eval/report.json            full metric report (skill, horizons,
                                    per-channel physical tables)
  <exp>/eval/preds.npz              raw predictions + ground truth
  <exp>/eval/maps_ch<k>.png         per-pixel RMSE/MAE/BIAS/ACC maps
  <exp>/eval/triad_ch<k>.png        truth / prediction / error figure
  <exp>/eval/mos_idw_sweep.json     post-processing parameter sweep table

Usage:
  python -m graphcast_lite_torch.cli.eval_experiment EXP_DIR \
      [--data-dir D] [--ar-steps N] [--max-samples N] [--channels 0 1] \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("exp_dir")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--ar-steps", type=int, default=None)
    ap.add_argument("--max-samples", type=int, default=None)
    ap.add_argument("--channels", type=int, nargs="*", default=[0])
    ap.add_argument("--skip-sweep", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the forecasts (default cuda)")
    args = ap.parse_args(argv)

    from ..config import load_experiment_config
    from ..inference.maps import (
        extract_field, pixel_metrics, plot_metric_maps, plot_triad,
    )
    from . import predict as predict_cli
    from .mos_idw_sweep import run_sweep

    out_dir = os.path.join(args.exp_dir, "eval")
    os.makedirs(out_dir, exist_ok=True)
    preds_path = os.path.join(out_dir, "preds.npz")
    report_path = os.path.join(out_dir, "report.json")

    argv2 = [args.exp_dir, "--per-channel", "--device", args.device,
             "--save-preds", preds_path, "--report-json", report_path]
    if args.data_dir:
        argv2 += ["--data-dir", args.data_dir]
    if args.ar_steps:
        argv2 += ["--ar-steps", str(args.ar_steps)]
    if args.max_samples:
        argv2 += ["--max-samples", str(args.max_samples)]
    predict_cli.main(argv2)

    cfg = load_experiment_config(os.path.join(args.exp_dir, "config.json"))
    data_dir = args.data_dir or cfg.data_dir
    z = np.load(preds_path)
    c = int(z["n_features"])
    n_lat, n_lon = int(z["n_lat"]), int(z["n_lon"])
    coords = np.load(os.path.join(data_dir, "coords.npz"))
    lats, lons = coords["latitude"], coords["longitude"]
    flat = lats.size == n_lat * n_lon
    sc = np.load(os.path.join(data_dir, "scalers.npz"))

    written = [report_path, preds_path]
    if not flat:
        mets = pixel_metrics(z["predictions"], z["ground_truth"], c)
        for ch in args.channels:
            written.append(plot_metric_maps(
                mets, lats, lons, ch,
                os.path.join(out_dir, f"maps_ch{ch}.png"),
                title=f"ch{ch}",
            ))
            truth = extract_field(
                z["ground_truth"], -1, int(z["ar_steps"]) - 1, ch, c,
                n_lat, n_lon, float(sc["mean"][ch]), float(sc["std"][ch]),
            )
            pred = extract_field(
                z["predictions"], -1, int(z["ar_steps"]) - 1, ch, c,
                n_lat, n_lon, float(sc["mean"][ch]), float(sc["std"][ch]),
            )
            written.append(plot_triad(
                truth, pred, lats, lons,
                os.path.join(out_dir, f"triad_ch{ch}.png"),
                title=f"ch{ch} +{int(z['ar_steps']) * 6}h",
            ))

    if not args.skip_sweep and z["predictions"].shape[0] >= 3:
        la = np.repeat(lats, n_lon) if not flat else lats
        lo = np.tile(lons, n_lat) if not flat else lons
        rows, raw_rmse = run_sweep(
            z["predictions"], z["ground_truth"], c, la, lo,
            channel=args.channels[0],
        )
        sweep_path = os.path.join(out_dir, "mos_idw_sweep.json")
        with open(sweep_path, "w") as f:
            json.dump({"raw_rmse": raw_rmse, "rows": rows}, f, indent=1)
        written.append(sweep_path)
        best = rows[0]
        print(f"[eval] best post-processing: {best['label']} "
              f"(Δ {best['delta_vs_raw_pct']:+.2f}% RMSE)")

    for w in written:
        print(f"[eval] wrote {w}")
    return written


if __name__ == "__main__":
    main()
