"""MOS/IDW post-processing parameter sweep (a NumPy copy of
``graphcast_lite_tpu.cli.mos_idw_sweep``; no model runs).

~ reference ``scripts/mos_idw_sweep.py`` / ``mos_idw_sweep_v2.py`` (IDW
power x max-radius sweep to find optimal post-processing settings), with a
structural improvement: the reference re-runs the full GNN forecast for
every parameter cell; here the sweep runs OFFLINE over one saved
raw-predictions file (``cli.predict --save-preds``) — corrections are
applied to finished trajectories, so the model never re-runs.

Method (mirrors cli.evaluate_pipeline's MOS/IDW rungs):
  1. pick pseudo-stations (sparsity x grid, seeded);
  2. calibrate per-(station, horizon) biases of the raw model on the first
     ``--calib`` samples;
  3. for every (power, max_radius_km) cell: IDW-spread the station biases,
     correct the remaining samples, score RMSE on the target channel;
  4. print a ranked table; write JSON + markdown next to the predictions.

Usage:
  python -m graphcast_lite_torch.cli.mos_idw_sweep --preds exp/preds.npz \
      --data-dir DATA [--channel 0] [--sparsity 0.05] [--calib 4] \
      [--powers 1,2,3] [--radii 150,300,600]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def run_sweep(
    predictions: np.ndarray,     # [N, G, P·C]
    ground_truth: np.ndarray,
    n_features: int,
    node_lats: np.ndarray,       # [G]
    node_lons: np.ndarray,
    channel: int = 0,
    sparsity: float = 0.05,
    calib: int = 4,
    powers=(1.0, 2.0, 3.0),
    radii_km=(150.0, 300.0, 600.0),
    seed: int = 0,
):
    """Returns (rows sorted by rmse asc, raw_rmse).  Pure NumPy."""
    from ..postprocessing.corrections import idw_interpolate_bias

    n, g, pc = predictions.shape
    p = pc // n_features
    pr = predictions.reshape(n, g, p, n_features)[..., channel]
    gt = ground_truth.reshape(n, g, p, n_features)[..., channel]
    calib = min(calib, n - 1)

    rs = np.random.RandomState(seed)
    n_st = max(int(g * sparsity), 2)
    station_idx = rs.choice(g, size=n_st, replace=False)
    bias = (gt[:calib, station_idx] - pr[:calib, station_idx]).mean(axis=0)

    ev_pr, ev_gt = pr[calib:], gt[calib:]
    raw_rmse = float(np.sqrt(((ev_pr - ev_gt) ** 2).mean()))
    bias_map = {int(si): bias[k] for k, si in enumerate(station_idx)}

    # station-only MOS rung (no spreading) as the sweep's anchor row
    mos_pr = ev_pr.copy()
    mos_pr[:, station_idx] += bias[None]
    rows = [{
        "power": None, "radius_km": None, "label": "mos(stations only)",
        "rmse": float(np.sqrt(((mos_pr - ev_gt) ** 2).mean())),
    }]
    for power in powers:
        for radius in radii_km:
            field = idw_interpolate_bias(
                bias_map, node_lats, node_lons, p,
                power=power, max_radius_km=radius,
            )
            corr = ev_pr + field[None]
            rmse = float(np.sqrt(((corr - ev_gt) ** 2).mean()))
            rows.append({
                "power": power, "radius_km": radius,
                "label": f"idw p={power} r={radius:.0f}km",
                "rmse": rmse,
            })
    for r in rows:
        r["delta_vs_raw_pct"] = 100.0 * (1.0 - r["rmse"] / raw_rmse)
    rows.sort(key=lambda r: r["rmse"])
    return rows, raw_rmse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preds", required=True)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--channel", type=int, default=0)
    ap.add_argument("--sparsity", type=float, default=0.05)
    ap.add_argument("--calib", type=int, default=4)
    ap.add_argument("--powers", default="1,2,3")
    ap.add_argument("--radii", default="150,300,600")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    z = np.load(args.preds)
    coords = np.load(os.path.join(args.data_dir, "coords.npz"))
    lats, lons = coords["latitude"], coords["longitude"]
    if lats.ndim == 1 and lats.size * lons.size == z["predictions"].shape[1]:
        la = np.repeat(lats, lons.size)
        lo = np.tile(lons, lats.size)
    else:
        la, lo = lats, lons

    rows, raw_rmse = run_sweep(
        z["predictions"], z["ground_truth"], int(z["n_features"]),
        la, lo, channel=args.channel, sparsity=args.sparsity,
        calib=args.calib,
        powers=[float(x) for x in args.powers.split(",")],
        radii_km=[float(x) for x in args.radii.split(",")],
        seed=args.seed,
    )
    print(f"raw rmse (ch {args.channel}): {raw_rmse:.6f}")
    print(f"{'rank':>4} {'config':>22} {'rmse':>10} {'Δ vs raw':>9}")
    for i, r in enumerate(rows):
        print(f"{i + 1:>4} {r['label']:>22} {r['rmse']:>10.6f} "
              f"{r['delta_vs_raw_pct']:>8.2f}%")
    out = args.out or os.path.splitext(args.preds)[0] + "_mos_idw_sweep.json"
    with open(out, "w") as f:
        json.dump({"raw_rmse": raw_rmse, "channel": args.channel,
                   "rows": rows}, f, indent=1)
    print(f"[mos_idw_sweep] wrote {out}")
    return rows


if __name__ == "__main__":
    main()
