"""Comparison figures from saved prediction files (a NumPy copy of
``graphcast_lite_tpu.cli.plot_compare``; no model runs).

~ reference ``scripts/plot_compare_algos.py`` / ``plot_diff.py`` /
``plot_triad.py``: load one or more ``--save-preds`` .npz files produced by
``cli.predict`` (or ``cli.evaluate_pipeline``), denormalize one
(variable, horizon, sample) slice with the dataset scalers, and emit

  compare_<tag>.png   truth + one panel per algorithm + error row
  diff_<tag>.png      truth / first / second / (second − first)
  triad_<tag>.png     truth / first prediction / error

Usage:
  python -m graphcast_lite_torch.cli.plot_compare --data-dir DATA \
      --preds base=exp/preds.npz --preds oi=exp/preds_oi.npz \
      --out-dir figs [--var-idx 0] [--step-idx -1] [--sample-idx -1]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", required=True,
                    help="dataset dir (scalers.npz + coords.npz)")
    ap.add_argument("--preds", action="append", required=True,
                    metavar="NAME=PATH", help="named predictions .npz")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--var-idx", type=int, default=0)
    ap.add_argument("--step-idx", type=int, default=-1)
    ap.add_argument("--sample-idx", type=int, default=-1)
    ap.add_argument("--tag", default=None)
    args = ap.parse_args(argv)

    from ..inference.maps import (
        extract_field, plot_compare_algos, plot_diff, plot_final_trio,
        plot_triad,
    )

    os.makedirs(args.out_dir, exist_ok=True)
    sc = np.load(os.path.join(args.data_dir, "scalers.npz"))
    mean = float(sc["mean"][args.var_idx])
    std = float(sc["std"][args.var_idx])

    loaded = {}
    meta = None
    for spec in args.preds:
        name, path = spec.split("=", 1)
        z = np.load(path)
        loaded[name] = z
        meta = z
    c = int(meta["n_features"])
    n_lat, n_lon = int(meta["n_lat"]), int(meta["n_lon"])
    coords = np.load(os.path.join(args.data_dir, "coords.npz"))
    lats, lons = coords["latitude"], coords["longitude"]
    if lats.size != n_lat:   # flat coords on a regular grid
        lats = np.unique(lats)
        lons = np.unique(lons)

    p = int(meta["ar_steps"])
    step = args.step_idx % p
    first = next(iter(loaded.values()))
    sample = args.sample_idx % first["predictions"].shape[0]

    def fld(arr):
        return extract_field(arr, sample, step, args.var_idx, c,
                             n_lat, n_lon, mean, std)

    truth = fld(first["ground_truth"])
    fields = {name: fld(z["predictions"]) for name, z in loaded.items()}
    tag = args.tag or f"v{args.var_idx}_s{step}"
    title = f"var{args.var_idx} +{(step + 1) * 6}h"

    paths = [plot_compare_algos(
        truth, fields, lats, lons,
        os.path.join(args.out_dir, f"compare_{tag}.png"), title,
    )]
    names = list(fields)
    paths.append(plot_triad(
        truth, fields[names[0]], lats, lons,
        os.path.join(args.out_dir, f"triad_{tag}.png"), title,
    ))
    if len(names) >= 2:
        paths.append(plot_diff(
            truth, fields[names[0]], fields[names[1]], lats, lons,
            os.path.join(args.out_dir, f"diff_{tag}.png"),
            labels=(names[0], names[1]), title=title,
        ))
        # Final-shot figure (~ reference plot_final_trio.py): truth vs
        # first (control) vs last (best) prediction on one shared scale.
        paths.append(plot_final_trio(
            truth, fields[names[0]], fields[names[-1]], lats, lons,
            os.path.join(args.out_dir, f"final_trio_{tag}.png"),
            labels=(names[0], names[-1]), title=title,
        ))
    for pth in paths:
        print(f"[plot_compare] wrote {pth}")
    return paths


if __name__ == "__main__":
    main()
