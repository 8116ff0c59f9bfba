"""Build the learned-MOS t2m bias model from station history.

A copy of ``graphcast_lite_tpu.cli.build_learned_mos`` with this
package's imports.  It runs on a host with scikit-learn and joblib; the
bundle it writes is what ``postprocessing.corrections.load_learned_mos``
reads.

~ reference ``scripts/build_learned_mos.py``: the reference downloads ERA5
hourly series (Open-Meteo Archive) + NOAA ISD-Lite station observations,
then fits a HistGradientBoostingRegressor on a 20-feature frame.  Here the
acquisition is an INJECTED input file — ``--history`` points at an .npz
with per-station arrays (the format any networked fetcher, or
``data.synthetic.generate_station_history``, can produce) — and the
feature/split/fit/eval/bundle pipeline is ``postprocessing.mos_training``
(fully offline-tested).

History .npz layout (one suffix per station id S):
  times_S   [T] unix seconds (UTC)
  era5_S    [T, K] columns named by era5_columns (below)
  obs_S     [T] station t2m (°C), NaN = missing
  meta_S    [3] lat, lon, elev
  era5_columns  [K] column names (shared), e.g. temperature_2m, ...
  stations  [S] station id strings

Usage:
  python -m graphcast_lite_torch.cli.build_learned_mos \
      --history stations.npz --output learned_mos_t2m.joblib
"""

from __future__ import annotations

import argparse
import datetime as _dt

import numpy as np

from ..postprocessing.mos_training import StationHistory, train_learned_mos


def load_station_histories(path: str):
    data = np.load(path, allow_pickle=False)
    columns = [str(c) for c in data["era5_columns"]]
    out = []
    for sid in (str(s) for s in data["stations"]):
        times = [
            _dt.datetime.fromtimestamp(float(t), _dt.timezone.utc)
            .replace(tzinfo=None)
            for t in data[f"times_{sid}"]
        ]
        era5 = {
            name: data[f"era5_{sid}"][:, k]
            for k, name in enumerate(columns)
        }
        lat, lon, elev = (float(v) for v in data[f"meta_{sid}"])
        out.append(StationHistory(
            times=times, era5=era5,
            station_t2m_c=data[f"obs_{sid}"],
            lat=lat, lon=lon, elev=elev, station_id=sid,
        ))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--history", required=True,
                    help="station-history .npz (see module docstring)")
    ap.add_argument("--output", default="learned_mos_t2m.joblib")
    ap.add_argument("--val-frac", type=float, default=0.15)
    ap.add_argument("--test-frac", type=float, default=0.15)
    ap.add_argument("--max-iter", type=int, default=500)
    args = ap.parse_args(argv)

    stations = load_station_histories(args.history)
    bundle = train_learned_mos(
        stations, output_path=args.output,
        val_frac=args.val_frac, test_frac=args.test_frac,
        max_iter=args.max_iter,
    )
    print(f"[build_learned_mos] {len(stations)} stations, "
          f"{bundle['n_train']} train / {bundle['n_test']} test samples")
    print(f"  raw forecast MAE : {bundle['era5_mae']:.3f} °C")
    print(f"  static MOS MAE   : {bundle['static_mos_mae']:.3f} °C")
    print(f"  learned MOS MAE  : {bundle['test_mae']:.3f} °C "
          f"(RMSE {bundle['test_rmse']:.3f})")
    print(f"[saved] {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
