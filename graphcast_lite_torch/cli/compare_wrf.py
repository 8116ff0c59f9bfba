"""GraphCast-lite vs WRF vs ERA5 comparison on a WRF domain (a NumPy
copy of ``graphcast_lite_tpu.cli.compare_wrf``; netCDF4 is imported only
by ``load_wrf``).

~ reference ``scripts/compare_wrf.py:1-689``: load a predictions bundle,
denormalize to physical units, restrict to the WRF d03 domain, domain-average
the mapped surface variables (t2m/10u/10v/sp), load the WRF run's domain
means (JSON export or netCDF), and render the per-horizon and summary
comparison tables.

Offline changes: predictions come from this package's ``.npz`` bundle
(``cli.predict --save-preds``, ``inference.predict.evaluate_model(
save_predictions=)``: ``predictions``, ``ground_truth``, ``n_features``), the
comparison core is pure NumPy over injected arrays (offline-tested with
fixture WRF/ERA5 fields — the reference's script needs live WRF output), and
netCDF readers are optional (the JSON export path has no dependencies).

Usage:
    python -m graphcast_lite_torch.cli.compare_wrf \
        --predictions exp/predictions.npz --data-dir data/region \
        --wrf-path wrf_d03_jan2023.json [--wrf-sample N]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "VAR_MAPPING",
    "load_wrf_json",
    "load_wrf",
    "domain_mask",
    "domain_means",
    "compute_metrics",
    "build_comparison",
    "render_tables",
]

# WRF d03 domain of the reference's study (Krasnoyarsk).
WRF_LAT_MIN, WRF_LAT_MAX = 55.5, 56.5
WRF_LON_MIN, WRF_LON_MAX = 92.0, 94.0

# our var name -> WRF field / unit handling (reference VAR_MAPPING).
# ``sp`` is stored in hPa in our datasets; WRF PSFC is Pa.
VAR_MAPPING = {
    "t2m": {"wrf_name": "T2", "unit": "K", "wrf_to_ours": 1.0},
    "10u": {"wrf_name": "U10", "unit": "m/s", "wrf_to_ours": 1.0},
    "10v": {"wrf_name": "V10", "unit": "m/s", "wrf_to_ours": 1.0},
    "sp": {"wrf_name": "PSFC", "unit": "hPa", "wrf_to_ours": 0.01},
}

_JSON_KEY_MAP = {
    "t2_K": "t2m",
    "u10_ms": "10u",
    "v10_ms": "10v",
    "psfc_Pa": "sp",
}


def _hourly_to_6h(hourly: np.ndarray) -> np.ndarray:
    """WRF hourly series -> [init, +6h, +12h, +18h, +24h] steps (reference
    compare_wrf.py:233-241 index policy)."""
    n = len(hourly)
    if n >= 25:
        idx = [0, 6, 12, 18, 24]
    else:
        idx = list(range(min(5, n)))
    return hourly[idx]


def load_wrf_json(wrf_path: str) -> Dict[str, np.ndarray]:
    """WRF JSON export (``domain_mean`` hourly series) -> 6h domain means in
    OUR units.  Dependency-free; the offline-testable path."""
    with open(wrf_path) as f:
        raw = json.load(f)
    dm = raw.get("domain_mean", {})
    out = {}
    for key, our in _JSON_KEY_MAP.items():
        if key not in dm:
            continue
        series = _hourly_to_6h(np.asarray(dm[key], np.float32))
        out[our] = series * VAR_MAPPING[our]["wrf_to_ours"]
    return out


def load_wrf(wrf_path: str, open_netcdf=None) -> Optional[Dict[str, np.ndarray]]:
    """Dispatch WRF loading: JSON export (no deps) or netCDF via an
    injectable ``open_netcdf(path) -> {var: [T, ...] array}`` (netCDF4 /
    xarray are not in the base environment; tests inject a fixture
    reader)."""
    if str(wrf_path).endswith(".json"):
        return load_wrf_json(wrf_path)
    if open_netcdf is None:
        try:  # pragma: no cover - optional dependency
            from netCDF4 import Dataset as NC4

            def open_netcdf(p):
                ds = NC4(p, "r")
                return {k: np.asarray(ds.variables[k][:], np.float32)
                        for k in ds.variables}
        except ImportError:
            print("WARNING: netCDF reader unavailable and not a .json "
                  "export; skipping WRF")
            return None
    fields = open_netcdf(wrf_path)
    out = {}
    for our, info in VAR_MAPPING.items():
        if info["wrf_name"] not in fields:
            continue
        arr = fields[info["wrf_name"]]
        mean = arr.reshape(arr.shape[0], -1).mean(axis=1)
        out[our] = _hourly_to_6h(mean) * info["wrf_to_ours"]
    return out


def domain_mask(node_lats: np.ndarray, node_lons: np.ndarray,
                bounds=(WRF_LAT_MIN, WRF_LAT_MAX, WRF_LON_MIN, WRF_LON_MAX)
                ) -> np.ndarray:
    lat0, lat1, lon0, lon1 = bounds
    return ((node_lats >= lat0) & (node_lats <= lat1)
            & (node_lons >= lon0) & (node_lons <= lon1))


def domain_means(pred: np.ndarray, truth: np.ndarray, mask: np.ndarray,
                 mean: np.ndarray, std: np.ndarray, n_feat: int):
    """Denormalize and domain-average predictions/truth.

    pred/truth: [n_samples, G, P*C] normalized; returns two
    [n_samples, P, C] arrays of physical-unit domain means."""
    n, g = pred.shape[:2]
    c = n_feat
    p_steps = pred.shape[-1] // c

    def conv(a):
        a = a.reshape(n, g, p_steps, c)[:, mask]
        a = a * std[:c] + mean[:c]
        return a.mean(axis=1)  # [n, P, C]

    return conv(pred), conv(truth)


def compute_metrics(pred: np.ndarray, truth: np.ndarray):
    diff = pred - truth
    return (float(np.sqrt(np.mean(diff ** 2))),
            float(np.mean(np.abs(diff))), float(np.mean(diff)))


def build_comparison(
    pred_mean: np.ndarray,          # [n_samples, P, C] physical units
    truth_mean: np.ndarray,         # [n_samples, P, C]
    var_names: List[str],
    wrf_data: Optional[Dict[str, np.ndarray]],
    wrf_sample: Optional[int],
    horizon_hours: int = 6,
) -> dict:
    """The full metric surface of reference compare_wrf.py:388-583 as a
    structured dict: our all-sample metrics per var/horizon, and (when WRF
    data + a matching sample exist) the per-horizon three-way table with
    per-model errors, winners and averages."""
    n_samples, p_steps, _ = pred_mean.shape
    compare_vars = [v for v in VAR_MAPPING if v in var_names]
    result = {"n_samples": n_samples, "ar_steps": p_steps,
              "wrf_sample": wrf_sample, "ours": {}, "wrf": {}}

    for var in compare_vars:
        vi = var_names.index(var)
        rmse, mae, bias = compute_metrics(
            pred_mean[:, :, vi].ravel(), truth_mean[:, :, vi].ravel())
        hor = []
        for h in range(min(p_steps, 4)):
            r, m, b = compute_metrics(pred_mean[:, h, vi],
                                      truth_mean[:, h, vi])
            hor.append({"horizon_h": (h + 1) * horizon_hours, "rmse": r,
                        "mae": m, "bias": b})
        result["ours"][var] = {
            "unit": VAR_MAPPING[var]["unit"], "rmse": rmse, "mae": mae,
            "bias": bias, "per_horizon": hor,
        }

    if wrf_data and wrf_sample is not None and wrf_sample < n_samples:
        for var in compare_vars:
            if var not in wrf_data:
                continue
            vi = var_names.index(var)
            wrf_vals = wrf_data[var]
            rows = []
            our_errs, wrf_errs = [], []
            n_h = min(p_steps, len(wrf_vals) - 1)  # skip the WRF init step
            for h in range(n_h):
                era5 = float(truth_mean[wrf_sample, h, vi])
                ours = float(pred_mean[wrf_sample, h, vi])
                wrf = float(wrf_vals[h + 1])
                oe, we = abs(ours - era5), abs(wrf - era5)
                our_errs.append(oe)
                wrf_errs.append(we)
                rows.append({
                    "horizon_h": (h + 1) * horizon_hours, "era5": era5,
                    "ours": ours, "wrf": wrf, "our_err": oe, "wrf_err": we,
                    "winner": "ours" if oe < we else
                              ("wrf" if we < oe else "tie"),
                })
            our_rmse = float(np.sqrt(np.mean(np.square(our_errs))))
            wrf_rmse = float(np.sqrt(np.mean(np.square(wrf_errs))))
            result["wrf"][var] = {
                "unit": VAR_MAPPING[var]["unit"], "rows": rows,
                "our_rmse": our_rmse, "wrf_rmse": wrf_rmse,
                "winner": "ours" if our_rmse < wrf_rmse else "wrf",
            }
    return result


def render_tables(result: dict) -> str:
    """Human-readable tables (the reference's thesis-table output)."""
    lines = ["=" * 70, "OUR MODEL metrics (domain-averaged, physical units)",
             "=" * 70]
    for var, m in result["ours"].items():
        lines.append(f"  {var:<5}: RMSE={m['rmse']:.3f} {m['unit']} | "
                     f"MAE={m['mae']:.3f} | bias={m['bias']:+.3f}")
        for h in m["per_horizon"]:
            lines.append(f"    +{h['horizon_h']:02d}h: RMSE={h['rmse']:.3f} |"
                         f" MAE={h['mae']:.3f} | bias={h['bias']:+.3f}")
    if result["wrf"]:
        lines += ["", "=" * 70,
                  f"WRF vs ERA5 vs Ours (sample #{result['wrf_sample']})",
                  "=" * 70]
        for var, t in result["wrf"].items():
            lines.append(f"\n  {var} ({t['unit']}):")
            lines.append("    Horizon |  ERA5  |  Ours  |  WRF   | our err"
                         " | wrf err")
            for r in t["rows"]:
                mark = {"ours": "<- us", "wrf": "<- WRF",
                        "tie": "  tie"}[r["winner"]]
                lines.append(
                    f"    +{r['horizon_h']:02d}h    |{r['era5']:7.2f} |"
                    f"{r['ours']:7.2f} |{r['wrf']:7.2f} |"
                    f" {r['our_err']:6.2f} | {r['wrf_err']:6.2f}  {mark}")
            lines.append(
                f"    AVG RMSE: ours {t['our_rmse']:.3f} vs WRF "
                f"{t['wrf_rmse']:.3f}  <- {t['winner']}")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--predictions", required=True,
                        help="predictions .npz bundle (cli.predict "
                             "--save-preds)")
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--wrf-path", default=None)
    parser.add_argument("--wrf-sample", type=int, default=None)
    parser.add_argument("--report-json", default=None)
    parser.add_argument("--bounds", type=float, nargs=4,
                        default=[WRF_LAT_MIN, WRF_LAT_MAX,
                                 WRF_LON_MIN, WRF_LON_MAX],
                        metavar=("LAT0", "LAT1", "LON0", "LON1"))
    args = parser.parse_args(argv)

    bundle = np.load(args.predictions)
    pred = bundle["predictions"]
    truth = bundle["ground_truth"]
    c = int(bundle["n_features"])

    scalers = np.load(os.path.join(args.data_dir, "scalers.npz"))
    coords = np.load(os.path.join(args.data_dir, "coords.npz"))
    lats = coords["latitude"].astype(np.float32)
    lons = coords["longitude"].astype(np.float32)
    if lats.ndim == 1 and lats.size * lons.size == pred.shape[1]:
        lon2d, lat2d = np.meshgrid(lons, lats)  # lat-major node order
        node_lats, node_lons = lat2d.ravel(), lon2d.ravel()
    else:
        node_lats, node_lons = lats, lons

    info_path = os.path.join(args.data_dir, "dataset_info.json")
    var_names = [f"f{i}" for i in range(c)]
    if os.path.exists(info_path):
        with open(info_path) as f:
            info = json.load(f)
        var_names = info.get("variables", info.get("var_names", var_names))

    mask = domain_mask(node_lats, node_lons, tuple(args.bounds))
    if not mask.any():
        raise SystemExit("no grid nodes inside the WRF domain bounds")
    pred_mean, truth_mean = domain_means(
        pred, truth, mask, scalers["mean"].astype(np.float32),
        scalers["std"].astype(np.float32), c)

    wrf_data = load_wrf(args.wrf_path) if args.wrf_path else None
    result = build_comparison(pred_mean, truth_mean, list(var_names),
                              wrf_data, args.wrf_sample)
    print(render_tables(result))
    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump(result, f, indent=1)
        print(f"\nreport -> {args.report_json}")


if __name__ == "__main__":
    main()
