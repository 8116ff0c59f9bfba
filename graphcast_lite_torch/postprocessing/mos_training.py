"""Learned-MOS training: fit the station bias regressor the apply path
consumes (a NumPy copy of ``graphcast_lite_tpu.postprocessing.
mos_training``; sklearn and joblib are imported only inside
``train_learned_mos``).

~ reference ``scripts/build_learned_mos.py``: downloads ERA5 hourly series
(Open-Meteo) + station observations (NOAA ISD-Lite), builds a 20-feature
frame per (station, hour), and fits a HistGradientBoostingRegressor
predicting ``bias = station_t2m - era5_t2m`` with a chronological
train/val/test split; the bundle is joblib-dumped with metadata
(``:357-465``).

Architecture: the DOWNLOAD is injected — ``train_learned_mos``
consumes plain ``StationHistory`` records (any acquisition path or a test
fixture fills them), while the feature construction, chronological split,
model fit, baseline comparisons (raw / static month×hour MOS) and bundle
schema are real, tested code.  The produced bundle round-trips through
this package's ``corrections.load_learned_mos`` +
``apply_learned_mos_t2m`` (the reference-format apply path).

Feature order matches ``corrections.build_mos_features`` /
the reference FEATURE_COLUMNS contract (build_learned_mos.py:245-266).
"""

from __future__ import annotations

import dataclasses
from datetime import datetime
from typing import Dict, List, Optional, Sequence

import numpy as np

from .corrections import solar_elevation

__all__ = [
    "FEATURE_COLUMNS",
    "StationHistory",
    "build_feature_matrix",
    "train_learned_mos",
]

# The reference's exact 20-column contract (build_learned_mos.py:245-266);
# corrections.build_mos_features emits the same order at apply time.
FEATURE_COLUMNS = [
    "era5_temperature_2m",
    "era5_dewpoint_2m",
    "era5_windspeed_10m",
    "wind_dir_sin",
    "wind_dir_cos",
    "era5_surface_pressure",
    "era5_cloudcover",
    "era5_shortwave_radiation",
    "era5_precipitation",
    "hour_sin",
    "hour_cos",
    "doy_sin",
    "doy_cos",
    "solar_elevation",
    "dewpoint_depression",
    "era5_t2m_lag6h",
    "delta_t2m_6h",
    "station_lat",
    "station_lon",
    "station_elev",
]


@dataclasses.dataclass
class StationHistory:
    """Aligned hourly history for one station (the injected data source).

    ``era5``: {column_name: [T]} for any subset of the non-derived ERA5
    columns — missing columns become NaN (HistGBR is NaN-tolerant, like the
    apply path's unavailable-input handling).  Expected names:
    temperature_2m (°C), dewpoint_2m (°C), windspeed_10m (m/s),
    winddirection_10m (deg, meteorological), surface_pressure (hPa),
    cloudcover (%), shortwave_radiation (W/m²), precipitation (mm —
    Open-Meteo's unit; converted to METERS at feature-build time so the
    trained model matches the apply path, which feeds raw ERA5/WB2 ``tp``
    in meters.  NOTE: the reference trains on mm and applies meters — a
    silent 1000x feature mismatch its own pipeline carries,
    build_learned_mos.py vs src/postprocessing/mos_correction.py:132 — we
    fix it on the training side).
    ``station_t2m_c``: observed 2-m temperature (°C); NaN = missing ob.
    """

    times: Sequence[datetime]
    era5: Dict[str, np.ndarray]
    station_t2m_c: np.ndarray
    lat: float
    lon: float
    elev: float
    station_id: str = ""


def build_feature_matrix(h: StationHistory) -> np.ndarray:
    """[T, 20] feature matrix in FEATURE_COLUMNS order (vectorized; the
    reference builds the same columns through pandas,
    build_learned_mos.py:210-242)."""
    t = len(h.times)
    nan = np.full(t, np.nan)

    def col(name):
        v = h.era5.get(name)
        return np.asarray(v, np.float64) if v is not None else nan

    t2m = col("temperature_2m")
    dew = col("dewpoint_2m")
    ws = col("windspeed_10m")
    wd = col("winddirection_10m")
    # Meteorological wind direction -> sin/cos (matches the apply path's
    # atan2(-u, -v) convention via wd = direction the wind comes FROM).
    wd_rad = np.radians(wd)
    hours = np.array([ti.hour + ti.minute / 60.0 for ti in h.times])
    doys = np.array([ti.timetuple().tm_yday for ti in h.times], np.float64)
    solar = np.array(
        [solar_elevation(h.lat, h.lon, ti) for ti in h.times]
    )
    # 6h lag of t2m along the (hourly or 6-hourly) time axis: find the
    # record exactly 6h earlier; NaN where absent.
    times_s = np.array(
        [ti.timestamp() for ti in h.times], np.float64
    )
    lag_idx = np.searchsorted(times_s, times_s - 6 * 3600.0)
    lag_ok = (lag_idx < t) & np.isclose(
        times_s[np.clip(lag_idx, 0, t - 1)], times_s - 6 * 3600.0
    )
    t2m_lag = np.where(lag_ok, t2m[np.clip(lag_idx, 0, t - 1)], np.nan)

    feats = np.stack([
        t2m,
        dew,
        ws,
        np.sin(wd_rad),
        np.cos(wd_rad),
        col("surface_pressure"),
        col("cloudcover"),
        col("shortwave_radiation"),
        col("precipitation") / 1000.0,   # mm -> m (apply-path unit)
        np.sin(2 * np.pi * hours / 24),
        np.cos(2 * np.pi * hours / 24),
        np.sin(2 * np.pi * doys / 365.25),
        np.cos(2 * np.pi * doys / 365.25),
        solar,
        t2m - dew,                  # dewpoint depression
        t2m_lag,
        t2m - t2m_lag,
        np.full(t, h.lat),
        np.full(t, h.lon),
        np.full(t, h.elev),
    ], axis=1)
    return feats


def _static_mos_table(times, biases) -> Dict:
    """Mean bias per (month, hour) — the reference's static-MOS baseline
    (build_learned_mos.py:447-455) and the bias_table the table-MOS apply
    path loads."""
    table: Dict[str, Dict[str, List[float]]] = {}
    for ti, b in zip(times, biases):
        table.setdefault(str(ti.month), {}).setdefault(str(ti.hour), []).append(b)
    return {
        m: {hr: float(np.mean(v)) for hr, v in hrs.items()}
        for m, hrs in table.items()
    }


def train_learned_mos(
    stations: Sequence[StationHistory],
    output_path: Optional[str] = None,
    val_frac: float = 0.15,
    test_frac: float = 0.15,
    max_iter: int = 500,
    random_state: int = 42,
) -> Dict:
    """Fit the t2m bias regressor and return the reference-schema bundle.

    The split is CHRONOLOGICAL over the pooled record (oldest
    1−val−test … train, then val, then test — the reference splits by
    calendar year, :344-350; fractions generalize that to arbitrary
    periods).  The bundle (optionally joblib-dumped to ``output_path``)
    carries the same keys as the reference's
    (model / feature_columns / stations_trained / test metrics /
    counts, :454-464) and loads through ``corrections.load_learned_mos``
    + ``apply_learned_mos_t2m`` unchanged.
    """
    from sklearn.ensemble import HistGradientBoostingRegressor

    xs, ys, ts = [], [], []
    for h in stations:
        feats = build_feature_matrix(h)
        bias = np.asarray(h.station_t2m_c, np.float64) - feats[:, 0]
        ok = ~np.isnan(bias) & ~np.isnan(feats[:, 0])
        xs.append(feats[ok])
        ys.append(bias[ok])
        ts.extend([h.times[i] for i in np.flatnonzero(ok)])
    x = np.concatenate(xs, axis=0)
    y = np.concatenate(ys, axis=0)
    # Columns with NO data at all (e.g. the source never supplied
    # dewpoint/cloudcover/radiation) become a constant: HistGBR never
    # splits on a constant column, so apply-time NaNs in those features
    # are inert — while partially-missing columns keep their NaNs
    # (HistGBR handles them natively, like the reference's frames).
    all_nan = np.isnan(x).all(axis=0)
    x[:, all_nan] = 0.0
    order = np.argsort(np.array([ti.timestamp() for ti in ts]))
    x, y = x[order], y[order]
    ts = [ts[i] for i in order]

    n = len(y)
    n_test = max(int(n * test_frac), 1)
    n_val = max(int(n * val_frac), 1)
    n_train = n - n_val - n_test
    if n_train < 10:
        raise ValueError(f"not enough samples to train: {n}")
    sl_train = slice(0, n_train)
    sl_val = slice(n_train, n_train + n_val)
    sl_test = slice(n_train + n_val, n)

    model = HistGradientBoostingRegressor(
        max_iter=max_iter,
        max_depth=8,
        learning_rate=0.05,
        min_samples_leaf=20,
        l2_regularization=0.1,
        early_stopping=True,
        validation_fraction=0.1,
        n_iter_no_change=15,
        random_state=random_state,
    )
    model.fit(x[sl_train], y[sl_train])

    y_pred = model.predict(x[sl_test])
    test_mae = float(np.mean(np.abs(y[sl_test] - y_pred)))
    test_rmse = float(np.sqrt(np.mean((y[sl_test] - y_pred) ** 2)))
    # Baseline 1: raw forecast (zero correction).
    raw_mae = float(np.mean(np.abs(y[sl_test])))
    # Baseline 2: static month×hour MOS from the train split.
    static_table = _static_mos_table(ts[sl_train], y[sl_train])
    y_static = np.array([
        static_table.get(str(ti.month), {}).get(str(ti.hour), 0.0)
        for ti in ts[sl_test]
    ])
    static_mae = float(np.mean(np.abs(y[sl_test] - y_static)))

    bundle = {
        "model": model,
        "feature_columns": FEATURE_COLUMNS,
        "stations_trained": [h.station_id for h in stations],
        "period": (f"{ts[0]:%Y-%m-%d}..{ts[-1]:%Y-%m-%d}" if ts else ""),
        "split": f"chronological {1 - val_frac - test_frac:.2f}/"
                 f"{val_frac:.2f}/{test_frac:.2f}",
        "test_mae": round(test_mae, 4),
        "test_rmse": round(test_rmse, 4),
        "era5_mae": round(raw_mae, 4),
        "static_mos_mae": round(static_mae, 4),
        "static_mos_table": {"bias_table": static_table},
        "n_train": int(n_train),
        "n_test": int(n - n_train - n_val),
    }
    if output_path:
        import joblib

        joblib.dump(bundle, output_path)
    return bundle
