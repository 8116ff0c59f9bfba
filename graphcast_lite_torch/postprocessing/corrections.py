"""Post-processing ladder: MOS bias correction, learned MOS, IDW spreading,
lapse-rate adjustment, boundary blending (a NumPy copy of
``graphcast_lite_tpu.postprocessing.corrections``; joblib is imported
only by ``load_learned_mos``).

~ reference ``src/postprocessing/mos_correction.py`` and the lapse/blending
logic inside ``scripts/evaluate_full_pipeline.py:50,184-201`` /
``scripts/predict.py:321-332,570-572``.  All host-side NumPy (this stage
operates on small physical-unit fields after inference); the IDW and
feature construction are vectorized instead of the reference's per-node
python loops.
"""

from __future__ import annotations

import json
import math
from datetime import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "load_mos_table",
    "get_t2m_bias",
    "apply_mos_t2m",
    "solar_elevation",
    "load_learned_mos",
    "build_mos_features",
    "idw_interpolate_bias",
    "apply_learned_mos_t2m",
    "apply_lapse_rate",
    "blend_boundary",
]

_LAPSE_RATE_K_PER_M = 6.5 / 1000.0
_G0 = 9.80665  # geopotential -> meters


# ---------------------------------------------------------------- table MOS
def load_mos_table(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def get_t2m_bias(mos_table: dict, valid_time: datetime) -> float:
    """Additive t2m bias (°C) for (month, hour) from the table."""
    return (
        mos_table.get("bias_table", {})
        .get(str(valid_time.month), {})
        .get(str(valid_time.hour), 0.0)
    )


def apply_mos_t2m(
    prediction_phys: np.ndarray,     # [G, steps, C]
    var_order: Sequence[str],
    mos_table: dict,
    valid_times: Sequence[datetime],
) -> np.ndarray:
    """Table-based (month, hour) additive t2m correction."""
    if "t2m" not in var_order:
        return prediction_phys
    out = prediction_phys.copy()
    idx = list(var_order).index("t2m")
    for s, vt in enumerate(valid_times):
        out[:, s, idx] += get_t2m_bias(mos_table, vt)
    return out


# ------------------------------------------------------------- learned MOS
def solar_elevation(lat_deg: float, lon_deg: float, dt: datetime) -> float:
    """Approximate solar elevation (degrees), Spencer (1971) Fourier series."""
    doy = dt.timetuple().tm_yday
    hour = dt.hour + dt.minute / 60.0
    gamma = 2 * math.pi * (doy - 1) / 365.0
    decl = (
        0.006918 - 0.399912 * math.cos(gamma) + 0.070257 * math.sin(gamma)
        - 0.006758 * math.cos(2 * gamma) + 0.000907 * math.sin(2 * gamma)
    )
    eqt = 229.18 * (
        0.000075 + 0.001868 * math.cos(gamma) - 0.032077 * math.sin(gamma)
        - 0.014615 * math.cos(2 * gamma) - 0.04089 * math.sin(2 * gamma)
    )
    solar_time = hour * 60 + eqt + 4 * lon_deg
    ha = math.radians(solar_time / 4.0 - 180.0)
    lat = math.radians(lat_deg)
    s = (
        math.sin(lat) * math.sin(decl)
        + math.cos(lat) * math.cos(decl) * math.cos(ha)
    )
    return math.degrees(math.asin(max(-1.0, min(1.0, s))))


def load_learned_mos(path: str) -> dict:
    import joblib

    return joblib.load(path)


def _get_var(vals: np.ndarray, var_order: Sequence[str], name: str) -> float:
    alt = {"u10": "10u", "10u": "u10", "v10": "10v", "10v": "v10"}
    order = list(var_order)
    if name in order:
        return float(vals[order.index(name)])
    if name in alt and alt[name] in order:
        return float(vals[order.index(alt[name])])
    return float("nan")


def build_mos_features(
    vals: np.ndarray,
    var_order: Sequence[str],
    valid_time: datetime,
    station_lat: float,
    station_lon: float,
    station_elev: float,
    prev_t2m_c: Optional[float],
) -> np.ndarray:
    """20-feature vector for the learned-MOS regressor (NaN for inputs the
    forecast can't supply; HistGBR is NaN-tolerant).  Feature order matches
    the reference's FEATURE_COLUMNS contract."""
    t2m_c = _get_var(vals, var_order, "t2m") - 273.15
    u10 = _get_var(vals, var_order, "u10")
    v10 = _get_var(vals, var_order, "v10")
    if math.isnan(u10) or math.isnan(v10):
        ws = wd_sin = wd_cos = float("nan")
    else:
        ws = math.hypot(u10, v10)
        wd = math.atan2(-u10, -v10)
        wd_sin, wd_cos = math.sin(wd), math.cos(wd)
    sp = _get_var(vals, var_order, "sp")
    sp_hpa = sp / 100.0 if not math.isnan(sp) else float("nan")
    precip = _get_var(vals, var_order, "tp")

    hour, doy = valid_time.hour, valid_time.timetuple().tm_yday
    feats = [
        t2m_c, float("nan"), ws, wd_sin, wd_cos,
        sp_hpa, float("nan"), float("nan"), precip,
        math.sin(2 * math.pi * hour / 24), math.cos(2 * math.pi * hour / 24),
        math.sin(2 * math.pi * doy / 365.25), math.cos(2 * math.pi * doy / 365.25),
        solar_elevation(station_lat, station_lon, valid_time),
        float("nan"),
        prev_t2m_c if prev_t2m_c is not None else float("nan"),
        (t2m_c - prev_t2m_c) if prev_t2m_c is not None else float("nan"),
        station_lat, station_lon, station_elev,
    ]
    return np.asarray(feats, np.float64)


def _haversine_km(lat1, lon1, lat2, lon2):
    """Vectorized great-circle distance in km (broadcasting inputs)."""
    lat1, lon1, lat2, lon2 = map(np.radians, (lat1, lon1, lat2, lon2))
    a = (
        np.sin((lat2 - lat1) / 2) ** 2
        + np.cos(lat1) * np.cos(lat2) * np.sin((lon2 - lon1) / 2) ** 2
    )
    return 6371.0 * 2 * np.arctan2(np.sqrt(a), np.sqrt(1 - a))


def idw_interpolate_bias(
    station_biases: Dict[int, np.ndarray],
    latitudes: np.ndarray,
    longitudes: np.ndarray,
    n_steps: int,
    power: float = 2.0,
    max_radius_km: float = 300.0,
) -> np.ndarray:
    """Spread per-station biases [steps] to all grid nodes by inverse-distance
    weighting within a max radius; station nodes keep their exact bias.
    Returns [G, steps].  Vectorized over the grid."""
    g = len(latitudes)
    field = np.zeros((g, n_steps), np.float64)
    if not station_biases:
        return field
    st_idx = np.fromiter(station_biases.keys(), int)
    st_b = np.stack([station_biases[i] for i in st_idx])   # [K, steps]
    d = _haversine_km(
        latitudes[:, None], longitudes[:, None],
        latitudes[st_idx][None, :], longitudes[st_idx][None, :],
    )  # [G, K]
    within = d < max_radius_km
    d = np.maximum(d, 0.1)
    w = np.where(within, 1.0 / d**power, 0.0)
    wsum = w.sum(axis=1, keepdims=True)
    has = wsum[:, 0] > 0
    w = np.where(wsum > 0, w / np.maximum(wsum, 1e-30), 0.0)
    field[has] = w[has] @ st_b
    field[st_idx] = st_b  # exact at station nodes
    return field


def apply_learned_mos_t2m(
    prediction_phys: np.ndarray,          # [G, steps, C]
    var_order: Sequence[str],
    model_bundle: dict,
    latitudes: np.ndarray,
    longitudes: np.ndarray,
    valid_times: Sequence[datetime],
    stations: Optional[List[dict]] = None,
    station_lat: float = 56.173,
    station_lon: float = 92.493,
    station_elev: float = 287.0,
    spatial_idw: bool = False,
    idw_power: float = 2.0,
    idw_max_radius_km: float = 300.0,
) -> Tuple[np.ndarray, int]:
    """ML bias correction of t2m at station grid points (optionally spread to
    the whole grid by IDW).  Returns (corrected, n_corrected_nodes)."""
    if "t2m" not in var_order:
        return prediction_phys, 0
    model = model_bundle["model"]
    out = prediction_phys.copy()
    t2m_idx = list(var_order).index("t2m")
    n_steps = len(valid_times)

    if stations is None:
        stations = [{"lat": station_lat, "lon": station_lon,
                     "elev": station_elev, "name": "default"}]

    grid_stations: Dict[int, List[dict]] = {}
    for st in stations:
        d2 = (latitudes - st["lat"]) ** 2 + (longitudes - st["lon"]) ** 2
        grid_stations.setdefault(int(np.argmin(d2)), []).append(st)

    station_biases: Dict[int, np.ndarray] = {}
    for gi, group in grid_stations.items():
        biases = np.zeros(n_steps)
        prev_t2m_c = None
        for s, vt in enumerate(valid_times):
            feats = np.stack([
                build_mos_features(out[gi, s], var_order, vt,
                                   st["lat"], st["lon"], st["elev"],
                                   prev_t2m_c)
                for st in group
            ])
            biases[s] = float(np.mean(model.predict(feats)))
            prev_t2m_c = float(out[gi, s, t2m_idx] + biases[s]) - 273.15
        station_biases[gi] = biases

    if spatial_idw and len(station_biases) >= 2:
        field = idw_interpolate_bias(
            station_biases, np.asarray(latitudes), np.asarray(longitudes),
            n_steps, idw_power, idw_max_radius_km,
        )
        out[:, :, t2m_idx] += field
        n_corrected = int((np.abs(field).max(axis=1) > 1e-6).sum())
    else:
        for gi, b in station_biases.items():
            out[gi, :, t2m_idx] += b
        n_corrected = len(station_biases)
    return out, n_corrected


# --------------------------------------------------------------- lapse rate
def apply_lapse_rate(
    t2m_phys: np.ndarray,          # [...] temperatures (K or °C)
    grid_elevation_m: np.ndarray,  # [...] model surface elevation (meters)
    target_elevation_m: np.ndarray,
    lapse_rate: float = _LAPSE_RATE_K_PER_M,
) -> np.ndarray:
    """Standard-atmosphere lapse adjustment: +6.5 K per km of elevation the
    model grid sits ABOVE the target (reference evaluate_full_pipeline.py:50,
    184-201).  Elevation from z_surf uses z/g0."""
    return t2m_phys + lapse_rate * (grid_elevation_m - target_elevation_m)


def geopotential_to_elevation(z_surf: np.ndarray) -> np.ndarray:
    return z_surf / _G0


# ---------------------------------------------------------- boundary blend
def blend_boundary(
    prediction: np.ndarray,      # [G, ...]
    background: np.ndarray,      # [G, ...] (e.g. interpolated global forecast)
    taper: np.ndarray,           # [G] in [0, 1]; 1 = trust prediction
) -> np.ndarray:
    """taper·prediction + (1−taper)·background (reference predict.py:570-572)."""
    t = taper.reshape((-1,) + (1,) * (prediction.ndim - 1))
    return t * prediction + (1.0 - t) * background
