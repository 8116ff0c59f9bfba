"""Live operational forecast from recent analysis cycles (torch
counterpart of ``graphcast_lite_tpu.operational.live``: the rollout runs on
``device``, default ``cuda``; the rest is a NumPy copy).

~ reference ``scripts/live_gdas_forecast.py``: fetch the latest GDAS
analysis cycles, interpolate onto the model grid, normalize with the
training scalers, run the AR rollout, denormalize, and render a t2m map +
city summary markdown.

Architecture: the data source is an injected ``fetch_fn(cycle_index) ->
{var_name: field[G]}`` so the pipeline is fully testable offline.  The
GRIB-payload TRANSFORM core is real, tested code (``extract_live_channels``:
per-variable GRIB name candidates incl. pressure levels, lon-wrapped
bilinear interpolation to model nodes, Pa→hPa pressure fix, zero-fill +
warning for channels the analysis lacks, e.g. tp, static channels from the
bundle template — reference ``scripts/live_gdas_forecast.py:430-484``); it
consumes plain ``GribField`` arrays, so any GRIB reader (cfgrib or a test
fixture) can feed it.  Only the NETWORK step (``fetch_gdas_cycle``'s NOMADS
download) is gated: it raises a clear error in zero-egress environments or
when cfgrib is absent — it does NOT implement the download itself.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .bundle import RuntimeBundle, load_runtime_bundle

__all__ = [
    "LiveForecast",
    "run_live_forecast",
    "GribField",
    "interp_to_nodes",
    "extract_live_channels",
    "fetch_gdas_cycle",
    "render_t2m_map",
    "render_summary_markdown",
]

FetchFn = Callable[[int], Dict[str, np.ndarray]]


@dataclasses.dataclass
class GribField:
    """One decoded GRIB field on a regular lat/lon grid (reader-agnostic:
    cfgrib fills this from a DataArray, tests from synthetic arrays)."""

    lats: np.ndarray     # [La] degrees (any order; sorted internally)
    lons: np.ndarray     # [Lo] degrees (any convention; wrapped to 0..360)
    values: np.ndarray   # [La, Lo]


@dataclasses.dataclass
class LiveForecast:
    predictions_phys: np.ndarray   # [G, P, C] physical units
    valid_times: List[_dt.datetime]
    variables: List[str]
    latitude: np.ndarray
    longitude: np.ndarray


def _assemble_frame(
    fields: Dict[str, np.ndarray],
    bundle: RuntimeBundle,
) -> np.ndarray:
    """Stack named fields into the canonical channel order; zero-fill missing
    channels (normalized zero = climatological mean) with a warning."""
    g = bundle.num_nodes
    c = len(bundle.variables)
    frame = np.zeros((g, c), np.float32)
    for i, name in enumerate(bundle.variables[:c]):
        if name in fields:
            frame[:, i] = (fields[name] - bundle.mean[i]) / bundle.std[i]
        else:
            print(f"[live] WARNING: channel '{name}' missing from analysis; "
                  "filled with climatological mean")
    # Static channels from the bundle template override the analysis.
    if bundle.static_values is not None:
        for j, ch in enumerate(bundle.static_channels):
            frame[:, ch] = bundle.static_values[:, j]
    return frame


def run_live_forecast(
    bundle_dir: str,
    fetch_fn: FetchFn,
    ar_steps: int = 4,
    base_time: Optional[_dt.datetime] = None,
    step_hours: int = 6,
    device: Union[str, torch.device, None] = None,
    dtype: Union[str, torch.dtype] = "fp32",
) -> LiveForecast:
    """Fetch obs_window recent cycles, roll out on ``device`` (default
    ``cuda``) in ``dtype``, return physical fields."""
    from ..build import build_weather_model, resolve_device, resolve_dtype
    from ..data.dataset import DatasetMetadata
    from ..inference.predict import serving_copy
    from ..training import checkpoint as ckpt_lib
    from ..training.rollout import RolloutSpec, rollout_predict

    dev = resolve_device(device)
    fdt = resolve_dtype(dtype)
    bundle = load_runtime_bundle(bundle_dir)
    cfg = bundle.config
    obs = cfg.data.obs_window_used
    c = cfg.data.num_features_used

    frames = [
        _assemble_frame(fetch_fn(i), bundle) for i in range(obs)
    ]  # oldest..newest
    window = np.stack(frames, axis=1)  # [G, obs, C]

    meta = DatasetMetadata(
        flattened=True,
        num_latitudes=0 if bundle.flat_grid else len(bundle.latitude),
        num_longitudes=0 if bundle.flat_grid else len(bundle.longitude),
        num_features=c,
        obs_window=obs,
        pred_window=ar_steps,
        flat_grid=bundle.flat_grid,
        coordinates=(bundle.latitude, bundle.longitude),
    )
    model, graphs, _ = build_weather_model(cfg, meta, device=dev)
    model.load_state_dict(ckpt_lib.load_params(bundle.params_path))
    model, graphs = serving_copy(model, graphs, dev, fdt)

    spec = RolloutSpec(
        obs_window=obs, num_features=c, use_residual=cfg.use_residual,
        remat=False, static_channels=tuple(bundle.static_channels),
    )

    def model_fn(inp, m, t, p):
        return model(inp, graphs, m, t, p)

    with torch.inference_mode():
        preds = rollout_predict(
            model_fn, torch.from_numpy(window).to(dev, fdt), ar_steps, spec
        )  # [G, P, C]
        preds = preds.float().cpu().numpy()
    preds_phys = preds * bundle.std[:c] + bundle.mean[:c]

    base = base_time or _dt.datetime.utcnow()
    valid = [base + _dt.timedelta(hours=step_hours * (i + 1))
             for i in range(ar_steps)]
    return LiveForecast(
        predictions_phys=preds_phys,
        valid_times=valid,
        variables=bundle.variables,
        latitude=bundle.latitude,
        longitude=bundle.longitude,
    )


def interp_to_nodes(
    field: GribField, node_lats: np.ndarray, node_lons: np.ndarray
) -> np.ndarray:
    """Longitude-wrapped bilinear interpolation of a regular-grid field to
    scattered model nodes (reference live_gdas_forecast.py:380-407: sort
    both axes, append a +360° wrap column, linear interpolation, clamped
    at the lat edges)."""
    lats = np.asarray(field.lats, np.float64)
    lons = np.mod(np.asarray(field.lons, np.float64), 360.0)
    vals = np.asarray(field.values, np.float64)
    lat_order = np.argsort(lats)
    lon_order = np.argsort(lons)
    lats_s = lats[lat_order]
    lons_s = lons[lon_order]
    vals_s = vals[np.ix_(lat_order, lon_order)]
    # Wrap column: the first longitude shifted by +360 closes the seam.
    lons_e = np.concatenate([lons_s, [lons_s[0] + 360.0]])
    vals_e = np.concatenate([vals_s, vals_s[:, :1]], axis=1)

    nl = np.asarray(node_lats, np.float64)
    no = np.mod(np.asarray(node_lons, np.float64), 360.0)
    # Nodes west of the first source longitude read the wrap cell.
    no = np.where(no < lons_e[0], no + 360.0, no)
    li = np.interp(nl, lats_s, np.arange(len(lats_s)))
    lo = np.interp(no, lons_e, np.arange(len(lons_e)))
    i0 = np.clip(np.floor(li).astype(int), 0, len(lats_s) - 2)
    j0 = np.clip(np.floor(lo).astype(int), 0, len(lons_e) - 2)
    fi, fj = li - i0, lo - j0
    out = (
        vals_e[i0, j0] * (1 - fi) * (1 - fj)
        + vals_e[i0 + 1, j0] * fi * (1 - fj)
        + vals_e[i0, j0 + 1] * (1 - fi) * fj
        + vals_e[i0 + 1, j0 + 1] * fi * fj
    )
    return out.astype(np.float32)


# (group key in the GRIB payload, candidate GRIB short names, hPa level)
# — reference live_gdas_forecast.py:441-460.
_VAR_SPECS = {
    "t2m": ("t2m", ["2t", "t2m", "t"], None),
    "10u": ("10u", ["10u", "u10", "u"], None),
    "10v": ("10v", ["10v", "v10", "v"], None),
    "msl": ("msl", ["prmsl", "mslma"], None),
    "sp": ("sp", ["sp", "pres"], None),
    "tcwv": ("tcwv", ["pwat", "tcwv"], None),
    "tp": ("tp", ["tp", "acpcp", "prate"], None),
}
for _v in ("t", "u", "v", "q"):
    for _lev in (850, 500):
        _VAR_SPECS[f"{_v}@{_lev}"] = (f"isobaric_{_v}", [_v], _lev)
for _lev in (850, 500):
    _VAR_SPECS[f"z@{_lev}"] = ("isobaric_z", ["gh", "z"], _lev)


def extract_live_channels(
    payload: Dict[str, Dict],
    node_lats: np.ndarray,
    node_lons: np.ndarray,
    var_order: Sequence[str],
    template_static: Optional[Dict[str, np.ndarray]] = None,
) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """Map a decoded GRIB payload onto the model's channel set.

    ``payload``: {group: {short_name: GribField}} for surface groups, or
    {group: {short_name: {level: GribField}}} for isobaric groups — the
    shape a cfgrib reader (or a test fixture) naturally produces.
    Static channels come from ``template_static`` (the runtime bundle);
    missing channels are zero-filled with a warning (normalized zero =
    climatological mean — reference :473-475); msl/sp are converted Pa→hPa
    to match the training scalers (reference :479).
    Returns ({var: field[G] float32}, warnings)."""
    template_static = template_static or {}
    extracted: Dict[str, np.ndarray] = {}
    warnings: List[str] = []
    zeros = np.zeros_like(np.asarray(node_lats), dtype=np.float32)

    for name in var_order:
        if name in template_static:
            extracted[name] = np.asarray(
                template_static[name], np.float32
            )
            continue
        spec = _VAR_SPECS.get(name)
        if spec is None:
            warnings.append(f"Unsupported variable {name}; filling zeros")
            extracted[name] = zeros.copy()
            continue
        group, candidates, level = spec
        field = None
        group_data = payload.get(group, {})
        for cand in candidates:
            entry = group_data.get(cand)
            if entry is None:
                continue
            field = entry.get(level) if isinstance(entry, dict) else entry
            if field is not None:
                break
        if field is None:
            warnings.append(
                "GDAS analysis does not expose tp in this path; filling "
                "zeros" if name == "tp"
                else f"Missing {name} in GDAS payload; filling zeros"
            )
            extracted[name] = zeros.copy()
            continue
        values = interp_to_nodes(field, node_lats, node_lons)
        if name in ("msl", "sp"):
            values = values / 100.0  # Pa -> hPa (training-scaler contract)
        extracted[name] = values
    return extracted, warnings


def fetch_gdas_cycle(
    cycle_index: int,
    variables: Sequence[str],
    grid_lat: np.ndarray,
    grid_lon: np.ndarray,
    base_url: str = "https://nomads.ncep.noaa.gov/pub/data/nccf/com/gfs/prod",
) -> Dict[str, np.ndarray]:
    """NOMADS GDAS download entry point — the NETWORK step only.

    The GRIB→channels transform is ``extract_live_channels`` (real, tested
    offline); this function only covers fetching the GRIB bytes and decoding
    them with cfgrib, which needs network access.  In this zero-egress build
    it raises a clear RuntimeError — inject a synthetic ``fetch_fn``
    instead (see tests/test_operational.py).
    """
    try:
        import cfgrib  # noqa: F401
        import urllib.request  # noqa: F401
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "fetch_gdas_cycle requires cfgrib + network access; inject a "
            "custom fetch_fn for offline use"
        ) from e
    raise RuntimeError(
        "Live GDAS download not available in a zero-egress environment; "
        "inject a custom fetch_fn (the GRIB->channel transform itself is "
        "extract_live_channels and works offline)"
    )


def render_t2m_map(
    forecast: LiveForecast,
    map_path: str,
    step: int = 0,
    city_name: Optional[str] = None,
    city_lat: Optional[float] = None,
    city_lon: Optional[float] = None,
) -> Optional[str]:
    """+step t2m map (°C) with an optional city marker, like the reference's
    summary figure (live_gdas_forecast.py:494-561).  Returns the path, or
    None when matplotlib is unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # pragma: no cover
        return None
    if "t2m" not in forecast.variables:
        return None
    ti = forecast.variables.index("t2m")
    t2m_c = forecast.predictions_phys[:, step, ti] - 273.15
    lat, lon = forecast.latitude, forecast.longitude
    fig, ax = plt.subplots(figsize=(9, 4.5))
    if lat.ndim == 1 and len(lat) != len(lon):
        field = t2m_c.reshape(len(lat), len(lon))
        im = ax.imshow(field, origin="lower", aspect="auto", cmap="RdYlBu_r",
                       extent=[lon.min(), lon.max(), lat.min(), lat.max()])
    else:  # flat grid: scatter
        im = ax.scatter(lon, lat, c=t2m_c, s=4, cmap="RdYlBu_r")
    if city_lat is not None and city_lon is not None:
        ax.plot(city_lon, city_lat, "k*", markersize=12)
        if city_name:
            ax.annotate(city_name, (city_lon, city_lat),
                        textcoords="offset points", xytext=(6, 6))
    vt = forecast.valid_times[step]
    ax.set_title(f"t2m forecast, valid {vt:%Y-%m-%d %H:%M} UTC")
    fig.colorbar(im, ax=ax, label="°C")
    fig.tight_layout()
    fig.savefig(map_path, dpi=110)
    plt.close(fig)
    return map_path


def render_summary_markdown(
    forecast: LiveForecast,
    city_name: str = "Krasnoyarsk",
    city_lat: float = 56.0153,
    city_lon: float = 92.8932,
    out_path: Optional[str] = None,
    map_path: Optional[str] = None,
) -> str:
    """City forecast table (t2m/wind) + optional t2m map (rendered to
    ``map_path`` and embedded when given), like the reference's markdown
    summary (:494-561)."""
    lat, lon = forecast.latitude, forecast.longitude
    if lat.ndim == 1 and len(lat) != len(lon):
        lo, la = np.meshgrid(lon, lat)
        nl, no = la.reshape(-1), lo.reshape(-1)
    else:
        nl, no = lat, lon
    node = int(np.argmin((nl - city_lat) ** 2 + (no - city_lon) ** 2))

    def var_idx(name):
        return forecast.variables.index(name) if name in forecast.variables else None

    lines = [f"# Live forecast — {city_name}", ""]
    lines.append("| valid (UTC) | " + " | ".join(
        v for v in ("t2m [°C]", "wind [m/s]") ) + " |")
    lines.append("|---|---|---|")
    t2m_i, u_i, v_i = var_idx("t2m"), var_idx("10u"), var_idx("10v")
    for s, vt in enumerate(forecast.valid_times):
        t2m = (forecast.predictions_phys[node, s, t2m_i] - 273.15
               if t2m_i is not None else float("nan"))
        if u_i is not None and v_i is not None:
            ws = float(np.hypot(forecast.predictions_phys[node, s, u_i],
                                forecast.predictions_phys[node, s, v_i]))
        else:
            ws = float("nan")
        lines.append(f"| {vt:%Y-%m-%d %H:%M} | {t2m:.1f} | {ws:.1f} |")
    if map_path is not None:
        rendered = render_t2m_map(
            forecast, map_path, step=0,
            city_name=city_name, city_lat=city_lat, city_lon=city_lon,
        )
        if rendered:
            # Link relative to the markdown file's directory, not basename
            # (map_path may live in a sibling directory).
            base = os.path.dirname(os.path.abspath(out_path)) if out_path \
                else os.getcwd()
            rel = os.path.relpath(os.path.abspath(rendered), base)
            lines += ["", f"![t2m map]({rel})"]
    text = "\n".join(lines)
    if out_path:
        with open(out_path, "w") as f:
            f.write(text)
    return text
