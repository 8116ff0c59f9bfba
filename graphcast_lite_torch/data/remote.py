"""Remote dataset acquisition (WeatherBench2 / ARCO ERA5 / Copernicus CDS),
a NumPy copy of ``graphcast_lite_tpu.data.remote``: the files it writes
are byte-equal to the JAX package's.

~ reference acquisition scripts (``build_dataset_wb2.py``,
``build_dataset_512x256.py``, ``build_dataset_arco.py``,
``build_region_arco.py``, ``build_region_cds.py``): stream cloud zarr
stores or the CDS API into the chunked on-disk format.

Architecture — everything except the literal network open is REAL code:

* ``ChannelSource`` protocol: the injected data handle (``n_time``,
  ``latitude``/``longitude``, ``channels``, ``read(name, t0, t1) ->
  [T, n_lon, n_lat]`` in physical units).
* ``stream_build_dataset``: the per-channel float16-memmap streamer with
  Welford scaler accumulation and the reference's progress.json resume
  protocol (re-download last chunk, recompute stats from disk —
  build_dataset_512x256.py:107-260).
* ``WB2Source``: maps the WeatherBench2/ARCO ERA5 variable catalog
  (surface renames, tp-name detection, pressure-level selection, static
  expansion, float16 range SCALE_FACTORS) onto the protocol.  It consumes
  any xarray-Dataset-LIKE object (``data_vars``/``[]``/``.sel``/
  ``.transpose``/``.values``), so tests drive it with a ~60-line fake.
* ``RegionSource``: lat/lon bbox cut of another source (the 0.25°
  regional builders).
* ``open_wb2`` / ``open_arco`` / ``open_cds_netcdf``: the ONLY gated
  functions — they import xarray/gcsfs/cdsapi and open the remote store;
  on a zero-egress machine they raise with a clear message.
* ``main()``: the acquisition CLI
  (``python -m graphcast_lite_torch.data.remote build-wb2 --out DIR ...``);
  on a networked machine it runs end-to-end with zero new code.

The produced artifact set (data.npy (T, n_lon, n_lat, C) float16 +
dataset_info.json + scalers.npz + coords.npz + variables.json) is
format-identical to ``data.synthetic.generate_synthetic_dataset`` and
loads through ``data.dataset.ChunkedTimeseriesDataset`` unchanged.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Protocol, Sequence

import numpy as np

__all__ = [
    "WB2_64X32_URL",
    "WB2_512X256_URL",
    "WB2_0P25_URL",
    "ARCO_ERA5_URL",
    "CANONICAL_19_VARIABLES",
    "SCALE_FACTORS",
    "ChannelSource",
    "WB2Source",
    "RegionSource",
    "stream_build_dataset",
    "resume_state",
    "save_resume_state",
    "open_wb2",
    "open_arco",
    "open_cds_netcdf",
    "build_dataset_wb2",
    "build_dataset_512x256",
    "build_region_arco",
    "build_region_cds",
    "main",
]

WB2_64X32_URL = (
    "gs://weatherbench2/datasets/era5/"
    "1959-2022-6h-64x32_equiangular_conservative.zarr"
)
WB2_512X256_URL = (
    "gs://weatherbench2/datasets/era5/"
    "1959-2022-6h-512x256_equiangular_conservative.zarr"
)
WB2_0P25_URL = (
    "gs://weatherbench2/datasets/era5/"
    "1959-2023_01_10-wb13-6h-1440x721.zarr"
)
ARCO_ERA5_URL = (
    "gs://gcp-public-data-arco-era5/ar/full_37-1h-0p25deg-chunk-1.zarr-v3"
)

# Canonical 19-variable order of the 512x256 experiments
# (reference experiments/wb2_512x256_19f_ar/variables.json).
CANONICAL_19_VARIABLES = [
    "t2m", "10u", "10v", "msl", "tp", "sp", "tcwv", "z_surf", "lsm",
    "t@850", "u@850", "v@850", "z@850", "q@850",
    "t@500", "u@500", "v@500", "z@500", "q@500",
]

# float16 max = 65504: pressures (Pa) and geopotential (m²/s²) overflow.
# Scaled BEFORE the cast, like the reference (build_dataset_512x256.py:76-83).
SCALE_FACTORS = {
    "msl": 0.01,            # Pa -> hPa
    "sp": 0.01,             # Pa -> hPa
    "z_surf": 1 / 9.80665,  # m²/s² -> m
    "z@850": 1 / 9.80665,
    "z@500": 1 / 9.80665,
}

# WB2/ARCO ERA5 variable catalog (reference RENAME tables).
_SURFACE_VARS = {
    "t2m": "2m_temperature",
    "10u": "10m_u_component_of_wind",
    "10v": "10m_v_component_of_wind",
    "msl": "mean_sea_level_pressure",
    "sp": "surface_pressure",
    "tcwv": "total_column_water_vapour",
}
_STATIC_VARS = {
    "z_surf": "geopotential_at_surface",
    "lsm": "land_sea_mask",
}
_PLEV_VARS = {
    "t": "temperature",
    "u": "u_component_of_wind",
    "v": "v_component_of_wind",
    "z": "geopotential",
    "q": "specific_humidity",
}
_TP_CANDIDATES = [
    "total_precipitation_6hr", "total_precipitation", "tp",
]
# CDS netcdf downloads use ERA5 SHORT names (reference build_region_cds.py
# retrieves via cdsapi; xarray exposes t2m/u10/... directly).
_SURFACE_SHORT = {
    "t2m": "t2m", "10u": "u10", "10v": "v10", "msl": "msl", "sp": "sp",
    "tcwv": "tcwv",
}
_STATIC_SHORT = {"z_surf": "z", "lsm": "lsm"}
_PLEV_SHORT = {"t": "t", "u": "u", "v": "v", "z": "z", "q": "q"}


# ------------------------------------------------------------------ protocol
class ChannelSource(Protocol):
    """The injected acquisition handle the streamer consumes."""

    n_time: int
    latitude: np.ndarray     # [n_lat] degrees
    longitude: np.ndarray    # [n_lon] degrees
    channels: Sequence[str]  # canonical names this source can produce

    def read(self, name: str, t0: int, t1: int) -> np.ndarray:
        """Channel slab [t1-t0, n_lon, n_lat], physical units (pre-scale)."""
        ...


class WB2Source:
    """Adapter: xarray-like ERA5 Dataset -> ChannelSource.

    ``ds`` must provide ``data_vars`` (name containment), ``ds[var]`` with
    ``.dims``, ``.sizes``, ``.sel(level=...)``, ``.isel(time=...)``,
    ``.transpose(*dims)``, ``.values`` and coordinate accessors
    ``ds[var].latitude/longitude`` — the subset of xarray the reference
    builders touch, so a real ``xr.Dataset`` drops in directly and tests
    use a small fake.
    """

    def __init__(self, ds, variables: Optional[Sequence[str]] = None):
        self.ds = ds
        want = list(variables) if variables else list(CANONICAL_19_VARIABLES)
        self.channels = [v for v in want if self._resolve(v) is not None]
        missing = [v for v in want if v not in self.channels]
        if missing:
            print(f"[remote] WARNING: source lacks {missing}; skipped")
        if not self.channels:
            raise ValueError(
                "source exposes none of the requested variables "
                f"({want}); data_vars do not match the ERA5 long- or "
                "short-name catalogs"
            )
        # Reference axes from the first TIME-VARYING channel (statics have
        # no time dim).
        ref = None
        for name in self.channels:
            da = self.ds[self._resolve(name)[0]]
            if "time" in da.dims:
                ref = da
                break
        if ref is None:
            raise ValueError("source has no time-varying channels")
        self.n_time = int(ref.sizes["time"])
        self.latitude = np.asarray(ref.latitude.values, np.float32)
        self.longitude = np.asarray(ref.longitude.values, np.float32)

    def _resolve(self, name: str):
        """canonical name -> (source var, level | None) or None.

        Tries the WB2/ARCO LONG names first, then the CDS SHORT names
        (reference build_dataset_*.py vs build_region_cds.py)."""
        if name == "tp":
            for cand in _TP_CANDIDATES:
                if cand in self.ds.data_vars:
                    return cand, None
            return None
        for table in (_SURFACE_VARS, _SURFACE_SHORT):
            if name in table and table[name] in self.ds.data_vars:
                return table[name], None
        for table in (_STATIC_VARS, _STATIC_SHORT):
            if name in table and table[name] in self.ds.data_vars:
                # CDS 'z' is ambiguous (surface vs plev); only accept the
                # short static name when it has NO level dim.
                v = table[name]
                if table is _STATIC_SHORT and "level" in getattr(
                        self.ds[v], "dims", ()):
                    continue
                return v, None
        if "@" in name:
            short, lev = name.split("@")
            for table in (_PLEV_VARS, _PLEV_SHORT):
                v = table.get(short)
                if v is not None and v in self.ds.data_vars and \
                        "level" in getattr(self.ds[v], "dims", ()):
                    return v, int(lev)
            return None
        return None

    def read(self, name: str, t0: int, t1: int) -> np.ndarray:
        var, level = self._resolve(name)
        da = self.ds[var]
        if level is not None:
            da = da.sel(level=level)
        if "time" in da.dims:
            da = da.isel(time=slice(t0, t1))
            arr = np.asarray(
                da.transpose("time", "longitude", "latitude").values,
                np.float32,
            )
        else:
            # Static field: expand along time (reference expand_dims path).
            arr2 = np.asarray(
                da.transpose("longitude", "latitude").values, np.float32
            )
            arr = np.broadcast_to(arr2[None], (t1 - t0,) + arr2.shape).copy()
        return arr


class RegionSource:
    """Lat/lon bbox cut of another ChannelSource (the 0.25° regional
    builders — reference build_region_arco.py:162-165 slices the store;
    slicing the read slabs is equivalent and source-agnostic)."""

    def __init__(self, base: ChannelSource, lat_min: float, lat_max: float,
                 lon_min: float, lon_max: float):
        self.base = base
        lat = np.asarray(base.latitude)
        lon = np.asarray(base.longitude)
        self._lat_idx = np.flatnonzero((lat >= lat_min) & (lat <= lat_max))
        self._lon_idx = np.flatnonzero((lon >= lon_min) & (lon <= lon_max))
        if self._lat_idx.size == 0 or self._lon_idx.size == 0:
            raise ValueError("empty region cut")
        self.latitude = lat[self._lat_idx]
        self.longitude = lon[self._lon_idx]
        self.n_time = base.n_time
        self.channels = list(base.channels)

    def read(self, name: str, t0: int, t1: int) -> np.ndarray:
        slab = self.base.read(name, t0, t1)
        return slab[:, self._lon_idx][:, :, self._lat_idx]


# ------------------------------------------------------------------ streamer
def resume_state(out_dir: str) -> Dict:
    """Read progress.json; missing -> fresh start (reference key layout:
    last_completed_timestep + chunk_size)."""
    path = os.path.join(out_dir, "progress.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"last_completed_timestep": 0, "chunk_size": 0}


def save_resume_state(out_dir: str, last_timestep: int,
                      chunk_size: int) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "progress.json"), "w") as f:
        json.dump({"last_completed_timestep": int(last_timestep),
                   "chunk_size": int(chunk_size)}, f)


def _welford_combine(mean, m2, n, b_sum, b_sumsq, b_n):
    """Chan parallel combination from per-block sum/sumsq accumulators."""
    b_mean = b_sum / b_n
    b_var = np.maximum(b_sumsq / b_n - b_mean**2, 0.0)
    delta = b_mean - mean
    new_n = n + b_n
    mean = mean + delta * (b_n / new_n)
    m2 = m2 + b_var * b_n + delta**2 * n * b_n / new_n
    return mean, m2, new_n


def stream_build_dataset(
    source: ChannelSource,
    out_dir: str,
    time_chunk: int = 500,
    resume: bool = False,
    scale_factors: Optional[Dict[str, float]] = None,
    time_start: str = "", time_end: str = "",
) -> str:
    """Stream ``source`` into the chunked on-disk format.

    Per time-chunk: read each channel slab, apply the float16 range scale,
    write into the (T, n_lon, n_lat, C) float16 memmap, accumulate Welford
    sums; then persist progress.json.  ``resume=True`` rolls back one chunk
    (the last one may be partial) and recomputes the statistics of the
    already-written prefix FROM DISK — no re-download
    (reference build_dataset_512x256.py:228-260, 395-407)."""
    scale_factors = SCALE_FACTORS if scale_factors is None else scale_factors
    variables = list(source.channels)
    n_time = int(source.n_time)
    n_lat = len(source.latitude)
    n_lon = len(source.longitude)
    n_feat = len(variables)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "data.npy")

    start = 0
    if resume:
        st = resume_state(out_dir)
        saved = int(st.get("last_completed_timestep", 0))
        if saved > 0 and os.path.exists(out_path):
            # Re-stream the last chunk: it may be partial.
            start = max(0, saved - max(int(st.get("chunk_size", 0)),
                                       time_chunk))
            print(f"[remote] resume: last_completed={saved}, "
                  f"restart at {start}")

    fp = np.memmap(out_path, dtype=np.float16,
                   mode="r+" if start > 0 else "w+",
                   shape=(n_time, n_lon, n_lat, n_feat))

    mean = np.zeros(n_feat, np.float64)
    m2 = np.zeros(n_feat, np.float64)
    total_n = 0
    if start > 0:
        # Stats of the kept prefix, recomputed from disk.
        for t0 in range(0, start, time_chunk):
            t1 = min(t0 + time_chunk, start)
            block = np.nan_to_num(
                np.asarray(fp[t0:t1], np.float64), nan=0.0
            ).reshape(-1, n_feat)
            mean, m2, total_n = _welford_combine(
                mean, m2, total_n,
                block.sum(0), (block * block).sum(0), block.shape[0],
            )

    for t0 in range(start, n_time, time_chunk):
        t1 = min(t0 + time_chunk, n_time)
        b_sum = np.zeros(n_feat, np.float64)
        b_sumsq = np.zeros(n_feat, np.float64)
        for j, name in enumerate(variables):
            arr = source.read(name, t0, t1)       # [T, n_lon, n_lat]
            assert arr.shape == (t1 - t0, n_lon, n_lat), (
                name, arr.shape, (t1 - t0, n_lon, n_lat)
            )
            s = scale_factors.get(name)
            if s is not None:
                arr = arr * s
            fp[t0:t1, :, :, j] = arr.astype(np.float16)
            arr64 = np.nan_to_num(arr.astype(np.float64), nan=0.0)
            b_sum[j] = arr64.sum()
            b_sumsq[j] = (arr64 * arr64).sum()
        fp.flush()
        mean, m2, total_n = _welford_combine(
            mean, m2, total_n, b_sum, b_sumsq,
            (t1 - t0) * n_lon * n_lat,
        )
        save_resume_state(out_dir, t1, time_chunk)

    fp.flush()
    del fp

    std = np.sqrt(m2 / max(total_n, 1))
    std = np.maximum(std, 1e-6)
    np.savez(os.path.join(out_dir, "scalers.npz"),
             mean=mean.astype(np.float32), std=std.astype(np.float32),
             n=np.array(total_n))
    np.savez(os.path.join(out_dir, "coords.npz"),
             latitude=np.asarray(source.latitude, np.float32),
             longitude=np.asarray(source.longitude, np.float32))
    with open(os.path.join(out_dir, "variables.json"), "w") as f:
        json.dump(variables, f)
    with open(os.path.join(out_dir, "dataset_info.json"), "w") as f:
        json.dump({
            "n_time": n_time, "n_lon": n_lon, "n_lat": n_lat,
            "n_feat": n_feat, "flat": False, "dtype": "float16",
            "file": "data.npy", "variables": variables,
            "time_start": time_start, "time_end": time_end,
        }, f)
    progress = os.path.join(out_dir, "progress.json")
    if os.path.exists(progress):
        os.remove(progress)   # complete build: no resume marker
    return out_dir


# ------------------------------------------------------------- gated openers
def _require(modules: Sequence[str], purpose: str):
    missing = []
    for m in modules:
        try:
            __import__(m)
        except ImportError:
            missing.append(m)
    if missing:
        raise RuntimeError(
            f"{purpose} requires {missing} and network access to public "
            "cloud datasets; this environment is zero-egress. The full "
            "transform pipeline (WB2Source/RegionSource -> "
            "stream_build_dataset) is implemented and tested offline — "
            "run this entry point on a networked machine, or use "
            "data.synthetic.generate_synthetic_dataset for format-"
            "identical offline data."
        )


def open_wb2(url: str, time_start: str, time_end: str):
    """Open a WeatherBench2 zarr store (anonymous GCS) time-sliced —
    the ONLY network step of the WB2 builders."""
    _require(["xarray", "gcsfs"], "WeatherBench2 acquisition")
    import gcsfs
    import xarray as xr

    fs = gcsfs.GCSFileSystem(token="anon")
    ds = xr.open_zarr(fs.get_mapper(url), consolidated=True)
    return ds.sel(time=slice(time_start, time_end))


def open_arco(time_start: str, time_end: str, hour_stride: int = 6):
    """Open ARCO ERA5 (hourly 0.25°), subsampled to the 6h cadence."""
    _require(["xarray", "gcsfs"], "ARCO ERA5 acquisition")
    import gcsfs
    import xarray as xr

    fs = gcsfs.GCSFileSystem(token="anon")
    ds = xr.open_zarr(fs.get_mapper(ARCO_ERA5_URL), consolidated=True)
    ds = ds.sel(time=slice(time_start, time_end))
    return ds.isel(time=slice(0, None, hour_stride))


def open_cds_netcdf(paths: Sequence[str]):
    """Open CDS-downloaded netcdf files (the reference's build_region_cds
    downloads monthly .nc via the cdsapi client first)."""
    _require(["xarray"], "CDS regional acquisition")
    import xarray as xr

    return xr.open_mfdataset(list(paths), combine="by_coords")


# ------------------------------------------------------------------ builders
def build_dataset_wb2(
    out_dir: str,
    url: str = WB2_64X32_URL,
    variables: Optional[Sequence[str]] = None,
    time_start: str = "2010-01-01",
    time_end: str = "2021-12-31",
    time_chunk: int = 500,
    resume: bool = False,
    open_fn=None,
) -> str:
    """WB2 zarr -> chunked dataset (64x32 by default; pass
    ``url=WB2_512X256_URL`` or use ``build_dataset_512x256``).
    ``open_fn(url, t0, t1)`` overrides the network opener (tests)."""
    ds = (open_fn or open_wb2)(url, time_start, time_end)
    src = WB2Source(ds, variables)
    return stream_build_dataset(src, out_dir, time_chunk, resume,
                                time_start=time_start, time_end=time_end)


def build_dataset_512x256(
    out_dir: str,
    time_start: str = "2010-01-01",
    time_end: str = "2021-12-31",
    time_chunk: int = 500,
    resume: bool = False,
    open_fn=None,
) -> str:
    """The flagship 0.7° global 19-variable dataset
    (reference build_dataset_512x256.py)."""
    return build_dataset_wb2(
        out_dir, url=WB2_512X256_URL, variables=CANONICAL_19_VARIABLES,
        time_start=time_start, time_end=time_end,
        time_chunk=time_chunk, resume=resume, open_fn=open_fn,
    )


def build_region_arco(
    out_dir: str,
    area: Sequence[float],          # lat_min, lat_max, lon_min, lon_max
    variables: Optional[Sequence[str]] = None,
    time_start: str = "2020-01-01",
    time_end: str = "2023-12-31",
    time_chunk: int = 200,
    resume: bool = False,
    open_fn=None,
) -> str:
    """0.25° regional cut from ARCO ERA5 (reference build_region_arco.py)."""
    ds = (open_fn or (lambda a, t0, t1: open_arco(t0, t1)))(
        None, time_start, time_end
    )
    src = RegionSource(WB2Source(ds, variables), *area)
    return stream_build_dataset(src, out_dir, time_chunk, resume,
                                time_start=time_start, time_end=time_end)


def build_region_cds(
    out_dir: str,
    area: Sequence[float],
    nc_paths: Optional[Sequence[str]] = None,
    variables: Optional[Sequence[str]] = None,
    time_chunk: int = 200,
    resume: bool = False,
    open_fn=None,
) -> str:
    """0.25° regional dataset from Copernicus CDS downloads (reference
    build_region_cds.py; the cdsapi download itself happens upstream —
    point ``nc_paths`` at the retrieved monthly files)."""
    if open_fn is not None:
        ds = open_fn(nc_paths)
    else:
        if not nc_paths:
            _require(["cdsapi", "xarray"], "CDS regional acquisition")
            raise RuntimeError(
                "pass nc_paths to the CDS files downloaded via cdsapi"
            )
        ds = open_cds_netcdf(nc_paths)
    src = RegionSource(WB2Source(ds, variables), *area)
    return stream_build_dataset(src, out_dir, time_chunk, resume)


# ----------------------------------------------------------------------- CLI
def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="graphcast_lite_torch.data.remote",
        description="Dataset acquisition builders (network required).",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--out", required=True)
        p.add_argument("--start", default="2010-01-01")
        p.add_argument("--end", default="2021-12-31")
        p.add_argument("--time-chunk", type=int, default=500)
        p.add_argument("--resume", action="store_true")
        p.add_argument("--variables", nargs="*", default=None)

    p = sub.add_parser("build-wb2", help="WB2 64x32 global")
    common(p)
    p.add_argument("--url", default=WB2_64X32_URL)
    p = sub.add_parser("build-512x256", help="WB2 0.7 deg global 19f")
    common(p)
    p = sub.add_parser("build-region-arco", help="ARCO 0.25 deg region")
    common(p)
    p.add_argument("--area", type=float, nargs=4, required=True,
                   metavar=("LAT_MIN", "LAT_MAX", "LON_MIN", "LON_MAX"))
    p = sub.add_parser("build-region-cds", help="CDS 0.25 deg region")
    common(p)
    p.add_argument("--area", type=float, nargs=4, required=True)
    p.add_argument("--nc", nargs="+", required=True,
                   help="netcdf files downloaded via cdsapi")

    args = ap.parse_args(argv)
    if args.cmd == "build-wb2":
        build_dataset_wb2(args.out, url=args.url, variables=args.variables,
                          time_start=args.start, time_end=args.end,
                          time_chunk=args.time_chunk, resume=args.resume)
    elif args.cmd == "build-512x256":
        build_dataset_512x256(args.out, time_start=args.start,
                              time_end=args.end,
                              time_chunk=args.time_chunk,
                              resume=args.resume)
    elif args.cmd == "build-region-arco":
        build_region_arco(args.out, args.area, variables=args.variables,
                          time_start=args.start, time_end=args.end,
                          time_chunk=args.time_chunk, resume=args.resume)
    elif args.cmd == "build-region-cds":
        build_region_cds(args.out, args.area, nc_paths=args.nc,
                         variables=args.variables,
                         time_chunk=args.time_chunk, resume=args.resume)
    print(f"[remote] dataset complete: {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
