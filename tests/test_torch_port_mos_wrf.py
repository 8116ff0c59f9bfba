"""Learned MOS (``postprocessing.mos_training``, ``cli.build_learned_mos``)
and the WRF comparison (``cli.compare_wrf``) in the port against the JAX
package, on the CPU.

* ``build_feature_matrix`` is bitwise the JAX one on
  ``tests/test_mos_training.py``'s station history.
* ``train_learned_mos`` in both packages gives the same split counts, the
  same test MAE / RMSE, raw and static-MOS MAE (within 1e-9), the same
  static table and the same predictions; the port's bundle, written by
  joblib, goes through the port's ``load_learned_mos`` +
  ``apply_learned_mos_t2m`` to the JAX apply's output of the JAX bundle.
  ``cli.build_learned_mos.main`` prints the same report in both.  The
  whole module runs inside ``threadpoolctl.threadpool_limits(1)``, every
  HistGradientBoostingRegressor fit and prediction with it: under several
  test workers their OpenMP threads oversubscribe the cores, and a 0.3 s
  fit takes minutes (the bundle's apply took 83 s).
* Each ``compare_wrf`` function equals the JAX one on
  ``tests/test_compare_wrf.py``'s fixtures (``load_wrf`` also with an
  injected netCDF reader), ``main`` prints the same tables and writes the
  same report, and it reads the ``.npz`` that the port's
  ``evaluate_model(save_predictions=)`` writes.
"""

import datetime
import json
import os

import numpy as np
import pytest

pytest.importorskip("sklearn")
threadpoolctl = pytest.importorskip("threadpoolctl")

from graphcast_lite_tpu.cli import compare_wrf as jwrf  # noqa: E402
from graphcast_lite_tpu.postprocessing import mos_training as jmos  # noqa
from graphcast_lite_torch.cli import compare_wrf as pwrf  # noqa: E402
from graphcast_lite_torch.postprocessing import mos_training as pmos  # noqa
from test_compare_wrf import _fixture_wrf_json  # noqa: E402
from test_mos_training import _make_history  # noqa: E402
from torch_port_common import one_torch_thread  # noqa: E402,F401 (autouse)

METRIC_ATOL = 1e-9
METRICS = ("test_mae", "test_rmse", "era5_mae", "static_mos_mae")


@pytest.fixture(scope="module", autouse=True)
def one_openmp_thread():
    """One OpenMP thread for every fit and prediction of the module (an
    autouse fixture of module scope runs before ``bundles``)."""
    with threadpoolctl.threadpool_limits(1):
        yield


@pytest.mark.parametrize("days", [10, 120])
def test_feature_matrix_bitwise(days):
    h = _make_history(days=days, seed=days)
    got, expect = pmos.build_feature_matrix(h), jmos.build_feature_matrix(h)
    assert got.dtype == expect.dtype and got.shape == expect.shape
    np.testing.assert_array_equal(got, expect)
    assert pmos.FEATURE_COLUMNS == jmos.FEATURE_COLUMNS
    assert pmos._static_mos_table(h.times, got[:, 0]) \
        == jmos._static_mos_table(h.times, got[:, 0])


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """The port's bundle (also written by joblib) and the JAX package's,
    fitted on the same two stations."""
    out = str(tmp_path_factory.mktemp("mos") / "port.joblib")
    stations = [_make_history(),
                _make_history("S2", lat=55.5, lon=93.5, elev=150.0, seed=3)]
    return (pmos.train_learned_mos(stations, output_path=out),
            jmos.train_learned_mos(stations), out, stations)


def test_train_learned_mos_equals_jax(bundles):
    from threadpoolctl import threadpool_info

    assert all(p["num_threads"] == 1 for p in threadpool_info()
               if p["user_api"] == "openmp")
    port, jax, _, stations = bundles
    for key in ("n_train", "n_test", "feature_columns", "stations_trained",
                "period", "split", "static_mos_table"):
        assert port[key] == jax[key], key
    for key in METRICS:
        assert abs(port[key] - jax[key]) <= METRIC_ATOL, key
    x = np.concatenate([pmos.build_feature_matrix(h) for h in stations])
    x = np.nan_to_num(x)
    np.testing.assert_array_equal(port["model"].predict(x),
                                  jax["model"].predict(x))
    assert port["test_mae"] < 0.5 * port["era5_mae"]


def test_port_bundle_through_the_port_apply(bundles):
    from graphcast_lite_tpu.postprocessing.corrections import \
        apply_learned_mos_t2m as japply
    from graphcast_lite_torch.postprocessing.corrections import \
        apply_learned_mos_t2m, load_learned_mos

    port, jax, path, stations = bundles
    loaded = load_learned_mos(path)
    assert loaded["feature_columns"] == pmos.FEATURE_COLUMNS
    lats = np.repeat(np.array([55.0, 56.0, 57.0]), 3)
    lons = np.tile(np.array([91.7, 92.7, 93.7]), 3)
    var_order = ["t2m", "10u", "10v", "sp"]
    times = [datetime.datetime(2024, 6, 1, hh) for hh in (0, 6, 12, 18)]
    rng = np.random.RandomState(5)
    pred = np.zeros((9, 4, 4), np.float32)
    pred[:, :, 0] = 278.0 + 6.0 * rng.randn(9, 4)
    pred[:, :, 1:3] = rng.randn(9, 4, 2)
    pred[:, :, 3] = 98000.0 + 300 * rng.randn(9, 4)
    st = [{"lat": h.lat, "lon": h.lon, "elev": h.elev, "name": h.station_id}
          for h in stations]
    for idw in (False, True):
        got, n = apply_learned_mos_t2m(pred, var_order, loaded, lats, lons,
                                       times, stations=st, spatial_idw=idw)
        expect, m = japply(pred, var_order, jax, lats, lons, times,
                           stations=st, spatial_idw=idw)
        assert n == m and n >= 2
        np.testing.assert_array_equal(got, expect)
        assert not np.array_equal(got, pred)


def test_build_learned_mos_cli(tmp_path, capsys):
    import joblib

    from graphcast_lite_tpu.cli.build_learned_mos import main as jmain
    from graphcast_lite_torch.cli.build_learned_mos import main

    h = _make_history()
    cols = sorted(h.era5.keys())
    hist = str(tmp_path / "stations.npz")
    np.savez(hist, stations=np.array(["S1"]), era5_columns=np.array(cols),
             times_S1=np.array([t.timestamp() for t in h.times]),
             era5_S1=np.stack([h.era5[c] for c in cols], axis=1),
             obs_S1=h.station_t2m_c, meta_S1=np.array([h.lat, h.lon, h.elev]))
    texts, outs = [], []
    for fn, name in ((main, "port"), (jmain, "jax")):
        out = str(tmp_path / f"{name}.joblib")
        assert fn(["--history", hist, "--output", out, "--max-iter",
                   "100"]) == 0
        texts.append(capsys.readouterr().out.replace(out, "OUT"))
        outs.append(joblib.load(out))
    assert texts[0] == texts[1] and "learned MOS MAE" in texts[0]
    assert outs[0]["stations_trained"] == ["S1"]
    for key in METRICS:
        assert abs(outs[0][key] - outs[1][key]) <= METRIC_ATOL, key


# ---- compare_wrf ---------------------------------------------------------

def test_wrf_loaders_equal(tmp_path):
    hourly = 250.0 + np.arange(25, dtype=np.float32)
    path = _fixture_wrf_json(tmp_path, hourly)
    (tmp_path / "short").mkdir()
    short = _fixture_wrf_json(tmp_path / "short", hourly[:4])
    for p in (path, short):
        got, expect = pwrf.load_wrf_json(p), jwrf.load_wrf_json(p)
        assert list(got) == list(expect)
        for k in got:
            np.testing.assert_array_equal(got[k], expect[k])
        assert set(pwrf.load_wrf(p)) == set(expect)
    fields = {
        "T2": 250.0 + np.arange(25 * 16, dtype=np.float32).reshape(25, 4, 4),
        "PSFC": np.full((25, 4, 4), 98000.0, np.float32),
        "U10": np.ones((7, 2, 3), np.float32),
    }
    got = pwrf.load_wrf("dummy.nc", open_netcdf=lambda p: fields)
    expect = jwrf.load_wrf("dummy.nc", open_netcdf=lambda p: fields)
    assert list(got) == list(expect) == ["t2m", "10u", "sp"]
    for k in got:
        np.testing.assert_array_equal(got[k], expect[k])
    assert pwrf.VAR_MAPPING == jwrf.VAR_MAPPING


def _comparison_fixture(tmp_path):
    """``test_full_comparison_fixture``'s fields: (node lats, node lons,
    normalized pred, truth, mean, std, var names, WRF json path)."""
    rng = np.random.RandomState(0)
    lats = np.linspace(55.0, 57.0, 8).astype(np.float32)
    lons = np.linspace(91.0, 95.0, 12).astype(np.float32)
    lon2d, lat2d = np.meshgrid(lons, lats)
    g, c, p_steps, n = 96, 4, 4, 3
    mean = np.array([260.0, 0.0, 0.0, 970.0], np.float32)
    std = np.array([10.0, 2.0, 2.0, 15.0], np.float32)
    truth = np.stack([260.0 + rng.randn(n, g, p_steps),
                      rng.randn(n, g, p_steps), rng.randn(n, g, p_steps),
                      970.0 + rng.randn(n, g, p_steps)],
                     axis=-1).astype(np.float32)
    pred = truth + 0.1 * rng.randn(*truth.shape).astype(np.float32)

    def norm(a):
        return ((a - mean) / std).reshape(n, g, p_steps * c)

    hourly = 262.0 + rng.randn(25).astype(np.float32)
    return (lat2d.ravel(), lon2d.ravel(), lats, lons, norm(pred),
            norm(truth), mean, std, ["t2m", "10u", "10v", "sp"],
            _fixture_wrf_json(tmp_path, hourly))


def test_comparison_functions_equal(tmp_path):
    node_lats, node_lons, _, _, pred, truth, mean, std, names, wrf = \
        _comparison_fixture(tmp_path)
    mask = pwrf.domain_mask(node_lats, node_lons)
    np.testing.assert_array_equal(mask, jwrf.domain_mask(node_lats,
                                                         node_lons))
    assert mask.any() and not mask.all()
    got = pwrf.domain_means(pred, truth, mask, mean, std, 4)
    expect = jwrf.domain_means(pred, truth, mask, mean, std, 4)
    for a, b in zip(got, expect):
        np.testing.assert_array_equal(a, b)
    assert pwrf.compute_metrics(got[0].ravel(), got[1].ravel()) \
        == jwrf.compute_metrics(got[0].ravel(), got[1].ravel())
    wrf_data = pwrf.load_wrf(wrf)
    for sample in (None, 1, 7):
        res = pwrf.build_comparison(*got, names, wrf_data, sample)
        ref = jwrf.build_comparison(*expect, names, wrf_data, sample)
        assert res == ref
        text = pwrf.render_tables(res)
        assert text == jwrf.render_tables(ref)
        assert ("WRF vs ERA5 vs Ours" in text) == (sample == 1)


def _data_dir(path, lats, lons, mean, std, names):
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "scalers.npz"), mean=mean, std=std)
    np.savez(os.path.join(path, "coords.npz"), latitude=lats,
             longitude=lons)
    with open(os.path.join(path, "dataset_info.json"), "w") as f:
        json.dump({"variables": names}, f)
    return path


def test_compare_wrf_main_equal(tmp_path, capsys):
    _, _, lats, lons, pred, truth, mean, std, names, wrf = \
        _comparison_fixture(tmp_path)
    preds = str(tmp_path / "preds.npz")
    np.savez(preds, predictions=pred, ground_truth=truth, n_features=4)
    data = _data_dir(str(tmp_path / "data"), lats, lons, mean, std, names)
    reports = []
    for main, name in ((pwrf.main, "port"), (jwrf.main, "jax")):
        report = str(tmp_path / f"{name}.json")
        main(["--predictions", preds, "--data-dir", data, "--wrf-path", wrf,
              "--wrf-sample", "1", "--report-json", report])
        with open(report) as f:
            reports.append(json.load(f))
        text = capsys.readouterr().out
        reports.append(text.replace(report, "REPORT"))
    assert reports[0] == reports[2] and reports[1] == reports[3]
    assert "WRF vs ERA5 vs Ours (sample #1)" in reports[1]


def test_compare_wrf_reads_the_port_predictions(tmp_path, capsys):
    """The port's ``evaluate_model(save_predictions=)`` writes the keys
    ``main`` reads; its domain means equal a direct NumPy computation."""
    from graphcast_lite_torch.build import build_weather_model
    from graphcast_lite_torch.data.dataset import load_chunked_datasets
    from graphcast_lite_torch.data.synthetic import \
        generate_synthetic_dataset
    from graphcast_lite_torch.inference.predict import evaluate_model
    from torch_port_common import N_FEAT, small_configs

    data = generate_synthetic_dataset(str(tmp_path / "data"), n_time=12,
                                      n_feat=N_FEAT, seed=1)
    with open(os.path.join(data, "dataset_info.json")) as f:
        info = json.load(f)
    info["variables"] = ["t2m", "10u", "10v", "sp", "tp"]
    with open(os.path.join(data, "dataset_info.json"), "w") as f:
        json.dump(info, f)
    _, _, test_ds, meta = load_chunked_datasets(
        data, obs_window=2, pred_steps=2, n_features=N_FEAT,
        test_split="test")
    _, cfg = small_configs()
    model, graphs, _ = build_weather_model(cfg, meta, device="cpu")
    preds = str(tmp_path / "preds.npz")
    evaluate_model(model, graphs, test_ds, meta, ar_steps=2, device="cpu",
                   max_samples=2, save_predictions=preds)
    bundle = np.load(preds)
    assert {"predictions", "ground_truth", "n_features"} <= set(bundle.files)
    bounds = ["-30", "30", "40", "100"]
    report = str(tmp_path / "report.json")
    pwrf.main(["--predictions", preds, "--data-dir", data, "--bounds",
               *bounds, "--report-json", report])
    assert "OUR MODEL metrics" in capsys.readouterr().out
    with open(report) as f:
        result = json.load(f)

    sc, co = np.load(os.path.join(data, "scalers.npz")), \
        np.load(os.path.join(data, "coords.npz"))
    lon2d, lat2d = np.meshgrid(co["longitude"], co["latitude"])
    lat, lon = lat2d.ravel(), lon2d.ravel()
    mask = (lat >= -30) & (lat <= 30) & (lon >= 40) & (lon <= 100)
    n, g = bundle["predictions"].shape[:2]
    phys = bundle["predictions"].reshape(n, g, 2, N_FEAT)[:, mask] \
        * sc["std"][:N_FEAT] + sc["mean"][:N_FEAT]
    truth = bundle["ground_truth"].reshape(n, g, 2, N_FEAT)[:, mask] \
        * sc["std"][:N_FEAT] + sc["mean"][:N_FEAT]
    diff = phys.mean(axis=1)[..., 0] - truth.mean(axis=1)[..., 0]
    assert result["ours"]["t2m"]["bias"] == pytest.approx(
        float(np.mean(diff)), rel=1e-6, abs=1e-9)
    assert set(result["ours"]) == {"t2m", "10u", "10v", "sp"}
