"""The operational layer in the port against the JAX package, on the CPU.

* A runtime bundle exported by the JAX package (``params.msgpack``) runs
  in the port's ``run_live_forecast``: the predictions against the JAX
  package's live forecast on the same injected, seeded ``fetch_fn`` at
  rtol 1e-4 (of the largest physical value per channel), the static
  channel equal to the bundle's template.
* The port's own export of an experiment with ``best_model.pt`` writes
  ``params.pt`` and loads back; its forecast equals a direct
  ``rollout_predict`` of the same frames and weights bitwise.
* ``interp_to_nodes`` and ``extract_live_channels`` on synthetic
  ``GribField``s, ``_assemble_frame`` and the markdown summary: equal to
  the JAX package's.  The map needs matplotlib (skipped without it).
"""

import datetime
import json
import os

import numpy as np
import pytest
import torch

from torch_port_common import one_torch_thread  # noqa: F401 (autouse)

BASE = datetime.datetime(2026, 1, 1, 0)
LIVE_RTOL = 1e-4


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """``small_experiment`` (ConvGCN 16 x 8, a static channel) with the
    JAX package's random-init params and named variables."""
    import jax

    from graphcast_lite_tpu.training.checkpoint import save_params
    from test_training import small_experiment

    tmp_path = tmp_path_factory.mktemp("operational")
    cfg, model, graphs, _, _, _, meta = small_experiment(
        tmp_path, n_feat=5, static=(3,), forcing=())
    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "config.json").write_text(cfg.model_dump_json())
    with open(tmp_path / "data" / "variables.json", "w") as f:
        json.dump(["t2m", "10u", "10v", "lsm", "sp"], f)
    dummy = np.zeros((128, 10), np.float32)
    save_params(str(exp / "best_model.msgpack"),
                model.init(jax.random.PRNGKey(1), dummy, graphs))
    return tmp_path, str(exp), str(tmp_path / "data")


def _fetch(bundle, seed=0):
    rng = np.random.RandomState(seed)

    def fetch(cycle):
        return {name: bundle.mean[i]
                + bundle.std[i] * rng.randn(bundle.num_nodes).astype(
                    np.float32)
                for i, name in enumerate(bundle.variables)}

    return fetch


def test_live_forecast_on_a_jax_bundle(experiment):
    from graphcast_lite_tpu.operational.bundle import \
        export_runtime_bundle as jax_export
    from graphcast_lite_tpu.operational.live import \
        run_live_forecast as jax_live
    from graphcast_lite_torch.operational.bundle import load_runtime_bundle
    from graphcast_lite_torch.operational.live import run_live_forecast

    tmp_path, exp, data = experiment
    bundle_dir = jax_export(exp, data, str(tmp_path / "jax_bundle"))
    bundle = load_runtime_bundle(bundle_dir)
    assert bundle.params_path.endswith("params.msgpack")
    assert bundle.num_nodes == 128 and bundle.static_values.shape == (128, 1)
    ref = jax_live(bundle_dir, _fetch(bundle), ar_steps=3, base_time=BASE)
    fc = run_live_forecast(bundle_dir, _fetch(bundle), ar_steps=3,
                           base_time=BASE, device="cpu")
    assert fc.predictions_phys.shape == (128, 3, 5)
    assert fc.valid_times == ref.valid_times and fc.variables == \
        ref.variables
    scale = np.abs(ref.predictions_phys).max(axis=(0, 1))
    err = np.abs(fc.predictions_phys - ref.predictions_phys).max(axis=(0, 1))
    assert (err <= LIVE_RTOL * scale).all(), (err, scale)
    np.testing.assert_allclose(
        fc.predictions_phys[:, 0, 3],
        bundle.static_values[:, 0] * bundle.std[3] + bundle.mean[3],
        rtol=1e-5)


def test_port_bundle_round_trip(experiment, monkeypatch):
    """``export_runtime_bundle`` of an experiment holding the port's
    ``best_model.pt``: ``params.pt`` loads back, the forecast equals a
    direct ``rollout_predict`` of the same frames bitwise (fp32), and
    without a card the forecast raises unless asked for the CPU."""
    from graphcast_lite_tpu.operational.live import \
        render_summary_markdown as jax_md
    from graphcast_lite_torch.build import build_weather_model
    from graphcast_lite_torch.config import load_experiment_config
    from graphcast_lite_torch.data.dataset import load_chunked_datasets
    from graphcast_lite_torch.operational.bundle import \
        export_runtime_bundle, load_runtime_bundle
    from graphcast_lite_torch.operational.live import _assemble_frame, \
        render_summary_markdown, run_live_forecast
    from graphcast_lite_torch.training.rollout import RolloutSpec, \
        rollout_predict

    tmp_path, exp, data = experiment
    pexp = tmp_path / "port_exp"
    pexp.mkdir()
    cfg_text = open(os.path.join(exp, "config.json")).read()
    (pexp / "config.json").write_text(cfg_text)
    cfg = load_experiment_config(str(pexp / "config.json"))
    _, _, _, meta = load_chunked_datasets(data, obs_window=2, pred_steps=1,
                                          n_features=5)
    model, graphs, _ = build_weather_model(cfg, meta, device="cpu", seed=5)
    torch.save(model.state_dict(), str(pexp / "best_model.pt"))
    bundle_dir = export_runtime_bundle(str(pexp), data,
                                       str(tmp_path / "port_bundle"))
    assert sorted(os.listdir(bundle_dir)) == [
        "config.json", "coords.npz", "dataset_info.json", "params.pt",
        "scalers.npz", "static_fields.npz", "variables.json"]
    bundle = load_runtime_bundle(bundle_dir)
    assert bundle.params_path.endswith("params.pt")
    from graphcast_lite_tpu.operational.live import \
        _assemble_frame as jax_frame

    fetch = _fetch(bundle, 2)
    frames = [fetch(i) for i in range(2)]
    del frames[0]["10v"]                    # a channel the analysis lacks
    window = np.stack([_assemble_frame(f, bundle) for f in frames], axis=1)
    np.testing.assert_array_equal(window[:, 0],
                                  jax_frame(frames[0], bundle))
    spec = RolloutSpec(obs_window=2, num_features=5, remat=False,
                       use_residual=cfg.use_residual,
                       static_channels=tuple(bundle.static_channels))
    with torch.inference_mode():
        preds = rollout_predict(lambda x, m, t, p: model(x, graphs, m),
                                torch.from_numpy(window), 2, spec).numpy()
    fc = run_live_forecast(bundle_dir, lambda i: frames[i], ar_steps=2,
                           base_time=BASE, device="cpu")
    np.testing.assert_array_equal(
        fc.predictions_phys, preds * bundle.std + bundle.mean)

    md = render_summary_markdown(fc, "TestCity", 10.0, 50.0)
    assert md == jax_md(fc, "TestCity", 10.0, 50.0)
    assert "TestCity" in md and "2026-01-01" in md

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_live_forecast(bundle_dir, fetch, ar_steps=1)


def test_grib_transforms_match_jax():
    from graphcast_lite_tpu.operational import live as jl
    from graphcast_lite_torch.operational import live as tl

    rng = np.random.RandomState(3)
    lats = np.linspace(80, -80, 17)                 # descending, as GRIB
    lons = np.arange(-180.0, 180.0, 30.0)           # -180..180 convention
    node_lats = rng.uniform(-85, 85, 50)
    node_lons = rng.uniform(-30, 400, 50)

    def field(v=None):
        vals = rng.randn(lats.size, lons.size) if v is None else \
            np.full((lats.size, lons.size), v)
        return vals.astype(np.float32)

    values = field()
    np.testing.assert_array_equal(
        tl.interp_to_nodes(tl.GribField(lats, lons, values), node_lats,
                           node_lons),
        jl.interp_to_nodes(jl.GribField(lats, lons, values), node_lats,
                           node_lons))

    raw = {"t2m": {"2t": field()}, "sp": {"pres": field(98000.0)},
           "msl": {"prmsl": field()},
           "isobaric_t": {"t": {850: field(), 500: field()}},
           "isobaric_z": {"gh": {500: field()}}}
    var_order = ["t2m", "sp", "msl", "t@850", "t@500", "z@500", "z@850",
                 "tp", "lsm", "weird"]
    template = {"lsm": rng.rand(50).astype(np.float32)}

    def payload(cls):
        return {g: {k: ({lev: cls(lats, lons, f) for lev, f in v.items()}
                        if isinstance(v, dict) else cls(lats, lons, v))
                    for k, v in grp.items()} for g, grp in raw.items()}

    port, port_w = tl.extract_live_channels(
        payload(tl.GribField), node_lats, node_lons, var_order, template)
    ref, ref_w = jl.extract_live_channels(
        payload(jl.GribField), node_lats, node_lons, var_order, template)
    assert port_w == ref_w and list(port) == list(ref)
    for name in ref:
        np.testing.assert_array_equal(port[name], ref[name], err_msg=name)


def test_render_t2m_map(tmp_path):
    pytest.importorskip("matplotlib")
    from graphcast_lite_torch.operational.live import LiveForecast, \
        render_summary_markdown, render_t2m_map

    fc = LiveForecast(
        predictions_phys=np.random.RandomState(0).randn(128, 2, 3)
        .astype(np.float32) + 280,
        valid_times=[BASE + datetime.timedelta(hours=6 * (i + 1))
                     for i in range(2)],
        variables=["t2m", "10u", "10v"],
        latitude=np.linspace(-80, 80, 8), longitude=np.linspace(0, 350, 16))
    path = render_t2m_map(fc, str(tmp_path / "t2m.png"), step=1,
                          city_name="X", city_lat=10.0, city_lon=50.0)
    assert path is not None and os.path.getsize(path) > 1000
    (tmp_path / "maps").mkdir()
    md = render_summary_markdown(fc, out_path=str(tmp_path / "s.md"),
                                 map_path=str(tmp_path / "maps" / "m.png"))
    assert "![t2m map](maps/m.png)" in md
