"""Data assimilation in the port against the JAX package, on the CPU.

* The sparse-station observations, nudging, the taper masks and the
  post-processing corrections are NumPy copies: bitwise equal.
* Optimal interpolation solves in float32 (``torch.linalg.solve`` here,
  ``jnp.linalg.solve`` there) on the small grid, with and without an ROI:
  |port − jax| ≤ 1e-4 · max|x_a − x_b|, and both within the same bound of
  a float64 solve of the same system; channels grouped by observation
  pattern equal per-channel solves.
* ``evaluate_model`` with a nudging hook, ``postprocess`` and
  ``skip_samples``, with an OI hook, and a direct two-step model with
  offline DA: each report against the JAX package's at rtol 1e-4 (the
  small lazy InteractionNet under ``GCLT_LAZY_EDGE=1``).
* ``cli.predict --da nudging`` and ``--da oi --obs-roi-only --region``
  with the nine DA flags: each report JSON against the JAX CLI's on the
  same experiment directory and JAX ``best_model.msgpack``.
"""

import json
import os
from datetime import datetime

import numpy as np
import pytest

from graphcast_lite_torch.data.synthetic import generate_synthetic_dataset
from torch_port_common import N_FEAT, flax_numpy, one_torch_thread, \
    small_configs  # noqa: F401 (one_torch_thread: an autouse fixture)

STATIC = [1]
# Region of the ROI cases (the README's, 20-60 N, 60-140 E).
ROI = (20.0, 60.0, 60.0, 140.0)
# OI: the port's analysis increment within OI_RTOL of its largest value.
OI_RTOL = 1e-4
REPORT_RTOL = 1e-4


def _grid():
    lats = np.linspace(-40.0, 40.0, 9)
    lons = np.linspace(0.0, 80.0, 11)
    return lats, lons


def test_observations_and_nudging_bitwise():
    from graphcast_lite_tpu.assimilation import nudging as jn
    from graphcast_lite_tpu.assimilation import observations as jo
    from graphcast_lite_torch.assimilation import nudging as tn
    from graphcast_lite_torch.assimilation import observations as to

    rng = np.random.RandomState(0)
    g, p, c = 99, 3, 4
    truth = rng.randn(g, p, c).astype(np.float32)
    roi = rng.rand(g) > 0.4
    for kw in ({}, {"roi_mask": roi}, {"channels": [0, 2]},
               {"roi_mask": roi, "channels": [1], "noise_std": 0.3,
                "seed": 5}):
        np.testing.assert_array_equal(
            to.make_sparse_observations(truth, 0.2, **kw),
            jo.make_sparse_observations(truth, 0.2, **kw))
    np.testing.assert_array_equal(
        to.sparse_observation_mask(g, 0.3, roi, seed=3),
        jo.sparse_observation_mask(g, 0.3, roi, seed=3))

    obs = jo.make_sparse_observations(truth, 0.3, seed=1)
    fmask = jn.feature_mask_from_indices([0, 3, 9], c)
    np.testing.assert_array_equal(
        tn.feature_mask_from_indices([0, 3, 9], c), fmask)
    np.testing.assert_array_equal(
        tn.feature_mask_from_names(list("abcd"), ["b", "z"]),
        jn.feature_mask_from_names(list("abcd"), ["b", "z"]))
    for alpha, fm in ((0.25, None), (0.7, fmask)):
        port = tn.NudgingAssimilator(alpha, fm)
        ref = jn.NudgingAssimilator(alpha, fm)
        np.testing.assert_array_equal(port.apply(truth[:, 0], obs[:, 1]),
                                      ref.apply(truth[:, 0], obs[:, 1]))
        hp, hj = port.make_step_hook(obs, k=2), ref.make_step_hook(obs, k=2)
        for step in range(4):
            np.testing.assert_array_equal(hp(truth[:, 0], step),
                                          hj(truth[:, 0], step))
    np.testing.assert_array_equal(tn.nudge_offline(truth, obs, 0.4),
                                  jn.nudge_offline(truth, obs, 0.4))
    for border in (0, 1, 3):
        np.testing.assert_array_equal(tn.cosine_taper_2d(7, 12, border),
                                      jn.cosine_taper_2d(7, 12, border))
        np.testing.assert_array_equal(tn.boundary_taper_mask(7, 12, border),
                                      jn.boundary_taper_mask(7, 12, border))


def _f64_analysis(oi, fc, obs):
    """The analysis with the solve in float64 on the host."""
    oi.solve = lambda a, rhs: np.linalg.solve(a, rhs)
    try:
        return oi.apply(fc.astype(np.float64), obs)
    finally:
        del oi.solve


@pytest.mark.parametrize("roi", [False, True])
def test_oi_matches_jax_and_float64(roi):
    from graphcast_lite_tpu.assimilation.optimal_interpolation import \
        OptimalInterpolation as JaxOI
    from graphcast_lite_torch.assimilation.optimal_interpolation import \
        OptimalInterpolation, haversine_matrix
    from graphcast_lite_tpu.assimilation.optimal_interpolation import \
        haversine_matrix as jax_haversine

    lats, lons = _grid()
    g = lats.size * lons.size
    rng = np.random.RandomState(1)
    roi_idx = np.flatnonzero(rng.rand(g) > 0.5) if roi else None
    kw = dict(sigma_b=1.0, sigma_o=0.3, length_scale_m=900e3,
              roi_idx=roi_idx)
    port = OptimalInterpolation(lats, lons, device="cpu", **kw)
    ref = JaxOI(lats, lons, **kw)
    np.testing.assert_array_equal(port.B, ref.B)
    coords = np.stack([rng.uniform(-80, 80, 7), rng.uniform(0, 360, 7)], 1)
    np.testing.assert_array_equal(haversine_matrix(coords, coords[:3]),
                                  jax_haversine(coords, coords[:3]))

    fc = rng.randn(g, 3).astype(np.float32)
    obs = np.full_like(fc, np.nan)
    sites = rng.choice(g if roi_idx is None else roi_idx, 20, replace=False)
    obs[sites] = fc[sites] + rng.randn(20, 3).astype(np.float32)
    out, expect = port.apply(fc, obs), ref.apply(fc, obs)
    f64 = _f64_analysis(port, fc, obs)
    assert out.dtype == np.float32
    scale = np.abs(f64 - fc).max()
    assert scale > 0.1
    err_jax = np.abs(out - expect).max()
    err_port, err_ref = np.abs(out - f64).max(), np.abs(expect - f64).max()
    print(f"OI (roi={roi}): increment {scale:.3f}; port-jax {err_jax:.2e}, "
          f"port-f64 {err_port:.2e}, jax-f64 {err_ref:.2e}")
    assert max(err_jax, err_port, err_ref) <= OI_RTOL * scale
    if roi_idx is not None:
        outside = np.setdiff1d(np.arange(g), roi_idx)
        np.testing.assert_array_equal(out[outside], fc[outside])


def test_oi_grouped_channels_match_per_channel_solve():
    from graphcast_lite_torch.assimilation.optimal_interpolation import \
        OptimalInterpolation

    rng = np.random.RandomState(0)
    lats = np.linspace(-10, 10, 6)
    lons = np.linspace(0, 10, 5)
    oi = OptimalInterpolation(lats, lons, 1.0, 0.3, 400_000.0, device="cpu")
    g, c = 30, 5
    fc = rng.randn(g, c).astype(np.float32)
    obs = np.full((g, c), np.nan, np.float32)
    obs[[3, 11, 22], 0:3] = rng.randn(3, 3)
    obs[[5, 17], 3] = rng.randn(2)
    out = oi.apply(fc, obs)
    expect = fc.astype(np.float64).copy()
    for ch in range(c):
        m = ~np.isnan(obs[:, ch])
        if m.any():
            expect[:, ch] = oi._analyze(fc[:, ch].astype(np.float64),
                                        obs[m, ch], np.flatnonzero(m))
    np.testing.assert_allclose(out, expect.astype(np.float32), atol=1e-5)
    np.testing.assert_array_equal(out[:, 4], fc[:, 4])


class _LinearMos:
    def predict(self, feats):
        return 0.01 * np.nan_to_num(feats).sum(axis=1)


def test_corrections_bitwise():
    from graphcast_lite_tpu.postprocessing import corrections as jc
    from graphcast_lite_torch.postprocessing import corrections as tc

    rng = np.random.RandomState(2)
    table = {"bias_table": {"1": {"6": -1.5}, "7": {"12": 0.8}}}
    times = [datetime(2024, 1, 5, 6), datetime(2024, 7, 5, 12)]
    var = ["10u", "t2m", "10v", "sp"]
    pred = rng.randn(40, 2, 4) + np.array([0, 280, 0, 1e5])
    np.testing.assert_array_equal(tc.apply_mos_t2m(pred, var, table, times),
                                  jc.apply_mos_t2m(pred, var, table, times))
    for t in times:
        assert tc.get_t2m_bias(table, t) == jc.get_t2m_bias(table, t)
        assert tc.solar_elevation(56.0, 92.5, t) \
            == jc.solar_elevation(56.0, 92.5, t)
        np.testing.assert_array_equal(
            tc.build_mos_features(pred[3, 0], var, t, 56.0, 92.0, 287.0,
                                  5.0),
            jc.build_mos_features(pred[3, 0], var, t, 56.0, 92.0, 287.0,
                                  5.0))
    lats, lons = rng.uniform(-60, 60, 40), rng.uniform(0, 40, 40)
    biases = {0: rng.randn(2), 7: rng.randn(2), 21: rng.randn(2)}
    np.testing.assert_array_equal(
        tc.idw_interpolate_bias(biases, lats, lons, 2, 1.5, 2000.0),
        jc.idw_interpolate_bias(biases, lats, lons, 2, 1.5, 2000.0))
    stations = [{"lat": float(lats[i]), "lon": float(lons[i]), "elev": 100.0}
                for i in (0, 7, 21)]
    for idw in (False, True):
        port = tc.apply_learned_mos_t2m(pred, var, {"model": _LinearMos()},
                                        lats, lons, times, stations,
                                        spatial_idw=idw,
                                        idw_max_radius_km=3000.0)
        ref = jc.apply_learned_mos_t2m(pred, var, {"model": _LinearMos()},
                                       lats, lons, times, stations,
                                       spatial_idw=idw,
                                       idw_max_radius_km=3000.0)
        np.testing.assert_array_equal(port[0], ref[0])
        assert port[1] == ref[1]
    z = rng.uniform(0, 3e4, (40, 2))
    np.testing.assert_array_equal(tc.geopotential_to_elevation(z),
                                  jc.geopotential_to_elevation(z))
    np.testing.assert_array_equal(
        tc.apply_lapse_rate(pred[:, :, 1], z[:, :1] / 9.8, z / 9.8),
        jc.apply_lapse_rate(pred[:, :, 1], z[:, :1] / 9.8, z / 9.8))
    taper = rng.rand(40)
    np.testing.assert_array_equal(tc.blend_boundary(pred, pred[::-1], taper),
                                  jc.blend_boundary(pred, pred[::-1], taper))


# ---- evaluate_model and cli.predict with DA --------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("da_data"))
    return generate_synthetic_dataset(d, n_time=30, n_feat=N_FEAT,
                                      static_channels=STATIC, seed=0)


def _pair(data_dir, direct_steps=1):
    """The small flagship architecture in both packages on the dataset's
    grid, JAX init bridged into the port; with each package's test split
    and metadata."""
    import jax

    from graphcast_lite_tpu.build import build_weather_model as jax_build
    from graphcast_lite_tpu.data.dataset import \
        load_chunked_datasets as jax_load
    from graphcast_lite_torch.build import build_weather_model
    from graphcast_lite_torch.data.dataset import load_chunked_datasets
    from graphcast_lite_torch.utils.params import from_flax_params

    jcfg, tcfg = small_configs()
    for cfg in (jcfg, tcfg):
        cfg.pipeline.decoder.gcn.output_dim = direct_steps * N_FEAT
    kw = dict(obs_window=2, pred_steps=4, n_features=N_FEAT)
    _, _, jtest, jmeta = jax_load(data_dir, **kw)
    jmodel, jgraphs, jgs = jax_build(jcfg, jmeta)
    dummy = np.zeros((jgs.num_grid_nodes, 2 * N_FEAT), np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), dummy, jgraphs)
    _, _, test_ds, meta = load_chunked_datasets(data_dir, **kw)
    model, graphs, _ = build_weather_model(tcfg, meta, device="cpu")
    model.load_state_dict(from_flax_params(flax_numpy(params)))
    return (jmodel, params, jgraphs, jtest, jmeta), \
        (model, graphs, test_ds, meta)


def _per_sample_hook(test_ds, da_obj, skip=0, sparsity=0.3):
    """Stations regenerated from each sample's truth at its step 0 (the
    CLI's hook)."""
    from graphcast_lite_torch.assimilation.observations import \
        make_sparse_observations

    state = {"i": skip - 1, "hook": None}

    def hook(out, step):
        if step == 0:
            state["i"] += 1
            _, y = test_ds.get(state["i"])
            obs = make_sparse_observations(
                y.reshape(-1, y.shape[-1] // N_FEAT, N_FEAT), sparsity,
                seed=state["i"])
            state["hook"] = da_obj.make_step_hook(obs)
        return state["hook"](out, step)

    return hook


def _assert_reports(port, ref):
    port = port if isinstance(port, dict) else port.to_json()
    ref = ref if isinstance(ref, dict) else ref.to_json()
    assert port["num_samples"] == ref["num_samples"] >= 2
    for name in ("rmse", "mae", "acc", "baseline_rmse", "skill"):
        np.testing.assert_allclose(port[name], ref[name], rtol=REPORT_RTOL,
                                   err_msg=name)
    assert len(port["per_horizon"]) == len(ref["per_horizon"])
    for hp, hj in zip(port["per_horizon"], ref["per_horizon"]):
        for name in ("rmse", "baseline_rmse", "skill", "acc"):
            np.testing.assert_allclose(hp[name], hj[name],
                                       rtol=REPORT_RTOL, err_msg=name)
    np.testing.assert_allclose(port["per_channel_rmse"],
                               ref["per_channel_rmse"], rtol=REPORT_RTOL)
    if ref.get("region"):
        np.testing.assert_allclose(port["region"]["rmse"],
                                   ref["region"]["rmse"], rtol=REPORT_RTOL)


def test_evaluate_model_hooks_match_jax(data_dir, monkeypatch):
    """Nudging fed back into the window with ``postprocess`` and
    ``skip_samples``; OI fed back; a direct two-step model with offline
    nudging."""
    from graphcast_lite_tpu.assimilation.nudging import \
        NudgingAssimilator as JaxNudging
    from graphcast_lite_tpu.assimilation.optimal_interpolation import \
        OptimalInterpolation as JaxOI
    from graphcast_lite_tpu.inference.predict import \
        evaluate_model as jax_evaluate
    from graphcast_lite_torch.assimilation.nudging import NudgingAssimilator
    from graphcast_lite_torch.assimilation.optimal_interpolation import \
        OptimalInterpolation
    from graphcast_lite_torch.inference.predict import evaluate_model

    monkeypatch.setenv("GCLT_LAZY_EDGE", "1")
    (jmodel, params, jgraphs, jtest, jmeta), \
        (model, graphs, test_ds, meta) = _pair(data_dir)
    kw = dict(ar_steps=3, static_channels=(STATIC[0],), max_samples=2)

    def post(pred_flat, i):
        return pred_flat * (1.0 + 0.01 * i) - 0.02

    seen = []

    def post_port(pred_flat, i):
        seen.append(i)
        return post(pred_flat, i)

    expect = jax_evaluate(jmodel, params, jgraphs, jtest, jmeta,
                          assimilator=_per_sample_hook(test_ds,
                                                       JaxNudging(0.5), 1),
                          postprocess=post, skip_samples=1, **kw)
    report = evaluate_model(model, graphs, test_ds, meta, device="cpu",
                            assimilator=_per_sample_hook(
                                test_ds, NudgingAssimilator(0.5), 1),
                            postprocess=post_port, skip_samples=1, **kw)
    assert seen == [1, 2]
    _assert_reports(report, expect)
    raw = evaluate_model(model, graphs, test_ds, meta, device="cpu",
                         skip_samples=1, **kw)
    assert report.num_samples == raw.num_samples == 2

    lats, lons = meta.coordinates
    oi_kw = dict(sigma_b=1.0, sigma_o=0.5, length_scale_m=900e3)
    expect = jax_evaluate(jmodel, params, jgraphs, jtest, jmeta,
                          assimilator=_per_sample_hook(
                              test_ds, JaxOI(lats, lons, **oi_kw)), **kw)
    report = evaluate_model(model, graphs, test_ds, meta, device="cpu",
                            assimilator=_per_sample_hook(
                                test_ds, OptimalInterpolation(
                                    lats, lons, device="cpu", **oi_kw)),
                            **kw)
    _assert_reports(report, expect)

    (jmodel, params, jgraphs, jtest, jmeta), \
        (model, graphs, test_ds, meta) = _pair(data_dir, direct_steps=2)
    kw = dict(kw, ar_steps=2, direct_steps=2)
    expect = jax_evaluate(jmodel, params, jgraphs, jtest, jmeta,
                          assimilator=_per_sample_hook(test_ds,
                                                       JaxNudging(0.5)), **kw)
    report = evaluate_model(model, graphs, test_ds, meta, device="cpu",
                            assimilator=_per_sample_hook(
                                test_ds, NudgingAssimilator(0.5)), **kw)
    _assert_reports(report, expect)


@pytest.fixture(scope="module")
def jax_experiment(data_dir, tmp_path_factory):
    """An experiment directory with the JAX package's config.json and
    best_model.msgpack (the small flagship architecture)."""
    import jax

    from graphcast_lite_tpu.build import build_weather_model as jax_build
    from graphcast_lite_tpu.data.dataset import \
        load_chunked_datasets as jax_load
    from graphcast_lite_tpu.training.checkpoint import save_params

    jcfg, _ = small_configs()
    jcfg = jcfg.model_copy(update={"data_dir": data_dir,
                                   "static_channels": list(STATIC)})
    exp = tmp_path_factory.mktemp("da_exp")
    (exp / "config.json").write_text(jcfg.model_dump_json(indent=1))
    _, _, _, jmeta = jax_load(data_dir, obs_window=2, pred_steps=4,
                              n_features=N_FEAT)
    jmodel, jgraphs, jgs = jax_build(jcfg, jmeta)
    dummy = np.zeros((jgs.num_grid_nodes, 2 * N_FEAT), np.float32)
    save_params(str(exp / "best_model.msgpack"),
                jmodel.init(jax.random.PRNGKey(4), dummy, jgraphs))
    return str(exp)


@pytest.mark.parametrize("flags", [
    ["--da", "nudging", "--da-alpha", "0.5", "--obs-sparsity", "0.2",
     "--da-steps", "2", "--obs-channels", "0", "2", "3", "--obs-seed", "3",
     "--region", "20", "60", "60", "140"],
    ["--da", "oi", "--obs-roi-only", "--region", "20", "60", "60", "140",
     "--obs-sparsity", "0.3", "--oi-sigma-b", "1.2", "--oi-sigma-o", "0.4",
     "--oi-length-km", "800"],
], ids=["nudging", "oi_roi"])
def test_cli_predict_da_matches_jax(jax_experiment, tmp_path, flags,
                                    monkeypatch):
    from graphcast_lite_tpu.cli.predict import main as jax_main
    from graphcast_lite_torch.cli.predict import main

    monkeypatch.setenv("GCLT_LAZY_EDGE", "1")
    common = [jax_experiment, "--ar-steps", "3", "--max-samples", "2",
              "--per-channel"] + flags
    jax_main(common + ["--report-json", str(tmp_path / "jax.json")])
    main(common + ["--device", "cpu",
                   "--report-json", str(tmp_path / "port.json")])
    ref = json.loads((tmp_path / "jax.json").read_text())
    port = json.loads((tmp_path / "port.json").read_text())
    _assert_reports(port, ref)
    np.testing.assert_allclose(port["per_channel_rmse_physical"],
                               ref["per_channel_rmse_physical"],
                               rtol=REPORT_RTOL)
    assert os.path.exists(os.path.join(jax_experiment, "best_model.msgpack"))
