"""The port's serving entry points against the JAX package on a tiny
synthetic dataset, fp32 on the CPU: ``evaluate_model`` gives the JAX
report's RMSE and skill (rtol 1e-4), and ``cli/predict.py --device cpu``
runs end to end."""

import json
import os

import numpy as np
import pytest

from graphcast_lite_torch.build import build_weather_model
from graphcast_lite_torch.config import to_dict
from graphcast_lite_torch.data.synthetic import generate_synthetic_dataset
from graphcast_lite_torch.utils.params import from_flax_params
from torch_port_common import N_FEAT, flax_numpy, small_configs

STATIC = [1]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_data"))
    return generate_synthetic_dataset(d, n_time=40, n_feat=N_FEAT,
                                      static_channels=STATIC, seed=0)


def _load(data_dir):
    from graphcast_lite_torch.data.dataset import load_chunked_datasets

    return load_chunked_datasets(data_dir, obs_window=2, pred_steps=4,
                                 n_features=N_FEAT)


def test_evaluate_model_matches_jax(data_dir, monkeypatch):
    import jax

    from graphcast_lite_tpu.build import build_weather_model as jax_build
    from graphcast_lite_tpu.data.dataset import (
        load_chunked_datasets as jax_load,
    )
    from graphcast_lite_tpu.inference.predict import (
        evaluate_model as jax_evaluate,
    )
    from graphcast_lite_torch.inference.predict import evaluate_model

    monkeypatch.setenv("GCLT_LAZY_EDGE", "1")
    jcfg, tcfg = small_configs()
    _, _, jtest, jmeta = jax_load(data_dir, obs_window=2, pred_steps=4,
                                  n_features=N_FEAT)
    jmodel, jgraphs, jgs = jax_build(jcfg, jmeta)
    dummy = np.zeros((jgs.num_grid_nodes, 2 * N_FEAT), np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), dummy, jgraphs)
    kw = dict(ar_steps=4, static_channels=(STATIC[0],),
              region=(-30.0, 30.0, 0.0, 180.0))
    std = np.load(os.path.join(data_dir, "scalers.npz"))["std"]
    expect = jax_evaluate(jmodel, params, jgraphs, jtest, jmeta,
                          scalers_std=std, **kw)

    _, _, test_ds, meta = _load(data_dir)
    model, graphs, _ = build_weather_model(tcfg, meta, device="cpu")
    model.load_state_dict(from_flax_params(flax_numpy(params)))
    report = evaluate_model(model, graphs, test_ds, meta, device="cpu",
                            scalers_std=std, **kw)

    assert report.num_samples == expect.num_samples >= 3
    for name in ("rmse", "mae", "acc", "baseline_rmse", "skill"):
        np.testing.assert_allclose(getattr(report, name),
                                   getattr(expect, name), rtol=1e-4,
                                   err_msg=name)
    for h_port, h_jax in zip(report.per_horizon, expect.per_horizon):
        for name in ("rmse", "baseline_rmse", "skill"):
            np.testing.assert_allclose(h_port[name], h_jax[name], rtol=1e-4)
    np.testing.assert_allclose(report.region["rmse"], expect.region["rmse"],
                               rtol=1e-4)
    np.testing.assert_allclose(report.per_channel_rmse_physical,
                               expect.per_channel_rmse_physical, rtol=1e-4)


def test_cli_predict_cpu(data_dir, tmp_path, capsys):
    from graphcast_lite_torch.cli.predict import main

    _, tcfg = small_configs()
    tcfg.static_channels = list(STATIC)
    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "config.json").write_text(json.dumps(to_dict(tcfg)))
    report_path = tmp_path / "report.json"
    preds = tmp_path / "preds.npz"
    main([str(exp), "--data-dir", data_dir, "--device", "cpu",
          "--ar-steps", "2", "--max-samples", "2", "--per-channel",
          "--save-preds", str(preds), "--report-json", str(report_path)])
    out = capsys.readouterr().out
    assert "evaluating random init" in out
    assert "Skill vs persistence" in out
    report = json.loads(report_path.read_text())
    assert report["num_samples"] == 2 and report["ar_steps"] == 2
    assert np.isfinite(report["rmse"])
    saved = np.load(preds)
    assert saved["predictions"].shape == (2, 64 * 32, 2 * N_FEAT)
    assert np.isfinite(saved["predictions"]).all()

    # A saved state dict is loaded back.
    import torch

    model, _, _ = build_weather_model(tcfg, _load(data_dir)[3],
                                      device="cpu", seed=7)
    torch.save(model.state_dict(), str(exp / "best_model.pt"))
    main([str(exp), "--data-dir", data_dir, "--device", "cpu",
          "--ar-steps", "1", "--max-samples", "1"])
    assert "[predict] loaded" in capsys.readouterr().out


# Named when --da was the CLI's one unported option; both assimilators run
# now (held against the JAX CLI in tests/test_torch_port_assimilation.py).
# --rollouts-per-dispatch K is accepted (tests/test_torch_port_cli.py).
@pytest.mark.parametrize("flag", [["--da", "nudging"], ["--da", "oi"]])
def test_cli_unported_options_exit(flag, data_dir, tmp_path, capsys):
    """``--da nudging`` and ``--da oi`` on the CPU: a finite report whose
    first horizon beats the same request without DA (the stations are
    the truth)."""
    from graphcast_lite_torch.cli.predict import main

    _, tcfg = small_configs()
    tcfg.static_channels = list(STATIC)
    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "config.json").write_text(json.dumps(to_dict(tcfg)))
    reports = {}
    for name, extra in (("raw", []), ("da", flag)):
        path = tmp_path / f"{name}.json"
        main([str(exp), "--data-dir", data_dir, "--device", "cpu",
              "--ar-steps", "2", "--max-samples", "2",
              "--obs-sparsity", "0.3", "--report-json", str(path)] + extra)
        reports[name] = json.loads(path.read_text())
    assert "Skill vs persistence" in capsys.readouterr().out
    da, raw = reports["da"], reports["raw"]
    assert da["num_samples"] == 2 and np.isfinite(da["rmse"])
    assert da["per_horizon"][0]["rmse"] < raw["per_horizon"][0]["rmse"]
