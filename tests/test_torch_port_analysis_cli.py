"""The diagnostics and analysis CLIs in the port against the JAX package,
on the CPU (``tests/test_analysis_cli.py``'s layout: the JAX suite's
``small_experiment``, ConvGCN on 16 x 8, random-init JAX params).

* ``cli.check graph``: on an experiment where the JAX CLI recorded
  ``graph_summary.json`` (the ConvGCN and the small flagship
  architecture), the port's rebuild reports a match; the summaries are
  equal.
* ``cli.check weights`` on a JAX ``.msgpack`` and on a port ``.pt``
  (OK), and on a ``.pt`` of another structure (problems, exit 1).
* ``cli.check scalers``: the same report as the JAX CLI's.
* ``inference.maps.pixel_metrics`` / ``extract_field`` and
  ``cli.mos_idw_sweep.run_sweep``: bitwise equal.
* ``cli.eval_experiment --device cpu`` (report against the JAX CLI's at
  rtol 1e-4, the maps, the sweep) and ``cli.plot_compare``, as
  ``tests/test_analysis_cli.py`` drives the JAX ones; they plot, so they
  need matplotlib (skipped without it).
"""

import json
import os

import numpy as np
import pytest
import torch

from torch_port_common import one_torch_thread, \
    small_configs  # noqa: F401 (one_torch_thread: an autouse fixture)

REPORT_RTOL = 1e-4


@pytest.fixture(scope="module")
def eval_exp(tmp_path_factory):
    import jax

    from graphcast_lite_tpu.training import checkpoint as ckpt_lib
    from test_training import small_experiment

    tmp_path = tmp_path_factory.mktemp("port_analysis")
    cfg, model, graphs, _, _, _, meta = small_experiment(tmp_path, max_ar=2)
    exp = tmp_path / "exp"
    exp.mkdir()
    cfg = cfg.model_copy(update={"data_dir": str(tmp_path / "data")})
    (exp / "config.json").write_text(cfg.model_dump_json(indent=1))
    dummy = np.zeros((meta.num_latitudes * meta.num_longitudes, 10),
                     np.float32)
    ckpt_lib.save_params(str(exp / "best_model.msgpack"),
                         model.init(jax.random.PRNGKey(0), dummy, graphs))
    return str(exp), str(tmp_path / "data")


@pytest.mark.parametrize("arch", ["conv_gcn", "interaction_net"])
def test_check_graph_matches_jax_record(eval_exp, tmp_path, arch, capsys):
    from graphcast_lite_tpu.cli import check as jax_check
    from graphcast_lite_torch.cli import check
    from graphcast_lite_torch.data.synthetic import \
        generate_synthetic_dataset

    exp, data = eval_exp
    if arch == "interaction_net":
        jcfg, _ = small_configs()
        data = generate_synthetic_dataset(str(tmp_path / "data64"),
                                          n_time=8, n_feat=5, seed=0)
        jcfg = jcfg.model_copy(update={"data_dir": data})
        exp = str(tmp_path / "exp")
        os.makedirs(exp)
        with open(os.path.join(exp, "config.json"), "w") as f:
            f.write(jcfg.model_dump_json())
    else:
        exp_copy = tmp_path / "exp"
        exp_copy.mkdir()
        (exp_copy / "config.json").write_text(
            open(os.path.join(exp, "config.json")).read())
        exp = str(exp_copy)
    assert jax_check.main(["graph", exp, "--data-dir", data]) == 0
    with open(os.path.join(exp, "graph_summary.json")) as f:
        recorded = json.load(f)
    capsys.readouterr()
    assert check.main(["graph", exp, "--data-dir", data, "--device",
                       "cpu"]) == 0
    assert "match the recorded summary — OK" in capsys.readouterr().out

    from graphcast_lite_torch.build import build_weather_model
    from graphcast_lite_torch.config import load_experiment_config
    from graphcast_lite_torch.data.dataset import load_chunked_datasets

    cfg = load_experiment_config(os.path.join(exp, "config.json"))
    _, _, _, meta = load_chunked_datasets(
        data, obs_window=2, pred_steps=cfg.data.pred_window_used,
        n_features=cfg.data.num_features_used)
    _, _, gs = build_weather_model(cfg, meta, device="cpu")
    assert check.graph_summary(gs) == recorded


def test_check_weights_and_scalers(eval_exp, tmp_path, capsys):
    from graphcast_lite_tpu.cli import check as jax_check
    from graphcast_lite_torch.build import build_weather_model
    from graphcast_lite_torch.cli import check
    from graphcast_lite_torch.config import load_experiment_config
    from graphcast_lite_torch.data.dataset import load_chunked_datasets

    exp, data = eval_exp
    assert check.main(["weights", exp, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "best_model.msgpack" in out and "-> OK" in out

    cfg = load_experiment_config(os.path.join(exp, "config.json"))
    _, _, _, meta = load_chunked_datasets(data, obs_window=2, pred_steps=2,
                                          n_features=5)
    model, _, _ = build_weather_model(cfg, meta, device="cpu", seed=2)
    pt = tmp_path / "model.pt"
    torch.save(model.state_dict(), str(pt))
    assert check.main(["weights", exp, "--device", "cpu",
                       "--checkpoint", str(pt)]) == 0
    assert "missing=0 unexpected=0 shape-mismatched=0 -> OK" in \
        capsys.readouterr().out
    state = model.state_dict()
    name = next(iter(state))
    state[name] = torch.zeros(3)
    del state[list(state)[-1]]
    torch.save(state, str(pt))
    assert check.main(["weights", exp, "--device", "cpu",
                       "--checkpoint", str(pt)]) == 1
    assert "missing=1 unexpected=0 shape-mismatched=1 -> PROBLEMS" in \
        capsys.readouterr().out

    other = tmp_path / "other"
    other.mkdir()
    sc = np.load(os.path.join(data, "scalers.npz"))
    np.savez(other / "scalers.npz", mean=sc["mean"] * 1.1, std=sc["std"])
    for argv in (["scalers", data], ["scalers", data, str(other)]):
        assert jax_check.main(argv) == 0
        ref = capsys.readouterr().out
        assert check.main(argv) == 0
        assert capsys.readouterr().out == ref


def test_maps_and_sweep_bitwise():
    from graphcast_lite_tpu.cli.mos_idw_sweep import run_sweep as jax_sweep
    from graphcast_lite_tpu.inference import maps as jm
    from graphcast_lite_torch.cli.mos_idw_sweep import run_sweep
    from graphcast_lite_torch.inference import maps as tm

    rng = np.random.RandomState(0)
    n, n_lat, n_lon, p, c = 6, 8, 16, 2, 5
    g = n_lat * n_lon
    gt = rng.randn(n, g, p * c).astype(np.float32)
    pred = (gt + 0.3 * rng.randn(n, g, p * c) + 0.2).astype(np.float32)
    port, ref = tm.pixel_metrics(pred, gt, c), jm.pixel_metrics(pred, gt, c)
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k])
    np.testing.assert_array_equal(
        tm.extract_field(pred, -1, 1, 2, c, n_lat, n_lon, 280.0, 5.0),
        jm.extract_field(pred, -1, 1, 2, c, n_lat, n_lon, 280.0, 5.0))
    la = np.repeat(np.linspace(-70, 70, n_lat), n_lon)
    lo = np.tile(np.linspace(0, 337.5, n_lon), n_lat)
    kw = dict(channel=1, sparsity=0.1, calib=2, powers=(1.0, 2.0),
              radii_km=(500.0, 3000.0), seed=4)
    rows, raw = run_sweep(pred, gt, c, la, lo, **kw)
    assert (rows, raw) == jax_sweep(pred, gt, c, la, lo, **kw)
    assert len(rows) == 5 and rows == sorted(rows, key=lambda r: r["rmse"])


def test_eval_experiment_matches_jax(eval_exp, tmp_path):
    pytest.importorskip("matplotlib")
    from graphcast_lite_tpu.cli import eval_experiment as jax_eval
    from graphcast_lite_torch.cli import eval_experiment

    exp, data = eval_exp
    argv = ["--data-dir", data, "--ar-steps", "2", "--max-samples", "4"]
    out = os.path.join(exp, "eval")
    jax_eval.main([exp] + argv)
    with open(os.path.join(out, "report.json")) as f:
        ref = json.load(f)
    with open(os.path.join(out, "mos_idw_sweep.json")) as f:
        ref_sweep = json.load(f)
    written = eval_experiment.main([exp, "--device", "cpu"] + argv)
    for name in ("report.json", "preds.npz", "maps_ch0.png",
                 "triad_ch0.png", "mos_idw_sweep.json"):
        assert os.path.join(out, name) in written
        assert os.path.exists(os.path.join(out, name))
    with open(os.path.join(out, "report.json")) as f:
        rep = json.load(f)
    assert rep["num_samples"] == ref["num_samples"] >= 3
    for name in ("rmse", "mae", "acc", "baseline_rmse", "skill"):
        np.testing.assert_allclose(rep[name], ref[name], rtol=REPORT_RTOL)
    np.testing.assert_allclose(rep["per_channel_rmse_physical"],
                               ref["per_channel_rmse_physical"],
                               rtol=REPORT_RTOL)
    with open(os.path.join(out, "mos_idw_sweep.json")) as f:
        sweep = json.load(f)
    # Rows are ranked by RMSE; near ties may rank either way.
    got = {r["label"]: r["rmse"] for r in sweep["rows"]}
    want = {r["label"]: r["rmse"] for r in ref_sweep["rows"]}
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose([got[k] for k in sorted(want)],
                               [want[k] for k in sorted(want)],
                               rtol=REPORT_RTOL)


@pytest.fixture(scope="module")
def saved_preds(eval_exp, tmp_path_factory):
    """``cli.predict --save-preds`` of the experiment on the CPU."""
    from graphcast_lite_torch.cli import predict

    exp, data = eval_exp
    preds = str(tmp_path_factory.mktemp("preds") / "preds.npz")
    predict.main([exp, "--device", "cpu", "--data-dir", data, "--ar-steps",
                  "2", "--max-samples", "4", "--save-preds", preds])
    return preds


def test_mos_idw_sweep_cli(eval_exp, saved_preds, tmp_path):
    from graphcast_lite_tpu.cli import mos_idw_sweep as jax_sweep
    from graphcast_lite_torch.cli import mos_idw_sweep

    _, data = eval_exp
    argv = ["--preds", saved_preds, "--data-dir", data, "--sparsity", "0.2",
            "--calib", "2", "--powers", "1,2", "--radii", "300,600"]
    rows = mos_idw_sweep.main(argv + ["--out", str(tmp_path / "p.json")])
    assert rows == jax_sweep.main(argv + ["--out", str(tmp_path / "j.json")])
    assert len(rows) == 5 and rows == sorted(rows, key=lambda r: r["rmse"])
    assert json.loads((tmp_path / "p.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())


def test_plot_compare_cli(eval_exp, saved_preds, tmp_path):
    pytest.importorskip("matplotlib")
    from graphcast_lite_torch.cli import plot_compare

    _, data = eval_exp
    paths = plot_compare.main([
        "--data-dir", data, "--out-dir", str(tmp_path / "figs"),
        "--preds", f"base={saved_preds}", "--preds", f"alt={saved_preds}",
        "--var-idx", "0", "--step-idx", "0"])
    assert len(paths) == 4 and any("final_trio" in p for p in paths)
    for p in paths:
        assert os.path.getsize(p) > 1000
