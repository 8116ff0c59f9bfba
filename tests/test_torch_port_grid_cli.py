"""The CNN stack's data tooling and CLIs on the CPU:

* ``data.etl`` (``welford_scalers``, ``recompute_scalers``,
  ``add_time_features``, ``repair_dataset``, ``build_multires_dataset``,
  ``build_downscaler_dataset``) writes files byte-equal to the JAX
  package's on the same inputs;
* ``data.legacy_pt`` as ``tests/test_convert.py::test_legacy_pt_loader``;
* ``cli.train_unet`` (v1 by flags, v2 by ``--config``),
  ``cli.train_downscaler`` (plain and ``--gnn-input``) and
  ``cli.generate_predictions`` through ``main(argv)`` with ``--device
  cpu`` on an 8 × 16 synthetic set: the files they write, finite losses;
* ``cli.generate_predictions`` on a JAX ``best_model.msgpack`` against the
  JAX CLI: the float16 predictions within one float16 ulp.
"""

import filecmp
import json
import os
import shutil

import numpy as np
import pytest

from graphcast_lite_torch.data import etl
from graphcast_lite_torch.data.synthetic import generate_synthetic_dataset
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


def test_etl_byte_equal(tmp_path):
    from graphcast_lite_tpu.data import etl as jetl

    src = generate_synthetic_dataset(str(tmp_path / "src"), n_time=10,
                                     n_lon=16, n_lat=8, n_feat=3, seed=2)
    with open(os.path.join(src, "variables.json"), "w") as f:
        json.dump(["msl", "t2m", "u10"], f)
    coarse = generate_synthetic_dataset(str(tmp_path / "coarse"), n_time=6,
                                        n_lon=8, n_lat=4, n_feat=3, seed=1)
    fine = generate_synthetic_dataset(str(tmp_path / "fine"), n_time=6,
                                      n_lon=16, n_lat=8, n_feat=3, seed=1)
    for name, mod in (("port", etl), ("jax", jetl)):
        root = tmp_path / name
        own = str(root / "src")
        shutil.copytree(src, own)
        mm, _ = mod._open_raw(own)
        np.save(str(root / "welford.npy"),
                np.concatenate(mod.welford_scalers(mm, chunk=3)[:2]))
        mod.recompute_scalers(own)
        mod.add_time_features(own, str(root / "tf"), start_hour=6)
        mod.repair_dataset(own, {"msl": 0.01, "absent": 2.0})
        mod.build_multires_dataset(coarse, fine, str(root / "multires"),
                                   (-40.0, 40.0, 90.0, 180.0))
        mod.build_multires_dataset(coarse, fine, str(root / "merge"),
                                   (-40.0, 40.0, 90.0, 180.0), mode="merge")
        mod.build_downscaler_dataset(coarse, fine, str(root / "ds"),
                                     static_channels=[2])
    for sub in ("src", "tf", "multires", "merge", "ds"):
        _same_files(tmp_path / "port" / sub, tmp_path / "jax" / sub)
    assert filecmp.cmp(tmp_path / "port" / "welford.npy",
                       tmp_path / "jax" / "welford.npy", shallow=False)
    pts = etl._bilinear_to_points(np.arange(12.0).reshape(3, 4),
                                  np.array([0.0, 1, 2]),
                                  np.array([0.0, 1, 2, 3]),
                                  np.array([0.5, 2.0]), np.array([1.5, 3.0]))
    np.testing.assert_allclose(pts, [3.5, 11.0])


def test_legacy_pt_loader(tmp_path):
    import torch

    from graphcast_lite_torch.data.legacy_pt import load_pt_datasets

    n, g, obs, pred, f = 12, 50, 3, 2, 6
    rng = np.random.RandomState(0)
    torch.save(torch.tensor(rng.randn(n, g, obs, f).astype(np.float32)),
               tmp_path / "X_train.pt")
    torch.save(torch.tensor(rng.randn(n, g, pred, f).astype(np.float32)),
               tmp_path / "y_train.pt")
    torch.save(torch.tensor(rng.randn(6, g, obs, f).astype(np.float32)),
               tmp_path / "X_test.pt")
    torch.save(torch.tensor(rng.randn(6, g, pred, f).astype(np.float32)),
               tmp_path / "y_test.pt")
    train, val, test, meta = load_pt_datasets(
        str(tmp_path), obs_window_used=2, pred_window_used=2,
        num_features_used=4)
    assert len(train) == 12 and len(val) == 3 and len(test) == 3
    x, y = train.get(0)
    assert x.shape == (g, 2 * 4) and y.shape == (g, 2 * 4)
    assert meta.num_grid_nodes == g


def _losses(out_dir):
    with open(os.path.join(out_dir, "results.json")) as f:
        res = json.load(f)
    losses = res["train_losses"] + res["val_losses"]
    assert losses and np.isfinite(losses).all()
    for name in ("best_model.pt", "config.json", "training_log.txt",
                 "metrics.jsonl", os.path.join("checkpoint", "state.pt"),
                 os.path.join("checkpoint", "meta.json")):
        assert os.path.exists(os.path.join(out_dir, name)), name
    return res


def test_train_unet_cli(tmp_path, capsys):
    """v1 from flags, then v2 selected by a flat ``--config`` with both
    extra losses; each run's files and finite losses, the model it
    trained evaluated through ``evaluate_model``; a GNN config is
    refused."""
    import torch

    from graphcast_lite_torch.cli import train_unet
    from graphcast_lite_torch.data.dataset import load_chunked_datasets
    from graphcast_lite_torch.inference.predict import evaluate_model
    from graphcast_lite_torch.models.grid_adapter import GridImageModel
    from graphcast_lite_torch.models.unet import WeatherUNetV2

    data = generate_synthetic_dataset(str(tmp_path / "data"), n_time=24,
                                      n_lon=16, n_lat=8, n_feat=4, seed=3)
    v1 = str(tmp_path / "v1")
    train_unet.main([v1, "--data-dir", data, "--base-filters", "8",
                     "--epochs", "2", "--max-steps-per-epoch", "2",
                     "--device", "cpu"])
    assert "U-Net v1" in capsys.readouterr().out
    _losses(v1)

    cfg = {"data_dir": data, "num_features": 4, "obs_window": 2,
           "batch_size": 2, "learning_rate": 1e-3, "num_epochs": 2,
           "base_filters": 8, "max_ar_steps": 2, "spectral_weight": 0.1,
           "gradient_weight": 0.05, "static_channels": [1],
           "forcing_channels": [3]}
    with open(tmp_path / "unet.json", "w") as f:
        json.dump(cfg, f)
    v2 = str(tmp_path / "v2")
    train_unet.main([v2, "--config", str(tmp_path / "unet.json"),
                     "--max-steps-per-epoch", "2", "--device", "cpu"])
    assert "U-Net v2" in capsys.readouterr().out
    _losses(v2)
    with open(os.path.join(v2, "config.json")) as f:
        saved = json.load(f)
    assert saved["static_channels"] == [1] and saved["max_ar_steps"] == 2

    _, val_ds, _, meta = load_chunked_datasets(data, obs_window=2,
                                               pred_steps=2, n_features=4)
    model = GridImageModel(WeatherUNetV2(8, 4, 8), 8, 16)
    model.load_state_dict(torch.load(os.path.join(v2, "best_model.pt")))
    report = evaluate_model(model, None, val_ds, meta, ar_steps=2,
                            max_samples=2, device="cpu")
    assert report.num_samples == 2 and np.isfinite(report.rmse)

    with open(tmp_path / "gnn.json", "w") as f:
        json.dump({"data": {"dataset_name": "x", "num_features_used": 4,
                            "obs_window_used": 2, "pred_window_used": 1,
                            "want_feats_flattened": True}}, f)
    with pytest.raises(SystemExit):
        train_unet.main([str(tmp_path / "bad"), "--config",
                         str(tmp_path / "gnn.json"), "--device", "cpu"])


@pytest.fixture(scope="module")
def cascade(tmp_path_factory):
    """A small GNN demo (32 × 16, its own seeded ``best_model.pt``), a
    downscaler dataset whose fine grid is the demo's data, and the demo's
    ``gnn_pred.npy`` over 6 training samples."""
    import torch

    from graphcast_lite_torch.build import build_weather_model
    from graphcast_lite_torch.cli import generate_predictions, make_demo
    from graphcast_lite_torch.config import load_experiment_config
    from graphcast_lite_torch.data.dataset import load_chunked_datasets

    root = tmp_path_factory.mktemp("cascade")
    exp = str(root / "demo")
    make_demo.main([exp, "--size", "small", "--processor", "conv_gcn"])
    cfg = load_experiment_config(os.path.join(exp, "config.json"))
    _, _, _, meta = load_chunked_datasets(cfg.data_dir, obs_window=2,
                                          pred_steps=1, n_features=6)
    model, _, _ = build_weather_model(cfg, meta, device="cpu", seed=7)
    torch.save(model.state_dict(), os.path.join(exp, "best_model.pt"))
    coarse = generate_synthetic_dataset(str(root / "coarse"), n_time=60,
                                        n_lon=16, n_lat=8, n_feat=6)
    ds = etl.build_downscaler_dataset(coarse, cfg.data_dir,
                                      str(root / "ds"))
    pred = str(root / "gnn_pred.npy")
    generate_predictions.main([exp, "--out", pred, "--max-samples", "6",
                               "--device", "cpu"])
    return exp, ds, pred


def test_generate_predictions_cli(cascade):
    exp, _, pred = cascade
    with open(pred + ".json") as f:
        info = json.load(f)
    assert info == {"n_samples": 6, "n_nodes": 32 * 16, "n_feat": 6,
                    "split": "train"}
    mm = np.memmap(pred, np.float16, "r", shape=(6, 32 * 16, 6))
    assert np.isfinite(np.asarray(mm, np.float32)).all()


@pytest.mark.parametrize("gnn_input", [False, True], ids=["truth",
                                                          "gnn_input"])
def test_train_downscaler_cli(cascade, tmp_path, capsys, gnn_input):
    """The downscaler on the bilinear coarse fields, then on the frozen
    GNN's predictions; its files, finite losses and the skill line."""
    from graphcast_lite_torch.cli import train_downscaler

    _, ds, pred = cascade
    out = str(tmp_path / "down")
    argv = [out, "--data-dir", ds, "--base-filters", "8", "--epochs", "1",
            "--max-steps-per-epoch", "2", "--spectral-weight", "0.1",
            "--device", "cpu"]
    if gnn_input:
        argv += ["--gnn-input", pred]
    res = train_downscaler.main(argv)
    text = capsys.readouterr().out
    assert "skill" in text
    assert ("frozen-GNN inputs (6 samples)" in text) == gnn_input
    _losses(out)
    assert np.isfinite([res["rmse"], res["bilinear_rmse"]]).all()


def test_generate_predictions_matches_jax_cli(tmp_path):
    """The JAX package's CLI and the port's on the same
    ``best_model.msgpack`` (ConvGCN demo): float16 outputs within one
    float16 ulp of each other."""
    import jax

    from graphcast_lite_tpu.build import build_weather_model as jax_build
    from graphcast_lite_tpu.cli.generate_predictions import main as jax_gen
    from graphcast_lite_tpu.cli.make_demo import main as jax_demo
    from graphcast_lite_tpu.config import load_experiment_config as jax_load
    from graphcast_lite_tpu.data.dataset import \
        load_chunked_datasets as jax_data
    from graphcast_lite_tpu.training.checkpoint import save_params
    from graphcast_lite_torch.cli import generate_predictions

    exp = str(tmp_path / "demo")
    jax_demo([exp, "--size", "small", "--processor", "conv_gcn"])
    jcfg = jax_load(os.path.join(exp, "config.json"))
    _, _, _, jmeta = jax_data(jcfg.data_dir, obs_window=2, pred_steps=1,
                              n_features=6)
    jmodel, jgraphs, jgs = jax_build(jcfg, jmeta)
    dummy = np.zeros((jgs.num_grid_nodes, 2 * 6), np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3), dummy, jgraphs)
    save_params(os.path.join(exp, "best_model.msgpack"), params)
    outs = {}
    for name, main in (("jax", jax_gen), ("port", generate_predictions.main)):
        path = str(tmp_path / f"{name}.npy")
        argv = [exp, "--out", path, "--max-samples", "3", "--split", "val"]
        main(argv + (["--device", "cpu"] if name == "port" else []))
        with open(path + ".json") as f:
            info = json.load(f)
        outs[name] = np.memmap(path, np.float16, "r", shape=(
            info["n_samples"], info["n_nodes"], info["n_feat"]))
    a = np.asarray(outs["port"], np.float32)
    b = np.asarray(outs["jax"], np.float32)
    assert a.shape == b.shape == (3, 32 * 16, 6)
    ulp = np.maximum(*(np.spacing(np.abs(v).astype(np.float16))
                       .astype(np.float32) for v in (a, b)))
    assert (np.abs(a - b) <= ulp).all()


def test_cli_need_a_card_unless_asked_for_cpu(cascade, tmp_path, monkeypatch):
    """Without a card each new CLI raises at its default ``--device
    cuda``; it never carries on on the CPU quietly."""
    import torch

    from graphcast_lite_torch.cli import generate_predictions, \
        train_downscaler, train_unet

    exp, ds, _ = cascade
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in (
            (train_unet.main, [str(tmp_path / "u"), "--data-dir", ds]),
            (train_downscaler.main, [str(tmp_path / "d"), "--data-dir", ds]),
            (generate_predictions.main, [exp, "--out",
                                         str(tmp_path / "p.npy")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
