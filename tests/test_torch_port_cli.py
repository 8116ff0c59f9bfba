"""The port's user surface on the CPU: ``cli.make_demo`` against the JAX
package's, ``evaluate_model``'s amortized serve, and the demo loop
make_demo -> train -> predict through the CLIs' ``main(argv)`` with
``--device cpu``, including a checkpoint the JAX package wrote.

* make_demo: both packages write configs that load to the same config
  (with either package's loader) and byte-identical data files.
* ``evaluate_model(rollouts_per_dispatch=K)`` for K in {2, 3} (accepted,
  with no effect until the batched forward) gives the report and the saved
  predictions of K = 1 exactly.
* ``cli.train`` writes the checkpoint, best model and logs, ``--resume``
  continues at the next epoch, and ``cli.predict`` reports the same at
  ``--rollouts-per-dispatch 4`` as at K = 1.
* A JAX ``best_model.msgpack`` (the JAX package's own ``save_params``) is
  found by ``cli.predict`` when there is no ``best_model.pt``; its report
  agrees with the JAX package's ``cli.predict`` on the same file within
  1e-4 relative; ``cli.train --pretrained`` restores it.
"""

import json
import os

import numpy as np
import pytest

from graphcast_lite_torch.build import build_weather_model
from graphcast_lite_torch.config import load_experiment_config
from graphcast_lite_torch.data.dataset import load_chunked_datasets
from graphcast_lite_torch.data.synthetic import generate_synthetic_dataset
from graphcast_lite_torch.inference.predict import evaluate_model
from torch_port_common import N_FEAT, one_torch_thread, \
    small_configs  # noqa: F401 (one_torch_thread: an autouse fixture)

DATA_FILES = ("data.npy", "dataset_info.json", "scalers.npz", "coords.npz",
              "variables.json")


def _demo(main, out, *args):
    main([str(out)] + list(args))
    return out


@pytest.mark.parametrize("size,processor", [
    ("small", "conv_gcn"), ("small", "conv_gat"), ("small", "sparse_gat"),
    ("small", "interaction_net"), ("small", "simple_conv"),
    ("medium", "interaction_net"),
])
def test_make_demo_matches_jax(tmp_path, size, processor):
    from graphcast_lite_tpu.cli.make_demo import main as jax_main
    from graphcast_lite_tpu.config import load_experiment_config as jax_load
    from graphcast_lite_torch.cli.make_demo import main as port_main

    args = ("--size", size, "--processor", processor)
    jdir = _demo(jax_main, tmp_path / "jax", *args)
    pdir = _demo(port_main, tmp_path / "port", *args)
    jcfg = load_experiment_config(str(jdir / "config.json"))
    pcfg = load_experiment_config(str(pdir / "config.json"))
    assert jcfg.data_dir == str(jdir / "data")
    assert pcfg.data_dir == str(pdir / "data")
    jcfg.data_dir = pcfg.data_dir = None
    assert pcfg == jcfg
    jraw = jax_load(str(jdir / "config.json")).model_dump()
    praw = jax_load(str(pdir / "config.json")).model_dump()
    jraw["data_dir"] = praw["data_dir"] = None
    assert praw == jraw
    for name in DATA_FILES:
        assert (pdir / "data" / name).read_bytes() \
            == (jdir / "data" / name).read_bytes(), name


@pytest.fixture(scope="module")
def five_samples(tmp_path_factory):
    """A 16x8 dataset whose test split holds 5 samples of AR 2, and a model
    with seeded random weights."""
    d = str(tmp_path_factory.mktemp("k_data"))
    generate_synthetic_dataset(d, n_time=28, n_lon=16, n_lat=8,
                               n_feat=N_FEAT, static_channels=[1],
                               forcing_channels=[3], seed=2)
    _, _, test_ds, meta = load_chunked_datasets(
        d, obs_window=2, pred_steps=2, n_features=N_FEAT, test_split="test")
    assert len(test_ds) == 5
    _, tcfg = small_configs()
    model, graphs, _ = build_weather_model(tcfg, meta, device="cpu", seed=4)
    return model, graphs, test_ds, meta


@pytest.mark.parametrize("k", [2, 3])
def test_amortized_serve_equals_one_by_one(five_samples, tmp_path, k):
    model, graphs, test_ds, meta = five_samples
    kw = dict(ar_steps=2, static_channels=(1,), forcing_channels=(3,),
              region=(-30.0, 30.0, 0.0, 180.0), device="cpu")
    reports, preds = [], []
    for kk in (1, k):
        path = str(tmp_path / f"preds_{kk}.npz")
        reports.append(evaluate_model(model, graphs, test_ds, meta,
                                      rollouts_per_dispatch=kk,
                                      save_predictions=path, **kw))
        preds.append(np.load(path)["predictions"])
    assert reports[0].num_samples == 5
    assert reports[1].to_json() == reports[0].to_json()
    assert np.array_equal(preds[1], preds[0])


def _set_epochs(exp, n):
    cfg = json.loads((exp / "config.json").read_text())
    cfg["num_epochs"] = n
    (exp / "config.json").write_text(json.dumps(cfg))


def test_demo_loop_cpu(tmp_path, capsys):
    from graphcast_lite_torch.cli import make_demo, predict, train

    exp = _demo(make_demo.main, tmp_path / "demo", "--size", "small")
    _set_epochs(exp, 2)
    train.main([str(exp), "--device", "cpu", "--max-steps-per-epoch", "2"])
    for name in ("best_model.pt", "results.json", "training_log.txt",
                 "metrics.jsonl", "checkpoint/state.pt",
                 "checkpoint/meta.json"):
        assert (exp / name).exists(), name
    first = json.loads((exp / "results.json").read_text())
    assert len(first["train_losses"]) == 2
    assert all(np.isfinite(first["train_losses"] + first["val_losses"]))

    _set_epochs(exp, 3)
    capsys.readouterr()
    train.main([str(exp), "--device", "cpu", "--max-steps-per-epoch", "2",
                "--resume"])
    assert ">>> Resumed from epoch 2, AR=2" in capsys.readouterr().out
    resumed = json.loads((exp / "results.json").read_text())
    assert resumed["train_losses"][:2] == first["train_losses"]
    assert len(resumed["train_losses"]) == 3

    reports = []
    for k in ("1", "4"):
        path = tmp_path / f"report_{k}.json"
        predict.main([str(exp), "--device", "cpu", "--ar-steps", "2",
                      "--rollouts-per-dispatch", k, "--report-json",
                      str(path)])
        reports.append(json.loads(path.read_text()))
    out = capsys.readouterr().out
    assert out.count(f"[predict] loaded {exp / 'best_model.pt'}") == 2
    assert reports[0]["num_samples"] == 6 and reports[0]["ar_steps"] == 2
    assert np.isfinite(reports[0]["rmse"])
    assert reports[1] == reports[0]


def test_predict_serves_a_jax_checkpoint(tmp_path, capsys):
    """The JAX package's cli.predict and the port's on the same
    best_model.msgpack (ConvGCN demo: no Pallas call on either side)."""
    import jax

    from graphcast_lite_tpu.build import build_weather_model as jax_build
    from graphcast_lite_tpu.cli.make_demo import main as jax_demo
    from graphcast_lite_tpu.cli.predict import main as jax_predict
    from graphcast_lite_tpu.config import load_experiment_config as jax_load
    from graphcast_lite_tpu.data.dataset import \
        load_chunked_datasets as jax_data
    from graphcast_lite_tpu.training.checkpoint import save_params
    from graphcast_lite_torch.cli import predict, train

    exp = _demo(jax_demo, tmp_path / "demo", "--size", "small",
                "--processor", "conv_gcn")
    jcfg = jax_load(str(exp / "config.json"))
    _, _, _, jmeta = jax_data(jcfg.data_dir, obs_window=2, pred_steps=2,
                              n_features=jcfg.data.num_features_used)
    jmodel, jgraphs, jgs = jax_build(jcfg, jmeta)
    dummy = np.zeros((jgs.num_grid_nodes, 2 * 6), np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3), dummy, jgraphs)
    save_params(str(exp / "best_model.msgpack"), params)

    args = ["--ar-steps", "2", "--max-samples", "3", "--report-json"]
    jax_predict([str(exp)] + args + [str(tmp_path / "jax.json")])
    capsys.readouterr()
    predict.main([str(exp), "--device", "cpu"] + args
                 + [str(tmp_path / "port.json")])
    assert f"[predict] loaded {exp / 'best_model.msgpack'}" \
        in capsys.readouterr().out
    jrep = json.loads((tmp_path / "jax.json").read_text())
    prep = json.loads((tmp_path / "port.json").read_text())
    assert prep["num_samples"] == jrep["num_samples"] == 3
    for name in ("rmse", "mae", "acc", "baseline_rmse", "skill"):
        np.testing.assert_allclose(prep[name], jrep[name], rtol=1e-4,
                                   err_msg=name)

    # Warm-start training from the same file: every entry matches.
    _set_epochs(exp, 1)
    train.main([str(exp), "--device", "cpu", "--max-steps-per-epoch", "1",
                "--pretrained", str(exp / "best_model.msgpack")])
    out = capsys.readouterr().out
    assert "[pretrained] restored from" in out
    assert "[partial_restore]" not in out

    # A checkpoint of another structure is restored non-strictly.
    other = _demo(jax_demo, tmp_path / "other", "--size", "small")
    os.replace(exp / "best_model.pt", other / "best_model.pt")
    predict.main([str(other), "--device", "cpu", "--ar-steps", "1",
                  "--max-samples", "1"])
    out = capsys.readouterr().out
    assert "[predict] non-strict restore" in out and "missing=" in out


def test_unported_processor_raises_in_train(tmp_path, capsys):
    """The GAT demo trains now; a grid / U-Net experiment is refused by
    the GNN trainer (it trains through ``cli.train_unet``)."""
    from graphcast_lite_torch.cli import make_demo, train

    exp = _demo(make_demo.main, tmp_path / "gat", "--size", "small",
                "--processor", "conv_gat")
    train.main([str(exp), "--device", "cpu", "--max-steps-per-epoch", "1"])
    assert (exp / "best_model.pt").exists()
    grid = tmp_path / "unet"
    grid.mkdir()
    with open(grid / "config.json", "w") as f:
        json.dump({"num_features": 5, "base_filters": 16}, f)
    with pytest.raises(SystemExit):
        train.main([str(grid), "--device", "cpu"])
    assert "cli.train_unet" in capsys.readouterr().err
