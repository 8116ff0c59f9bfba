"""Guards on the port's boundaries: it imports nothing of JAX or of the JAX
package, and its entry points run on the card unless asked for the CPU."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from graphcast_lite_torch.build import build_weather_model
from graphcast_lite_torch.data.dataset import load_chunked_datasets
from graphcast_lite_torch.data.synthetic import generate_synthetic_dataset
from graphcast_lite_torch.inference.predict import evaluate_model
from torch_port_common import N_FEAT, small_configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """Every module of the package, and chip_smoke (whose main runs only
    under ``__main__``), imports without jax, flax, optax, pydantic,
    msgpack, sklearn, matplotlib, joblib, netCDF4, xarray, gcsfs, cdsapi,
    threadpoolctl or anything of graphcast_lite_tpu (the card's machine
    has none of them)."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import graphcast_lite_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        assert callable(chip_smoke.main)
        banned = ("jax", "jaxlib", "flax", "optax", "pydantic", "msgpack",
                  "sklearn", "matplotlib", "joblib", "netCDF4", "xarray",
                  "gcsfs", "cdsapi", "threadpoolctl", "graphcast_lite_tpu")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in banned)
        print(len(names), "modules")
        sys.exit(f"imported {bad}" if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # 80 since the offline tooling (constants, utils.torch_convert,
    # postprocessing.mos_training, cli.{build_learned_mos, compare_wrf},
    # data.remote, graphs.partition); 73 since data assimilation and the
    # serving entry points
    # (assimilation.{observations, nudging, optimal_interpolation},
    # postprocessing.corrections, inference.{maps, regional_pipelines},
    # operational.{bundle, live}, cli.{evaluate_pipeline, check,
    # mos_idw_sweep, eval_experiment, plot_compare} and three package
    # __init__ files); 57 since the CNN stacks (models.unet, models.grid_adapter,
    # training.optim, data.etl, data.legacy_pt, cli.train_unet,
    # cli.train_downscaler, cli.generate_predictions); 49 since the
    # regional stack and the COO training units
    # (ops.gcn_agg, graphs.regional, models.dual_mesh, models.roi_residual,
    # cli.train_regional); 44 with the product graph (graphs.product); 43
    # with the trainer (utils.logs, utils.flax_msgpack, training.checkpoint,
    # cli.make_demo and cli.train), 38 with the train step, 35 with the COO
    # routes.
    assert int(proc.stdout.split()[0]) >= 80, proc.stdout


OFFLINE_MODULES = ("constants", "utils.torch_convert",
                   "postprocessing.mos_training", "cli.build_learned_mos",
                   "cli.compare_wrf", "data.remote", "graphs.partition")


@pytest.mark.parametrize("name", OFFLINE_MODULES)
def test_offline_module_imports_stay_lazy(name):
    """The offline tooling names no JAX, no module of the JAX package and
    none of its optional dependencies at module level: sklearn and joblib
    (learned MOS), netCDF4 (the WRF reader), xarray, gcsfs and cdsapi
    (the dataset openers) are imported inside the functions that use
    them, and threadpoolctl nowhere."""
    import ast

    path = os.path.join(REPO, "graphcast_lite_torch",
                        *name.split(".")) + ".py"
    with open(path) as f:
        tree = ast.parse(f.read())
    banned = {"jax", "jaxlib", "flax", "optax", "graphcast_lite_tpu"}
    optional = {"sklearn", "joblib", "netCDF4", "xarray", "gcsfs", "cdsapi",
                "threadpoolctl"}
    top, inner = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = {node.module.split(".")[0]}
        else:
            continue
        (top if node in tree.body else inner).update(mods)
    assert not (top | inner) & banned, name
    assert not top & optional, (name, top & optional)
    assert "threadpoolctl" not in inner, name


@pytest.fixture(scope="module")
def tiny_serve(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("guard_data"))
    generate_synthetic_dataset(d, n_time=12, n_feat=N_FEAT, seed=1)
    _, _, test_ds, meta = load_chunked_datasets(d, obs_window=2,
                                                pred_steps=1,
                                                n_features=N_FEAT,
                                                test_split="test")
    _, tcfg = small_configs()
    return tcfg, test_ds, meta


def test_entry_points_need_a_card_unless_asked_for_cpu(tiny_serve,
                                                       monkeypatch):
    tcfg, test_ds, meta = tiny_serve
    model, graphs, _ = build_weather_model(tcfg, meta, device="cpu")
    report = evaluate_model(model, graphs, test_ds, meta, device="cpu",
                            max_samples=1)
    assert report.num_samples == 1 and np.isfinite(report.rmse)

    # With no card, a call that does not name the CPU raises: it never
    # carries on there quietly.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_weather_model(tcfg, meta)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_model(model, graphs, test_ds, meta, max_samples=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_model(model, graphs, test_ds, meta, device="cuda",
                       max_samples=1)


def test_train_step_needs_a_card_unless_asked_for_cpu(tiny_serve,
                                                      monkeypatch):
    from graphcast_lite_torch.training.rollout import RolloutSpec
    from graphcast_lite_torch.training.trainer import make_train_step

    tcfg, test_ds, meta = tiny_serve
    model, graphs, _ = build_weather_model(tcfg, meta, device="cpu")
    spec = RolloutSpec(obs_window=2, num_features=N_FEAT)
    x, y = test_ds.get(0)
    step = make_train_step(model, graphs, spec, tcfg, steps=1, device="cpu")
    assert torch.isfinite(step(x[None], y[None]))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(model, graphs, spec, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(model, graphs, spec, tcfg, device="cuda")


def test_trainer_and_clis_need_a_card_unless_asked_for_cpu(tiny_serve,
                                                           tmp_path,
                                                           monkeypatch):
    from graphcast_lite_torch.cli import make_demo, predict, train
    from graphcast_lite_torch.training.trainer import Trainer

    tcfg, _, meta = tiny_serve
    model, graphs, _ = build_weather_model(tcfg, meta, device="cpu")
    Trainer(model, graphs, tcfg, meta, str(tmp_path / "cpu"), device="cpu")
    exp = str(tmp_path / "demo")
    make_demo.main([exp])     # writes files only: no device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, graphs, tcfg, meta, str(tmp_path / "card"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main([exp, "--max-steps-per-epoch", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main([exp, "--max-samples", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main([exp, "--device", "cuda"])


def test_new_families_need_a_card_unless_asked_for_cpu(tiny_serve, tmp_path,
                                                      monkeypatch):
    """The GAT, SparseGAT and product-graph configurations (5 features,
    hidden 16) build, train a step and serve on the CPU when asked, and
    raise without a card otherwise."""
    from graphcast_lite_torch import presets
    from graphcast_lite_torch.training.trainer import Trainer

    _, test_ds, meta = tiny_serve
    cfgs = [presets.gat_64x32(n_feat=N_FEAT, hidden=16, heads=2),
            presets.sparse_gat_64x32(n_feat=N_FEAT, hidden=16),
            presets.product_graph_64x32(n_feat=N_FEAT, obs=2, hidden=16)]
    for i, cfg in enumerate(cfgs):
        cfg.graph.mesh_levels = [1, 2]
        model, graphs, _ = build_weather_model(cfg, meta, device="cpu")
        trainer = Trainer(model, graphs, cfg, meta, str(tmp_path / str(i)),
                          device="cpu")
        state = trainer.init_state()
        assert (state.edge_mask is not None) == trainer.using_sparse_gat
        x, y = test_ds.get(0)
        state, loss = trainer.train_step(state, x[None], y[None], 1, 0.1,
                                         trainer.using_sparse_gat)
        assert torch.isfinite(loss)
        report = evaluate_model(model, graphs, test_ds, meta, device="cpu",
                                max_samples=1, edge_mask=state.edge_mask)
        assert np.isfinite(report.rmse)

        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_available", lambda: False)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build_weather_model(cfg, meta)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                Trainer(model, graphs, cfg, meta, str(tmp_path / "card"))
            with pytest.raises(RuntimeError, match="no CUDA device"):
                evaluate_model(model, graphs, test_ds, meta, max_samples=1)


def test_train_regional_needs_a_card_unless_asked_for_cpu(tmp_path,
                                                         monkeypatch):
    """``cli.train_regional`` runs both heads on the CPU when asked, and
    raises without a card otherwise."""
    from graphcast_lite_torch.cli import make_demo, train_regional

    exp = str(tmp_path / "demo")
    make_demo.main([exp])
    args = [exp, "--roi", "20", "60", "60", "140", "--reg-level", "3",
            "--hidden", "16", "--processor-steps", "1", "--epochs", "1",
            "--max-steps-per-epoch", "1"]
    for head in ("dual_mesh", "roi_residual"):
        report = train_regional.main(args + ["--head", head, "--device",
                                             "cpu", "--evaluate"])
        assert np.isfinite(report.region["rmse"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_regional.main(args + extra)


def test_da_and_serving_entry_points_need_a_card_unless_asked_for_cpu(
        tmp_path, monkeypatch):
    """OI's solve, ``cli.predict --da oi``, the ladder, ``cli.check``,
    ``cli.eval_experiment`` and the cascade's U-Net run on the CPU when
    asked, and raise without a card otherwise."""
    from graphcast_lite_torch.assimilation.optimal_interpolation import \
        OptimalInterpolation
    from graphcast_lite_torch.cli import check, eval_experiment, \
        evaluate_pipeline, make_demo, predict
    from graphcast_lite_torch.inference.regional_pipelines import \
        unet_apply_nhwc

    exp = str(tmp_path / "demo")
    make_demo.main([exp])
    lats, lons = np.linspace(-10, 10, 4), np.linspace(0, 10, 5)
    oi = OptimalInterpolation(lats, lons, 1.0, 0.5, 3e5, device="cpu")
    assert oi.solve(np.eye(2), np.ones(2)).dtype == np.float32
    predict.main([exp, "--device", "cpu", "--ar-steps", "1",
                  "--max-samples", "1", "--da", "oi"])
    assert check.main(["graph", exp, "--device", "cpu"]) == 0
    ladder = [exp, "--ar-steps", "1", "--max-samples", "1",
              "--mos-calibration", "1"]
    assert set(evaluate_pipeline.main(ladder + ["--device", "cpu"])) >= {
        "raw", "+nudging", "+oi"}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: OptimalInterpolation(lats, lons, 1.0, 0.5, 3e5),
             lambda: predict.main([exp, "--max-samples", "1", "--da",
                                   "nudging"]),
             lambda: evaluate_pipeline.main(ladder),
             lambda: check.main(["weights", exp]),
             lambda: check.main(["graph", exp, "--device", "cuda"]),
             lambda: eval_experiment.main([exp, "--max-samples", "1"]),
             lambda: unet_apply_nhwc(torch.nn.Identity())]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
