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
    under ``__main__``), imports without jax, flax, pydantic, msgpack or
    anything of graphcast_lite_tpu."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import graphcast_lite_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        assert callable(chip_smoke.main)
        banned = ("jax", "jaxlib", "flax", "pydantic", "msgpack",
                  "graphcast_lite_tpu")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in banned)
        print(len(names), "modules")
        sys.exit(f"imported {bad}" if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # 38 since the train step: ops.fused_edge, training.loss and
    # training.trainer joined the walk (35 with the COO routes).
    assert int(proc.stdout.split()[0]) >= 38, proc.stdout


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
