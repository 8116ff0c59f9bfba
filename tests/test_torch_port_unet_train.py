"""The CNN trainers' engine against the JAX package (fp32, CPU):
``training.optim.ClippedAdamW`` against optax's
``chain(clip_by_global_norm, adamw(cosine_decay_schedule))``, three
``Trainer`` steps of ``GridImageModel(WeatherUNetV2)`` with the spectral
and Sobel losses against the JAX ``Trainer`` (batch 2, AR 2, a schedule of
4 steps, the clip active and not), a checkpoint resume that continues the
schedule bit for bit, the JAX package's shared-trainer U-Net test mirrored
on the port, and the flat config schema.

Tolerances: losses 1e-5 relative; optimizer updates on equal gradients
1e-6 relative (1e-7 absolute).  Parameters after three train steps: per
leaf the mean distance within 1e-3 and the largest within 0.2 of the
most three steps can move a parameter (3 × the rate).  Adam moves each
coordinate by about the rate whatever its gradient's size (eps 1e-8), so
a coordinate whose gradient sits at the packages' rounding difference
moves either way (measured: mean 6e-5, largest 0.062 of 3 × the rate)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphcast_lite_tpu.config import DataConfig as JDataConfig
from graphcast_lite_tpu.config import ExperimentConfig as JExperimentConfig
from graphcast_lite_tpu.config import GridExperimentConfig as JGrid
from graphcast_lite_tpu.data.dataset import DatasetMetadata as JMeta
from graphcast_lite_tpu.models.grid_adapter import GridImageModel as JGIM
from graphcast_lite_tpu.models.unet import WeatherUNetV2 as JV2
from graphcast_lite_tpu.training.loss import gradient_loss as j_gradient_loss
from graphcast_lite_tpu.training.loss import spectral_loss as j_spectral_loss
from graphcast_lite_tpu.training.trainer import Trainer as JTrainer
from graphcast_lite_tpu.training.trainer import TrainState as JState
from graphcast_lite_torch.config import DataConfig, ExperimentConfig, \
    GridExperimentConfig, load_experiment_config, to_dict
from graphcast_lite_torch.data.dataset import DatasetMetadata
from graphcast_lite_torch.models.grid_adapter import GridImageModel
from graphcast_lite_torch.models.unet import WeatherUNetV2
from graphcast_lite_torch.training import checkpoint as ckpt_lib
from graphcast_lite_torch.training.loss import image_extra_loss
from graphcast_lite_torch.training.optim import ClippedAdamW, cosine_decay
from graphcast_lite_torch.training.trainer import Trainer
from graphcast_lite_torch.utils.params import from_flax_params
from torch_port_common import jax_params, \
    one_torch_thread  # noqa: F401 (one_torch_thread: an autouse fixture)

LR, DECAY_STEPS = 1e-3, 4
N_LAT, N_LON, C, OBS, AR, B = 8, 12, 4, 2, 2, 2


def _optax(max_norm):
    return optax.chain(optax.clip_by_global_norm(max_norm),
                       optax.adamw(optax.cosine_decay_schedule(
                           LR, DECAY_STEPS)))


@pytest.mark.parametrize("max_norm", [0.5, 1e6], ids=["clip", "no_clip"])
def test_optimizer_matches_optax(max_norm):
    """Five updates on the same gradients (past the schedule's end): the
    parameters after each update, the schedule's rate at each count."""
    rng = np.random.RandomState(0)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 2, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = ClippedAdamW(list(tp.values()), LR, DECAY_STEPS, max_norm)
    jopt = _optax(max_norm)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jopt.init(jp)
    sched = optax.cosine_decay_schedule(LR, DECAY_STEPS)
    for step in range(5):
        assert abs(cosine_decay(LR, DECAY_STEPS, step)
                   - float(sched(step))) <= 1e-6 * LR
        grads = {k: rng.randn(*s).astype(np.float32)
                 for k, s in shapes.items()}
        norm = np.sqrt(sum(np.square(g).sum() for g in grads.values()))
        assert (norm > max_norm) == (max_norm < 1)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        upd, state = jopt.update({k: jnp.asarray(g)
                                  for k, g in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert all(int(s["step"]) == 5 for s in opt.state.values())
    with pytest.raises(ValueError):
        ClippedAdamW(list(tp.values()), LR, 0)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    g = N_LAT * N_LON
    x = rng.randn(3, B, g, OBS * C).astype(np.float32)
    y = rng.randn(3, B, g, AR * C).astype(np.float32)
    return x, y


def _configs():
    kw = dict(batch_size=B, learning_rate=LR, num_epochs=2, max_ar_steps=AR,
              static_channels=[1], forcing_channels=[3])
    jcfg = JExperimentConfig(data=JDataConfig(
        dataset_name="unet", num_features_used=C, obs_window_used=OBS,
        pred_window_used=AR, want_feats_flattened=True), **kw)
    tcfg = ExperimentConfig(data=DataConfig(
        dataset_name="unet", num_features_used=C, obs_window_used=OBS,
        pred_window_used=AR, want_feats_flattened=True), **kw)
    meta = dict(flattened=True, num_latitudes=N_LAT, num_longitudes=N_LON,
                num_features=C, obs_window=OBS, pred_window=AR,
                num_grid_nodes=N_LAT * N_LON)
    return jcfg, tcfg, JMeta(**meta), DatasetMetadata(**meta)


def _jax_extra(out, target):
    io = out.reshape(out.shape[:-2] + (N_LAT, N_LON, C))
    it = target.reshape(target.shape[:-2] + (N_LAT, N_LON, C))
    return 0.1 * j_spectral_loss(io, it) + 0.05 * j_gradient_loss(io, it)


def _port_trainer(tmp_path, tcfg, tmeta, max_norm, name="port"):
    model = GridImageModel(WeatherUNetV2(OBS * C, C, 8), N_LAT, N_LON)
    opt = ClippedAdamW(model.parameters(), LR, DECAY_STEPS, max_norm)
    return Trainer(model, None, tcfg, tmeta, str(tmp_path / name),
                   optimizer=opt,
                   extra_loss_fn=image_extra_loss(N_LAT, N_LON, C, 0.1, 0.05),
                   device="cpu")


@pytest.mark.parametrize("max_norm", [1.0, 1e6], ids=["clip", "no_clip"])
def test_trainer_steps_match_jax(tmp_path, max_norm):
    """Three steps of both Trainers on the same weights and batches: every
    step's loss, every parameter after the third update; then the port's
    checkpoint after step 2, resumed by a new Trainer, gives step 3's
    parameters and optimizer state bit for bit."""
    jcfg, tcfg, jmeta, tmeta = _configs()
    x, y = _data()
    jmodel = JGIM(image_module=JV2(C, 8), n_lat=N_LAT, n_lon=N_LON)
    params = jax_params(jmodel, x[0, 0])
    jopt = _optax(max_norm)
    jt = JTrainer(jmodel, None, jcfg, jmeta, str(tmp_path / "jax"),
                  optimizer=jopt, extra_loss_fn=_jax_extra)
    jstate = JState(params=params, opt_state=jopt.init(params),
                    edge_mask=None)
    trainer = _port_trainer(tmp_path, tcfg, tmeta, max_norm)
    state = trainer.init_state(seed=0)
    state.model.load_state_dict(from_flax_params(params))
    norms = []
    for i in range(3):
        jstate, jloss = jt.train_step(jstate, x[i], y[i], AR, 0.0, False,
                                      False)
        state, loss = trainer.train_step(state, x[i], y[i], AR)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        norms.append(torch.sqrt(sum(torch.sum(p.grad ** 2) for p in
                                    state.model.parameters())).item())
        if i == 1:
            ckpt_lib.save_checkpoint(str(tmp_path / "ckpt"), state.model,
                                     state.optimizer, {"epoch": 0})
    assert (min(norms) > max_norm) == (max_norm == 1.0), norms
    expect = from_flax_params(jax.tree.map(np.asarray, jstate.params))
    moved = 3 * LR          # the most three steps can move a parameter
    for name, p in state.model.named_parameters():
        diff = np.abs(p.detach().numpy() - expect[name].numpy())
        assert diff.mean() <= 1e-3 * moved, (name, diff.mean())
        assert diff.max() <= 0.2 * moved, (name, diff.max())

    resumed = _port_trainer(tmp_path, tcfg, tmeta, max_norm, "resumed")
    rstate = resumed.init_state(seed=1)
    ckpt_lib.load_checkpoint(str(tmp_path / "ckpt"), rstate.model,
                             rstate.optimizer)
    rstate, rloss = resumed.train_step(rstate, x[2], y[2], AR)
    assert float(rloss) == float(loss)
    for (name, p), q in zip(state.model.named_parameters(),
                            rstate.model.parameters()):
        assert torch.equal(p, q), name
        s, r = state.optimizer.state[p], rstate.optimizer.state[q]
        assert int(s["step"]) == int(r["step"]) == 3
        assert torch.equal(s["exp_avg"], r["exp_avg"]), name
        assert torch.equal(s["exp_avg_sq"], r["exp_avg_sq"]), name


def test_unet_through_shared_trainer(tmp_path):
    """tests/test_unet.py::test_unet_through_shared_trainer on the port:
    a U-Net trains through the GNNs' Trainer (val loss falls) and is
    evaluated by the shared inference engine (finite)."""
    from graphcast_lite_torch.data.dataset import load_chunked_datasets
    from graphcast_lite_torch.data.synthetic import \
        generate_synthetic_dataset
    from graphcast_lite_torch.inference.predict import evaluate_model
    from graphcast_lite_torch.models.unet import WeatherUNet

    data_dir = str(tmp_path / "data")
    generate_synthetic_dataset(data_dir, n_time=24, n_lon=16, n_lat=8,
                               n_feat=4)
    train_ds, val_ds, _, meta = load_chunked_datasets(
        data_dir, obs_window=2, pred_steps=2, n_features=4)
    cfg = ExperimentConfig(
        batch_size=2, learning_rate=1e-3, num_epochs=4, max_ar_steps=2,
        data=DataConfig(dataset_name="synthetic", num_features_used=4,
                        obs_window_used=2, pred_window_used=2,
                        want_feats_flattened=True))
    model = GridImageModel(WeatherUNet(8, 4, 8), n_lat=8, n_lon=16)
    opt = ClippedAdamW(model.parameters(), 1e-3, 200)
    trainer = Trainer(model, None, cfg, meta, str(tmp_path / "results"),
                      optimizer=opt, device="cpu")
    state = trainer.init_state(seed=0)
    results = trainer.fit(state, train_ds, val_ds, print_losses=False)
    assert results["val_losses"][-1] < results["val_losses"][0]
    for name in ("best_model.pt", "results.json", "training_log.txt",
                 os.path.join("checkpoint", "state.pt")):
        assert (tmp_path / "results" / name).exists(), name
    report = evaluate_model(trainer.final_state.model, None, val_ds, meta,
                            ar_steps=2, max_samples=2, device="cpu")
    assert np.isfinite(report.rmse) and report.num_samples == 2


def test_grid_config_roundtrip(tmp_path):
    """tests/test_config_ingestion.py's flat U-Net dict: the port's
    ``GridExperimentConfig`` and ``to_experiment_config`` give the JAX
    package's values field by field; defaults too."""
    from graphcast_lite_tpu.config import \
        load_experiment_config as jax_load

    raw = {
        "data_dir": "data/x", "num_features": 23, "obs_window": 4,
        "batch_size": 8, "learning_rate": 5e-4, "num_epochs": 80,
        "patience": 15, "base_filters": 64, "max_ar_steps": 4,
        "attn_heads": 4, "spectral_modes": 4, "spectral_weight": 0.1,
        "gradient_weight": 0.05, "static_channels": [7, 8],
        "forcing_channels": [19, 20, 21, 22], "random_seed": 42,
        "wandb_key": "secret", "unknown_key": 1,
    }
    for case in (raw, {"num_features": 5, "base_filters": 16}):
        p = tmp_path / "config.json"
        p.write_text(json.dumps(case))
        cfg, jcfg = load_experiment_config(str(p)), jax_load(str(p))
        assert isinstance(cfg, GridExperimentConfig)
        assert isinstance(jcfg, JGrid)
        assert to_dict(cfg) == jcfg.model_dump()
        ec, jec = cfg.to_experiment_config(), jcfg.to_experiment_config()
        assert to_dict(ec) == json.loads(jec.model_dump_json())
