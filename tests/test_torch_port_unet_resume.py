"""Resuming a JAX U-Net run on the port (fp32, CPU): the JAX ``Trainer``
takes two AR-1 steps of ``GridImageModel(WeatherUNet)`` at base 8 under
the CNN trainers' ``optax.chain(clip_by_global_norm(1.0),
adamw(schedule))``,
saves its ``checkpoint/state.msgpack``, resumes it and takes a third
step; the port's ``Trainer`` with ``training.optim.ClippedAdamW`` loads
the same file through ``Trainer.load_checkpoint`` and takes the same
step.  Losses within 1e-5 relative; parameters as
``tests/test_torch_port_unet_train.py`` holds them after three steps
(per leaf mean distance within 1e-3, largest within 0.2 of 3 × the
rate).  A state whose schedule count is not Adam's is refused.

Also ``utils.logs.compare_experiments`` against the JAX package's on the
same logs."""

import os

import jax
import numpy as np
import pytest

from graphcast_lite_tpu.models.grid_adapter import GridImageModel as JGIM
from graphcast_lite_tpu.models.unet import WeatherUNet as JV1
from graphcast_lite_tpu.training import checkpoint as jax_ckpt
from graphcast_lite_tpu.training.trainer import Trainer as JTrainer
from graphcast_lite_tpu.training.trainer import TrainState as JState
from graphcast_lite_torch.models.grid_adapter import GridImageModel
from graphcast_lite_torch.models.unet import WeatherUNet
from graphcast_lite_torch.training import checkpoint as ckpt_lib
from graphcast_lite_torch.training.optim import ClippedAdamW
from graphcast_lite_torch.training.trainer import Trainer
from graphcast_lite_torch.utils.flax_msgpack import load_msgpack
from graphcast_lite_torch.utils.params import from_flax_params, \
    from_optax_clipped_adamw_state
from test_torch_port_unet_train import C, DECAY_STEPS, LR, N_LAT, N_LON, \
    OBS, _configs, _data, _optax
from torch_port_common import jax_params, \
    one_torch_thread  # noqa: F401 (one_torch_thread: an autouse fixture)

MAX_NORM, AR = 1.0, 1


def _port_trainer(tmp, tcfg, tmeta):
    model = GridImageModel(WeatherUNet(OBS * C, C, 8), N_LAT, N_LON)
    opt = ClippedAdamW(model.parameters(), LR, DECAY_STEPS, MAX_NORM)
    return Trainer(model, None, tcfg, tmeta, str(tmp / "port"),
                   optimizer=opt, device="cpu")


@pytest.fixture(scope="module")
def jax_resumed(tmp_path_factory):
    """The JAX run: two steps, saved under ``<dir>/checkpoint``, resumed,
    a third step.  Returns (results dir, third loss, params after it)."""
    tmp = tmp_path_factory.mktemp("unet_resume")
    jcfg, _, jmeta, _ = _configs()
    x, y = _data()
    jmodel = JGIM(image_module=JV1(C, 8), n_lat=N_LAT, n_lon=N_LON)
    params = jax_params(jmodel, x[0, 0])
    jopt = _optax(MAX_NORM)
    jt = JTrainer(jmodel, None, jcfg, jmeta, str(tmp / "jax"),
                  optimizer=jopt)
    jstate = JState(params=params, opt_state=jopt.init(params),
                    edge_mask=None)
    for i in range(2):
        jstate, _ = jt.train_step(jstate, x[i], y[i], AR, 0.0, False, False)
    ckpt_dir = str(tmp / "port" / "checkpoint")
    jax_ckpt.save_checkpoint(ckpt_dir, jstate.params, jstate.opt_state,
                             None, {"epoch": 0})
    rparams, ropt, _, _ = jax_ckpt.load_checkpoint(
        ckpt_dir, jstate.params, jstate.opt_state, None)
    jstate = JState(params=rparams, opt_state=ropt, edge_mask=None)
    jstate, jloss = jt.train_step(jstate, x[2], y[2], AR, 0.0, False, False)
    return tmp, float(jloss), jax.tree.map(np.asarray, jstate.params)


def test_port_resumes_a_jax_unet_run(jax_resumed):
    tmp, jloss, jparams = jax_resumed
    _, tcfg, _, tmeta = _configs()
    x, y = _data()
    trainer = _port_trainer(tmp, tcfg, tmeta)
    state = trainer.init_state(seed=3)
    meta = trainer.load_checkpoint(state)
    assert meta["epoch"] == 0
    for p in state.model.parameters():
        assert int(state.optimizer.state[p]["step"]) == 2
    state, loss = trainer.train_step(state, x[2], y[2], AR)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    expect = from_flax_params(jparams)
    moved = 3 * LR
    for name, p in state.model.named_parameters():
        diff = np.abs(p.detach().numpy() - expect[name].numpy())
        assert diff.mean() <= 1e-3 * moved, (name, diff.mean())
        assert diff.max() <= 0.2 * moved, (name, diff.max())
        assert int(state.optimizer.state[p]["step"]) == 3


def test_mismatched_schedule_count_is_refused(jax_resumed):
    tmp = jax_resumed[0]
    _, tcfg, _, tmeta = _configs()
    model = _port_trainer(tmp, tcfg, tmeta).init_state(seed=0).model
    blob = load_msgpack(os.path.join(str(tmp / "port" / "checkpoint"),
                                     ckpt_lib.FLAX_STATE_FILE))
    opt_state = blob["opt_state"]
    converted = from_optax_clipped_adamw_state(opt_state, model)
    assert {float(s["step"]) for s in converted["state"].values()} == {2.0}
    opt_state["1"]["2"]["count"] = np.asarray(3, np.int32)
    with pytest.raises(ValueError, match="schedule's count"):
        from_optax_clipped_adamw_state(opt_state, model)
    with pytest.raises(ValueError, match="layout"):
        from_optax_clipped_adamw_state(opt_state["1"], model)


def test_compare_experiments_matches_jax(tmp_path):
    from graphcast_lite_tpu.utils.logs import compare_experiments as jax_cmp
    from graphcast_lite_torch.utils.logs import compare_experiments

    log = tmp_path / "training_log.txt"
    log.write_text(
        "=== Training started ===\n"
        "epoch  ar  train_loss  val_loss  val_ACC  best_vl  patience  time\n"
        " init  --  --  0.98988  0.6672  --  --  10:00:00\n"
        "    1   1     0.85914     0.82262    0.6985     0.82262         0"
        "  10:00:06\n"
        "    2   2     0.63981     0.72262    0.7155     0.72262         0"
        "  10:00:07\n")
    empty = tmp_path / "empty.txt"
    empty.write_text("=== Training started ===\n")
    paths = {"demo": str(log), "none": str(empty)}
    table = compare_experiments(paths)
    assert table == jax_cmp(paths)
    assert "| demo | 0.72262 | 0.7155 | 2 |" in table
