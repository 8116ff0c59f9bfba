"""The port's ``Trainer.fit`` against the JAX package's ``Trainer.fit`` on
the CPU: the same initial weights (the JAX ``init_state(seed=0)`` bridged
with ``from_flax_params``), the same synthetic 16x8 dataset and the same
``small_experiment`` config (hidden 16, ROADMAP trap 5).

Every epoch's train loss, validation loss and validation ACC agree within
``FIT_RTOL`` (1e-4 relative; measured about 5e-6), and the AR level of
each epoch, the epoch of ``best_model``, the early-stop epoch and the keys
of ``checkpoint/meta.json`` are identical.  Two processors: ConvGCN (4
epochs x 2 steps, AR 1, 1, 2, 2) and the lazy-LN InteractionNet on the
reg-block route (``GCLT_LAZY_EDGE=1``, so the JAX package runs its Pallas
calls in interpret mode; 2 epochs x 1 step, with early stopping set to
stop at epoch 2).
"""

import json
import os

import jax
import numpy as np
import pytest

from graphcast_lite_tpu.training.trainer import Trainer as JaxTrainer
from graphcast_lite_tpu.utils.logs import parse_training_log as jax_log
from graphcast_lite_torch import tracing
from graphcast_lite_torch.training.trainer import Trainer as PortTrainer
from graphcast_lite_torch.utils.logs import parse_training_log as port_log
from graphcast_lite_torch.utils.params import from_flax_params
from torch_port_common import FIT_RTOL, fit_experiment, flax_numpy, \
    one_torch_thread, read_jsonl  # noqa: F401 (an autouse fixture)

CASES = {
    # (processor, config updates, steps an epoch)
    "conv_gcn": ("conv_gcn", {"num_epochs": 4}, 2),
    # patience 1 and a delta no improvement reaches: best at epoch 1,
    # early stop at epoch 2 in both packages whatever the losses.
    "interaction_net_lazy": ("interaction_net",
                             {"num_epochs": 2, "early_stopping_patience": 1,
                              "early_stopping_delta": 1e9}, 1),
}


def _best_epoch(rows):
    """The last epoch whose validation loss improved (patience back to 0
    without an AR raise: an improvement saves best_model)."""
    return max(r["epoch"] for r in rows if r["patience"] == 0)


def _early_stop(path):
    with open(path) as f:
        return [line.strip() for line in f if "Early stopping" in line]


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_matches_jax(tmp_path, monkeypatch, case):
    processor, updates, steps = CASES[case]
    for name in ("GCLT_REG_EDGE", "GCLT_EDGE_STEP", "GCLT_MEGA_EDGE"):
        monkeypatch.delenv(name, raising=False)
    if processor == "interaction_net":
        monkeypatch.setenv("GCLT_LAZY_EDGE", "1")
    (jcfg, jmodel, jgraphs, (jtrain, jval, jmeta), pcfg, pmodel, pgraphs,
     (ptrain, pval, pmeta)) = fit_experiment(tmp_path, processor, **updates)

    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jt = JaxTrainer(jmodel, jgraphs, jcfg, jmeta, str(jdir))
    jstate = jt.init_state(seed=0)
    params0 = flax_numpy(jstate.params)
    jres = jt.fit(jstate, jtrain, jval, print_losses=False,
                  max_steps_per_epoch=steps)

    pt = PortTrainer(pmodel, pgraphs, pcfg, pmeta, str(pdir), device="cpu")
    pstate = pt.init_state(seed=0)
    pstate.model.load_state_dict(from_flax_params(params0))
    pres = pt.fit(pstate, ptrain, pval, print_losses=False,
                  max_steps_per_epoch=steps)
    if processor == "interaction_net":
        assert {s.route for s in pmodel.processor.graph_layer.inet.steps} \
            == {"reg_block"}

    for key in ("train_losses", "val_losses"):
        got, want = np.array(pres[key]), np.array(jres[key])
        assert got.shape == want.shape, (key, got, want)
        np.testing.assert_allclose(got, want, rtol=FIT_RTOL, err_msg=key)
    jm, pm = read_jsonl(jdir / "metrics.jsonl"), read_jsonl(
        pdir / "metrics.jsonl")
    assert [r["epoch"] for r in pm] == [r["epoch"] for r in jm]
    assert [r["ar_steps"] for r in pm] == [r["ar_steps"] for r in jm]
    np.testing.assert_allclose([r["val_acc"] for r in pm],
                               [r["val_acc"] for r in jm], rtol=FIT_RTOL)
    np.testing.assert_allclose([r["raw_rmse"] for r in pm],
                               [r["raw_rmse"] for r in jm], rtol=FIT_RTOL)
    jrows = jax_log(str(jdir / "training_log.txt"))
    prows = port_log(str(pdir / "training_log.txt"))
    assert [(r["epoch"], r["ar"], r["patience"]) for r in prows] \
        == [(r["epoch"], r["ar"], r["patience"]) for r in jrows]
    assert _best_epoch(prows) == _best_epoch(jrows)
    assert _early_stop(pdir / "training_log.txt") \
        == _early_stop(jdir / "training_log.txt")

    with open(jdir / "checkpoint" / "meta.json") as f:
        jmeta_json = json.load(f)
    with open(pdir / "checkpoint" / "meta.json") as f:
        pmeta_json = json.load(f)
    assert set(pmeta_json) == set(jmeta_json)
    for key in ("epoch", "ar_steps", "patience_counter"):
        assert pmeta_json[key] == jmeta_json[key], key
    np.testing.assert_allclose(pmeta_json["best_val_loss"],
                               jmeta_json["best_val_loss"], rtol=FIT_RTOL)
    for name in ("best_model.pt", "results.json", "training_log.txt",
                 "metrics.jsonl", os.path.join("checkpoint", "state.pt")):
        assert (pdir / name).exists(), name
    if case == "interaction_net_lazy":
        assert len(pres["train_losses"]) == 2
        assert _early_stop(pdir / "training_log.txt") \
            == [">>> Early stopping at epoch 2"]
        assert _best_epoch(prows) == 1
    else:
        assert [r["ar_steps"] for r in pm] == [1, 1, 2, 2]
        assert _early_stop(pdir / "training_log.txt") == []
    jax.clear_caches()


def test_profile_dir_traces_the_second_step(tmp_path, monkeypatch):
    """``GCLT_PROFILE_DIR`` writes a ``torch.profiler`` Chrome trace of the
    first epoch's second step, with the program's ``gclt::`` span ranges,
    and leaves the losses as they are."""
    (*_, pcfg, pmodel, pgraphs, (ptrain, pval, pmeta)) = fit_experiment(
        tmp_path, "conv_gcn", num_epochs=1)
    state0 = {k: v.clone() for k, v in pmodel.state_dict().items()}
    prof = tmp_path / "prof"
    runs = {}
    for name in ("plain", "profiled"):
        if name == "profiled":
            monkeypatch.setenv("GCLT_PROFILE_DIR", str(prof))
        pmodel.load_state_dict(state0)
        pt = PortTrainer(pmodel, pgraphs, pcfg, pmeta, str(tmp_path / name),
                         device="cpu")
        state = pt.init_state(seed=0)
        runs[name] = pt.fit(state, ptrain, pval, print_losses=False,
                            max_steps_per_epoch=2)
        assert (prof / "train_step_trace.json").exists() \
            == (name == "profiled")
    assert runs["profiled"] == runs["plain"]
    with open(prof / "train_step_trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
    # The step's spans recorded while it was profiled (``tracing``).
    assert {"gclt::train.step", "gclt::train.forward", "gclt::train.backward",
            "gclt::train.optimizer", "gclt::model"} <= names
    assert tracing.recorder() is None
