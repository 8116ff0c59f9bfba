"""Checkpoints and resume in the port, and the JAX package's checkpoints
read by the port without flax or msgpack, on the CPU.

* Resume: a port fit interrupted after epoch 2 and resumed gives the same
  losses, bit for bit, as the same fit in one go (4 epochs, AR 1, 1, 2,
  2).
* Cross-package resume: the JAX ``Trainer`` fits 2 epochs and writes
  ``checkpoint/state.msgpack``; the port resumes it for epoch 3
  (``load_flax_checkpoint``: params, Adam's moments and step, meta), and so
  does the JAX package; the two epoch-3 losses agree within ``FIT_RTOL``.
  Both optimizer layouts: ``optax.adam`` (lr factor 1) and the
  ``multi_transform`` of a processor frozen for epoch 1 with lr factor 0.1.
* ``utils.flax_msgpack.msgpack_restore`` against
  ``flax.serialization.msgpack_restore``: on those real checkpoints, on a
  tree of every dtype and msgpack type flax writes, and on arrays chunked
  over a (monkeypatched, small) ``MAX_CHUNK_SIZE``.
* ``partial_restore`` reports the same missing / unexpected / mismatched
  names as the JAX function on a model with one changed width.
"""

import copy
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from graphcast_lite_tpu.training import checkpoint as jax_ckpt
from graphcast_lite_tpu.training.trainer import Trainer as JaxTrainer
from graphcast_lite_torch.training import checkpoint as port_ckpt
from graphcast_lite_torch.training.trainer import Trainer as PortTrainer
from graphcast_lite_torch.utils.flax_msgpack import msgpack_restore
from graphcast_lite_torch.utils.params import from_flax_params
from torch_port_common import FIT_RTOL, fit_experiment, flax_numpy, \
    one_torch_thread  # noqa: F401 (an autouse fixture)

STEPS = 2   # steps an epoch
LAYOUTS = {
    # name: (config updates, processor lr factor)
    "adam": ({}, 1.0),
    "multi_transform": ({"freeze_processor_epochs": 1,
                         "finetune_processor_lr_factor": 0.1}, 0.1),
}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per optimizer layout: the JAX fit of 2 epochs (its checkpoint copied
    aside), then the JAX package's own resume of that checkpoint for
    epoch 3, and the experiment's port half."""
    runs = {}
    for name, (updates, factor) in LAYOUTS.items():
        tmp = tmp_path_factory.mktemp(name)
        (jcfg, jmodel, jgraphs, (jtrain, jval, jmeta), pcfg, pmodel,
         pgraphs, (ptrain, pval, pmeta)) = fit_experiment(
            tmp, "conv_gcn", num_epochs=2, **updates)
        jt = JaxTrainer(jmodel, jgraphs, jcfg, jmeta, str(tmp / "jax"),
                        processor_lr_factor=factor)
        jt.fit(jt.init_state(seed=0), jtrain, jval, print_losses=False,
               max_steps_per_epoch=STEPS)
        shutil.copytree(tmp / "jax", tmp / "saved")
        # The same Trainer (its compiled steps) resumes for epoch 3.
        jt.config = jcfg.model_copy(update={"num_epochs": 3})
        jres = jt.fit(jt.init_state(seed=1), jtrain, jval,
                      print_losses=False, resume=True,
                      max_steps_per_epoch=STEPS)
        pcfg.num_epochs = 3
        runs[name] = dict(dir=tmp / "saved", jax=jres, factor=factor,
                          port=(pcfg, pmodel, pgraphs, ptrain, pval, pmeta))
    jax.clear_caches()
    return runs


def _port_resume(run, tmp_path, reset_adam=False):
    pcfg, pmodel, pgraphs, ptrain, pval, pmeta = run["port"]
    results = tmp_path / "port"
    shutil.copytree(run["dir"], results)
    trainer = PortTrainer(copy.deepcopy(pmodel), pgraphs, pcfg, pmeta,
                          str(results), processor_lr_factor=run["factor"],
                          device="cpu")
    state = trainer.init_state(seed=5)
    if reset_adam:
        trainer.load_checkpoint(state)
        state.optimizer.state.clear()
        ckpt = results / "checkpoint"
        port_ckpt.save_checkpoint(str(ckpt), state.model, state.optimizer,
                                  port_ckpt._meta(str(ckpt)))
    return trainer.fit(state, ptrain, pval, resume=True, print_losses=False,
                       max_steps_per_epoch=STEPS), trainer


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_port_resumes_a_jax_checkpoint(jax_runs, tmp_path, layout):
    run = jax_runs[layout]
    pres, trainer = _port_resume(run, tmp_path)
    jres = run["jax"]
    for key in ("train_losses", "val_losses"):
        assert len(pres[key]) == len(jres[key]) == 3
        assert pres[key][:2] == jres[key][:2]      # from meta.json
        np.testing.assert_allclose(pres[key][2], jres[key][2],
                                   rtol=FIT_RTOL, err_msg=key)
    # Adam's step came from optax's count: 2 epochs x 2 steps, then 2 more.
    steps = {float(s["step"]) for s in trainer.optimizer.state.values()}
    assert steps == {2.0 * STEPS + STEPS}
    assert len(trainer.optimizer.param_groups) == (
        1 if run["factor"] == 1.0 else 2)
    # The moments matter: a resume without them lands elsewhere.
    fresh, _ = _port_resume(run, tmp_path / "fresh", reset_adam=True)
    assert abs(fresh["train_losses"][2] - jres["train_losses"][2]) \
        > 10 * FIT_RTOL * abs(jres["train_losses"][2])


def test_load_flax_checkpoint_maps_every_moment(jax_runs):
    """The converted Adam state is optax's, leaf by leaf, and the params
    are the saved ones."""
    for name, run in jax_runs.items():
        pcfg, pmodel, *_ = run["port"]
        model = copy.deepcopy(pmodel)
        opt = torch.optim.Adam(
            [{"params": [p for n, p in model.named_parameters()
                         if "processor" not in n.split(".")], "lr": 1e-3},
             {"params": [p for n, p in model.named_parameters()
                         if "processor" in n.split(".")], "lr": 1e-4}]
            if run["factor"] != 1.0 else model.parameters(), lr=1e-3)
        meta = port_ckpt.load_flax_checkpoint(
            str(run["dir"] / "checkpoint"), model, opt)
        assert meta["epoch"] == 1
        with open(run["dir"] / "checkpoint" / "state.msgpack", "rb") as f:
            blob = serialization.msgpack_restore(f.read())
        opt_state = blob["opt_state"]
        if run["factor"] == 1.0:
            inner = {"rest": opt_state["0"], "processor": opt_state["0"]}
        else:
            inner = {k: v["inner_state"]["0"]
                     for k, v in opt_state["inner_states"].items()}
        params = dict(model.named_parameters())
        want = from_flax_params(blob["params"])
        for n, p in params.items():
            assert torch.equal(p.detach(), want[n]), n
            part = inner["processor" if "processor" in n.split(".")
                         else "rest"]
            st = opt.state[p]
            assert float(st["step"]) == float(part["count"]) == 2 * STEPS
            for key, src in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                assert torch.equal(st[key],
                                   from_flax_params(part[src])[n]), (n, key)



def test_load_flax_checkpoint_refuses_an_edge_mask(jax_runs, tmp_path):
    """A JAX checkpoint's SparseGAT edge mask that has no place in the
    state (no mask there, or one of another shape) raises instead of being
    dropped, and leaves the model as it was; one that fits is copied in."""
    run = jax_runs["adam"]
    ckpt = tmp_path / "checkpoint"
    shutil.copytree(run["dir"] / "checkpoint", ckpt)
    with open(ckpt / "state.msgpack", "rb") as f:
        blob = serialization.msgpack_restore(f.read())
    saved = (np.arange(8) % 3 > 0).astype(np.float32)
    blob["edge_mask"] = saved
    with open(ckpt / "state.msgpack", "wb") as f:
        f.write(serialization.msgpack_serialize(blob))
    model = copy.deepcopy(run["port"][1])
    before = copy.deepcopy(model.state_dict())
    for template in (None, torch.ones(9)):
        with pytest.raises(ValueError, match="edge mask"):
            port_ckpt.load_flax_checkpoint(
                str(ckpt), model, torch.optim.Adam(model.parameters()),
                template)
        for n, p in model.state_dict().items():
            assert torch.equal(p, before[n]), n
    mask = torch.ones(8)
    port_ckpt.load_flax_checkpoint(
        str(ckpt), model, torch.optim.Adam(model.parameters()), mask)
    np.testing.assert_array_equal(mask.numpy(), saved)

@pytest.mark.parametrize("factor", [1.0, 0.1])
def test_optax_moments_are_torch_adams(tmp_path, factor):
    """One update of the JAX package's optimizer and one ``torch.optim.Adam``
    step of the port's ``build_optimizer`` on the same gradients: the
    converted optax state is the torch state (the InteractionNet's
    ``nn.scan`` steps unstacked), up to fp32 rounding."""
    from graphcast_lite_tpu.training.trainer import build_optimizer as jopt
    from graphcast_lite_torch.training.trainer import build_optimizer
    from graphcast_lite_torch.utils.params import from_optax_adam_state
    (_, jmodel, jgraphs, _, _, tmodel, _, _) = fit_experiment(
        tmp_path, "interaction_net")
    dummy = np.zeros((jmodel.num_grid_nodes, 10), np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), dummy, jgraphs)
    tmodel.load_state_dict(from_flax_params(flax_numpy(params)))
    rng = np.random.RandomState(0)
    grads = jax.tree.map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)),
        params)
    opt = jopt(1e-3, factor)
    _, state = jax.jit(opt.update)(grads, opt.init(params), params)
    tree = jax.tree.map(np.asarray, serialization.to_state_dict(state))
    converted = from_optax_adam_state(tree, tmodel, factor)

    torch_opt = build_optimizer(tmodel, 1e-3, factor)
    g = from_flax_params(flax_numpy(grads))
    for n, p in tmodel.named_parameters():
        p.grad = g[n].clone()
    torch_opt.step()
    want = torch_opt.state_dict()
    assert [gr["params"] for gr in want["param_groups"]] \
        == [gr["params"] for gr in converted["param_groups"]]
    assert set(want["state"]) == set(converted["state"])
    steps = sum(".inet.steps." in n for n, _ in tmodel.named_parameters())
    assert steps > 0
    for i, st in want["state"].items():
        got = converted["state"][i]
        assert float(got["step"]) == float(st["step"]) == 1.0
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(got[key], st[key], rtol=1e-6,
                                       atol=0.0)


def _assert_same_tree(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same_tree(a, b, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape, path
        if want.dtype.name == "bfloat16":   # returned as float32, exact
            assert got.dtype == np.float32, path
            want = want.astype(np.float32)
        else:
            assert got.dtype == want.dtype, path
        assert np.array_equal(got, want), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def test_flax_msgpack_reads_real_checkpoints(jax_runs):
    for run in jax_runs.values():
        for name in ("checkpoint/state.msgpack", "best_model.msgpack"):
            data = (run["dir"] / name).read_bytes()
            _assert_same_tree(msgpack_restore(data),
                              serialization.msgpack_restore(data))


def test_flax_msgpack_reads_every_type_flax_writes():
    tree = {
        "f32": np.arange(6, dtype=np.float32).reshape(2, 3),
        "f16": np.array([1.5, -2.25], np.float16),
        "f64": np.array([1e300, -1e-300]),
        "bf16": jnp.asarray([1.5, -3.0, 7.0], jnp.bfloat16),
        "i8": np.array([-128, 127], np.int8),
        "i32": np.arange(5, dtype=np.int32),
        "i64": np.array([-2 ** 40], np.int64),
        "u8": np.array([0, 255], np.uint8),
        "bool": np.array([True, False]),
        "c64": np.array([1 + 2j], np.complex64),
        "scalar0d": np.array(3, np.int32),
        "npscalar": np.float32(2.5),
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32,
                 -33, -128, -129, -32768, -32769, -2 ** 31 - 1],
        "floats": [0.5, -1e-10, 1e300], "none": None, "t": True, "f": False,
        "complex": 1.0 - 3.0j, "str": "x" * 40, "long": "y" * 70000,
        "bytes": b"\x00\x01" * 200, "empty": {}, "list": [],
        "wide": {str(i): i for i in range(20)},
        "nested": {"a": {"b": {"c": np.zeros((0, 3), np.float32)}}},
    }
    data = serialization.msgpack_serialize(tree)
    _assert_same_tree(msgpack_restore(data),
                      serialization.msgpack_restore(data))
    with pytest.raises(ValueError):
        msgpack_restore(data + b"\x00")
    with pytest.raises(ValueError):
        msgpack_restore(b"\xc1")


def test_flax_msgpack_joins_chunked_arrays(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(300, dtype=np.float32).reshape(3, 100),
            "small": np.ones(4, np.float32),
            "deep": {"x": np.arange(50, dtype=np.int64)}}
    data = serialization.to_bytes(tree)
    raw = serialization.msgpack_restore(data)
    assert np.array_equal(raw["w"], tree["w"])
    got = msgpack_restore(data)
    _assert_same_tree(got, raw)
    assert np.array_equal(got["w"], tree["w"])


def _port_names(tree, keys):
    """JAX key paths (``jax.tree_util.keystr``) -> the port's state-dict
    names through ``from_flax_params``."""
    names = set()
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if jax.tree_util.keystr(kp) in keys:
            nested = np.asarray(leaf)
            for k in reversed(kp):
                nested = {k.key: nested}
            names |= set(from_flax_params(nested))
    return names


def test_partial_restore_matches_jax(tmp_path):
    """Restore a checkpoint of the small experiment into the same model with
    a wider encoder MLP."""
    from graphcast_lite_torch.build import build_weather_model

    (jcfg, jmodel, jgraphs, (_, _, jmeta), pcfg, pmodel, _,
     (_, _, pmeta)) = fit_experiment(tmp_path, "conv_gcn")
    wide = jcfg.model_copy(deep=True)
    wide.pipeline.encoder.mlp.mlp_hidden_dims = [48]
    pwide = copy.deepcopy(pcfg)
    pwide.pipeline.encoder.mlp.mlp_hidden_dims = [48]

    from graphcast_lite_tpu.models.weather import WeatherModel as JaxModel

    g = jmodel.num_grid_nodes
    dummy = np.zeros((g, 10), np.float32)
    saved = jax.jit(jmodel.init)(jax.random.PRNGKey(0), dummy, jgraphs)
    jwide = JaxModel(pipeline=wide.pipeline, data=wide.data,
                     num_grid_nodes=g, num_mesh_nodes=jmodel.num_mesh_nodes)
    template = jax.jit(jwide.init)(jax.random.PRNGKey(1), dummy, jgraphs)
    raw = serialization.msgpack_restore(serialization.to_bytes(saved))
    restored, jreport = jax_ckpt.partial_restore(template, raw,
                                                 verbose=False)

    model, _, _ = build_weather_model(pwide, pmeta, device="cpu", seed=1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = from_flax_params(flax_numpy(saved))
    report = port_ckpt.partial_restore(model, state, verbose=False)

    assert report["mismatched"] and not report["missing"]
    for key, tree in (("missing", template), ("mismatched", template),
                      ("unexpected", saved)):
        assert set(report[key]) == _port_names(tree, set(jreport[key])), key
    # The matching entries were copied and the rest left as they were, as
    # the JAX function restores them.
    want = from_flax_params(flax_numpy(restored))
    for n, p in model.named_parameters():
        expect = before[n] if n in report["mismatched"] else want[n]
        assert torch.equal(p.detach(), expect), n


class _Stopped(Exception):
    """A fit stopped after a checkpoint, as an interrupted run stops."""


def test_port_resume_equals_one_fit(tmp_path, monkeypatch):
    """A port fit stopped after epoch 2 (its checkpoint written) and resumed
    gives the losses of the same 4-epoch fit in one go, bit for bit."""
    from graphcast_lite_torch.build import build_weather_model

    (_, _, _, _, pcfg, _, _, (ptrain, pval, pmeta)) = fit_experiment(
        tmp_path, "conv_gcn", num_epochs=4)

    def fit(results, interrupt=False, resume=False):
        model, graphs, _ = build_weather_model(pcfg, pmeta, device="cpu")
        trainer = PortTrainer(model, graphs, pcfg, pmeta, str(results),
                              device="cpu")
        state = trainer.init_state(seed=3)
        if interrupt:
            save = port_ckpt.save_checkpoint

            def save_then_stop(ckpt_dir, *args, **kwargs):
                save(ckpt_dir, *args, **kwargs)
                if args[-1]["epoch"] == 1:
                    raise _Stopped

            monkeypatch.setattr(port_ckpt, "save_checkpoint", save_then_stop)
            with pytest.raises(_Stopped):
                trainer.fit(state, ptrain, pval, print_losses=False,
                            max_steps_per_epoch=STEPS)
            monkeypatch.setattr(port_ckpt, "save_checkpoint", save)
            return None
        return trainer.fit(state, ptrain, pval, resume=resume,
                           print_losses=False, max_steps_per_epoch=STEPS)

    whole = fit(tmp_path / "whole")
    fit(tmp_path / "split", interrupt=True)
    resumed = fit(tmp_path / "split", resume=True)
    assert resumed == whole
    assert len(whole["train_losses"]) == 4
