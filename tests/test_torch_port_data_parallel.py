"""The data-parallel step (``parallel.sharding.make_data_parallel_train_step``
and ``make_data_parallel_eval_step``) on 2 gloo ranks on the CPU, against
its oracle: the JAX package's one-device ``Trainer`` step run under GSPMD,
the batch ``jax.device_put`` with ``P("data")`` over a (2, 1) mesh of the
suite's virtual CPU devices and the state replicated, as
``bench.py: bench_gspmd_fallback`` runs the families that the explicit
sharded path refuses.

Five such families, 5 features, hidden 16, weights from the JAX init (or a
numpy seed for the U-Net) bridged by ``from_flax_params``, one spawn of 2
ranks for all of them (``torch_port_dist.data_parallel_cases``):

* the product-graph GCN (``presets.product_graph_64x32``, its AR 1);
* a ``SimpleConv`` encoder (after a graph-mode LayerNorm MLP) and a
  ``SimpleConv`` processor (AR 1);
* a direct multi-step GCN (the decoder emits 3 steps' channels at once);
* SparseGAT pruning at 0.1356 on the batch's first sample (AR 2: the
  second AR step runs on the mask that data rank 0 pruned);
* ``GridImageModel`` over U-Net V1 with the spectral and Sobel losses and
  ``ClippedAdamW``, its global-norm clip engaged (AR 1).

Each at B = 2 (one sample a rank) with a static and a forcing channel and
latitude weights.  Checks: the loss within 1e-5 relative, the averaged
gradients within 1e-4·max|g| + 1e-6 per leaf of the gradients the JAX
step's optimizer received (recorded in its state), and the post-step
parameters within 1e-5·max|p| of the JAX step wherever Adam's update is
resolved (``ADAM_RESOLVED``); the pruned mask equal; the ranks' losses, masks and parameters bitwise equal, one
all-reduce a step; each rank's model calls on its block of B / 2
samples; the eval step against the one-device ``Trainer``'s
evaluation of the whole batch (loss and raw RMSE 1e-6 relative, the ACC,
which lies in [-1, 1] and near 0 on random data, 1e-6 absolute) and the
JAX eval step under GSPMD (1e-5 alike); at world 1 (a group of one rank) loss, mask and parameters
bitwise ``make_train_step``'s (each case on one of the ranks); the refusals of a space axis and of a batch
that does not divide."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_port_dist as tpd
from graphcast_lite_tpu import config as jconf
from graphcast_lite_tpu.data.dataset import DatasetMetadata as JMeta
from graphcast_lite_tpu.models import unet as JU
from graphcast_lite_tpu.models.grid_adapter import GridImageModel as JGIM
from graphcast_lite_tpu.models.weather import ModelGraphs as JGraphs
from graphcast_lite_tpu.models.weather import WeatherModel as JModel
from graphcast_lite_tpu.training.loss import gradient_loss as j_gradient
from graphcast_lite_tpu.training.loss import spectral_loss as j_spectral
from graphcast_lite_tpu.training.trainer import Trainer as JTrainer
from graphcast_lite_tpu.training.trainer import TrainState as JState
from graphcast_lite_torch import config as pconf
from graphcast_lite_torch.data.dataset import DatasetMetadata
from graphcast_lite_torch.models.grid_adapter import GridImageModel
from graphcast_lite_torch.models.unet import WeatherUNet
from graphcast_lite_torch.models.weather import WeatherModel as PModel
from graphcast_lite_torch.parallel.sharding import ProcessMesh, \
    make_data_parallel_train_step
from graphcast_lite_torch.training.trainer import Trainer, make_train_step
from graphcast_lite_torch.utils.params import from_flax_params
from test_torch_port_configs import THR, _pair
from torch_port_common import flax_numpy, jax_params, \
    one_torch_thread  # noqa: F401 (an autouse fixture)

WORLD, B, N_FEAT, AR, DIRECT = 2, 2, 5, 2, 3
LOSS_RTOL, PARAM_RTOL, EVAL_RTOL, JAX_EVAL_RTOL = 1e-5, 1e-5, 1e-6, 1e-5
# Gradients per leaf: max|g - g_jax| <= GRAD_RTOL max|g_jax| + GRAD_ATOL,
# as the port's other train-step tests hold them.  Adam's first update is
# lr·g / (|g| + 1e-8): where |g| nears its eps (a GAT's ``att_dst``, whose
# gradient is zero in exact arithmetic: the softmax over a receiver's
# edges cancels it; the U-Net's convolution biases before its
# per-image normalization, likewise) the update turns the
# gradients' rounding (1e-9 to 1e-8) into up to lr, in the one-device
# step as well.  The parameters are held where both gradients, as Adam
# sees them, exceed ADAM_RESOLVED (100 x eps).
GRAD_RTOL, GRAD_ATOL, ADAM_RESOLVED = 1e-4, 1e-6, 1e-6
STATIC, FORCING = [1], [3]
# The U-Net case: a 24 x 16 grid (three poolings), base 8, the CNN
# trainers' optimizer and image losses.
N_LAT, N_LON, UNET_OBS, UNET_BASE = 24, 16, 2, 8
UNET_LR, DECAY_STEPS, MAX_NORM, SPECTRAL, SOBEL = 1e-3, 4, 1.0, 0.1, 0.05
FAMILIES = ("product_graph", "simple_conv", "direct", "sparse_gat", "unet")


def _simple_conv(cfg, conf):
    """A SimpleConv encoder after a graph-mode LayerNorm MLP, and a
    SimpleConv processor (both refused by the explicit sharded path)."""
    enc = cfg.pipeline.encoder
    enc.mlp.layer_norm_mode = "graph"
    enc.gcn = conf.GraphBlock(layer_type=conf.GraphLayerType.SimpleConv)
    cfg.pipeline.processor = conf.ModelConfig(
        gcn=conf.GraphBlock(layer_type=conf.GraphLayerType.SimpleConv))


def _direct(cfg, conf):
    cfg.pipeline.decoder.gcn.output_dim = DIRECT * N_FEAT
    cfg.data.pred_window_used = DIRECT
    cfg.max_ar_steps = DIRECT


def _graph_pair(family):
    """(jax cfg, jax model, params, jax graphs, port cfg, port graphs,
    grid nodes, mesh nodes, AR steps) of a GNN family."""
    base = {"product_graph": "product_graph", "sparse_gat": "sparse_gat"} \
        .get(family, "gcn")
    jcfg, jmodel, params, jgraphs, pcfg, pmodel, pgraphs = _pair(base)
    edit = {"simple_conv": _simple_conv, "direct": _direct}.get(family)
    if edit is not None:
        edit(jcfg, jconf)
        edit(pcfg, pconf)
        jmodel = JModel(pipeline=jcfg.pipeline, data=jcfg.data,
                        num_grid_nodes=pmodel.num_grid_nodes,
                        num_mesh_nodes=pmodel.num_mesh_nodes)
        dummy = np.zeros((pmodel.num_grid_nodes,
                          jcfg.data.obs_window_used * N_FEAT), np.float32)
        params = jmodel.init(jax.random.PRNGKey(0), dummy, jgraphs)
    steps = {"direct": DIRECT, "sparse_gat": AR}.get(family, 1)
    for cfg in (jcfg, pcfg):
        cfg.static_channels, cfg.forcing_channels = STATIC, FORCING
        cfg.max_ar_steps = steps
        cfg.batch_size = B
    return (jcfg, jmodel, params, jgraphs, pcfg, pgraphs,
            pmodel.num_grid_nodes, pmodel.num_mesh_nodes, steps)


def _meta(cls, n_lat, n_lon, obs, pred):
    return cls(flattened=True, num_latitudes=n_lat, num_longitudes=n_lon,
               num_features=N_FEAT, obs_window=obs, pred_window=pred,
               num_grid_nodes=n_lat * n_lon)


def _unet_cfg(conf):
    return conf.ExperimentConfig(
        data=conf.DataConfig(dataset_name="unet", num_features_used=N_FEAT,
                             obs_window_used=UNET_OBS, pred_window_used=1,
                             want_feats_flattened=True),
        batch_size=B, learning_rate=UNET_LR, max_ar_steps=1,
        static_channels=STATIC, forcing_channels=FORCING)


def _jax_image_extra(out, target):
    io = out.reshape(out.shape[:-2] + (N_LAT, N_LON, N_FEAT))
    it = target.reshape(target.shape[:-2] + (N_LAT, N_LON, N_FEAT))
    return SPECTRAL * j_spectral(io, it) + SOBEL * j_gradient(io, it)


def _recording(opt):
    """``opt`` behind a transform that keeps the step's gradients (as the
    optimizer receives them) in its state, ``opt_state[0]``."""
    return optax.chain(optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads)), opt)


def _family(family, tmp):
    """(the JAX Trainer, its state, the rank payload's case, the port's
    one-device Trainer on the same weights)."""
    rng = np.random.RandomState(FAMILIES.index(family))
    if family == "unet":
        jcfg, pcfg = _unet_cfg(jconf), _unet_cfg(pconf)
        obs, steps = UNET_OBS, 1
        jmodel = JGIM(image_module=JU.WeatherUNet(N_FEAT, UNET_BASE),
                      n_lat=N_LAT, n_lon=N_LON)
        g = N_LAT * N_LON
        params = jax_params(jmodel, np.zeros((g, obs * N_FEAT), np.float32))
        jgraphs = pgraphs = None
        jopt = optax.chain(optax.clip_by_global_norm(MAX_NORM),
                           optax.adamw(optax.cosine_decay_schedule(
                               UNET_LR, DECAY_STEPS)))
        jextra = _jax_image_extra
        meta = (N_LAT, N_LON)
        unet = {"cls": "WeatherUNet",
                "args": (obs * N_FEAT, N_FEAT, UNET_BASE), "n_lat": N_LAT,
                "n_lon": N_LON, "c": N_FEAT, "decay_steps": DECAY_STEPS,
                "max_norm": MAX_NORM, "extra": (SPECTRAL, SOBEL)}
        n_grid = n_mesh = None
        pmodel = GridImageModel(WeatherUNet(*unet["args"]), N_LAT, N_LON)
    else:
        (jcfg, jmodel, params, jgraphs, pcfg, pgraphs, n_grid, n_mesh,
         steps) = _graph_pair(family)
        obs = jcfg.data.obs_window_used
        g = n_grid
        jopt = optax.adam(jcfg.learning_rate)   # build_optimizer's
        jextra, unet, meta = None, None, (32, 64)
        pmodel = PModel(pcfg.pipeline, pcfg.data, n_grid, n_mesh)
    pmodel.load_state_dict(from_flax_params(flax_numpy(params)))
    jt = JTrainer(jmodel, jgraphs, jcfg, _meta(JMeta, *meta, obs, steps),
                  str(tmp / f"jax_{family}"), optimizer=_recording(jopt),
                  extra_loss_fn=jextra)
    mask0 = None
    if family == "sparse_gat":
        mask0 = pgraphs.processing.edge_mask.numpy().copy()
    jstate = JState(params=params, opt_state=jt.optimizer.init(params),
                    edge_mask=None if mask0 is None else jnp.asarray(mask0))
    pt = Trainer(pmodel, pgraphs, pcfg, _meta(DatasetMetadata, *meta, obs,
                                              steps),
                 str(tmp / f"port_{family}"), device="cpu")
    x = rng.randn(B, g, obs * N_FEAT).astype(np.float32)
    y = rng.randn(B, g, steps * N_FEAT).astype(np.float32)
    case = {"name": family, "cfg": pcfg, "graphs": pgraphs,
            "n_grid": n_grid, "n_mesh": n_mesh, "unet": unet,
            "state": {k: v.numpy().copy()
                      for k, v in pmodel.state_dict().items()},
            "spec": pt.spec, "steps": steps, "lw": pt.lat_weights,
            "cm": pt.chan_mask, "sm": pt.spatial_mask, "exclude": pt._exclude,
            "x": x, "y": y, "mask0": mask0, "thr": THR,
            "prune": family == "sparse_gat"}
    return jt, jstate, case, pt


def _gspmd(jt, jstate, case):
    """The JAX oracle: the one-device step and eval step with the batch
    sharded P("data") over 2 devices and the state replicated."""
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(WORLD, 1),
                ("data", "space"))
    rep, data = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    state = jax.device_put(jstate, rep)
    x, y = (jax.device_put(a, data) for a in (case["x"], case["y"]))
    evaluate = jt._make_eval_step()(state.params, state.edge_mask, x, y)
    state, loss = jt.train_step(state, x, y, case["steps"], case["thr"],
                                case["prune"], False)
    assert x.sharding.spec == P("data")
    params, grads = ({k: v.numpy() for k, v in from_flax_params(
        flax_numpy(tree)).items()} for tree in (state.params,
                                                state.opt_state[0]))
    mask = None if state.edge_mask is None else np.asarray(state.edge_mask)
    return {"loss": float(loss), "params": params, "grads": grads,
            "mask": mask,
            "eval": tuple(float(v) for v in evaluate)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{family: (JAX oracle, one-device eval, the ranks' results)}."""
    tmp = tmp_path_factory.mktemp("data_parallel")
    oracle, one_eval, cases = {}, {}, []
    for family in FAMILIES:
        jt, jstate, case, pt = _family(family, tmp)
        oracle[family] = _gspmd(jt, jstate, case)
        state = pt.init_state()
        state.model.load_state_dict({k: torch.from_numpy(v)
                                     for k, v in case["state"].items()})
        if case["mask0"] is not None:
            state = dataclasses.replace(
                state, edge_mask=torch.from_numpy(case["mask0"]))
        with torch.no_grad():
            one_eval[family] = pt._eval_batch(state, case["x"], case["y"])
        cases.append(case)
    ranks = tpd.spawn(tpd.data_parallel_cases, WORLD, tmp / "spawn",
                      {"cases": cases})
    return {f: (oracle[f], one_eval[f], [r[f] for r in ranks])
            for f in FAMILIES}


def _rel(a, b):
    return abs(a - b) / abs(b)


def _bytes(params):
    return [(n, p.tobytes()) for n, p in params.items()]


@pytest.mark.parametrize("family", FAMILIES)
def test_step_against_gspmd(runs, family):
    want, _, ranks = runs[family]
    got = ranks[0]
    assert _rel(got["loss"], want["loss"]) <= LOSS_RTOL, \
        (got["loss"], want["loss"])
    assert set(got["params"]) == set(want["params"]) == set(got["grads"])
    # The gradient Adam sees (after ClippedAdamW's global-norm clip).
    norm = np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                       for g in want["grads"].values()))
    clip = min(1.0, MAX_NORM / norm) if family == "unet" else 1.0
    tol = PARAM_RTOL * max(np.abs(p).max() for p in want["params"].values())
    for name, g in got["grads"].items():
        jg = want["grads"][name]
        gtol = GRAD_RTOL * np.abs(jg).max() + GRAD_ATOL
        assert np.abs(g - jg).max() <= gtol, (name, np.abs(g - jg).max())
        resolved = np.minimum(np.abs(g), np.abs(jg)) * clip > ADAM_RESOLVED
        err = np.abs(got["params"][name] - want["params"][name])[resolved]
        assert err.size == 0 or err.max() <= tol, (name, err.max(), tol)
    assert (got["mask"] is None) == (want["mask"] is None) \
        == (family != "sparse_gat")
    if got["mask"] is not None:
        live = float(runs[family][2][0]["mask"].size)
        assert 0 < got["mask"].sum() < live
        np.testing.assert_array_equal(got["mask"], want["mask"])


@pytest.mark.parametrize("family", FAMILIES)
def test_ranks_bitwise_equal(runs, family):
    """Every rank ends the step with the same bits, after one all-reduce;
    SparseGAT broadcasts data rank 0's mask once an AR step, and never in
    the backward's recompute."""
    first, second = runs[family][2]
    assert first["loss"] == second["loss"]
    assert _bytes(first["params"]) == _bytes(second["params"])
    if first["mask"] is not None:
        assert first["mask"].tobytes() == second["mask"].tobytes()
    for r in (first, second):
        assert r["all_reduces"] == 1
        assert r["mask_broadcasts"] == (AR if family == "sparse_gat" else 0)
        assert r["transport"]["collectives"] == 1 + r["mask_broadcasts"]


@pytest.mark.parametrize("family", FAMILIES)
def test_rank_runs_its_block(runs, family):
    """Each rank's model calls (the forward and the checkpoint's
    recompute) see its B / world samples, not the whole batch."""
    for r in runs[family][2]:
        assert r["batch_seen"] == [B // WORLD], r["batch_seen"]


@pytest.mark.parametrize("family", FAMILIES)
def test_eval_step(runs, family):
    """The eval step over the data group against the one-device Trainer's
    evaluation of the whole batch and the JAX eval step under GSPMD."""
    want, one, ranks = runs[family]
    for r in ranks:
        assert r["eval"] == ranks[0]["eval"]
        (loss, acc, rmse), (loss1, acc1, rmse1) = r["eval"], one
        assert _rel(loss, loss1) <= EVAL_RTOL, (loss, loss1)
        assert _rel(rmse, rmse1) <= EVAL_RTOL, (rmse, rmse1)
        assert abs(acc - acc1) <= EVAL_RTOL, (acc, acc1)
        jloss, jacc, jrmse = want["eval"]
        assert _rel(loss, jloss) <= JAX_EVAL_RTOL, (loss, jloss)
        assert _rel(rmse, jrmse) <= JAX_EVAL_RTOL, (rmse, jrmse)
        assert abs(acc - jacc) <= JAX_EVAL_RTOL, (acc, jacc)


@pytest.mark.parametrize("family", FAMILIES)
def test_world_one_bitwise(runs, family):
    """At world 1 the data-parallel step is ``make_train_step`` bit for
    bit: loss, pruned mask and parameters."""
    ranks = runs[family][2]
    w1 = ranks[FAMILIES.index(family) % WORLD]["world1"]
    (loss, mask, params), (loss1, mask1, params1) = w1["dp"], w1["one"]
    assert loss == loss1
    assert (mask is None) == (mask1 is None)
    if mask is not None:
        assert mask.tobytes() == mask1.tobytes()
    assert _bytes(params) == _bytes(params1)


def _tiny_step():
    model = GridImageModel(WeatherUNet(UNET_OBS * N_FEAT, N_FEAT,
                                       UNET_BASE), N_LAT, N_LON)
    cfg = _unet_cfg(pconf)
    spec = Trainer(model, None, cfg, _meta(DatasetMetadata, N_LAT, N_LON,
                                           UNET_OBS, AR),
                   "unused", device="cpu").spec
    return make_train_step(model, None, spec, cfg, device="cpu")


def _mesh(data, space):
    return ProcessMesh(shape=(data, space), rank=0, data_index=0,
                       space_index=0, space_group=None, data_group=None,
                       world_group=None)


def test_refuses_space_axis():
    with pytest.raises(NotImplementedError, match="data_parallel=world"):
        make_data_parallel_train_step(_tiny_step(), _mesh(1, 2))


def test_refuses_uneven_batch(monkeypatch):
    from graphcast_lite_torch.parallel import sharding

    monkeypatch.setattr(sharding, "replicated", lambda m, mesh: m)
    step = make_data_parallel_train_step(_tiny_step(), _mesh(2, 1))
    x = np.zeros((3, N_LAT * N_LON, UNET_OBS * N_FEAT), np.float32)
    y = np.zeros((3, N_LAT * N_LON, N_FEAT), np.float32)
    with pytest.raises(ValueError, match="divisible by the data-parallel"):
        step(x, y)


def test_refusals_name_the_data_parallel_step(tmp_path):
    """The explicit sharded path and ``Trainer(mesh=)`` still refuse these
    families, as the JAX package's do, and name the data-parallel step."""
    from graphcast_lite_torch import presets
    from graphcast_lite_torch.parallel.sharded_model import \
        ShardedWeatherForward

    cfg = presets.product_graph_64x32(n_feat=N_FEAT, hidden=16)
    with pytest.raises(NotImplementedError,
                       match="make_data_parallel_train_step"):
        ShardedWeatherForward(cfg.pipeline, cfg.data, 2)
    _simple_conv(cfg, pconf)
    cfg.pipeline.product_graph = None
    with pytest.raises(NotImplementedError,
                       match="make_data_parallel_train_step"):
        ShardedWeatherForward(cfg.pipeline, cfg.data, 2)
    with pytest.raises(NotImplementedError,
                       match="make_data_parallel_train_step"):
        Trainer(None, None, None, None, str(tmp_path), mesh=object(),
                graph_set=object(), extra_loss_fn=lambda o, t: 0.0)
