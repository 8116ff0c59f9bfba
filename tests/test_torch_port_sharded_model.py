"""The port's sharded model (``parallel.sharded_model``, ``parallel.spmd``)
on gloo ranks against the JAX package's ``parallel`` functions, on the
CPU.

The JAX test's setup (``tests/test_sharded_model.py``): a 16 x 24 grid,
mesh levels [1, 2], hidden 32, 2 message-passing steps, 5 features, obs 2,
pred 2.  The same weights (the JAX init bridged into the port) and inputs
go through the JAX package's sharded forward, processor, train step and
eval step on its CPU devices and through the port on spawned ranks
(``torch_port_dist``: one spawn of 2 ranks for the (1, 2) and (2, 1)
grids and one of 4 for the (1, 4) tile shape and the (2, 2) grid):

* the forward in gather, banded and tiled modes, and the processor alone
  in gather and banded modes with LayerNorm on and off: max abs 1e-5;
* the AR-2 train step at (1, 2) banded, (2, 1) data-parallel and (2, 2):
  the loss within 1e-5 relative and every gradient within 1e-4·max|g|
  (+ 1e-6) of the JAX step's and of the port's one-device step's; the
  ranks' parameters bitwise equal after the step;
* the eval step on a padded partial batch (1e-5);
* the GAT encoder/processor/decoder model and the ConvGCN pipeline
  forward, and a SparseGAT step whose pruned mask equals the JAX one;
* the rows each rank received in the exchanges against the plan's
  ``rows_exchanged_per_step``;
* ``Trainer(mesh=, graph_set=).fit`` for one epoch of 2 steps against the
  JAX package's ``Trainer(mesh=, graph_set=).fit`` (the losses and the
  saved [S, E_s] SparseGAT mask) and the port's one-device
  ``Trainer.fit``, with rank 0 alone writing.
"""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import torch_port_dist as tpd
from graphcast_lite_tpu import presets as jpresets
from graphcast_lite_tpu.config import GATProps, GraphBlock, GraphLayerType, \
    ModelConfig
from graphcast_lite_tpu.graphs.build import build_graph_set as jbuild
from graphcast_lite_tpu.graphs.partition import build_banded_halos as \
    jbanded
from graphcast_lite_tpu.graphs.partition import partition_nodes_by_latitude \
    as jlat_shards
from graphcast_lite_tpu.graphs.partition import gather_nodes as jgather
from graphcast_lite_tpu.graphs.partition import scatter_nodes as jscatter
from graphcast_lite_tpu.graphs.partition import shard_graph as jshard
from graphcast_lite_tpu.models.weather import ModelGraphs as JGraphs
from graphcast_lite_tpu.models.weather import WeatherModel as JModel
from graphcast_lite_tpu.parallel import sharded_model as jsm
from graphcast_lite_tpu.parallel.spmd import sharded_interaction_processor \
    as jspmd
from graphcast_lite_tpu.training.rollout import RolloutSpec as JSpec
from graphcast_lite_torch.config import ExperimentConfig, from_dict
from graphcast_lite_torch.graphs.build import build_graph_set as pbuild
from graphcast_lite_torch.models.weather import ModelGraphs as PGraphs
from graphcast_lite_torch.models.weather import WeatherModel as PModel
from graphcast_lite_torch.training.loss import channel_mask, \
    lat_weights_from_axis
from graphcast_lite_torch.utils.params import from_flax_params
from torch_port_common import flax_numpy, one_torch_thread  # noqa: F401

N_FEAT, OBS, PRED, HIDDEN, MP = 5, 2, 2, 32, 2
LAT = np.linspace(-80, 80, 16).astype(np.float32)
LON = np.arange(0, 360, 360 / 24).astype(np.float32)
GRID = (LAT, LON, [1, 2], 0.6)
SPEC = dict(obs_window=OBS, num_features=N_FEAT, use_residual=True,
            remat=True, static_channels=(1,), forcing_channels=(3,))
FWD_ATOL = 1e-5
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6
THR = 0.1
BATCH = 2


def _port_cfg(jcfg):
    return from_dict(ExperimentConfig, json.loads(jcfg.model_dump_json()))


def _inet_cfg(hidden=HIDDEN):
    cfg = jpresets.interaction_net_64x32(n_feat=N_FEAT, obs=OBS, pred=PRED,
                                         hidden=hidden, mp_steps=MP)
    cfg.graph.mesh_levels = [1, 2]
    return cfg


def _gat_cfg(sparse):
    cfg = _inet_cfg()
    lt = GraphLayerType.SparseGATConv if sparse else GraphLayerType.GATConv
    cfg.pipeline.processor = ModelConfig(gcn=GraphBlock(
        layer_type=lt, hidden_dims=None if sparse else [HIDDEN],
        output_dim=HIDDEN, use_layer_norm=False,
        gat_props=GATProps(num_heads=2, sparsity_thresholds=[0.1])))
    return cfg


def _full_gat_cfg():
    cfg = _inet_cfg()
    gat = dict(layer_type=GraphLayerType.GATConv, output_dim=HIDDEN,
               use_layer_norm=False,
               gat_props=GATProps(num_heads=2, sparsity_thresholds=[0.1]))
    cfg.pipeline.encoder = ModelConfig(
        mlp=cfg.pipeline.encoder.mlp,
        gcn=GraphBlock(hidden_dims=[HIDDEN], **gat))
    cfg.pipeline.processor = ModelConfig(
        gcn=GraphBlock(hidden_dims=[HIDDEN], **gat))
    dec = dict(gat, output_dim=N_FEAT)
    cfg.pipeline.decoder = ModelConfig(
        gcn=GraphBlock(hidden_dims=[HIDDEN], **dec))
    return cfg


def _gcn_cfg():
    cfg = jpresets.baseline_gcn_64x32(n_feat=N_FEAT, obs=OBS, pred=1,
                                      hidden=16)
    cfg.graph.mesh_levels = [1, 2]
    return cfg


class _Setup:
    """The JAX graph set and a model's JAX params and port state."""

    def __init__(self):
        self.gs = jbuild(LAT, LON, [1, 2], 0.6)
        self.graphs = JGraphs.from_graph_set(self.gs)
        self.g = self.gs.num_grid_nodes
        self.models = {}

    def model(self, name, jcfg, seed=0):
        if name not in self.models:
            jm = JModel(pipeline=jcfg.pipeline, data=jcfg.data,
                        num_grid_nodes=self.g,
                        num_mesh_nodes=self.gs.num_mesh_nodes)
            params = jm.init(jax.random.PRNGKey(seed),
                             jnp.zeros((self.g, OBS * N_FEAT)), self.graphs)
            state = {k: v.numpy() for k, v in
                     from_flax_params(flax_numpy(params)).items()}
            self.models[name] = (jcfg, jm, params, state)
        return self.models[name]


def _mesh(data, space):
    devs = np.asarray(jax.devices()[:data * space]).reshape(data, space)
    return Mesh(devs, ("data", "space"))


def _jax_forward(st, jcfg, params, x, space, zero_mask=False, **plan_kw):
    plan = jsm.build_sharding_plan(st.gs, space, **plan_kw)
    arrs = jsm.plan_device_arrays(plan, st.gs)
    fwd = jsm.ShardedWeatherForward(jcfg.pipeline, jcfg.data, space)
    mask = jnp.zeros_like(arrs.proc.edge_mask) if zero_mask else None
    out = jsm.make_sharded_forward(fwd, _mesh(1, space))(
        params, jnp.asarray(plan.scatter_grid(x)[None]), arrs, mask)
    return plan.gather_grid(np.asarray(out[0])), plan


def _grab():
    """An optax transformation whose state after a step is the step's
    gradient (and whose update is zero)."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@contextlib.contextmanager
def _jax_vma_off():
    """The JAX package's sharded steps with their VMA check off
    (``GCLT_SHARDED_KERNELS=1``, its configuration on a TPU; at hidden 32
    and below no kernel engages).  With the check on, its default on the
    CPU, the gradient of the replicated parameters is summed over the
    devices implicitly and again by the step's own psum: it comes out
    data × space times the gradient (ROADMAP trap 14)."""
    saved = os.environ.get("GCLT_SHARDED_KERNELS")
    os.environ["GCLT_SHARDED_KERNELS"] = "1"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["GCLT_SHARDED_KERNELS"]
        else:
            os.environ["GCLT_SHARDED_KERNELS"] = saved


def _jax_train(st, jcfg, params, x, y, data, space, prune=False, **plan_kw):
    """(loss, gradients by port name, pruned mask or None) of the JAX
    package's sharded train step (``_jax_vma_off``)."""
    with _jax_vma_off():
        return _jax_train_step(st, jcfg, params, x, y, data, space, prune,
                               **plan_kw)


def _jax_train_step(st, jcfg, params, x, y, data, space, prune, **plan_kw):
    plan = jsm.build_sharding_plan(st.gs, space, **plan_kw)
    lw = lat_weights_from_axis(16, 24)
    arrs = jsm.plan_device_arrays(plan, st.gs, lat_weights=lw)
    fwd = jsm.ShardedWeatherForward(jcfg.pipeline, jcfg.data, space)
    cm = jnp.asarray(channel_mask(N_FEAT, [1], [3]))
    step = jsm.make_sharded_train_step(fwd, JSpec(**SPEC), _mesh(data, space),
                                       _grab(), steps=PRED, chan_mask=cm,
                                       prune=prune)
    args = (jax.tree.map(jnp.copy, params), _grab().init(params),
            jnp.asarray(plan.scatter_grid(x)),
            jnp.asarray(plan.scatter_grid(y)), arrs)
    mask = None
    if fwd.sparse_gat:
        _, grads, loss, mask = step(*args, arrs.proc.edge_mask,
                                    jnp.asarray(THR))
        mask = np.asarray(mask)
    else:
        _, grads, loss = step(*args)
    grads = from_flax_params(flax_numpy(grads))
    return float(loss), {k: v.numpy() for k, v in grads.items()}, mask


def _port_one_device(jcfg, state, x, y):
    """(loss, gradients) of the port's one-device AR-2 step."""
    from graphcast_lite_torch.training.rollout import RolloutSpec
    from graphcast_lite_torch.training.trainer import make_train_step

    pcfg = _port_cfg(jcfg)
    pcfg.max_ar_steps = PRED
    gs = pbuild(LAT, LON, [1, 2], 0.6)
    model = PModel(pcfg.pipeline, pcfg.data, gs.num_grid_nodes,
                   gs.num_mesh_nodes)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    step = make_train_step(model, PGraphs.from_graph_set(gs),
                           RolloutSpec(**SPEC), pcfg, device="cpu",
                           lat_weights=lat_weights_from_axis(16, 24),
                           chan_mask=channel_mask(N_FEAT, [1], [3]))
    loss = step(x, y)
    return float(loss), {n: p.grad.double().numpy()
                         for n, p in model.named_parameters()}


def _jax_processor(st, params, x, use_ln, halo, space=2):
    inet = params["params"]["processor"]["graph_layer"]["inet"]
    sg = jshard(st.gs.processing, jlat_shards(st.gs.mesh_lat, space), space)
    halos = jbanded(sg) if halo == "banded" else None
    mesh = Mesh(np.asarray(jax.devices()[:space]), ("space",))
    out = jspmd(inet, jnp.asarray(jscatter(sg, x)), sg, mesh,
                use_layer_norm=use_ln, halos=halos)
    return jgather(sg, np.asarray(out))


def _jax_eval(st, jcfg, params, x, y, sample_mask, data, space):
    plan = jsm.build_sharding_plan(st.gs, space)
    arrs = jsm.plan_device_arrays(plan, st.gs)
    fwd = jsm.ShardedWeatherForward(jcfg.pipeline, jcfg.data, space)
    ev = jsm.make_sharded_eval_step(fwd, JSpec(**SPEC), _mesh(data, space),
                                    exclude_channels=(1, 3))
    loss, acc, rmse = ev(params, jnp.asarray(plan.scatter_grid(x)),
                         jnp.asarray(plan.scatter_grid(y)),
                         jnp.asarray(sample_mask), arrs)
    return float(loss), float(acc), float(rmse)


def _batch(g, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(BATCH, g, OBS * N_FEAT).astype(np.float32),
            rng.randn(BATCH, g, PRED * N_FEAT).astype(np.float32))


def _train_case(name, cfg_name, jcfg, st, mesh, seed, **kw):
    _, _, _, state = st.model(cfg_name, jcfg)
    x, y = _batch(st.g, seed)
    return dict(name=name, kind="train", mesh=mesh, cfg=_port_cfg(jcfg),
                state=state, x=x, y=y, spec=SPEC, steps=PRED,
                lat_weights=lat_weights_from_axis(16, 24),
                chan_mask=channel_mask(N_FEAT, [1], [3]), **kw)


@pytest.fixture(scope="module")
def setup():
    return _Setup()


@pytest.fixture(scope="module")
def two_ranks(setup, tmp_path_factory):
    """The 2-rank cases: (JAX references, the ranks' results)."""
    st = setup
    inet = _inet_cfg()
    _, _, params, state = st.model("inet", inet)
    pcfg = _port_cfg(inet)
    rng = np.random.RandomState(1)
    x1 = rng.randn(st.g, OBS * N_FEAT).astype(np.float32)
    xm = rng.randn(st.gs.num_mesh_nodes, HIDDEN).astype(np.float32)
    cases, ref = [], {}
    for mode, kw in (("gather", dict(halo_mode="gather")),
                     ("banded", dict(halo_mode="banded")),
                     ("tiled", dict(halo_mode="banded",
                                    partition="tiles"))):
        ref[f"fwd_{mode}"] = _jax_forward(st, inet, params, x1, 2, **kw)
        cases.append(dict(name=f"fwd_{mode}", kind="forward", mesh=(1, 2),
                          cfg=pcfg, state=state, x=x1,
                          halo=kw["halo_mode"],
                          partition=kw.get("partition", "lat")))
    for halo in ("gather", "banded"):
        for use_ln in (True, False):
            name = f"proc_{halo}_{'ln' if use_ln else 'noln'}"
            ref[name] = _jax_processor(st, params, xm, use_ln, halo)
            cases.append(dict(name=name, kind="processor", mesh=(1, 2),
                              cfg=pcfg, state=state, x=xm, use_ln=use_ln,
                              halo=halo))
    for name, mesh, kw in (("train_banded", (1, 2),
                            dict(halo_mode="banded")),
                           ("train_dp", (2, 1), {})):
        x, y = _batch(st.g, 2)
        ref[name] = _jax_train(st, inet, params, x, y, *mesh, **kw)
        cases.append(_train_case(name, "inet", inet, st, mesh, 2,
                                 halo=kw.get("halo_mode", "auto")))
    ref["one_device"] = _port_one_device(inet, state, *_batch(st.g, 2))
    # Eval: a full batch at (1, 2); a padded partial batch at (2, 1)
    # (sample 1 is garbage with mask 0).
    x, y = _batch(st.g, 3)
    xp = np.stack([x[0], 13.0 + 0 * x[1]])
    yp = np.stack([y[0], -7.0 + 0 * y[1]])
    for name, mesh, (xe, ye), sm in (
            ("eval_full", (1, 2), (x, y), np.ones(2, np.float32)),
            ("eval_partial", (2, 1), (xp, yp),
             np.array([1.0, 0.0], np.float32))):
        ref[name] = _jax_eval(st, inet, params, xe, ye, sm, *mesh)
        cases.append(dict(name=name, kind="eval", mesh=mesh, cfg=pcfg,
                          state=state, x=xe, y=ye, sample_mask=sm,
                          spec=SPEC, exclude=(1, 3)))
    # The other families.
    for name, jcfg in (("fwd_gat", _full_gat_cfg()), ("fwd_gcn", _gcn_cfg())):
        _, _, p, s = st.model(name, jcfg)
        ref[name] = _jax_forward(st, jcfg, p, x1, 2)
        cases.append(dict(name=name, kind="forward", mesh=(1, 2),
                          cfg=_port_cfg(jcfg), state=s, x=x1))
    sparse = _gat_cfg(sparse=True)
    _, _, p, s = st.model("sparse", sparse)
    # A SparseGAT forward under an all-zero processing mask: the mask given
    # is the one applied.
    ref["fwd_sparse"] = _jax_forward(st, sparse, p, x1, 2, zero_mask=True)
    cases.append(dict(name="fwd_sparse", kind="forward", mesh=(1, 2),
                      cfg=_port_cfg(sparse), state=s, x=x1, zero_mask=True))
    x, y = _batch(st.g, 4)
    ref["train_sparse"] = _jax_train(st, sparse, p, x, y, 1, 2, prune=True)
    cases.append(_train_case("train_sparse", "sparse", sparse, st, (1, 2), 4,
                             prune=True, thr=THR))
    # The same step with each message-passing step recomputed in the
    # backward, and at hidden 128 through the kernel gate's units (the
    # fused edge unit and gcn_aggregate on the extended-table CSRs)
    # against the composed ops.
    cases.append(_train_case("train_remat", "inet", inet, st, (1, 2), 2,
                             halo="banded",
                             env={"GCLT_SHARDED_SCAN_REMAT": "full"}))
    wide = _inet_cfg(hidden=128)
    pwide = _port_cfg(wide)
    state128 = {k: v.numpy() for k, v in PModel(
        pwide.pipeline, pwide.data, st.g, st.gs.num_mesh_nodes,
        generator=torch.Generator().manual_seed(3)).state_dict().items()}
    for flag in ("1", "0"):
        cases.append(dict(_train_case(f"train_h128_units{flag}", "inet",
                                      inet, st, (1, 2), 7, halo="banded",
                                      env={"GCLT_SHARDED_KERNELS": flag}),
                          cfg=pwide, state=state128))
    cases.append(_train_case("train_frozen", "inet", inet, st, (1, 2), 2,
                             halo="banded", freeze=True))
    # Trainer(mesh=, graph_set=) on the JAX trainer test's experiments.
    for name, processor in (("trainer", "interaction_net"),
                            ("trainer_sparse", "sparse_gat")):
        ref[name], trainer_case = _trainer_reference(
            tmp_path_factory.mktemp(name), name, processor)
        cases.append(trainer_case)
    got = tpd.spawn(tpd.sharded_cases, 2,
                    tmp_path_factory.mktemp("ranks2"),
                    {"grid": GRID, "cases": cases}, timeout=600)
    return st, ref, got


def _trainer_reference(tmp_path, name, processor):
    """((the JAX package's ``Trainer(mesh=, graph_set=).fit`` results at
    (1, 2), its final [S, E_s] processing mask or None, the one-device
    port ``Trainer.fit`` results), the trainer case), every trainer from
    the JAX mesh trainer's initial weights."""
    from torch_port_common import fit_experiment
    from graphcast_lite_tpu.training.trainer import Trainer as JTrainer
    from graphcast_lite_torch.training.trainer import Trainer

    (jcfg, jmodel, jgraphs, (jtrain, jval, jmeta), pcfg, pmodel, pgraphs,
     (ptrain, pval, pmeta)) = fit_experiment(
        tmp_path, processor=processor, num_epochs=1, max_ar_steps=1)
    jgs = jbuild(jmeta.coordinates[0], jmeta.coordinates[1],
                 jcfg.graph.mesh_levels, jcfg.graph.grid2mesh_radius_query)
    with _jax_vma_off():
        jt = JTrainer(jmodel, jgraphs, jcfg, jmeta, str(tmp_path / "jax"),
                      mesh=_mesh(1, 2), graph_set=jgs)
        jstate = jt.init_state(seed=0)
        init = {k: v.numpy() for k, v in
                from_flax_params(flax_numpy(jstate.params)).items()}
        jres = jt.fit(jstate, jtrain, jval, print_losses=False,
                      max_steps_per_epoch=2)
    jmask = (np.asarray(jt.final_state.edge_mask) if jt.using_sparse_gat
             else None)
    tr = Trainer(pmodel, pgraphs, pcfg, pmeta, str(tmp_path / "one"),
                 device="cpu")
    state = tr.init_state(seed=0)
    state.model.load_state_dict({k: torch.from_numpy(v)
                                 for k, v in init.items()})
    res = tr.fit(state, ptrain, pval, print_losses=False,
                 max_steps_per_epoch=2)
    case = dict(name=name, kind="trainer", mesh=(1, 2), cfg=pcfg,
                data_dir=str(tmp_path / "data"), out=str(tmp_path / "mesh"),
                steps=2, init=init)
    return (jres, jmask, res), case


def _close(got, expect, label, atol=FWD_ATOL):
    err = float(np.abs(np.asarray(got) - np.asarray(expect)).max())
    assert err <= atol, f"{label}: max abs {err:.3e} > {atol:.1e}"


def _grads_close(grads, expect, label):
    assert set(grads) == set(expect), label
    for name, g in grads.items():
        ref = np.asarray(expect[name], np.float64)
        err = np.abs(g - ref).max()
        tol = GRAD_RTOL * np.abs(ref).max() + GRAD_ATOL
        assert err <= tol, f"{label} {name}: {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("mode", ["gather", "banded", "tiled", "gat", "gcn",
                                  "sparse"])
def test_forward_matches_jax(two_ranks, mode):
    st, ref, got = two_ranks
    expect, plan = ref[f"fwd_{mode}"]
    for r in got:
        _close(r[f"fwd_{mode}"]["out"], expect, mode)
    if mode in ("banded", "tiled", "gather"):
        # The rows the ranks received an exchange are the plan's.
        for graph, stats in plan.comm_stats.items():
            rows = sum(r[f"fwd_{mode}"]["halo_rows"][graph]
                       / r[f"fwd_{mode}"]["halo_exchanges"][graph]
                       for r in got)
            want = (stats["all_gather_baseline"] if stats["chosen"]
                    == "gather" else stats["banded"])
            assert rows == want, (mode, graph, rows, stats)


@pytest.mark.parametrize("halo", ["gather", "banded"])
@pytest.mark.parametrize("use_ln", [True, False])
def test_processor_matches_jax(two_ranks, halo, use_ln):
    _, ref, got = two_ranks
    name = f"proc_{halo}_{'ln' if use_ln else 'noln'}"
    for r in got:
        _close(r[name]["out"], ref[name], name)


@pytest.mark.parametrize("name", ["train_banded", "train_dp"])
def test_train_step_matches_jax_and_one_device(two_ranks, name):
    _, ref, got = two_ranks
    loss, grads, _ = ref[name]
    one_loss, one_grads = ref["one_device"]
    for r in got:
        res = r[name]
        assert abs(res["loss"] - loss) <= LOSS_RTOL * abs(loss), \
            (res["loss"], loss)
        assert abs(res["loss"] - one_loss) <= LOSS_RTOL * abs(one_loss)
        _grads_close(res["grads"], one_grads, f"{name} vs one device")
        _grads_close(res["grads"], grads, f"{name} vs JAX")
    # Every rank holds the same parameters after the Adam step, bitwise.
    assert all(np.array_equal(r[name]["params"], got[0][name]["params"])
               for r in got)


def test_train_step_with_step_recompute(two_ranks):
    """``GCLT_SHARDED_SCAN_REMAT=full`` (a checkpoint per message-passing
    step) gives the step without it."""
    _, ref, got = two_ranks
    loss, grads, _ = ref["train_banded"]
    for r in got:
        assert abs(r["train_remat"]["loss"] - loss) <= LOSS_RTOL * abs(loss)
        _grads_close(r["train_remat"]["grads"], grads, "remat")


def test_kernel_gate_units_match_composed_ops(two_ranks):
    """At hidden 128 with ``GCLT_SHARDED_KERNELS=1`` the processor runs the
    fused edge unit (``edge_gather_mlp_agg``, its sender scatter over the
    extended table's CSR) and the GCN layers ``gcn_aggregate``; with
    ``=0`` the composed ops: the same loss and gradients."""
    _, _, got = two_ranks
    for r in got:
        on, off = r["train_h128_units1"], r["train_h128_units0"]
        assert abs(on["loss"] - off["loss"]) <= LOSS_RTOL * abs(off["loss"])
        _grads_close(on["grads"], off["grads"], "units")


@pytest.mark.parametrize("name", ["eval_full", "eval_partial"])
def test_eval_step_matches_jax(two_ranks, name):
    _, ref, got = two_ranks
    for r in got:
        for a, b, what in zip((r[name]["loss"], r[name]["acc"],
                               r[name]["rmse"]), ref[name],
                              ("loss", "acc", "rmse")):
            assert abs(a - b) <= 1e-5, (name, what, a, b)


def test_sparse_gat_step_prunes_as_jax(two_ranks):
    st, ref, got = two_ranks
    loss, grads, mask = ref["train_sparse"]
    live = int((mask > 0).sum())
    for r in got:
        res = r["train_sparse"]
        assert abs(res["loss"] - loss) <= LOSS_RTOL * abs(loss)
        _grads_close(res["grads"], grads, "sparse")
        assert res["mask"].shape == mask.shape
        differ = int((res["mask"] != mask).sum())
        assert differ <= 2, differ
    # Pruning happened.
    assert live < st.gs.processing.num_edges, (live,)


@pytest.mark.parametrize("name", ["trainer", "trainer_sparse"])
def test_trainer_mesh_fit(two_ranks, name):
    """One epoch of 2 steps through ``Trainer(mesh=, graph_set=).fit``
    against the JAX package's ``Trainer(mesh=, graph_set=).fit`` and the
    port's one-device fit (the InteractionNet and the SparseGAT
    experiments); rank 0 alone writes, and its checkpoint (for SparseGAT
    with every shard's mask, which is the JAX trainer's) loads back on
    every rank."""
    _, ref, got = two_ranks
    jres, jmask, one = ref[name]
    for r in got:
        res = r[name]
        for key in ("train_losses", "val_losses"):
            for want in (jres, one):
                assert len(res["results"][key]) == len(want[key]) == 1
                for a, b in zip(res["results"][key], want[key]):
                    assert abs(a - b) <= 1e-4 * max(abs(b), 1e-3), \
                        (key, a, b)
        assert res["meta_epoch"] == 0 and res["reloaded"]
        if jmask is not None:
            assert res["mask"].shape == jmask.shape
            differ = int((res["mask"] != jmask).sum())
            assert differ <= 2, differ
    files = got[0][name]["files"]
    for f in ("best_model.pt", "checkpoint", "metrics.jsonl",
              "results.json", "training_log.txt"):
        assert f in files, files
    assert got[1][name]["files"] == []


def test_frozen_processor(two_ranks):
    """``freeze_processor`` zeroes the processor's gradients after the
    all-reduce and leaves the others the unfrozen step's."""
    _, _, got = two_ranks
    for r in got:
        frozen, free = r["train_frozen"]["grads"], r["train_banded"]["grads"]
        for n, g in frozen.items():
            if "processor" in n.split("."):
                assert not g.any(), n
            else:
                np.testing.assert_array_equal(g, free[n], err_msg=n)


@pytest.fixture(scope="module")
def four_ranks(setup, tmp_path_factory):
    """The 4-rank cases: the (2, 2) tile shape at (1, 4) and the (2, 2)
    grid."""
    st = setup
    inet = _inet_cfg()
    _, _, params, state = st.model("inet", inet)
    x1 = np.random.RandomState(5).randn(st.g, OBS * N_FEAT).astype(
        np.float32)
    ref = {"fwd_tiles4": _jax_forward(st, inet, params, x1, 4,
                                      halo_mode="banded",
                                      partition="tiles")}
    x, y = _batch(st.g, 6)
    ref["train_grid"] = _jax_train(st, inet, params, x, y, 2, 2)
    cases = [dict(name="fwd_tiles4", kind="forward", mesh=(1, 4),
                  cfg=_port_cfg(inet), state=state, x=x1, halo="banded",
                  partition="tiles"),
             _train_case("train_grid", "inet", inet, st, (2, 2), 6)]
    got = tpd.spawn(tpd.sharded_cases, 4, tmp_path_factory.mktemp("ranks4"),
                    {"grid": GRID, "cases": cases}, timeout=600)
    return ref, got


def test_four_ranks_tiles_and_grid(four_ranks):
    """(1, 4) on the 2 x 2 tile plan: the forward and the rows exchanged;
    (2, 2): the train step, its gradients and the ranks' parameters."""
    ref, got = four_ranks
    expect, plan = ref["fwd_tiles4"]
    assert plan.partition == "tiles" and all(
        st["chosen"] == "tiled" for st in plan.comm_stats.values())
    for r in got:
        _close(r["fwd_tiles4"]["out"], expect, "tiles4")
    for graph, stats in plan.comm_stats.items():
        assert sum(r["fwd_tiles4"]["halo_rows"][graph]
                   / r["fwd_tiles4"]["halo_exchanges"][graph]
                   for r in got) == stats["banded"], (graph, stats)
    loss, grads, _ = ref["train_grid"]
    assert sorted(r["train_grid"]["mesh_index"] for r in got) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in got:
        assert abs(r["train_grid"]["loss"] - loss) <= LOSS_RTOL * abs(loss)
        _grads_close(r["train_grid"]["grads"], grads, "train_grid")
        assert np.array_equal(r["train_grid"]["params"],
                              got[0]["train_grid"]["params"])
