"""Rank programs of the port's multi-process tests, and the spawn that runs
them.

This module imports only torch, numpy and the port, so the ranks it spawns
never import JAX: ``spawn(fn, world, workdir, payload)`` starts ``world``
processes (the ``spawn`` start method), each with one torch thread and a
``gloo`` process group over a file store in ``workdir``, runs
``fn(rank, world, payload)`` in each and returns the ranks' results (dicts
of NumPy arrays and numbers), in rank order.  A rank that raises fails the
spawn with its traceback; a spawn that outlives ``timeout`` is killed; no
rank is left running when ``spawn`` returns or raises.

The JAX references are computed by the test process itself (on the
conftest's CPU devices) and the weights travel as the port's state dict.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from graphcast_lite_torch.graphs.build import build_graph_set
from graphcast_lite_torch.graphs.partition import build_banded_halos, \
    gather_nodes, partition_nodes_by_latitude, scatter_nodes, shard_graph
from graphcast_lite_torch.models.weather import WeatherModel
from graphcast_lite_torch.parallel import collectives as coll
from graphcast_lite_torch.parallel import sharded_model as sm
from graphcast_lite_torch.parallel.sharding import make_mesh
from graphcast_lite_torch.parallel.spmd import sharded_interaction_processor
from graphcast_lite_torch.training.rollout import RolloutSpec

# Seconds a collective may wait before gloo gives up on a peer.
COLLECTIVE_TIMEOUT_S = 120


def _entry(rank, world, store, fn, payload, out_dir):
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        out = fn(rank, world, payload)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn, world, workdir, payload, timeout=300.0):
    """[result of rank 0, ..., rank world - 1] of ``fn`` run on ``world``
    ranks."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    ctx = mp.start_processes(_entry, args=(world, store, fn, payload,
                                           workdir),
                             nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {world} ranks "
                                   f"outlived {timeout} s")
    finally:
        # No rank outlives the spawn, whatever ended it: a rank left alive
        # would keep the test worker from exiting.
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _np(t):
    return t.detach().cpu().double().numpy()


# ---- the collectives ------------------------------------------------------


def _adjoint(fn, x, y):
    """(f(x), the gradient of <f(x), y> in x, <f(x), y>, <x, grad>) in
    float64."""
    x = x.clone().requires_grad_(True)
    out = fn(x)
    (out * y).sum().backward()
    out = out.detach()
    return (_np(out), _np(x.grad), float((out * y).sum()),
            float((x.detach() * x.grad).sum()))


def collective_cases(rank, world, payload):
    """Each differentiable collective's forward and backward at ``world``
    ranks, and again over a group of this rank alone; the plain in-place
    ones."""
    solo = [dist.new_group([r]) for r in range(world)][rank]
    world_g = dist.group.WORLD
    out = {}
    n, f = payload["rows"], payload["cols"]

    def draw(seed, rows):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(rows, f, generator=g, dtype=torch.float64)

    x = draw(100 + rank, n)
    for label, group, size in (("world", world_g, world), ("solo", solo, 1)):
        out[f"all_gather/{label}"] = _adjoint(
            lambda v: coll.all_gather_rows(v, group), x,
            draw(200 + rank, size * n))
        out[f"all_reduce_sum/{label}"] = _adjoint(
            lambda v: coll.all_reduce_sum(v, group), x, draw(300 + rank, n))
    for name, pairs in payload["pairs"].items():
        out[f"ppermute/{name}"] = _adjoint(
            lambda v: coll.ppermute_rows(v, pairs, world_g), x,
            draw(400 + rank, n))
    out["ppermute/solo"] = _adjoint(
        lambda v: coll.ppermute_rows(v, [], solo), x, draw(500 + rank, n))
    t = x.clone()
    out["all_reduce_"] = _np(coll.all_reduce_(t, world_g))
    t = x.clone()
    out["broadcast_"] = _np(coll.broadcast_(t, world - 1, world_g))
    out["staged_bytes"] = coll.transport["staged_bytes"]
    return out


# ---- the sharded model ----------------------------------------------------


def _graph_set(grid):
    lat, lon, levels, radius = grid
    return build_graph_set(np.asarray(lat, np.float32),
                           np.asarray(lon, np.float32), levels, radius)


def _model(cfg, gs, state):
    model = WeatherModel(cfg.pipeline, cfg.data, gs.num_grid_nodes,
                         gs.num_mesh_nodes)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in state.items()})
    return model


def _gather_grid(plan, mesh, block):
    """This rank's [G_s, C] block -> the grid [G, C] in node order (over
    the space group)."""
    full = coll.all_gather_rows(block.detach(), mesh.space_group)
    return plan.gather_grid(_np(full).reshape(plan.num_shards, -1,
                                              block.shape[-1]))


def _gather_mask(mesh, mask):
    return _np(coll.all_gather_rows(mask.detach()[None], mesh.space_group))


def _case_forward(case, gs, model, mesh, plan, arrs, fwd):
    x = case["x"]                               # [G, obs·F]
    run = sm.make_sharded_forward(fwd, mesh)
    edge_mask = None
    if case.get("zero_mask"):
        edge_mask = torch.zeros_like(arrs.proc.graph.edge_mask)
    sm.reset_halo_rows()
    out = run(model, plan.scatter_grid(x[None]), arrs, edge_mask)
    return {"out": _gather_grid(plan, mesh, out[0, 0]),
            "halo_rows": dict(sm.halo_rows),
            "halo_exchanges": dict(sm.halo_exchanges)}


def _case_train(case, gs, model, mesh, plan, arrs, fwd):
    spec = RolloutSpec(**case["spec"])
    opt = torch.optim.Adam(model.parameters(), lr=case.get("lr", 1e-3))
    step = sm.make_sharded_train_step(
        fwd, spec, mesh, model, opt, case["steps"],
        chan_mask=case.get("chan_mask"), prune=case.get("prune", False),
        freeze_processor=case.get("freeze", False))
    mask = None
    if fwd.sparse_gat:
        mask = arrs.proc.graph.edge_mask.clone()
    loss, new_mask = step(plan.scatter_grid(case["x"]),
                          plan.scatter_grid(case["y"]), arrs, mask,
                          case.get("thr", 0.0))
    res = {"loss": float(loss),
           "grads": {n: _np(p.grad) for n, p in model.named_parameters()},
           "params": np.concatenate([_np(p).ravel()
                                     for p in model.parameters()])}
    if new_mask is not None:
        res["mask"] = _gather_mask(mesh, new_mask)
    return res


def _case_eval(case, gs, model, mesh, plan, arrs, fwd):
    spec = RolloutSpec(**case["spec"])
    ev = sm.make_sharded_eval_step(fwd, spec, mesh, model,
                                   chan_mask=case.get("chan_mask"),
                                   exclude_channels=case.get("exclude", ()))
    loss, acc, rmse = ev(plan.scatter_grid(case["x"]),
                         plan.scatter_grid(case["y"]), case["sample_mask"],
                         arrs)
    return {"loss": loss, "acc": acc, "rmse": rmse}


def _case_processor(case, gs, model, mesh):
    """The InteractionNet processor alone (``parallel.spmd``) on the
    processing graph cut into latitude bands."""
    s = mesh.space
    sg = shard_graph(gs.processing,
                     partition_nodes_by_latitude(gs.mesh_lat, s), s)
    shard = mesh.space_index
    ga = sm.graph_arrays(sg, None, shard, "proc", False, "cpu")
    halos = None
    if case["halo"] == "banded":
        halos = sm.graph_arrays(sg, build_banded_halos(sg), shard, "proc",
                                False, "cpu")
    proc = model.processor.graph_layer.inet
    x = torch.from_numpy(scatter_nodes(sg, case["x"])[shard])
    with torch.no_grad():
        out = sharded_interaction_processor(proc, x, ga, mesh,
                                            case["use_ln"], halos)
    full = coll.all_gather_rows(out, mesh.space_group)
    return {"out": gather_nodes(sg, _np(full).reshape(s, -1,
                                                      out.shape[-1]))}


def sharded_cases(rank, world, payload):
    """Every case of ``payload["cases"]`` on its own (data, space) grid."""
    gs = _graph_set(payload["grid"])
    out = {}
    for case in payload["cases"]:
        if case["kind"] == "trainer":
            out[case["name"]] = trainer_case(rank, case)
            continue
        data, space = case["mesh"]
        mesh = make_mesh(data_parallel=data)
        assert mesh.shape == (data, space)
        model = _model(case["cfg"], gs, case["state"])
        if case["kind"] == "processor":
            out[case["name"]] = _case_processor(case, gs, model, mesh)
            continue
        plan = sm.build_sharding_plan(gs, space,
                                      halo_mode=case.get("halo", "auto"),
                                      partition=case.get("partition",
                                                         "auto"))
        arrs = sm.plan_device_arrays(plan, gs, mesh,
                                     lat_weights=case.get("lat_weights"),
                                     device="cpu")
        fwd = sm.ShardedWeatherForward(case["cfg"].pipeline,
                                       case["cfg"].data, space)
        run = {"forward": _case_forward, "train": _case_train,
               "eval": _case_eval}[case["kind"]]
        env = case.get("env", {})
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            out[case["name"]] = run(case, gs, model, mesh, plan, arrs, fwd)
        finally:
            for k, v in saved.items():
                if v is None:
                    del os.environ[k]
                else:
                    os.environ[k] = v
        out[case["name"]]["mesh_index"] = (mesh.data_index,
                                           mesh.space_index)
    return out


# ---- the batch axis through the sharded path ------------------------------


@contextlib.contextmanager
def _counted():
    """The plain segment-sum and ``edge_mlp`` calls, the halo exchanges and
    the collectives made in the block: ``counts`` is filled on exit."""
    from graphcast_lite_torch.ops import cuda_segment, edge_mlp

    counts = {"segment_sum": 0, "edge_mlp": 0}
    saved = (cuda_segment.segment_sum, edge_mlp.edge_mlp)

    def counting(name, fn):
        def call(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return call

    cuda_segment.segment_sum = counting("segment_sum", saved[0])
    edge_mlp.edge_mlp = counting("edge_mlp", saved[1])
    sm.reset_halo_rows()
    coll.reset_transport()
    try:
        yield counts
    finally:
        cuda_segment.segment_sum, edge_mlp.edge_mlp = saved
        counts.update(halo_exchanges=dict(sm.halo_exchanges),
                      halo_rows=dict(sm.halo_rows),
                      collectives=coll.transport["collectives"])


def _batched_forward(case, model, mesh, plan, arrs, fwd):
    """A batch of B samples in one forward call against one call a sample;
    the counts of the batched call and of a one-sample call; sample 0 of
    a batch whose other samples changed."""
    x = case["x"]                               # [B, G, obs·F]
    run = sm.make_sharded_forward(fwd, mesh)

    def grid(out):
        return np.stack([_gather_grid(plan, mesh, o[0]) for o in out])

    with _counted() as batched:
        out = run(model, plan.scatter_grid(x), arrs)
    singles = []
    for i in range(x.shape[0]):
        with _counted() as one:
            singles.append(run(model, plan.scatter_grid(x[i:i + 1]), arrs))
    changed = run(model, plan.scatter_grid(case["x_changed"]), arrs)
    return {"out": grid(out),
            "singles": np.concatenate([grid(o) for o in singles]),
            "changed": grid(changed), "counts": batched, "counts_one": one}


def _batched_train(case, model, mesh, plan, arrs, fwd):
    """The train step on the batch and on each sample alone (SGD at lr 0,
    so that every step starts from the same weights): losses, gradients,
    the SparseGAT mask, the counts of the batched and of a one-sample
    step."""
    spec = RolloutSpec(**case["spec"])
    step = sm.make_sharded_train_step(
        fwd, spec, mesh, model, torch.optim.SGD(model.parameters(), lr=0.0),
        case["steps"], chan_mask=case.get("chan_mask"),
        prune=case.get("prune", False))

    def one(x, y):
        mask = (arrs.proc.graph.edge_mask.clone() if fwd.sparse_gat
                else None)
        with _counted() as counts:
            loss, new_mask = step(plan.scatter_grid(x), plan.scatter_grid(y),
                                  arrs, mask, case.get("thr", 0.0))
        res = {"loss": float(loss), "counts": counts,
               "grads": {n: _np(p.grad) for n, p in
                         model.named_parameters()}}
        if new_mask is not None:
            res["mask"] = _gather_mask(mesh, new_mask)
        return res

    x, y = case["x"], case["y"]
    out = {"batched": one(x, y)}
    if case.get("singles", True):
        out["singles"] = [one(x[i:i + 1], y[i:i + 1])
                          for i in range(x.shape[0])]
    return out


def _batched_eval(case, model, mesh, plan, arrs, fwd):
    """The eval step on a padded batch and on each real sample alone."""
    spec = RolloutSpec(**case["spec"])
    ev = sm.make_sharded_eval_step(fwd, spec, mesh, model,
                                   chan_mask=case.get("chan_mask"),
                                   exclude_channels=case.get("exclude", ()))
    x, y, smask = case["x"], case["y"], case["sample_mask"]
    with _counted() as counts:
        batched = ev(plan.scatter_grid(x), plan.scatter_grid(y), smask,
                     arrs)
    singles = [ev(plan.scatter_grid(x[i:i + 1]), plan.scatter_grid(
        y[i:i + 1]), np.ones(1, np.float32), arrs)
        for i in range(x.shape[0]) if smask[i] > 0]
    return {"batched": batched, "singles": singles, "counts": counts}


def _batched_collectives(rank, payload):
    """Each differentiable collective on a [B, n, F] batch against the
    same collective a sample, forward and backward, and the collectives
    the batch took."""
    world_g = dist.group.WORLD
    b, n, f = payload["batch"], payload["rows"], payload["cols"]
    g = torch.Generator().manual_seed(700 + rank)
    x = torch.randn(b, n, f, generator=g, dtype=torch.float64)
    out = {}
    for name, fn, rows_out in (
            ("all_gather", lambda v: coll.all_gather_rows(v, world_g),
             dist.get_world_size() * n),
            ("ppermute", lambda v: coll.ppermute_rows(
                v, payload["pairs"], world_g), n),
            ("all_reduce_sum", lambda v: coll.all_reduce_sum(v, world_g),
             n)):
        y = torch.randn(b, rows_out, f, generator=g, dtype=torch.float64)
        coll.reset_transport()
        batched = _adjoint(fn, x, y)
        collectives = coll.transport["collectives"]
        singles = [_adjoint(fn, x[i], y[i]) for i in range(b)]
        out[name] = {"out": batched[0], "grad": batched[1],
                     "out_singles": np.stack([s[0] for s in singles]),
                     "grad_singles": np.stack([s[1] for s in singles]),
                     "collectives": collectives}
    return out


def batched_sharded_cases(rank, world, payload):
    """Every case of ``payload["cases"]`` (kinds ``forward``, ``train``,
    ``eval``) on its (data, space) grid, and the collectives on a batch."""
    gs = _graph_set(payload["grid"])
    out = {"collectives": _batched_collectives(rank,
                                               payload["collectives"])}
    for case in payload["cases"]:
        data, space = case["mesh"]
        mesh = make_mesh(data_parallel=data)
        model = _model(case["cfg"], gs, case["state"])
        plan = sm.build_sharding_plan(gs, space,
                                      halo_mode=case.get("halo", "auto"),
                                      partition=case.get("partition",
                                                         "auto"))
        arrs = sm.plan_device_arrays(plan, gs, mesh,
                                     lat_weights=case.get("lat_weights"),
                                     device="cpu")
        fwd = sm.ShardedWeatherForward(case["cfg"].pipeline,
                                       case["cfg"].data, space)
        run = {"forward": _batched_forward, "train": _batched_train,
               "eval": _batched_eval}[case["kind"]]
        env = case.get("env", {})
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            out[case["name"]] = run(case, model, mesh, plan, arrs, fwd)
        finally:
            for k, v in saved.items():
                if v is None:
                    del os.environ[k]
                else:
                    os.environ[k] = v
    return out


# ---- the trainer ------------------------------------------------------------


def trainer_case(rank, payload):
    """``Trainer(mesh=, graph_set=).fit`` of ``payload["cfg"]`` from the
    weights ``payload["init"]`` on the dataset of ``payload["data_dir"]``
    at ``payload["steps"]`` steps an epoch, each rank into its own results
    folder (so that the parent sees which ranks wrote)."""
    from graphcast_lite_torch.build import build_weather_model
    from graphcast_lite_torch.data.dataset import load_chunked_datasets
    from graphcast_lite_torch.training.trainer import Trainer

    cfg = payload["cfg"]
    train_ds, val_ds, _, meta = load_chunked_datasets(
        payload["data_dir"], obs_window=cfg.data.obs_window_used,
        pred_steps=cfg.data.pred_window_used,
        n_features=cfg.data.num_features_used)
    model, graphs, gs = build_weather_model(cfg, meta, device="cpu")
    mesh = make_mesh(data_parallel=payload["mesh"][0])
    results_dir = os.path.join(payload["out"], f"rank{rank}")
    tr = Trainer(model, graphs, cfg, meta, results_dir, mesh=mesh,
                 graph_set=gs, device="cpu")
    state = tr.init_state(seed=0)
    state.model.load_state_dict({k: torch.from_numpy(v)
                                 for k, v in payload["init"].items()})
    res = tr.fit(state, train_ds, val_ds, print_losses=False,
                 max_steps_per_epoch=payload["steps"])
    files = sorted(os.listdir(results_dir)) if os.path.isdir(
        results_dir) else []
    final = {n: _np(p) for n, p in model.named_parameters()}
    # Rank 0's checkpoint loads back into a fresh trainer's state on every
    # rank.
    tr2 = Trainer(model, graphs, cfg, meta,
                  os.path.join(payload["out"], "rank0"), mesh=mesh,
                  graph_set=gs, device="cpu")
    state2 = tr2.init_state(seed=1)
    meta2 = tr2.load_checkpoint(state2)
    reloaded = all(np.array_equal(_np(p), final[n])
                   for n, p in model.named_parameters())
    out = {"results": res, "files": files, "meta_epoch": meta2["epoch"],
           "params": final}
    if tr.using_sparse_gat:
        # This rank's row of the [S, E_s] mask the checkpoint holds.
        reloaded = reloaded and torch.equal(state2.edge_mask,
                                            tr.final_state.edge_mask)
        out["mask"] = _gather_mask(mesh, tr.final_state.edge_mask)
    out["reloaded"] = reloaded
    return out


# ---- the data-parallel step (the GSPMD fallback's counterpart) -------------


def _dp_model(case):
    """The case's port model from its state dict (fp32, CPU)."""
    from graphcast_lite_torch.models import unet
    from graphcast_lite_torch.models.grid_adapter import GridImageModel

    if case["unet"] is not None:
        u = case["unet"]
        model = GridImageModel(getattr(unet, u["cls"])(*u["args"]),
                               u["n_lat"], u["n_lon"])
    else:
        model = WeatherModel(case["cfg"].pipeline, case["cfg"].data,
                             case["n_grid"], case["n_mesh"])
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in case["state"].items()})
    return model


def _dp_step(case, model):
    """``make_train_step`` of the case on ``model``: Adam at the config's
    rate, or the CNN trainers' ``ClippedAdamW`` and image losses."""
    from graphcast_lite_torch.training.loss import image_extra_loss
    from graphcast_lite_torch.training.optim import ClippedAdamW
    from graphcast_lite_torch.training.trainer import make_train_step

    opt = extra = None
    if case["unet"] is not None:
        u = case["unet"]
        opt = ClippedAdamW(model.parameters(), case["cfg"].learning_rate,
                           u["decay_steps"], u["max_norm"])
        extra = image_extra_loss(u["n_lat"], u["n_lon"], u["c"],
                                 *u["extra"])
    return make_train_step(model, case["graphs"], case["spec"], case["cfg"],
                           steps=case["steps"], device="cpu",
                           lat_weights=case["lw"], chan_mask=case["cm"],
                           spatial_mask=case["sm"], optimizer=opt,
                           extra_loss_fn=extra)


def _named_params(model):
    """{name: parameter} in the module's order."""
    return {n: p.detach().numpy().copy()
            for n, p in model.named_parameters()}


def _dp_run(step, case):
    mask = case["mask0"]
    mask = None if mask is None else torch.from_numpy(mask)
    loss, new_mask = step.run(case["x"], case["y"], mask, case["thr"],
                              case["prune"])
    return (float(loss),
            None if new_mask is None else new_mask.numpy().copy())


def data_parallel_cases(rank, world, payload):
    """Each case of ``payload["cases"]`` through the data-parallel step over
    all ranks (a (world, 1) mesh), with the batch sizes its model calls
    saw, and its eval step; case i also at world 1 on rank i % world (a
    group of that rank alone) against ``make_train_step``."""
    from graphcast_lite_torch.parallel.sharding import ProcessMesh, \
        make_data_parallel_eval_step, make_data_parallel_train_step

    solo = [dist.new_group([r]) for r in range(world)][rank]
    mesh = make_mesh(data_parallel=world)
    assert mesh.shape == (world, 1)
    one = ProcessMesh(shape=(1, 1), rank=0, data_index=0, space_index=0,
                      space_group=solo, data_group=solo, world_group=solo)
    out = {}
    for i, case in enumerate(payload["cases"]):
        res = {}
        model = _dp_model(case)
        ev = make_data_parallel_eval_step(
            model, case["graphs"], case["spec"], mesh, case["lw"],
            case["cm"], case["sm"], case["exclude"], device="cpu")
        mask0 = case["mask0"]
        res["eval"] = ev(case["x"], case["y"], None if mask0 is None
                         else torch.from_numpy(mask0))
        dp = make_data_parallel_train_step(_dp_step(case, model), mesh)
        seen = set()
        hook = model.register_forward_pre_hook(
            lambda m, args: seen.add(args[0].shape[0]))
        coll.reset_transport()
        res["loss"], res["mask"] = _dp_run(dp, case)
        hook.remove()
        res["batch_seen"] = sorted(seen)
        res["params"] = _named_params(model)
        res["grads"] = {n: p.grad.numpy().copy()
                        for n, p in model.named_parameters()}
        res["all_reduces"] = dp.all_reduces
        res["mask_broadcasts"] = dp.mask_broadcasts
        res["transport"] = dict(coll.transport)
        if i % world == rank:
            a, b = _dp_model(case), _dp_model(case)
            solo_dp = make_data_parallel_train_step(_dp_step(case, a), one)
            ref = _dp_step(case, b)
            res["world1"] = {
                "dp": _dp_run(solo_dp, case) + (_named_params(a),),
                "one": _dp_run(ref, case) + (_named_params(b),)}
        out[case["name"]] = res
    return out
