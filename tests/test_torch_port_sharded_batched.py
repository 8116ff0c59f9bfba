"""The batch axis through the port's sharded path: a rank's whole local
batch in one forward call (``parallel.sharded_model``), as the JAX
package's ``jax.vmap`` maps its sharded forward, on gloo ranks on the CPU.

``tests/test_sharded_model.py``'s setup (16 x 24 grid, mesh levels [1,
2], hidden 32, 2 message-passing steps, 5 features, obs 2, pred 2) on one
spawn of 2 ranks (``torch_port_dist.batched_sharded_cases``):

* the forward at B = 3 in gather, banded and tiled halo modes and for the
  GCN, GAT and SparseGAT families against one call a sample (fp32, atol
  1e-6 + rtol 1e-5); sample 0's output bitwise unchanged when the other
  samples change;
* the AR-2 train step at B = 2 against the mean of one step a sample (the
  loss within 1e-5 relative, every gradient within 1e-5·max|g| + 1e-6),
  also at hidden 128 through the fused edge unit with its ``edge_mlp``
  tail (``GCLT_SHARDED_KERNELS=1``, ``GCLT_MEGA_EDGE=1``); the eval step
  on a padded partial batch against its real samples alone;
* per call, the halo exchanges, the collectives and the plain segment-sum
  and ``edge_mlp`` calls of a batch equal one sample's; the rows an
  exchange, per sample, the plan's;
* SparseGAT at B = 2 prunes on sample 0's attention;
* each collective on a [B, n, F] batch in one call against one a sample;
* and against the JAX package: a B = 3 forward at mesh (1, 2) through its
  ``jax.vmap`` (1e-5) and a (2, 1) train step at B = 4, two samples a
  rank (the loss within 1e-5 relative, gradients within 1e-4·max|g| +
  1e-6, as ``test_torch_port_sharded_model.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dist as tpd
from graphcast_lite_tpu.parallel import sharded_model as jsm
from graphcast_lite_torch.models.weather import WeatherModel as PModel
from graphcast_lite_torch.training.loss import channel_mask, \
    lat_weights_from_axis
from test_torch_port_sharded_model import GRID, N_FEAT, OBS, PRED, SPEC, \
    THR, _full_gat_cfg, _gat_cfg, _gcn_cfg, _grads_close, _inet_cfg, \
    _jax_train, _mesh, _port_cfg, _Setup
from torch_port_common import one_torch_thread  # noqa: F401

B_FWD, B_TRAIN, B_JAX_TRAIN = 3, 2, 4
ATOL, RTOL = 1e-6, 1e-5
JAX_FWD_ATOL = 1e-5
JAX_LOSS_RTOL = 1e-5
MODES = {"gather": dict(halo="gather"),
         "banded": dict(halo="banded"),
         "tiled": dict(halo="banded", partition="tiles")}
FAMILIES = ("gcn", "gat", "sparse")


def _draw(rng, b, g, width):
    return rng.randn(b, g, width).astype(np.float32)


def _jax_forward_batch(st, jcfg, params, x, space, **plan_kw):
    """The JAX package's sharded forward on a batch (its ``jax.vmap``):
    [B, G, obs·F] -> [B, G, C]."""
    plan = jsm.build_sharding_plan(st.gs, space, **plan_kw)
    arrs = jsm.plan_device_arrays(plan, st.gs)
    fwd = jsm.ShardedWeatherForward(jcfg.pipeline, jcfg.data, space)
    out = np.asarray(jsm.make_sharded_forward(fwd, _mesh(1, space))(
        params, jnp.asarray(plan.scatter_grid(x)), arrs))
    return np.stack([plan.gather_grid(o) for o in out])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(JAX references, the two ranks' results)."""
    st = _Setup()
    rng = np.random.RandomState(11)
    inet = _inet_cfg()
    _, _, params, state = st.model("inet", inet)
    pcfg = _port_cfg(inet)
    x = _draw(rng, B_FWD, st.g, OBS * N_FEAT)
    # The same batch with samples 1 and 2 replaced.
    x_changed = np.concatenate([x[:1], _draw(rng, B_FWD - 1, st.g,
                                             OBS * N_FEAT)])
    fwd = dict(kind="forward", mesh=(1, 2), x=x, x_changed=x_changed)
    cases = [dict(fwd, name=f"fwd_{mode}", cfg=pcfg, state=state, **kw)
             for mode, kw in MODES.items()]
    for name, jcfg in (("gcn", _gcn_cfg()), ("gat", _full_gat_cfg()),
                       ("sparse", _gat_cfg(sparse=True))):
        _, _, _, s = st.model(name, jcfg)
        cases.append(dict(fwd, name=f"fwd_{name}", cfg=_port_cfg(jcfg),
                          state=s))
    ref = {"fwd_jax": _jax_forward_batch(st, inet, params, x, 2,
                                         halo_mode="banded")}

    train = dict(kind="train", spec=SPEC, steps=PRED,
                 lat_weights=lat_weights_from_axis(16, 24),
                 chan_mask=channel_mask(N_FEAT, [1], [3]))
    xt = _draw(rng, B_TRAIN, st.g, OBS * N_FEAT)
    yt = _draw(rng, B_TRAIN, st.g, PRED * N_FEAT)
    cases.append(dict(train, name="train", mesh=(1, 2), cfg=pcfg,
                      state=state, x=xt, y=yt, halo="banded"))
    wide = _port_cfg(_inet_cfg(hidden=128))
    state128 = {k: v.numpy() for k, v in PModel(
        wide.pipeline, wide.data, st.g, st.gs.num_mesh_nodes,
        generator=torch.Generator().manual_seed(3)).state_dict().items()}
    cases.append(dict(train, name="train_units", mesh=(1, 2), cfg=wide,
                      state=state128, x=xt, y=yt, halo="banded",
                      env={"GCLT_SHARDED_KERNELS": "1",
                           "GCLT_MEGA_EDGE": "1"}))
    sparse = _gat_cfg(sparse=True)
    _, _, _, s = st.model("sparse", sparse)
    cases.append(dict(train, name="train_sparse", mesh=(1, 2),
                      cfg=_port_cfg(sparse), state=s, x=xt, y=yt,
                      prune=True, thr=THR))
    xj = _draw(rng, B_JAX_TRAIN, st.g, OBS * N_FEAT)
    yj = _draw(rng, B_JAX_TRAIN, st.g, PRED * N_FEAT)
    ref["train_jax"] = _jax_train(st, inet, params, xj, yj, 2, 1)
    cases.append(dict(train, name="train_dp", mesh=(2, 1), cfg=pcfg,
                      state=state, x=xj, y=yj, singles=False))
    # Eval: sample 2 is padding (mask 0) full of garbage.
    xe = _draw(rng, 3, st.g, OBS * N_FEAT)
    ye = _draw(rng, 3, st.g, PRED * N_FEAT)
    xe[2], ye[2] = 13.0, -7.0
    cases.append(dict(kind="eval", name="eval_partial", mesh=(1, 2),
                      cfg=pcfg, state=state, x=xe, y=ye,
                      sample_mask=np.array([1.0, 1.0, 0.0], np.float32),
                      spec=SPEC, exclude=(1, 3)))
    payload = {"grid": GRID, "cases": cases,
               "collectives": {"batch": 3, "rows": 4, "cols": 5,
                               "pairs": [(0, 1), (1, 0)]}}
    got = tpd.spawn(tpd.batched_sharded_cases, 2,
                    tmp_path_factory.mktemp("batched_ranks"), payload,
                    timeout=300)
    return st, ref, got


def _close(got, want, label, atol=ATOL, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    err = np.abs(got - want)
    tol = atol + rtol * np.abs(want)
    worst = float((err - tol).max())
    assert worst <= 0.0, f"{label}: max abs {float(err.max()):.3e}"


def _per_call(counts):
    return {k: counts[k] for k in ("segment_sum", "edge_mlp",
                                   "halo_exchanges", "collectives")}


def _grads_mean_close(grads, singles, label):
    """Every gradient of the batched step within 1e-5·max|g| + 1e-6 of the
    mean of the one-sample steps' (each step's loss is its own mean)."""
    assert set(grads) == set(singles[0]), label
    for name, g in grads.items():
        want = np.mean([s[name] for s in singles], axis=0)
        err = np.abs(g - want).max()
        tol = RTOL * np.abs(want).max() + ATOL
        assert err <= tol, f"{label} {name}: {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("name", [f"fwd_{m}" for m in MODES]
                         + [f"fwd_{f}" for f in FAMILIES])
def test_forward_batch_matches_one_call_a_sample(ranks, name):
    st, _, got = ranks
    for r in got:
        res = r[name]
        _close(res["out"], res["singles"], name)
        # Sample 0 does not see the others.
        np.testing.assert_array_equal(res["changed"][0], res["out"][0],
                                      err_msg=name)
        assert not np.array_equal(res["changed"][1], res["out"][1])
        # One exchange, one collective and one launch a layer for the batch.
        assert _per_call(res["counts"]) == _per_call(res["counts_one"]), \
            (name, res["counts"], res["counts_one"])
        assert res["counts"]["segment_sum"] > 0
        # The rows an exchange are still one sample's.
        assert res["counts"]["halo_rows"] == res["counts_one"]["halo_rows"]


def test_forward_batch_matches_jax_vmap(ranks):
    """B = 3 through the port's one call and the JAX package's
    ``jax.vmap`` of its sharded forward at mesh (1, 2), banded."""
    _, ref, got = ranks
    for r in got:
        err = np.abs(r["fwd_banded"]["out"] - ref["fwd_jax"]).max()
        assert err <= JAX_FWD_ATOL, err


@pytest.mark.parametrize("name", ["train", "train_units"])
def test_train_step_batch_matches_one_step_a_sample(ranks, name):
    _, _, got = ranks
    for r in got:
        res = r[name]
        batched, singles = res["batched"], res["singles"]
        loss = np.mean([s["loss"] for s in singles])
        assert abs(batched["loss"] - loss) <= RTOL * abs(loss), \
            (batched["loss"], loss)
        _grads_mean_close(batched["grads"], [s["grads"] for s in singles],
                          name)
        assert _per_call(batched["counts"]) == _per_call(
            singles[0]["counts"]), (batched["counts"], singles[0]["counts"])
    if name == "train_units":
        # The fused unit's forward tail: edge_mlp, forward and recompute
        # of each of the 2 message-passing steps in each of the 2 AR steps.
        assert got[0][name]["batched"]["counts"]["edge_mlp"] == 2 * 2 * 2


def test_train_step_two_samples_a_rank_matches_jax(ranks):
    """(2, 1) at B = 4: each data rank's two samples in one call, against
    the JAX package's vmapped step."""
    _, ref, got = ranks
    loss, grads, _ = ref["train_jax"]
    for r in got:
        res = r["train_dp"]["batched"]
        assert abs(res["loss"] - loss) <= JAX_LOSS_RTOL * abs(loss)
        _grads_close(res["grads"], grads, "train_dp vs JAX")


def test_eval_step_padded_batch_matches_its_samples(ranks):
    _, _, got = ranks
    for r in got:
        res = r["eval_partial"]
        (loss, acc, rmse), singles = res["batched"], res["singles"]
        assert len(singles) == 2
        want = (np.mean([s[0] for s in singles]),
                np.mean([s[1] for s in singles]),
                np.sqrt(np.mean([s[2] ** 2 for s in singles])))
        _close([loss, acc, rmse], want, "eval_partial")


def test_sparse_gat_batch_prunes_on_sample_zero(ranks):
    """The mask a B = 2 step returns is sample 0's alone (the JAX
    package's ``masks[0]``), not sample 1's."""
    st, _, got = ranks
    for r in got:
        res = r["train_sparse"]
        mask = res["batched"]["mask"]
        first, second = (s["mask"] for s in res["singles"])
        assert int((mask != first).sum()) <= 2
        assert int((mask != second).sum()) > 2
        assert int((mask > 0).sum()) < st.gs.processing.num_edges


@pytest.mark.parametrize("name", ["all_gather", "ppermute",
                                  "all_reduce_sum"])
def test_collectives_carry_a_batch_in_one_call(ranks, name):
    _, _, got = ranks
    for r in got:
        res = r["collectives"][name]
        np.testing.assert_array_equal(res["out"], res["out_singles"])
        np.testing.assert_array_equal(res["grad"], res["grad_singles"])
        assert res["collectives"] == 2     # the forward and its adjoint
