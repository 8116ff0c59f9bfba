"""The port's host-side sharding plan (``parallel.sharding``,
``parallel.sharded_model``) against the JAX package's, on the CPU, with no
process group.

* ``choose_mesh_shape`` for 1-16 devices, with and without a data axis;
* ``build_sharding_plan`` on the 64x32 graph set (mesh [1, 2]) at S = 2
  and 4, partition lat / tiles / auto, halo mode gather / banded / auto:
  every array of both node partitions, of the three sharded graphs and of
  their halo plans, the chosen plans and ``comm_stats``;
* ``predict_scaling_efficiency`` (the same link bandwidth on both sides;
  the port has no default for it) and ``estimate_sharded_hbm``;
* each rank's CSRs (``graph_arrays``): receivers sorted with padding rows
  last, ``indptr[R] == E_pad``, the sender CSR a stable argsort over the
  extended table, the static in-degree equal to the JAX package's
  ``static_in_degree`` and ``gcn_norm`` equal to the one-device graph's
  normalizer of the same edges; a shard whose receivers are out of order
  is refused.
"""

import dataclasses

import numpy as np
import pytest
import torch

from graphcast_lite_tpu.parallel import sharded_model as jsm
from graphcast_lite_tpu.parallel import sharding as jsharding
from graphcast_lite_torch.parallel import sharded_model as psm
from graphcast_lite_torch.parallel import sharding as psharding
from test_torch_port_partition import _assert_fields_equal
from torch_port_common import graph_sets
from torch_port_common import \
    one_torch_thread  # noqa: F401 (an autouse fixture)

CASES = [(s, part, halo) for s in (2, 4) for part in ("lat", "tiles", "auto")
         for halo in ("gather", "banded", "auto")]


@pytest.mark.parametrize("n", range(1, 17))
def test_choose_mesh_shape(n):
    assert psharding.choose_mesh_shape(n) == jsharding.choose_mesh_shape(n)
    for d in (1, 2, 4):
        if n % d == 0:
            assert psharding.choose_mesh_shape(n, d) \
                == jsharding.choose_mesh_shape(n, d)


def _plans(num_shards, partition, halo):
    jgs, pgs = graph_sets()
    return (jsm.build_sharding_plan(jgs, num_shards, halo_mode=halo,
                                    partition=partition),
            psm.build_sharding_plan(pgs, num_shards, halo_mode=halo,
                                    partition=partition))


@pytest.mark.parametrize("num_shards,partition,halo", CASES)
def test_plan_equals_jax(num_shards, partition, halo):
    jplan, pplan = _plans(num_shards, partition, halo)
    assert pplan.num_shards == jplan.num_shards
    assert pplan.partition == jplan.partition
    assert pplan.comm_stats == jplan.comm_stats
    _assert_fields_equal(pplan.grid_part, jplan.grid_part, "grid")
    _assert_fields_equal(pplan.mesh_part, jplan.mesh_part, "mesh")
    for name in ("enc", "proc", "dec"):
        _assert_fields_equal(getattr(pplan, name), getattr(jplan, name),
                             name)
        jh, ph = getattr(jplan, f"{name}_halos"), getattr(pplan,
                                                          f"{name}_halos")
        assert (jh is None) == (ph is None), name
        if jh is not None:
            _assert_fields_equal(ph, jh, f"{name} halos")
    x = np.random.RandomState(num_shards).randn(
        2, pplan.grid_part.num_nodes, 3).astype(np.float32)
    np.testing.assert_array_equal(pplan.scatter_grid(x),
                                  jplan.scatter_grid(x))
    np.testing.assert_array_equal(pplan.gather_grid(pplan.scatter_grid(x)),
                                  x)


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_scaling_and_memory_models_equal_jax(num_shards):
    jplan, pplan = _plans(num_shards, "auto", "auto")
    for kw in (dict(t1_step_ms=1000.0), dict(t1_step_ms=700.0, hidden=32,
                                             ar_steps=2, mp_steps=2,
                                             overhead_frac=0.25)):
        assert psm.predict_scaling_efficiency(pplan, link_gbps=45.0, **kw) \
            == jsm.predict_scaling_efficiency(jplan, ici_gbps=45.0, **kw)
    for kw in ({}, dict(scan_remat=True), dict(hidden=32, mp_steps=2)):
        assert psm.estimate_sharded_hbm(pplan, **kw) \
            == jsm.estimate_sharded_hbm(jplan, **kw)


@pytest.mark.parametrize("num_shards,partition,halo",
                         [(2, "lat", "gather"), (2, "lat", "banded"),
                          (4, "tiles", "banded"), (4, "auto", "auto")])
def test_rank_csrs(num_shards, partition, halo):
    jplan, pplan = _plans(num_shards, partition, halo)
    jgs, pgs = graph_sets()
    jarrs = jsm.plan_device_arrays(jplan, jgs)
    one_device = {"enc": pgs.encoding, "proc": pgs.processing,
                  "dec": pgs.decoding}
    for name, bipartite in (("enc", True), ("proc", False), ("dec", True)):
        sg = getattr(pplan, name)
        halos = getattr(pplan, f"{name}_halos")
        jga = getattr(jarrs, name)
        full = one_device[name]
        # (sender node, receiver node) -> the one-device normalizer.
        fs = full.senders.numpy()[:full.num_edges]
        fr = full.receivers.numpy()[:full.num_edges]
        norm = dict(zip(zip(fs.tolist(), fr.tolist()),
                        full.gcn_norm.numpy()[:full.num_edges].tolist()))
        s_off = pgs.num_grid_nodes if name == "dec" else 0
        r_off = pgs.num_grid_nodes if name == "enc" else 0
        send_slots = (pplan.mesh_part if name != "enc"
                      else pplan.grid_part).inv_slots.reshape(-1)
        for s in range(num_shards):
            ga = psm.graph_arrays(sg, halos, s, name, bipartite, "cpu")
            g = ga.graph
            e_pad = sg.edge_mask.shape[1]
            assert ga.mode == ("gather" if halos is None else
                               ("tiled" if partition == "tiles"
                                or pplan.partition == "tiles"
                                else "banded"))
            assert ga.num_sender_rows == jga.num_sender_rows
            assert g.num_nodes == jga.num_sender_rows
            assert g.num_receivers == sg.nodes_per_shard
            rl = g.receivers.numpy()
            ip = g.indptr.numpy()
            assert (np.diff(rl) >= 0).all()
            assert ip[0] == 0 and ip[-1] == e_pad
            np.testing.assert_array_equal(
                np.repeat(np.arange(g.num_receivers), np.diff(ip)), rl)
            snd = g.senders.numpy()
            np.testing.assert_array_equal(
                g.s_perm.numpy(), np.argsort(snd, kind="stable"))
            np.testing.assert_array_equal(g.s_perm.numpy(),
                                          np.asarray(jga.s_perm[s]))
            np.testing.assert_array_equal(
                g.s_indptr.numpy(),
                np.searchsorted(snd[g.s_perm.numpy()],
                                np.arange(ga.num_sender_rows + 1)))
            np.testing.assert_array_equal(g.static_in_degree.numpy(),
                                          np.asarray(jga.static_in_degree[s]))
            live = g.edge_mask.numpy() > 0
            assert g.num_edges == int(live.sum())
            inv = sg.inv_slots.reshape(-1)
            snodes = send_slots[sg.senders_global[s][live]] + s_off
            rnodes = inv[s * sg.nodes_per_shard + rl[live]] + r_off
            expect = np.array([norm[(a, b)] for a, b in
                               zip(snodes.tolist(), rnodes.tolist())])
            np.testing.assert_allclose(g.gcn_norm.numpy()[live], expect,
                                       rtol=1e-6)
            assert not g.gcn_norm.numpy()[~live].any()


def test_unsorted_receivers_refused():
    _, pplan = _plans(2, "lat", "gather")
    sg = pplan.proc
    rl = sg.receivers_local.copy()
    live = int(sg.edge_mask[0].sum())
    rl[0, [0, live - 1]] = rl[0, [live - 1, 0]]
    bad = dataclasses.replace(sg, receivers_local=rl)
    with pytest.raises(ValueError, match="not sorted"):
        psm.graph_arrays(bad, None, 0, "proc", False, "cpu")


def test_plan_arrays_need_a_card_unless_asked_for_cpu(monkeypatch):
    _, pplan = _plans(2, "lat", "auto")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psm.graph_arrays(pplan.proc, None, 0, "proc", False)
