"""The train step on the COO processor routes, against the JAX package on
the CPU.

The fused edge-step and edge-MLP kernels are forward only.  Under
``GCLT_REG_EDGE=0`` with ``GCLT_EDGE_STEP=1`` or ``GCLT_MEGA_EDGE=1`` a
train step takes the composed route in both packages (their training flag,
``ops.fused_edge.training_trace``), and the port's loss and gradients
match ``jax.value_and_grad`` at the fp32 tolerances of
``test_torch_port_train.py``, on the small model (hidden 32).

The fused kernels take only widths that are multiples of 128, so at hidden
32 neither switch would pick them in the first place.  At hidden 128,
where the edge-step switch does pick its kernel when serving, the train
step is held to the port's own composed-route step without the switch:
there the JAX package is no fp32 oracle at 1e-4, since the fp32 rounding
of either package alone moves the encoder's first-layer gradients by
about 1.2e-4 of their largest value (the port in float64 agrees with the
JAX package in float64 to 3e-7).
"""

import numpy as np
import pytest
import torch

from torch_port_common import (
    LAT,
    LEVELS,
    LON,
    LOSS_RTOL,
    PortGraphs,
    PortModel,
    assert_grads_close,
    batch,
    graph_sets,
    jax_build,
    jax_step,
    model_pair,
    port_step,
    small_configs,
)
from torch_port_common import \
    one_torch_thread  # noqa: F401 (an autouse fixture)

SWITCHES = {
    "edge_step": {"GCLT_EDGE_STEP": "1"},
    "mega": {"GCLT_MEGA_EDGE": "1", "GCLT_PALLAS_SEGMENT": "1"},
}


@pytest.fixture
def jax_fused_calls(monkeypatch):
    """Counts the JAX package's calls of its two fused Pallas kernels."""
    from graphcast_lite_tpu.ops import pallas_edge_mlp, pallas_edge_step

    calls = {"edge_step": 0, "mega": 0}

    def counting(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(pallas_edge_step, "edge_step_fused",
                        counting("edge_step", pallas_edge_step.edge_step_fused))
    monkeypatch.setattr(pallas_edge_mlp, "edge_mlp_segment",
                        counting("mega", pallas_edge_mlp.edge_mlp_segment))
    return calls


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_train_step_takes_the_composed_route(switch, monkeypatch,
                                             jax_fused_calls):
    from graphcast_lite_tpu.models.weather import ModelGraphs

    for name in ("GCLT_EDGE_STEP", "GCLT_MEGA_EDGE", "GCLT_PALLAS_SEGMENT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("GCLT_LAZY_EDGE", "1")
    monkeypatch.setenv("GCLT_REG_EDGE", "0")
    for name, value in SWITCHES[switch].items():
        monkeypatch.setenv(name, value)
    # The JAX package reads GCLT_EDGE_STEP also when it builds a graph.
    jgs = jax_build(LAT, LON, LEVELS, 0.6)
    jmodel, params, jgraphs, tmodel, tgraphs = model_pair(jax_graph_set=jgs)
    assert isinstance(jgraphs, ModelGraphs)
    for key in jax_fused_calls:   # the JAX init is a forward outside training
        jax_fused_calls[key] = 0
    steps = tmodel.processor.graph_layer.inet.steps
    x, y, lw, cm = batch(tgraphs.num_grid_nodes)
    jloss, jgrads = jax_step(jmodel, params, jgraphs, x, y, lw, cm)
    loss, grads, _, _ = port_step(tmodel, tgraphs, x, y, lw, cm)
    assert {s.route for s in steps} == {"composed"}
    assert jax_fused_calls == {"edge_step": 0, "mega": 0}
    assert np.isfinite(loss)
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss)
    assert_grads_close(grads, jgrads)


def test_edge_step_switch_trains_on_the_composed_route(monkeypatch):
    """Hidden 128: serving, ``GCLT_EDGE_STEP=1`` takes the fused kernel; a
    train step under it takes the composed route and gives the loss and
    gradients of the same step without the switch."""
    monkeypatch.setenv("GCLT_REG_EDGE", "0")
    for name in ("GCLT_EDGE_STEP", "GCLT_MEGA_EDGE"):
        monkeypatch.delenv(name, raising=False)
    _, tcfg = small_configs(hidden=128)
    _, tgs = graph_sets()
    graphs = PortGraphs.from_graph_set(tgs)
    x, y, lw, cm = batch(tgs.num_grid_nodes)
    runs = []
    for flag in (None, "1"):
        if flag:
            monkeypatch.setenv("GCLT_EDGE_STEP", flag)
        model = PortModel(tcfg.pipeline, tcfg.data, tgs.num_grid_nodes,
                          tgs.num_mesh_nodes,
                          generator=torch.Generator().manual_seed(3))
        steps = model.processor.graph_layer.inet.steps
        with torch.no_grad():
            model(torch.from_numpy(x[0]), graphs)
        assert {s.route for s in steps} == {"edge_step" if flag
                                            else "composed"}
        runs.append(port_step(model, graphs, x, y, lw, cm, hidden=128))
        assert {s.route for s in steps} == {"composed"}
    (loss0, grads0, _, after0), (loss1, grads1, _, after1) = runs
    assert loss0 == loss1
    for name, g in grads0.items():
        assert torch.equal(g, grads1[name]), name
        assert torch.equal(after0[name], after1[name]), name


def test_fused_routes_are_off_in_training(monkeypatch):
    """On a graph that both fused routes take when serving, neither is taken
    inside ``training_trace()``."""
    from graphcast_lite_torch.graphs.structure import build_graph
    from graphcast_lite_torch.models.gnn import _use_edge_step_path, \
        _use_mega_edge_path
    from graphcast_lite_torch.ops.fused_edge import in_training, \
        training_trace

    rng = np.random.RandomState(7)
    n, e = 700, 20000
    graph = build_graph(rng.randint(0, n, e), rng.randint(0, n, e),
                        num_nodes=n)
    monkeypatch.setenv("GCLT_EDGE_STEP", "1")
    monkeypatch.setenv("GCLT_MEGA_EDGE", "1")
    args = (graph, 128, 128, "swish")
    assert _use_edge_step_path(*args) and _use_mega_edge_path(*args)
    assert not in_training()
    with training_trace():
        assert in_training()
        assert not _use_edge_step_path(*args)
        assert not _use_mega_edge_path(*args)
    assert not in_training()
    assert _use_edge_step_path(*args) and _use_mega_edge_path(*args)
