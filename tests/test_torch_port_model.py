"""The port's model layers against the JAX package on the CPU, with the
JAX parameters bridged by ``utils.params.from_flax_params``.

In fp32 the tolerance is atol 5e-5 / rtol 1e-4 (tests/test_torch_parity.py's):
both sides differ in summation order only.  The bf16 serve is held to the
reference's own bf16 error (``torch_port_common.bf16_close``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_lite_torch.utils.params import from_flax_params
from torch_port_common import (
    ATOL,
    HIDDEN,
    N_FEAT,
    RTOL,
    bf16_close,
    flax_numpy,
    graph_sets,
    model_pair,
    to_torch,
)
from torch_port_common import \
    one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture
def lazy_edge(monkeypatch):
    """Put the JAX package on the path the port implements (the lazy-LN
    reg-block processor), which it takes on the CPU only when asked."""
    monkeypatch.setenv("GCLT_LAZY_EDGE", "1")
    monkeypatch.delenv("GCLT_REG_EDGE", raising=False)


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def test_bridge_round_trip():
    """Every flax leaf lands in the port's state dict unchanged, the
    scanned steps unstacked per step, and no key is left over."""
    _, params, _, tmodel, _ = model_pair()
    tree = flax_numpy(params)["params"]
    sd = tmodel.state_dict()
    seen = set()

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            p = path + (k,)
            if "steps" in p:
                i = p.index("steps")
                for s in range(v.shape[0]):
                    key = ".".join(p[:i + 1] + (str(s),) + p[i + 2:])
                    np.testing.assert_array_equal(sd[key].numpy(), v[s])
                    seen.add(key)
            else:
                key = ".".join(p)
                np.testing.assert_array_equal(sd[key].numpy(), v)
                seen.add(key)

    walk(tree, ())
    assert seen == set(sd)
    # A bridged state dict is also accepted with the outer "params" level.
    assert set(from_flax_params(tree)) == set(
        from_flax_params(flax_numpy(params)))


def test_gcnconv_on_encoder_graph():
    from graphcast_lite_tpu.models.gnn import GCNConv as JaxGCN
    from graphcast_lite_torch.models.gnn import GCNConv

    jgs, tgs = graph_sets()
    x = np.random.RandomState(0).randn(jgs.num_nodes, 12).astype(np.float32)
    conv = JaxGCN(HIDDEN)
    params = conv.init(jax.random.PRNGKey(1), jnp.asarray(x), jgs.encoding)
    p = flax_numpy(params)["params"]
    p["bias"] = np.random.RandomState(1).randn(HIDDEN).astype(np.float32)
    expect = conv.apply({"params": p}, jnp.asarray(x), jgs.encoding)

    tconv = GCNConv(12, HIDDEN)
    tconv.load_state_dict({"kernel": to_torch(p["kernel"]),
                           "bias": to_torch(p["bias"])})
    with torch.no_grad():
        out = tconv(to_torch(x), tgs.encoding)
    _close(out, expect)


def test_lazy_reg_block_processor(lazy_edge):
    from graphcast_lite_tpu.models.gnn import (
        InteractionNetProcessor as JaxProc,
    )
    from graphcast_lite_torch.models.gnn import InteractionNetProcessor

    jgs, tgs = graph_sets()
    m = jgs.num_mesh_nodes
    kw = dict(node_dim=HIDDEN, raw_edge_dim=4, edge_latent_dim=HIDDEN,
              hidden_dim=HIDDEN, num_steps=3, activation="swish",
              use_layer_norm=True)
    x = np.random.RandomState(2).randn(m, HIDDEN).astype(np.float32)
    jproc = JaxProc(**kw)
    params = jproc.init(jax.random.PRNGKey(2), jnp.asarray(x), jgs.processing)
    # Non-trivial LayerNorm affines, so the lazy fold is exercised.
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.1 * jax.random.normal(
            jax.random.PRNGKey(len(str(path))), v.shape)
        if "norm" in jax.tree_util.keystr(path) else v,
        params,
    )
    expect = jproc.apply(params, jnp.asarray(x), jgs.processing)

    tproc = InteractionNetProcessor(**kw)
    tproc.load_state_dict(from_flax_params(flax_numpy(params)))
    with torch.no_grad():
        out = tproc(to_torch(x), tgs.processing)
    _close(out, expect)


def test_weather_model_forward(lazy_edge):
    jmodel, params, jgraphs, tmodel, tgraphs = model_pair()
    g = tgraphs.num_grid_nodes
    x = np.random.RandomState(3).randn(g, 2 * N_FEAT).astype(np.float32)
    expect, _ = jmodel.apply(params, jnp.asarray(x), jgraphs)
    with torch.no_grad():
        out, mask = tmodel(to_torch(x), tgraphs)
    assert mask is None and out.shape == (g, N_FEAT)
    _close(out, expect)


def test_rollout_predict_ar4(lazy_edge):
    """AR-4 rollout with residuals, a static and a forcing channel."""
    from graphcast_lite_tpu.training.rollout import RolloutSpec as JSpec
    from graphcast_lite_tpu.training.rollout import rollout_predict as jroll
    from graphcast_lite_torch.training.rollout import (
        RolloutSpec,
        rollout_predict,
    )

    jmodel, params, jgraphs, tmodel, tgraphs = model_pair()
    g = tgraphs.num_grid_nodes
    rng = np.random.RandomState(4)
    window = rng.randn(g, 2, N_FEAT).astype(np.float32)
    forcing = rng.randn(g, 4, N_FEAT).astype(np.float32)
    kw = dict(obs_window=2, num_features=N_FEAT, use_residual=True,
              remat=False, static_channels=(1,), forcing_channels=(3,))

    def jfn(inp, m, t, p):
        return jmodel.apply(params, inp, jgraphs)[0], None

    def tfn(inp, m, t, p):
        return tmodel(inp, tgraphs)[0], None

    expect = jroll(jfn, jnp.asarray(window), 4, JSpec(**kw),
                   forcing=jnp.asarray(forcing))
    with torch.no_grad():
        out = rollout_predict(tfn, to_torch(window), 4, RolloutSpec(**kw),
                              forcing=to_torch(forcing))
    assert out.shape == (g, 4, N_FEAT)
    _close(out, expect)
    # Carry-forward: the static channel never moves, forcing is the input.
    np.testing.assert_array_equal(out[:, :, 1].numpy(),
                                  np.repeat(window[:, -1:, 1], 4, axis=1))
    np.testing.assert_array_equal(out[:, :, 3].numpy(), forcing[:, :, 3])


def _jax_bf16(params, graphs):
    """Params and float graph arrays cast to bf16 as ``bench.py`` does."""
    def cast(a):
        if hasattr(a, "dtype") and a.dtype == jnp.float32:
            return a.astype(jnp.bfloat16)
        return a

    return jax.tree.map(cast, params), jax.tree.map(cast, graphs)


def test_weather_model_forward_bf16(lazy_edge):
    """One forward of the bf16 serve: params and graph arrays cast by the
    port's ``serving_copy`` (what ``evaluate_model`` runs) and by
    ``bench.py``'s cast on the JAX side."""
    from graphcast_lite_torch.inference.predict import serving_copy

    jmodel, params, jgraphs, tmodel, tgraphs = model_pair()
    g = tgraphs.num_grid_nodes
    x = np.random.RandomState(3).randn(g, 2 * N_FEAT).astype(np.float32)
    expect32, _ = jmodel.apply(params, jnp.asarray(x), jgraphs)
    p16, g16 = _jax_bf16(params, jgraphs)
    expect16, _ = jmodel.apply(p16, jnp.asarray(x, jnp.bfloat16), g16)
    m16, tg16 = serving_copy(tmodel, tgraphs, torch.device("cpu"),
                             torch.bfloat16)
    with torch.no_grad():
        out, _ = m16(to_torch(x).to(torch.bfloat16), tg16)
    assert out.dtype == torch.bfloat16 and out.shape == (g, N_FEAT)
    bf16_close(out.float(), expect16.astype(jnp.float32), expect32)


def test_rollout_predict_ar4_bf16(lazy_edge):
    """AR-4 bf16 rollout, each step held as in the forward test."""
    from graphcast_lite_tpu.training.rollout import RolloutSpec as JSpec
    from graphcast_lite_tpu.training.rollout import rollout_predict as jroll
    from graphcast_lite_torch.inference.predict import serving_copy
    from graphcast_lite_torch.training.rollout import (
        RolloutSpec,
        rollout_predict,
    )

    jmodel, params, jgraphs, tmodel, tgraphs = model_pair()
    g = tgraphs.num_grid_nodes
    rng = np.random.RandomState(4)
    window = rng.randn(g, 2, N_FEAT).astype(np.float32)
    forcing = rng.randn(g, 4, N_FEAT).astype(np.float32)
    kw = dict(obs_window=2, num_features=N_FEAT, use_residual=True,
              remat=False, static_channels=(1,), forcing_channels=(3,))

    def jax_rollout(p, gr, dtype):
        def fn(inp, m, t, pr):
            return jmodel.apply(p, inp, gr)[0], None

        out = jroll(fn, jnp.asarray(window, dtype), 4, JSpec(**kw),
                    forcing=jnp.asarray(forcing, dtype))
        return np.asarray(out.astype(jnp.float32))

    expect32 = jax_rollout(params, jgraphs, jnp.float32)
    expect16 = jax_rollout(*_jax_bf16(params, jgraphs), jnp.bfloat16)
    m16, tg16 = serving_copy(tmodel, tgraphs, torch.device("cpu"),
                             torch.bfloat16)

    def tfn(inp, m, t, p):
        return m16(inp, tg16)[0], None

    with torch.no_grad():
        out = rollout_predict(tfn, to_torch(window).to(torch.bfloat16), 4,
                              RolloutSpec(**kw),
                              forcing=to_torch(forcing).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and out.shape == (g, 4, N_FEAT)
    out = out.float().numpy()
    for s in range(4):
        bf16_close(out[:, s], expect16[:, s], expect32[:, s])


def test_unported_paths_raise(tmp_path):
    """Every layer family builds and runs now (GAT, SparseGAT, SimpleConv,
    the PReLU InteractionNet, the processor under a runtime mask), and
    nothing is left unported: sharded training (A12) runs through
    ``Trainer(mesh=, graph_set=)``, which raises the JAX package's errors
    for ``mesh=`` without ``graph_set=`` and for an ``extra_loss_fn`` on the
    mesh.  A grid / U-Net config loads as a ``GridExperimentConfig``
    (A10's CNN half)."""
    import json

    from graphcast_lite_torch.config import GATProps, GraphBlock, \
        GraphLayerType, GridExperimentConfig, load_experiment_config
    from graphcast_lite_torch.models.gnn import InteractionNetProcessor
    from graphcast_lite_torch.models.weather import GraphLayerModule
    from graphcast_lite_torch.training.trainer import Trainer

    _, tgs = graph_sets()
    pg = tgs.processing
    x = torch.randn(tgs.num_mesh_nodes, 8)
    mask = torch.ones(pg.padded_num_edges)
    gat = GraphBlock(layer_type=GraphLayerType.GATConv, output_dim=8,
                     gat_props=GATProps(num_heads=2, sparsity_thresholds=[]))
    for block in (gat, GraphBlock(layer_type=GraphLayerType.SimpleConv),
                  GraphBlock(layer_type=GraphLayerType.SparseGATConv,
                             output_dim=8, gat_props=GATProps(
                                 num_heads=1, sparsity_thresholds=[0.1]))):
        out, _ = GraphLayerModule(block, 8)(x, pg, mask, 0.1, True)
        assert out.shape == (tgs.num_mesh_nodes, 8)
    out = InteractionNetProcessor(8, 4, 8, 8, 2, activation="prelu")(x, pg)
    assert torch.isfinite(out).all()
    assert torch.isfinite(InteractionNetProcessor(8, 4, 8, 8, 1)(
        x, pg, edge_mask=mask)).all()

    path = tmp_path / "config.json"
    with open(path, "w") as f:
        json.dump({"num_features": 5, "base_filters": 16}, f)
    grid = load_experiment_config(str(path))
    assert isinstance(grid, GridExperimentConfig)
    assert (grid.num_features, grid.base_filters) == (5, 16)
    with pytest.raises(ValueError, match="mesh= requires graph_set="):
        Trainer(None, None, None, None, str(tmp_path), mesh=object())
    with pytest.raises(NotImplementedError, match="extra_loss_fn"):
        Trainer(None, None, None, None, str(tmp_path), mesh=object(),
                graph_set=object(), extra_loss_fn=lambda o, t: 0.0)
