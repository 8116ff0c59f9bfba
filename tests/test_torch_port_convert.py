"""The port's reference-checkpoint converter (``utils.torch_convert``)
against the JAX package's, on the CPU.

(a) For every family the JAX converter handles — the InteractionNet with
    and without its edge/node norms, ConvGCN (a trailing LayerNorm and a
    three-conv stack whose shared PReLU sits at ``layers.1`` and
    ``layers.3``), GATConv at 2 heads and SparseGAT (both with their
    LayerNorm), the product graph and a SimpleConv processor — at hidden
    16 on the 64x32 grid, mesh [1, 2]: a reference-layout state dict is
    synthesized from the JAX parameter tree (``_reference_sd``, which for
    the flagship family equals ``tests/test_convert.py``'s
    ``_invert_to_torch_layout``), and the port's
    ``convert_reference_checkpoint(sd, cfg)`` equals
    ``from_flax_params(jax convert_reference_checkpoint(sd, cfg))``
    bitwise, key for key, and loads with ``strict=True``.
(b) ``tests/torch_reference.WeatherPredictionRef`` (the reference's layer
    math in plain torch) converted by the port: the port's AR-4 rollout on
    the CPU matches the reference model's within
    ``tests/test_torch_parity.py``'s tolerance, at its sizes (33 features,
    hidden 64, 3 steps, the 64x32 graphs at mesh [3, 5]).
(c) ``load_torch_state_dict`` reads a ``.pth`` with and without the
    ``model_state_dict`` wrapper, and an ``.npz``.
(d) A reference key that maps to nothing, a model key left unfilled and a
    shape that differs raise with their names.
"""

import json

import jax
import numpy as np
import pytest
import torch

from graphcast_lite_tpu import presets as jpresets
from graphcast_lite_tpu.config import GraphBlock as JBlock
from graphcast_lite_tpu.config import GraphLayerType as JType
from graphcast_lite_tpu.config import ModelConfig as JModelConfig
from graphcast_lite_tpu.models.weather import ModelGraphs as JGraphs
from graphcast_lite_tpu.models.weather import WeatherModel as JModel
from graphcast_lite_tpu.utils.torch_convert import \
    convert_reference_checkpoint as jax_convert
from graphcast_lite_torch.config import ExperimentConfig, from_dict
from graphcast_lite_torch.models.weather import WeatherModel as PModel
from graphcast_lite_torch.utils.params import from_flax_params
from graphcast_lite_torch.utils.torch_convert import (
    convert_reference_checkpoint,
    load_torch_state_dict,
)
from test_convert import _invert_to_torch_layout
from torch_port_common import LEVELS, graph_sets, \
    one_torch_thread  # noqa: F401 (an autouse fixture)

N_FEAT, HID = 5, 16


def _no_norms(cfg):
    cfg.pipeline.processor.gcn.use_layer_norm = False


def _gcn_norm(cfg):
    cfg.pipeline.encoder.gcn.use_layer_norm = True


def _processor_norm(cfg):
    cfg.pipeline.processor.gcn.use_layer_norm = True


def _simple_conv(cfg):
    cfg.pipeline.processor = JModelConfig(
        gcn=JBlock(layer_type=JType.SimpleConv, output_dim=HID))


FAMILIES = {
    "interaction_net": ("interaction_net_64x32", {"mp_steps": 2}, None),
    "interaction_net_no_norms": ("interaction_net_64x32", {"mp_steps": 2},
                                 _no_norms),
    "conv_gcn": ("baseline_gcn_64x32", {}, _gcn_norm),
    "gat": ("gat_64x32", {"heads": 2}, _processor_norm),
    "sparse_gat": ("sparse_gat_64x32", {}, _processor_norm),
    "product_graph": ("product_graph_64x32", {"obs": 2}, None),
    "simple_conv": ("baseline_gcn_64x32", {}, _simple_conv),
}


def _port_cfg(jcfg):
    return from_dict(ExperimentConfig, json.loads(jcfg.model_dump_json()))


def _jax_tree(name, seed=0):
    """(jax cfg, port cfg, the JAX model's parameter tree as numpy arrays
    from a seed: names and shapes from an abstract init)."""
    fn, kw, edit = FAMILIES[name]
    jcfg = getattr(jpresets, fn)(n_feat=N_FEAT, hidden=HID, **kw)
    jcfg.graph.mesh_levels = list(LEVELS)
    if edit is not None:
        edit(jcfg)
    obs = jcfg.data.obs_window_used
    jgs, _ = graph_sets()
    jgraphs = JGraphs.from_graph_set(jgs, jcfg.pipeline.product_graph, obs)
    jmodel = JModel(pipeline=jcfg.pipeline, data=jcfg.data,
                    num_grid_nodes=jgs.num_grid_nodes,
                    num_mesh_nodes=jgs.num_mesh_nodes)
    dummy = np.zeros((jgs.num_grid_nodes, obs * N_FEAT), np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), dummy,
                            jgraphs)
    rng = np.random.RandomState(seed)
    tree = jax.tree.map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    return jcfg, _port_cfg(jcfg), tree


def _reference_sd(params, pipeline):
    """The reference state dict that converts into ``params`` (torch
    layouts, every family; the shared activation at each of its
    positions, as ``state_dict()`` lists a module held twice)."""
    sd = {}

    def lin(prefix, tree):
        sd[f"{prefix}.weight"] = tree["kernel"].T
        if "bias" in tree:
            sd[f"{prefix}.bias"] = tree["bias"]

    def ln(prefix, tree):
        sd[f"{prefix}.weight"] = tree["weight"]
        sd[f"{prefix}.bias"] = tree["bias"]

    def block(prefix, tree, cfg):
        if cfg.mlp is not None:
            hidden = list(cfg.mlp.mlp_hidden_dims or [])
            mlp, idx = tree["mlp"], 0
            for i in range(len(hidden)):
                lin(f"{prefix}.mlp.MLP.{idx}", mlp[f"lin_{i}"])
                sd[f"{prefix}.mlp.MLP.{idx + 1}.weight"] = \
                    mlp[f"prelu_{i}"]["alpha"]
                idx += 2
            lin(f"{prefix}.mlp.MLP.{idx}", mlp[f"lin_{len(hidden)}"])
            if cfg.mlp.use_layer_norm:
                ln(f"{prefix}.mlp.MLP.{idx + 1}", mlp["norm"])
        gl, lt = tree["graph_layer"], cfg.gcn.layer_type
        if lt in (JType.ConvGCN, JType.GATConv):
            n = len(cfg.gcn.hidden_dims or []) + 1
            for i in range(n):
                conv, p = gl[f"conv_{i}"], f"{prefix}.layers.{2 * i}"
                if lt == JType.ConvGCN:
                    sd[f"{p}.lin.weight"] = conv["kernel"].T
                    sd[f"{p}.bias"] = conv["bias"]
                else:
                    sd[f"{p}.lin.weight"] = conv["core"]["kernel"].T
                    for k in ("att_src", "att_dst", "bias"):
                        sd[f"{p}.{k}"] = conv["core"][k]
                if i < n - 1 and "act" in gl:
                    sd[f"{prefix}.layers.{2 * i + 1}.weight"] = \
                        gl["act"]["alpha"]
            if cfg.gcn.use_layer_norm:
                ln(f"{prefix}.layers.{2 * n}", gl["norm"])
        elif lt == JType.SparseGATConv:
            core = gl["conv_0"]["core"]
            sd[f"{prefix}.layers.0.lin_src.weight"] = core["kernel"].T
            for k in ("att_src", "att_dst", "bias"):
                sd[f"{prefix}.layers.0.{k}"] = core[k]
            if cfg.gcn.use_layer_norm:
                ln(f"{prefix}.layers.1", gl["norm"])
        elif lt == JType.InteractionNet:
            inet, p = gl["inet"], f"{prefix}.layers"
            lin(f"{p}.edge_encoder.0", inet["edge_encoder_lin"])
            stacked = inet["steps"]["layer"]
            for i in range(cfg.gcn.num_message_passing_steps or 4):
                step = jax.tree.map(lambda a: a[i], stacked)
                for mlp in ("edge_mlp", "node_mlp"):
                    lin(f"{p}.steps.{i}.{mlp}.0", step[mlp]["lin_0"])
                    lin(f"{p}.steps.{i}.{mlp}.2", step[mlp]["lin_1"])
                for norm in ("edge_norm", "node_norm"):
                    if norm in step:
                        ln(f"{p}.steps.{i}.{norm}", step[norm])

    p = params["params"]
    if pipeline.product_graph is not None:
        block("product_graph_model", p["product_model"],
              pipeline.product_graph.model)
    for name in ("encoder", "processor", "decoder"):
        # A block without parameters (SimpleConv) has no subtree.
        block(name, p.get(name, {"graph_layer": {}}), getattr(pipeline, name))
    return {k: np.asarray(v) for k, v in sd.items()}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_converter_equals_jax_converter_bridged(name):
    jcfg, pcfg, tree = _jax_tree(name)
    sd = _reference_sd(tree, jcfg.pipeline)
    if name == "interaction_net":
        ref = _invert_to_torch_layout(tree, jcfg.pipeline)
        assert set(ref) == set(sd)
        for k in sd:
            np.testing.assert_array_equal(ref[k], sd[k], err_msg=k)

    got = convert_reference_checkpoint(sd, pcfg)
    expect = from_flax_params(jax_convert(sd, jcfg))
    assert list(got) == list(PModel(pcfg.pipeline, pcfg.data, 1,
                                    1).state_dict())
    assert set(got) == set(expect)
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.is_contiguous(), k
        assert v.shape == expect[k].shape, k
        assert torch.equal(v, expect[k]), k
    # And the JAX tree itself comes back, leaf for leaf.
    assert set(from_flax_params(tree)) == set(got)
    for k, v in from_flax_params(tree).items():
        assert torch.equal(got[k], v), k

    jgs, _ = graph_sets()
    model = PModel(pcfg.pipeline, pcfg.data, jgs.num_grid_nodes,
                   jgs.num_mesh_nodes)
    model.load_state_dict(got, strict=True)


def _unpadded(graph):
    e = graph.num_edges
    return (graph.senders[:e].numpy().astype(np.int64),
            graph.receivers[:e].numpy().astype(np.int64))


def test_reference_model_rollout_through_the_port():
    """``tests/test_torch_parity.py``'s 4-step AR parity with the port in
    the JAX package's place."""
    from graphcast_lite_torch import presets as ppresets
    from graphcast_lite_torch.graphs.build import build_graph_set
    from graphcast_lite_torch.models.weather import ModelGraphs
    from graphcast_lite_torch.training.rollout import RolloutSpec, \
        rollout_predict
    from test_torch_parity import AR, HIDDEN, MP, N_FEAT as FEAT, OBS
    from torch_reference import WeatherPredictionRef, \
        reference_state_dict_keys_remap

    torch.manual_seed(0)
    cfg = ppresets.interaction_net_64x32(n_feat=FEAT, obs=OBS, pred=AR,
                                         hidden=HIDDEN, mp_steps=MP)
    lat, lon = ppresets.wb2_64x32_grid()
    gs = build_graph_set(lat, lon, cfg.graph.mesh_levels,
                         cfg.graph.grid2mesh_radius_query)
    es, er = _unpadded(gs.encoding)
    ps, pr = _unpadded(gs.processing)
    ds, dr = _unpadded(gs.decoding)
    p_attr = gs.processing.edge_attr[:gs.processing.num_edges]
    ref = WeatherPredictionRef(
        n_grid=gs.num_grid_nodes, n_mesh=gs.num_mesh_nodes, obs=OBS,
        n_feat=FEAT, hidden=HIDDEN, mp_steps=MP,
        enc_edges=torch.tensor(np.stack([es, er])),
        proc_edges=torch.tensor(np.stack([ps, pr])),
        dec_edges=torch.tensor(np.stack([ds, dr])),
        grid_static=torch.tensor(gs.grid_static),
        mesh_static=torch.tensor(gs.mesh_static),
        proc_edge_attr=p_attr.clone(),
    )
    ref.eval()
    window = np.random.RandomState(0).randn(
        gs.num_grid_nodes, OBS, FEAT).astype(np.float32)
    with torch.no_grad():
        ref_preds = ref.rollout(torch.tensor(window), AR).numpy()

    model = PModel(cfg.pipeline, cfg.data, gs.num_grid_nodes,
                   gs.num_mesh_nodes)
    model.load_state_dict(convert_reference_checkpoint(
        reference_state_dict_keys_remap(ref), cfg), strict=True)
    model.eval()
    graphs = ModelGraphs.from_graph_set(gs)
    spec = RolloutSpec(obs_window=OBS, num_features=FEAT, use_residual=True,
                       remat=False)
    with torch.no_grad():
        preds = rollout_predict(lambda inp, m, t, p: (model(inp, graphs)[0],
                                                      None),
                                torch.from_numpy(window), AR, spec).numpy()
    assert preds.shape == ref_preds.shape and np.isfinite(preds).all()
    err = np.abs(preds - ref_preds)
    print(f"port vs reference, 4-step AR: max|d| {err.max():.3e} (mean|ref| "
          f"{np.abs(ref_preds).mean():.3f})")
    assert err.max() < 2e-3, (
        f"4-step AR parity failed: max|d|={err.max():.3e}; per-step max "
        f"{[float(err[:, s].max()) for s in range(AR)]}")


def test_load_torch_state_dict_formats(tmp_path):
    jcfg, _, tree = _jax_tree("gat")
    sd = _reference_sd(tree, jcfg.pipeline)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in sd.items()}
    paths = {"bare.pth": tensors, "wrapped.pth": {
        "model_state_dict": tensors, "epoch": 3}}
    for name, blob in paths.items():
        torch.save(blob, tmp_path / name)
    np.savez(tmp_path / "export.npz", **sd)
    for name in ("bare.pth", "wrapped.pth", "export.npz"):
        got = load_torch_state_dict(str(tmp_path / name))
        assert set(got) == set(sd), name
        for k, v in sd.items():
            assert isinstance(got[k], np.ndarray)
            np.testing.assert_array_equal(got[k], v, err_msg=f"{name} {k}")


def test_unmapped_and_unfilled_keys_raise():
    jcfg, pcfg, tree = _jax_tree("interaction_net")
    sd = _reference_sd(tree, jcfg.pipeline)

    extra = dict(sd, **{"processor.layers.edge_encoder.1.weight":
                        np.ones(1, np.float32)})
    with pytest.raises(KeyError, match=r"edge_encoder\.1\.weight"):
        convert_reference_checkpoint(extra, pcfg)

    missing = {k: v for k, v in sd.items()
               if k != "decoder.layers.0.bias"}
    with pytest.raises(KeyError, match=r"decoder\.layers\.0\.bias"):
        convert_reference_checkpoint(missing, pcfg)

    # A bias the reference may omit (the optional Linear bias) leaves the
    # model's bias unfilled.
    no_bias = {k: v for k, v in sd.items()
               if k != "processor.layers.steps.1.node_mlp.2.bias"}
    with pytest.raises(KeyError, match=r"steps\.1\.node_mlp\.lin_1\.bias"):
        convert_reference_checkpoint(no_bias, pcfg)

    # A PReLU edge encoder: the model's edge_encoder_act is left unfilled.
    pcfg.pipeline.processor.gcn.activation = "prelu"
    with pytest.raises(KeyError, match="edge_encoder_act"):
        convert_reference_checkpoint(sd, pcfg)

    wrong = dict(sd, **{"encoder.layers.0.lin.weight":
                        sd["encoder.layers.0.lin.weight"][:, :-1]})
    _, pcfg, _ = _jax_tree("interaction_net")
    with pytest.raises(ValueError, match=r"encoder\.graph_layer\.conv_0"):
        convert_reference_checkpoint(wrong, pcfg)
