"""Convert reference PyTorch checkpoints into this package's state dict.

The reference trains ``WeatherPrediction`` (torch/PyG) and saves
``best_model.pth`` / ``checkpoint.pth`` state dicts (reference
src/train.py:22-49,496).  ``convert_reference_checkpoint(state_dict,
cfg)`` maps those tensors straight onto the state dict of
``models.weather.WeatherModel`` built from ``cfg``: the names that
``model.state_dict()`` has, as float32 torch tensors.  It gives, key for
key, what ``utils.params.from_flax_params`` gives for the tree that the
JAX package's converter (``graphcast_lite_tpu.utils.torch_convert``)
builds from the same state dict.

Layout differences handled here:
  * torch ``Linear`` stores weight [out, in]; this package's linear layers
    keep the flax layout, kernel [in, out], so every weight is transposed;
  * PyG ``GATConv`` stores ``lin`` (or ``lin_src``) [H*C, in] and
    ``att_src`` / ``att_dst`` [1, H, C], which map to ``conv_i.core.*``;
  * the reference's ``GraphLayer`` interleaves its convolutions with ONE
    shared activation module at ``layers.1, 3, …`` (every copy in the
    state dict is the same tensor) and puts its ``LayerNorm`` last;
  * the InteractionNet processor's unshared steps are ``steps.{i}`` in
    both packages, with ``edge_mlp`` / ``node_mlp`` as
    ``Sequential(Linear, act, Linear)`` → ``lin_0`` / ``lin_1``, and
    ``edge_norm`` / ``node_norm`` only where the reference has them;
  * PReLU single-slope tensors and LayerNorm weight/bias map 1:1.

The mapping is checked both ways against the model ``cfg`` builds: a
reference key that maps to nothing, a model key left unfilled and a shape
that differs each raise with their names.

Loading uses ``torch.load(map_location='cpu', weights_only=True)`` and
also reads a NumPy ``.npz`` export of the same state dict.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping, Set

import numpy as np
import torch

from ..config import ExperimentConfig, GraphLayerType, MLPBlock, ModelConfig

__all__ = ["load_torch_state_dict", "convert_reference_checkpoint"]


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a torch .pth/.pt state dict (or an .npz export) -> numpy dict."""
    if path.endswith(".npz"):
        return dict(np.load(path))
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        blob = blob["model_state_dict"]
    return {k: v.detach().numpy() for k, v in blob.items()
            if hasattr(v, "detach")}


class _Reader:
    """Reads reference tensors into port names, recording what it used."""

    def __init__(self, sd: Mapping[str, np.ndarray]):
        self.sd = sd
        self.used: Set[str] = set()
        self.out: Dict[str, torch.Tensor] = OrderedDict()

    def has(self, key: str) -> bool:
        return key in self.sd

    def get(self, key: str) -> np.ndarray:
        if key not in self.sd:
            raise KeyError(f"the reference state dict has no {key}")
        self.used.add(key)
        return np.asarray(self.sd[key]).astype(np.float32)

    def put(self, name: str, arr: np.ndarray) -> None:
        self.out[name] = torch.from_numpy(np.ascontiguousarray(arr))

    def lin(self, name: str, prefix: str) -> None:
        self.put(f"{name}.kernel", self.get(f"{prefix}.weight").T)
        if self.has(f"{prefix}.bias"):
            self.put(f"{name}.bias", self.get(f"{prefix}.bias"))

    def prelu(self, name: str, key: str) -> None:
        self.put(f"{name}.alpha", self.get(key).reshape(1))

    def ln(self, name: str, prefix: str) -> None:
        self.put(f"{name}.weight", self.get(f"{prefix}.weight"))
        self.put(f"{name}.bias", self.get(f"{prefix}.bias"))


def _mlp_tower(r: _Reader, name: str, prefix: str, mlp_cfg: MLPBlock):
    """Reference MLP is an nn.ModuleList: Linear, PReLU, Linear, PReLU, ...,
    Linear[, LayerNorm] under ``{prefix}.MLP.{i}``."""
    hidden = list(mlp_cfg.mlp_hidden_dims or [])
    idx = 0
    for i in range(len(hidden)):
        r.lin(f"{name}.lin_{i}", f"{prefix}.MLP.{idx}")
        r.prelu(f"{name}.prelu_{i}", f"{prefix}.MLP.{idx + 1}.weight")
        idx += 2
    r.lin(f"{name}.lin_{len(hidden)}", f"{prefix}.MLP.{idx}")
    if mlp_cfg.use_layer_norm:
        r.ln(f"{name}.norm", f"{prefix}.MLP.{idx + 1}")


def _gcn_conv(r: _Reader, name: str, prefix: str):
    r.put(f"{name}.kernel", r.get(f"{prefix}.lin.weight").T)
    r.put(f"{name}.bias", r.get(f"{prefix}.bias"))


def _gat_core(r: _Reader, name: str, prefix: str):
    lin = (f"{prefix}.lin.weight" if r.has(f"{prefix}.lin.weight")
           else f"{prefix}.lin_src.weight")
    r.put(f"{name}.core.kernel", r.get(lin).T)
    for att in ("att_src", "att_dst"):
        r.put(f"{name}.core.{att}", r.get(f"{prefix}.{att}"))
    if r.has(f"{prefix}.bias"):
        r.put(f"{name}.core.bias", r.get(f"{prefix}.bias"))


def _two_layer_mlp(r: _Reader, name: str, prefix: str):
    """Reference nn.Sequential(Linear, act, Linear) -> lin_0/lin_1."""
    r.lin(f"{name}.lin_0", f"{prefix}.0")
    r.lin(f"{name}.lin_1", f"{prefix}.2")


def _interaction_processor(r: _Reader, name: str, prefix: str,
                           num_steps: int):
    r.lin(f"{name}.edge_encoder_lin", f"{prefix}.edge_encoder.0")
    for i in range(num_steps):
        sp, sn = f"{prefix}.steps.{i}", f"{name}.steps.{i}"
        _two_layer_mlp(r, f"{sn}.edge_mlp", f"{sp}.edge_mlp")
        _two_layer_mlp(r, f"{sn}.node_mlp", f"{sp}.node_mlp")
        if r.has(f"{sp}.edge_norm.weight"):
            r.ln(f"{sn}.edge_norm", f"{sp}.edge_norm")
            r.ln(f"{sn}.node_norm", f"{sp}.node_norm")


def _graph_layer(r: _Reader, name: str, prefix: str, cfg: ModelConfig):
    lt = cfg.gcn.layer_type
    if lt == GraphLayerType.SimpleConv:
        return
    if lt in (GraphLayerType.ConvGCN, GraphLayerType.GATConv):
        n_layers = len(cfg.gcn.hidden_dims or []) + 1
        # Convs at layers.{0, 2, 4, ...}; the one shared activation at
        # layers.{1, 3, ...} (the same tensor at each); a trailing
        # LayerNorm.
        for i in range(n_layers):
            conv = _gcn_conv if lt == GraphLayerType.ConvGCN else _gat_core
            conv(r, f"{name}.conv_{i}", f"{prefix}.layers.{2 * i}")
        act_key = f"{prefix}.layers.1.weight"
        if r.has(act_key):
            r.prelu(f"{name}.act", act_key)
            for i in range(1, n_layers - 1):
                key = f"{prefix}.layers.{2 * i + 1}.weight"
                if r.has(key) and not np.array_equal(r.get(key),
                                                     r.get(act_key)):
                    raise ValueError(f"{key} differs from {act_key}: the "
                                     "reference shares one activation")
        if cfg.gcn.use_layer_norm:
            r.ln(f"{name}.norm", f"{prefix}.layers.{2 * n_layers}")
    elif lt == GraphLayerType.SparseGATConv:
        _gat_core(r, f"{name}.conv_0", f"{prefix}.layers.0")
        if cfg.gcn.use_layer_norm:
            r.ln(f"{name}.norm", f"{prefix}.layers.1")
    elif lt == GraphLayerType.InteractionNet:
        _interaction_processor(r, f"{name}.inet", f"{prefix}.layers",
                               cfg.gcn.num_message_passing_steps or 4)
    else:
        raise NotImplementedError(f"layer type {lt} is not supported")


def _model_block(r: _Reader, name: str, prefix: str, cfg: ModelConfig):
    if cfg.mlp is not None:
        _mlp_tower(r, f"{name}.mlp", f"{prefix}.mlp", cfg.mlp)
    _graph_layer(r, f"{name}.graph_layer", prefix, cfg)


def _expected_state(cfg: ExperimentConfig) -> Dict[str, torch.Size]:
    """Names and shapes of the state dict of the model ``cfg`` builds (its
    parameters do not depend on the node counts)."""
    from ..models.weather import WeatherModel

    model = WeatherModel(cfg.pipeline, cfg.data, 1, 1)
    return {k: v.shape for k, v in model.state_dict().items()}


def convert_reference_checkpoint(
    state_dict: Mapping[str, np.ndarray],
    cfg: ExperimentConfig,
) -> Dict[str, torch.Tensor]:
    """The ``WeatherModel`` state dict (float32 tensors, for
    ``load_state_dict(strict=True)``) of a reference ``WeatherPrediction``
    state dict."""
    pipeline = cfg.pipeline
    r = _Reader(state_dict)
    if pipeline.product_graph is not None:
        _model_block(r, "product_model", "product_graph_model",
                     pipeline.product_graph.model)
    for name in ("encoder", "processor", "decoder"):
        _model_block(r, name, name, getattr(pipeline, name))

    unused = sorted(set(state_dict) - r.used)
    if unused:
        raise KeyError(f"reference keys that map to nothing: {unused}")
    expected = _expected_state(cfg)
    missing = sorted(set(expected) - set(r.out))
    extra = sorted(set(r.out) - set(expected))
    if missing or extra:
        raise KeyError(f"model keys left unfilled: {missing}; converted "
                       f"keys the model does not have: {extra}")
    for key, shape in expected.items():
        if r.out[key].shape != shape:
            raise ValueError(f"{key}: converted shape "
                             f"{tuple(r.out[key].shape)}, the model's "
                             f"{tuple(shape)}")
    return OrderedDict((k, r.out[k]) for k in expected)
