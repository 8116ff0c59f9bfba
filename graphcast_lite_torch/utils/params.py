"""Weight bridge from the JAX package's flax parameter tree to this
package's modules.

``from_flax_params(tree)`` takes the tree as nested dicts of NumPy arrays
(for example ``jax.tree.map(np.asarray, params)``) and returns a state
dict for ``WeatherModel.load_state_dict``.  The torch modules carry the
flax names, so a path maps by joining its keys with dots
(``encoder/mlp/lin_0/kernel`` → ``encoder.mlp.lin_0.kernel``), with one
exception: the InteractionNet steps run under ``nn.scan`` in JAX, which
stacks their parameters on axis 0 under ``…/inet/steps/layer/…``; they are
unstacked here into ``…inet.steps.{i}.…``.  Kernels keep their [in, out]
layout.  This covers every family: GAT's ``conv_i.core.{kernel, att_src,
att_dst, bias}`` and the stack's one shared ``act``, the product-graph
pre-encoder's ``product_model.*``, and the InteractionNet steps, lazy or
plain (they share their names; PReLU adds ``edge_mlp.act`` and
``edge_encoder_act``), so one tree loads into either processor.  The
regional heads carry the flax names too, so their trees map by the same
rules: ``models.dual_mesh.DualMeshRegional`` (one shared step,
``reg_processor.step.…``, not scanned) and
``models.roi_residual.ROIResidualModule`` (``processor.steps.{i}.…``
from its scanned ``processor/steps/layer``).

The U-Net family (``models.unet``, also under ``models.grid_adapter.
GridImageModel``'s ``image_module``) is built of torch's own layers, so
its tree maps by a rename and a transpose: a tree with a 4-D ``kernel``
(a convolution; no GNN has one) is read as an image model's, where conv
kernels [kh, kw, in, out] become ``weight`` [out, in, kh, kw], dense
kernels [in, out] ``weight`` [out, in], the norms' ``scale`` ``weight``,
and ``bias``, ``weights_re`` and ``weights_im`` keep their names.

``from_optax_adam_state(tree, model, processor_lr_factor)`` maps the JAX
package's Adam state (as ``flax.serialization.to_state_dict`` lays it out)
onto the state dict of ``training.trainer.build_optimizer``'s optimizer,
through the same path rules; ``from_optax_clipped_adamw_state(tree,
model)`` maps the CNN trainers' ``optax.chain(clip_by_global_norm,
adamw(schedule))`` state onto ``training.optim.ClippedAdamW``'s.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch

__all__ = ["from_flax_params", "from_flax_image_params",
           "from_optax_adam_state", "from_optax_clipped_adamw_state"]


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) \
        -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _image_leaf(path: Tuple[str, ...], arr: np.ndarray) \
        -> Tuple[Tuple[str, ...], np.ndarray]:
    """An image model's flax leaf -> its torch name and layout."""
    name = path[-1]
    if name == "kernel":
        arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        name = "weight"
    elif name == "scale":
        name = "weight"
    return path[:-1] + (name,), arr


def from_flax_image_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """An image model's flax tree (the U-Net family or one of its blocks)
    → state dict of float32 tensors in torch's layouts."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    state: Dict[str, torch.Tensor] = OrderedDict()
    for path, arr in _flatten(tree):
        path, arr = _image_leaf(path, arr.astype(np.float32))
        state[".".join(path)] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def from_flax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (``{"params": …}`` or its inner dict) → state
    dict of float32 tensors (an image model's through
    ``from_flax_image_params``)."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    leaves = list(_flatten(tree))
    if any(p[-1] == "kernel" and a.ndim == 4 for p, a in leaves):
        return from_flax_image_params(tree)
    state: Dict[str, torch.Tensor] = OrderedDict()
    for path, arr in leaves:
        arr = arr.astype(np.float32)
        i = path.index("steps") if "steps" in path else -1
        if 0 <= i < len(path) - 1 and path[i + 1] == "layer":
            head, tail = path[:i + 1], path[i + 2:]
            for s in range(arr.shape[0]):
                key = ".".join(head + (str(s),) + tail)
                state[key] = torch.from_numpy(np.ascontiguousarray(arr[s]))
        else:
            state[".".join(path)] = torch.from_numpy(
                np.ascontiguousarray(arr)
            )
    return state


def _adam_leaves(adam: Mapping) -> Tuple[float, Dict[str, torch.Tensor],
                                         Dict[str, torch.Tensor]]:
    """``optax.adam``'s state ``{"0": {count, mu, nu}, "1": {}}`` ->
    (count, mu, nu) with mu and nu as port state dicts (leaves masked out
    by ``optax.masked`` are empty dicts, and drop out)."""
    if set(adam.keys()) != {"0", "1"} or set(adam["0"].keys()) \
            != {"count", "mu", "nu"}:
        raise ValueError(f"not an optax.adam state: {sorted(adam.keys())}")
    inner = adam["0"]
    return (float(np.asarray(inner["count"])), from_flax_params(inner["mu"]),
            from_flax_params(inner["nu"]))


def from_optax_adam_state(tree: Mapping, model: torch.nn.Module,
                          processor_lr_factor: float = 1.0) -> Dict[str, Any]:
    """The JAX package's optimizer state (``optax.adam``, or the
    ``optax.multi_transform`` of its ``build_optimizer`` when
    ``processor_lr_factor`` is not 1) -> a state dict for the optimizer
    ``training.trainer.build_optimizer(model, lr, processor_lr_factor)``
    builds: per parameter ``step`` (optax's ``count``), ``exp_avg`` (``mu``)
    and ``exp_avg_sq`` (``nu``), and the groups' parameter indices.  The
    groups carry no hyperparameters: the caller puts ``state`` into its own
    optimizer's state dict."""
    named = list(model.named_parameters())
    processor = {n for n, _ in named if "processor" in n.split(".")}
    if processor_lr_factor == 1.0:
        if "0" not in tree:
            raise ValueError("expected the optax.adam layout "
                             "{'0': {count, mu, nu}, '1': {}}")
        groups: List[List[str]] = [[n for n, _ in named]]
        adam = _adam_leaves(tree)
        sources = {n: adam for n in groups[0]}
    else:
        if set(tree.keys()) != {"inner_states"}:
            raise ValueError("expected the multi_transform layout "
                             "{'inner_states': {'rest', 'processor'}}")
        groups = [[n for n, _ in named if n not in processor],
                  [n for n, _ in named if n in processor]]
        rest, proc = (_adam_leaves(tree["inner_states"][k]["inner_state"])
                      for k in ("rest", "processor"))
        sources = {n: (proc if n in processor else rest) for n, _ in named}
    return _optimizer_state(named, groups, sources)


def from_optax_clipped_adamw_state(tree: Mapping, model: torch.nn.Module
                                   ) -> Dict[str, Any]:
    """The CNN trainers' optimizer state (``optax.chain(clip_by_global_norm,
    adamw(schedule))``: ``{"0": {}, "1": {"0": {count, mu, nu}, "1": {},
    "2": {count}}}``) -> a state dict for ``training.optim.ClippedAdamW``
    over ``model``'s parameters in one group: per parameter ``step``
    (Adam's ``count``, which is also the schedule's position),
    ``exp_avg`` and ``exp_avg_sq``.  Raises if the schedule's count is
    not Adam's."""
    inner = tree.get("1")
    if not (set(tree.keys()) == {"0", "1"} and tree["0"] == {}
            and isinstance(inner, Mapping)
            and set(inner.keys()) == {"0", "1", "2"} and inner["1"] == {}
            and isinstance(inner["2"], Mapping)
            and set(inner["2"].keys()) == {"count"}):
        raise ValueError("expected the optax.chain(clip_by_global_norm, "
                         "adamw(schedule)) layout {'0': {}, '1': {'0': "
                         "{count, mu, nu}, '1': {}, '2': {count}}}")
    adam = _adam_leaves({"0": inner["0"], "1": {}})
    schedule = float(np.asarray(inner["2"]["count"]))
    if schedule != adam[0]:
        raise ValueError(f"the schedule's count {schedule:g} is not "
                         f"Adam's {adam[0]:g}")
    named = list(model.named_parameters())
    names = [n for n, _ in named]
    return _optimizer_state(named, [names], dict.fromkeys(names, adam))


def _optimizer_state(named, groups: List[List[str]], sources
                     ) -> Dict[str, Any]:
    """The optimizer state dict of ``groups`` (lists of parameter names),
    each parameter's (count, mu, nu) taken from ``sources[name]``."""
    shapes = {n: p.shape for n, p in named}
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    index = 0
    param_groups = []
    for names in groups:
        ids = []
        for name in names:
            count, mu, nu = sources[name]
            if name not in mu or name not in nu:
                raise KeyError(f"the optax state has no moments of {name}")
            if mu[name].shape != shapes[name]:
                raise ValueError(f"{name}: moments of shape "
                                 f"{tuple(mu[name].shape)}, parameter "
                                 f"{tuple(shapes[name])}")
            state[index] = {"step": torch.tensor(count),
                            "exp_avg": mu[name], "exp_avg_sq": nu[name]}
            ids.append(index)
            index += 1
        param_groups.append({"params": ids})
    return {"state": state, "param_groups": param_groups}
