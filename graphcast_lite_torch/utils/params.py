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
layout.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

__all__ = ["from_flax_params"]


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) \
        -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def from_flax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (``{"params": …}`` or its inner dict) → state
    dict of float32 tensors."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    state: Dict[str, torch.Tensor] = OrderedDict()
    for path, arr in _flatten(tree):
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
