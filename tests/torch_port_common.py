"""Shared set-up of the ``test_torch_port_*`` files: the same small
flagship-architecture model in both packages, with the JAX parameters
bridged into the port.

The JAX package takes the lazy-LN reg-block processor (the path the port
implements) only when ``GCLT_LAZY_EDGE=1`` on the CPU; callers set it with
``monkeypatch`` before the JAX model is applied (the policy is read while
tracing).
"""

import functools

import jax
import numpy as np
import torch

from graphcast_lite_tpu import presets as jax_presets
from graphcast_lite_tpu.graphs.build import build_graph_set as jax_build
from graphcast_lite_tpu.models.weather import ModelGraphs as JaxGraphs
from graphcast_lite_tpu.models.weather import WeatherModel as JaxModel
from graphcast_lite_torch import presets as port_presets
from graphcast_lite_torch.graphs.build import build_graph_set as port_build
from graphcast_lite_torch.models.weather import ModelGraphs as PortGraphs
from graphcast_lite_torch.models.weather import WeatherModel as PortModel
from graphcast_lite_torch.utils.params import from_flax_params

# Small flagship architecture: 64x32 grid, mesh [1, 2], hidden 32, 2 steps.
N_FEAT, HIDDEN, MP_STEPS, LEVELS = 5, 32, 2, [1, 2]
LAT, LON = jax_presets.wb2_64x32_grid()
# Parity tolerance in fp32 (as tests/test_torch_parity.py).
ATOL, RTOL = 5e-5, 1e-4


def small_configs(n_feat=N_FEAT, hidden=HIDDEN, mp_steps=MP_STEPS):
    jcfg = jax_presets.interaction_net_64x32(n_feat=n_feat, hidden=hidden,
                                             mp_steps=mp_steps)
    tcfg = port_presets.interaction_net_64x32(n_feat=n_feat, hidden=hidden,
                                              mp_steps=mp_steps)
    jcfg.graph.mesh_levels = list(LEVELS)
    tcfg.graph.mesh_levels = list(LEVELS)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def graph_sets():
    """(JAX GraphSet, port GraphSet) on the small grid."""
    return jax_build(LAT, LON, LEVELS, 0.6), port_build(LAT, LON, LEVELS, 0.6)


def flax_numpy(params):
    return jax.tree.map(np.asarray, params)


def model_pair(seed=0, hidden=HIDDEN, jax_graph_set=None):
    """(jax_model, jax_params, jax_graphs, port_model, port_graphs) with
    the JAX init bridged into the port (CPU, fp32).  ``jax_graph_set``
    replaces the cached JAX graphs (e.g. one built under an opt-in switch
    that the JAX package reads when it builds a graph)."""
    jcfg, tcfg = small_configs(hidden=hidden)
    jgs, tgs = graph_sets()
    jgs = jax_graph_set or jgs
    jgraphs = JaxGraphs.from_graph_set(jgs)
    jmodel = JaxModel(pipeline=jcfg.pipeline, data=jcfg.data,
                      num_grid_nodes=jgs.num_grid_nodes,
                      num_mesh_nodes=jgs.num_mesh_nodes)
    dummy = np.zeros((jgs.num_grid_nodes,
                      jcfg.data.obs_window_used * N_FEAT), np.float32)
    params = jmodel.init(jax.random.PRNGKey(seed), dummy, jgraphs)
    tmodel = PortModel(tcfg.pipeline, tcfg.data, tgs.num_grid_nodes,
                       tgs.num_mesh_nodes)
    tmodel.load_state_dict(from_flax_params(flax_numpy(params)))
    return jmodel, params, jgraphs, tmodel, PortGraphs.from_graph_set(tgs)


def to_torch(a):
    return torch.from_numpy(np.array(a, np.float32))


def bf16_close(port16, jax16, jax32):
    """The port in bf16 rounds in other places than XLA's fused CPU
    kernels, so it is held to the reference's own bf16 error rather than
    to the reference: its RMS distance from JAX fp32 stays within 1.25x
    JAX bf16's, and its largest distance from JAX bf16 within 2x JAX
    bf16's largest distance from JAX fp32.  The two ratios are printed
    (``pytest -k bf16 -rP``); for the reg-block model of
    tests/test_torch_port_model.py they read 0.91-1.01 and 0.72-1.05 over
    the forward and the four AR steps."""
    port16, jax16, jax32 = (np.asarray(a, np.float32)
                            for a in (port16, jax16, jax32))

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a))))

    rms_ratio = rms(port16 - jax32) / rms(jax16 - jax32)
    max_ratio = np.abs(port16 - jax16).max() / np.abs(jax16 - jax32).max()
    print(f"bf16: RMS ratio {rms_ratio:.3f}, largest-distance ratio "
          f"{max_ratio:.3f}; JAX bf16 vs fp32 RMS {rms(jax16 - jax32):.3e}, "
          f"largest {np.abs(jax16 - jax32).max():.3e}")
    assert np.isfinite(port16).all()
    assert rms_ratio <= 1.25
    assert max_ratio <= 2.0
