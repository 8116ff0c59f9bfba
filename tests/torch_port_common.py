"""Shared set-up of the ``test_torch_port_*`` files: the same small
flagship-architecture model in both packages, with the JAX parameters
bridged into the port, and (for the ``test_torch_port_train*`` files) one
AR-4 BPTT step through both packages: the JAX package's ``rollout_loss``
under ``jax.value_and_grad`` with the mixed-precision casts of its
``Trainer._make_train_step``, and the port's ``make_train_step``, on the
same weights, window, targets, latitude weights and channel mask, with a
static and a forcing channel.

The JAX package takes the lazy-LN reg-block processor (the path the port
implements) only when ``GCLT_LAZY_EDGE=1`` on the CPU; callers set it with
``monkeypatch`` before the JAX model is applied (the policy is read while
tracing).
"""

import functools

import jax
import jax.numpy as jnp
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


def model_pair(seed=0, hidden=HIDDEN, jax_graph_set=None, direct_steps=1):
    """(jax_model, jax_params, jax_graphs, port_model, port_graphs) with
    the JAX init bridged into the port (CPU, fp32).  ``jax_graph_set``
    replaces the cached JAX graphs (e.g. one built under an opt-in switch
    that the JAX package reads when it builds a graph).  ``direct_steps``
    P > 1 makes a direct multi-step model (the decoder emits P·C
    channels)."""
    jcfg, tcfg = small_configs(hidden=hidden)
    for cfg in (jcfg, tcfg):
        cfg.pipeline.decoder.gcn.output_dim = direct_steps * N_FEAT
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


# ---- one train step through both packages ----------------------------

AR, OBS, LR = 4, 2, 1e-3
SPEC = dict(obs_window=OBS, num_features=N_FEAT, use_residual=True,
            remat=True, static_channels=(1,), forcing_channels=(3,))
# fp32 tolerances of the port against the JAX package: the loss relative,
# and per gradient leaf max|g_port - g_jax| <= GRAD_RTOL max|g_jax| + 1e-6.
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6


def batch(g, seed=0):
    """(x [1, G, obs·C], y [1, G, AR·C], lat weights [G], channel mask [C])
    from a seed."""
    from graphcast_lite_torch.training.loss import channel_mask, \
        lat_weights_from_axis

    rng = np.random.RandomState(seed)
    x = rng.randn(1, g, OBS * N_FEAT).astype(np.float32)
    y = rng.randn(1, g, AR * N_FEAT).astype(np.float32)
    lw = lat_weights_from_axis(32, 64)
    cm = channel_mask(N_FEAT, SPEC["static_channels"],
                      SPEC["forcing_channels"])
    return x, y, lw, cm


def _cast(tree, dtype):
    return jax.tree.map(
        lambda a: a.astype(dtype)
        if hasattr(a, "dtype") and a.dtype == jnp.float32 else a, tree)


def jax_step(jmodel, params, jgraphs, x, y, lw, cm, dtype=jnp.float32):
    """(loss, gradients as a port state dict) of the JAX package's
    rollout_loss, in ``dtype`` against the fp32 ``params``."""
    from graphcast_lite_tpu.training.rollout import RolloutSpec, \
        rollout_loss

    spec = RolloutSpec(**SPEC)
    graphs = _cast(jgraphs, dtype) if dtype != jnp.float32 else jgraphs
    g = x.shape[1]
    window = jnp.asarray(x).reshape(1, g, OBS, N_FEAT).astype(dtype)
    targets = jnp.asarray(y).reshape(1, g, AR, N_FEAT).astype(dtype)

    def loss_fn(p):
        pc = _cast(p, dtype) if dtype != jnp.float32 else p

        def fn(inp, m, t, pr):
            return jmodel.apply(pc, inp[0], graphs)[0][None], None

        loss, _ = rollout_loss(fn, window, targets, AR, spec, None, 0.0,
                               False, jnp.asarray(lw), jnp.asarray(cm))
        return loss.astype(jnp.float32)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    grads = jax.tree.map(lambda a: np.asarray(a, np.float32), grads)
    return float(loss), from_flax_params(flax_numpy(grads))


def port_step(tmodel, tgraphs, x, y, lw, cm, dtype="float32", hidden=None):
    """(loss, {name: fp32 grad}, params before, params after) of one
    ``make_train_step`` step on the CPU; a parameter the loss does not
    reach has a zero gradient."""
    from graphcast_lite_torch.training.rollout import RolloutSpec
    from graphcast_lite_torch.training.trainer import make_train_step

    _, cfg = small_configs() if hidden is None else small_configs(
        hidden=hidden)
    cfg.max_ar_steps, cfg.learning_rate = AR, LR
    cfg.tpu.compute_dtype = dtype
    before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    step = make_train_step(tmodel, tgraphs, RolloutSpec(**SPEC), cfg,
                           device="cpu", lat_weights=lw, chan_mask=cm)
    loss = step(x, y)
    assert loss.dtype == torch.float32
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in tmodel.named_parameters()}
    assert all(g.dtype == torch.float32 for g in grads.values())
    after = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    return float(loss), grads, before, after


def assert_grads_close(grads, expect):
    """Every parameter's gradient within GRAD_RTOL of the leaf's largest
    JAX gradient (+ GRAD_ATOL)."""
    assert set(grads) == set(expect)
    worst = (0.0, None)
    for name, g in grads.items():
        ref = expect[name]
        err = (g - ref).abs().max().item()
        tol = GRAD_RTOL * ref.abs().max().item() + GRAD_ATOL
        assert err <= tol, f"{name}: max|err| {err:.3e} > {tol:.3e}"
        worst = max(worst, (err / tol, name))
    print(f"gradients: largest error {worst[0]:.3f} of its tolerance "
          f"({worst[1]}), {len(grads)} leaves")
