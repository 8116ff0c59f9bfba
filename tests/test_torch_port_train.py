"""The port's train step (``training.trainer.make_train_step``: AR-4 BPTT
with a checkpoint per AR step, then Adam) against the JAX package on the
CPU, on the default reg-block route of the small flagship architecture
(64x32, mesh [1, 2], hidden 32, 2 steps; ``GCLT_LAZY_EDGE=1``, the JAX
package's Pallas calls in interpret mode).

fp32: the loss within 1e-5 relative of ``jax.value_and_grad`` of the JAX
package's ``rollout_loss``, every parameter's gradient within
1e-4·max|g_jax| + 1e-6, and the Adam update allclose to ``optax.adam`` on
the same gradients.  bf16 mixed precision: the loss and the gradients held
to the JAX package's own bf16 error (``bf16_close``).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_common import (
    LOSS_RTOL,
    LR,
    assert_grads_close,
    batch,
    bf16_close,
    jax_step,
    model_pair,
    port_step,
)
from torch_port_common import \
    one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope="module")
def fp32_step():
    """Both packages' fp32 step on the reg-block route, computed once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GCLT_LAZY_EDGE", "1")
        for name in ("GCLT_REG_EDGE", "GCLT_EDGE_STEP", "GCLT_MEGA_EDGE"):
            mp.delenv(name, raising=False)
        jmodel, params, jgraphs, tmodel, tgraphs = model_pair()
        x, y, lw, cm = batch(tgraphs.num_grid_nodes)
        jloss, jgrads = jax_step(jmodel, params, jgraphs, x, y, lw, cm)
        loss, grads, before, after = port_step(tmodel, tgraphs, x, y, lw, cm)
        routes = {s.route for s in tmodel.processor.graph_layer.inet.steps}
    return dict(jax=(jloss, jgrads), port=(loss, grads, before, after),
                routes=routes, pair=(jmodel, params, jgraphs), batch=(x, y,
                                                                      lw, cm))


def test_train_loss_and_every_gradient_match_jax(fp32_step):
    jloss, jgrads = fp32_step["jax"]
    loss, grads, _, _ = fp32_step["port"]
    assert fp32_step["routes"] == {"reg_block"}
    assert np.isfinite(loss)
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss)
    assert_grads_close(grads, jgrads)
    # The loss reaches every parameter but the last step's edge LayerNorm
    # (its affine would only scale the next step's edges).
    zero = {n for n, g in grads.items() if not g.abs().max() > 0}
    assert zero == {n for n, g in jgrads.items() if not g.abs().max() > 0}
    assert all(".steps.1.edge_norm." in n for n in zero), zero


def test_adam_step_matches_optax(fp32_step):
    """The update of the masters: optax.adam on the port's own gradients."""
    _, grads, before, after = fp32_step["port"]
    opt = optax.adam(LR)
    params = {n: jnp.asarray(p.numpy()) for n, p in before.items()}
    updates, _ = opt.update({n: jnp.asarray(g.numpy())
                             for n, g in grads.items()},
                            opt.init(params), params)
    expect = optax.apply_updates(params, updates)
    moved = 0
    for name, p in after.items():
        np.testing.assert_allclose(p.numpy(), np.asarray(expect[name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        moved += int((p != before[name]).any())
    assert moved >= len(after) - 2


def _flat(grads, scale):
    """All gradient leaves in one vector, each leaf divided by its largest
    fp32 JAX gradient, so every leaf weighs alike."""
    return np.concatenate([np.asarray(grads[n], np.float32).ravel() / s
                           for n, s in scale.items()])


def test_train_step_bf16_mixed_precision(fp32_step, monkeypatch):
    """bf16 compute against fp32 masters: the port's loss and gradients
    stay within the JAX package's own bf16 error against its fp32 step."""
    monkeypatch.setenv("GCLT_LAZY_EDGE", "1")
    jmodel, params, jgraphs = fp32_step["pair"]
    x, y, lw, cm = fp32_step["batch"]
    jloss32, jgrads32 = fp32_step["jax"]
    jloss16, jgrads16 = jax_step(jmodel, params, jgraphs, x, y, lw, cm,
                                 jnp.bfloat16)
    _, _, _, tmodel, tgraphs = model_pair()
    loss16, grads16, _, _ = port_step(tmodel, tgraphs, x, y, lw, cm,
                                      "bfloat16")
    assert {s.route for s in tmodel.processor.graph_layer.inet.steps} \
        == {"reg_block"}
    scale = {n: g.abs().max().item() for n, g in jgrads32.items()
             if g.abs().max() > 0}
    port16 = np.concatenate([[loss16], _flat(grads16, scale)])
    jax16 = np.concatenate([[jloss16], _flat(jgrads16, scale)])
    jax32 = np.concatenate([[jloss32], _flat(jgrads32, scale)])
    bf16_close(port16, jax16, jax32)


def test_processor_lr_factor_and_freeze(monkeypatch):
    """A processor LR factor puts the processor in a second Adam group; a
    frozen processor gets zeroed gradients (its moments still decay) and
    the rest trains."""
    from graphcast_lite_torch.training.trainer import build_optimizer
    from torch_port_common import SPEC, small_configs
    from graphcast_lite_torch.training.rollout import RolloutSpec
    from graphcast_lite_torch.training.trainer import make_train_step

    monkeypatch.setenv("GCLT_LAZY_EDGE", "1")
    _, _, _, tmodel, tgraphs = model_pair()
    names = dict(tmodel.named_parameters())
    assert len(build_optimizer(tmodel, 1e-3).param_groups) == 1

    _, cfg = small_configs()
    cfg.max_ar_steps, cfg.learning_rate = 2, 1e-3
    before = {n: p.detach().clone() for n, p in names.items()}
    step = make_train_step(tmodel, tgraphs, RolloutSpec(**SPEC), cfg,
                           steps=2, device="cpu", processor_lr_factor=0.1,
                           freeze_processor=True)
    opt = step.optimizer
    assert [g["lr"] for g in opt.param_groups] == pytest.approx([1e-3, 1e-4])
    proc = {id(p) for n, p in names.items() if n.startswith("processor.")}
    assert {id(p) for p in opt.param_groups[1]["params"]} == proc
    x, y, _, _ = batch(tgraphs.num_grid_nodes)
    assert torch.isfinite(step(x, y))
    for n, p in names.items():
        changed = bool((p != before[n]).any())
        if n.startswith("processor."):
            assert not changed, n
            assert p.grad is None or not p.grad.abs().max() > 0, n
    assert any((p != before[n]).any() for n, p in names.items()
               if n.startswith("encoder."))
