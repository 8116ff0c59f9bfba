"""SparseGAT through the port's ``Trainer.fit`` against the JAX package's
on the CPU, and its edge mask in checkpoints.

The JAX package's ``small_experiment`` with the SparseGAT processor (2
heads, hidden 16, batch 2, max AR 2), 7 epochs of 1 step.  The epoch's
``attention_threshold_schedule`` threshold turns positive at epoch index
6, which prunes on that epoch's first batch with the mask of the batch's
first sample.  With the default ramp (25 epochs to 0.1356) the threshold
there, 0.0054, is below every α of this small model (0.04 and up), so both
packages' fits take the same schedule with ``max_epochs=6``: the full
0.1356 at epoch 6.  Both fits start from the JAX ``init_state(seed=0)``
weights and the graph's own mask.

* Every epoch's losses and ACC within ``FIT_RTOL`` (1e-4 relative), the
  same thresholds in ``metrics.jsonl``.
* The final masks: pruned, and equal on every edge whose α at the prune
  (the port's) lies more than 1e-5 from the threshold.
* The mask round-trips through the port's ``checkpoint/state.pt`` (a new
  ``Trainer`` resumes it), and is read from the JAX package's
  ``checkpoint/state.msgpack`` equal to the JAX fit's final mask.
"""

import numpy as np
import torch

from graphcast_lite_tpu.training import trainer as jax_trainer
from graphcast_lite_tpu.training.trainer import Trainer as JaxTrainer
from graphcast_lite_torch.training import trainer as port_trainer
from graphcast_lite_torch.models.gnn import SparseGATConv
from graphcast_lite_torch.training.trainer import Trainer as PortTrainer
from graphcast_lite_torch.training.trainer import \
    attention_threshold_schedule
from graphcast_lite_torch.utils.params import from_flax_params
from torch_port_common import FIT_RTOL, fit_experiment, flax_numpy, \
    one_torch_thread, read_jsonl  # noqa: F401 (an autouse fixture)

EPOCHS, STEPS = 7, 1
ALPHA_MARGIN = 1e-5


def test_sparse_gat_fit_matches_jax(tmp_path, monkeypatch):
    for name in ("GCLT_LAZY_EDGE", "GCLT_REG_EDGE", "GCLT_EDGE_STEP",
                 "GCLT_MEGA_EDGE"):
        monkeypatch.delenv(name, raising=False)
    for mod in (jax_trainer, port_trainer):
        monkeypatch.setattr(mod, "attention_threshold_schedule",
                            lambda e, f=mod.attention_threshold_schedule:
                            f(e, max_epochs=6))
    (jcfg, jmodel, jgraphs, (jtrain, jval, jmeta), pcfg, pmodel, pgraphs,
     (ptrain, pval, pmeta)) = fit_experiment(tmp_path, "sparse_gat",
                                             num_epochs=EPOCHS)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jt = JaxTrainer(jmodel, jgraphs, jcfg, jmeta, str(jdir))
    jstate = jt.init_state(seed=0)
    params0 = flax_numpy(jstate.params)
    jres = jt.fit(jstate, jtrain, jval, print_losses=False,
                  max_steps_per_epoch=STEPS)
    jmask = np.asarray(jt.final_state.edge_mask)

    # The port's α at every pruning call.
    pruned_alpha = []
    forward = SparseGATConv.forward

    def recording(self, x, graph, edge_mask=None, attention_threshold=0.0,
                  prune=False):
        if prune:
            _, alpha = self.core(x, graph, edge_mask)
            pruned_alpha.append((alpha.detach().clone(),
                                 attention_threshold))
        return forward(self, x, graph, edge_mask, attention_threshold, prune)

    monkeypatch.setattr(SparseGATConv, "forward", recording)
    pt = PortTrainer(pmodel, pgraphs, pcfg, pmeta, str(pdir), device="cpu")
    assert pt.using_sparse_gat
    pstate = pt.init_state(seed=0)
    pstate.model.load_state_dict(from_flax_params(params0))
    mask0 = pstate.edge_mask.clone()
    assert torch.equal(mask0, pgraphs.processing.edge_mask)
    pres = pt.fit(pstate, ptrain, pval, print_losses=False,
                  max_steps_per_epoch=STEPS)
    pmask = pt.final_state.edge_mask

    for key in ("train_losses", "val_losses"):
        np.testing.assert_allclose(pres[key], jres[key], rtol=FIT_RTOL,
                                   err_msg=key)
    jm, pm = read_jsonl(jdir / "metrics.jsonl"), read_jsonl(
        pdir / "metrics.jsonl")
    np.testing.assert_allclose([r["val_acc"] for r in pm],
                               [r["val_acc"] for r in jm], rtol=FIT_RTOL)
    thr = [r["attention_threshold"] for r in pm]
    assert thr == [r["attention_threshold"] for r in jm]
    assert thr == [attention_threshold_schedule(e, max_epochs=6)
                   for e in range(EPOCHS)]
    assert thr[5] == 0.0 and thr[6] == 0.1356

    # One pruning step (epoch 6, first batch, AR 2: two model calls in
    # the forward, then the recompute of each in the backward).
    assert pruned_alpha and {t for _, t in pruned_alpha} == {thr[6]}
    far = np.ones(pmask.numel(), bool)
    for alpha, t in pruned_alpha:
        far &= np.abs(alpha.numpy() - t) > ALPHA_MARGIN
    assert 0 < pmask.sum() < mask0.sum()
    np.testing.assert_array_equal(pmask.numpy()[far], jmask[far])
    print(f"SparseGAT fit: live edges {int(mask0.sum())} -> "
          f"{int(pmask.sum())} (JAX {int(jmask.sum())}); "
          f"{int((~far).sum())} edges within {ALPHA_MARGIN} of the threshold")

    # The mask round-trips through the port's state.pt ...
    rt = PortTrainer(pmodel, pgraphs, pcfg, pmeta, str(pdir), device="cpu")
    rstate = rt.init_state(seed=1)
    assert torch.equal(rstate.edge_mask, mask0)
    meta = rt.load_checkpoint(rstate)
    assert meta["epoch"] == EPOCHS - 1
    assert torch.equal(rstate.edge_mask, pmask)
    # ... and is read from the JAX package's state.msgpack.
    jr = PortTrainer(pmodel, pgraphs, pcfg, pmeta, str(jdir), device="cpu")
    jrstate = jr.init_state(seed=1)
    jr.load_checkpoint(jrstate)
    np.testing.assert_array_equal(jrstate.edge_mask.numpy(), jmask)
