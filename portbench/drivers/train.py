"""Training, closed loop: AR BPTT steps through the program's
``make_train_step`` (its ``TrainStep``: the compute-dtype forward over
fp32 masters, ``rollout_loss`` with a checkpoint per AR step, Adam), one
after the other, each step's loss read to the host as ``Trainer.fit``
logs it.

Batches come from a pool of ``pool_batches`` batches of ``batch`` samples
(input window and ``ar_steps`` targets, standard-normal fields) made on
the device from the seed in set-up; step t takes batch t mod the pool.
Set-up drives the step object through its first ``checked_steps`` steps
on the first batches, whose rows all differ, and keeps what the
comparison needs: the weights before them, the first gradient as Adam
holds it, the losses and the weights after them.  The window then goes on
with the same object.

Traffic keys: driver, batch, ar_steps, pool_batches, checked_steps,
profile_units.
"""

from __future__ import annotations

import gc
import math
import sys
import time
import traceback

import torch

from portbench.harness import check, system

FIELDS = 5   # generator stream of the run's seed


class Driver:
    def __init__(self, run):
        self.run = run
        t = run.traffic
        self.batch = int(t["batch"])
        self.steps = int(t["ar_steps"])
        self.pool_batches = int(t["pool_batches"])
        self.checked = int(t["checked_steps"])
        self.next = 0
        self.model = self.optimizer = self.step = None

    def setup(self):
        from graphcast_lite_torch.build import config_direct_steps
        from graphcast_lite_torch.training.loss import channel_mask, \
            lat_weights_from_axis
        from graphcast_lite_torch.training.rollout import RolloutSpec
        from graphcast_lite_torch.training.trainer import make_train_step

        run, cfg = self.run, self.run.config
        exp = system.experiment_config(cfg)
        self.model, graphs, self.weights = system.build_model(
            cfg, run.device, run.seed)
        g = self.model.num_grid_nodes
        c, obs = exp.data.num_features_used, exp.data.obs_window_used
        spec = RolloutSpec(
            obs_window=obs, num_features=c, use_residual=exp.use_residual,
            remat=exp.tpu.remat_rollout,
            static_channels=tuple(exp.static_channels),
            forcing_channels=tuple(exp.forcing_channels),
            direct_steps=config_direct_steps(exp))
        lat_w = lat_weights_from_axis(cfg["grid"]["num_lat"],
                                      cfg["grid"]["num_lon"]) \
            if exp.use_latitude_weighting else None
        self.step = make_train_step(
            self.model, graphs, spec, exp, steps=self.steps,
            device=run.device, lat_weights=lat_w,
            chan_mask=channel_mask(c, exp.static_channels,
                                   exp.forcing_channels))
        self.optimizer = self.step.optimizer
        self.xs, self.ys = self._fields(g, obs, c)

        # The first steps, kept for the comparison.
        names = [n for n, _ in self.model.named_parameters()]
        params = dict(self.model.named_parameters())
        self.losses = []
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        for i in range(self.checked):
            self.losses.append(self.unit())
            if i == 0:
                # Adam's first moment after one step is (1 - beta1) g.
                st = self.optimizer.state
                self.first_grad = {
                    n: (st[params[n]]["exp_avg"] / (1 - beta1)).detach()
                    .clone() if "exp_avg" in st.get(params[n], {})
                    else torch.zeros_like(params[n]) for n in names}
        self.after = {n: params[n].detach().clone() for n in names}

    def _fields(self, g, obs, c):
        """The pool: windows of standard-normal fields, and targets that
        are the last frame plus a tendency at each AR step, as a 6-hour
        step changes a standardized state little: its scale grows with the
        sample's place in its batch from 0.05 to 0.4 (times a seeded factor
        within 10%), so that every sample of a batch weighs differently in
        its loss."""
        dev = self.run.device
        gen = system.generator(self.run.seed, FIELDS, dev)
        nb, b = self.pool_batches, self.batch
        xs = torch.randn((nb, b, g, obs, c), generator=gen, device=dev)
        place = torch.arange(b, device=dev) / max(b - 1, 1)
        jitter = 1.0 + 0.2 * (torch.rand((nb, b), generator=gen,
                                         device=dev) - 0.5)
        scale = 0.05 * 8.0 ** place * jitter
        noise = torch.randn((nb, b, g, self.steps, c), generator=gen,
                            device=dev)
        ys = xs[:, :, :, -1:, :] + scale[:, :, None, None, None] * noise
        return (xs.reshape(nb, b, g, obs * c),
                ys.reshape(nb, b, g, self.steps * c))

    def unit(self) -> float:
        """One train step on the next batch; its loss on the host."""
        b = self.next % self.pool_batches
        self.next += 1
        with self.run.annotate("portbench::train_step"):
            loss = self.step(self.xs[b], self.ys[b])
        with self.run.annotate("portbench::loss_to_host"):
            return float(loss.item())

    def window(self, seconds: float):
        w = self.run.window
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            w.attempted += 1
            t1 = time.perf_counter()
            try:
                loss = self.unit()
            except Exception:  # noqa: BLE001 - the loop counts and goes on
                traceback.print_exc(file=sys.stderr)
                w.failed += 1
                continue
            if not math.isfinite(loss):
                w.failed += 1
                continue
            w.units += 1
            w.samples += self.batch
            w.latencies_s.append(time.perf_counter() - t1)
        w.seconds = time.perf_counter() - t0

    def release(self):
        """Keep the graphs the timed path used (their real edges, on the
        host) for the judge; free the rest of the program's state."""
        self.prog_graphs = check.program_edges(self.step.graphs)
        self.model = self.optimizer = self.step = None
        gc.collect()

    def reference(self, pr=None):
        """The reference's (losses, first gradients, weights after) over
        the checked steps' batches, from the benchmark's weights; at the
        precision ``pr`` for the control."""
        run, cfg = self.run, self.run.config
        ref = system.reference_module(cfg)
        if getattr(self, "_ref_graphs", None) is None:
            self._faults, self._ref_graphs = check.reference_graphs(
                cfg, self.prog_graphs, run.device)
        gr = self._ref_graphs
        batches = [(self.xs[i % self.pool_batches],
                    self.ys[i % self.pool_batches])
                   for i in range(self.checked)]
        if pr is None and getattr(self, "_ref", None) is not None:
            return self._ref
        with check.fp32_exact():
            out = ref.train_steps(self.weights, gr, batches, cfg, pr)
        if pr is None:
            self._ref = out
        return out

    def check(self, program=None):
        """{loss_gap, grad_gap, change_gap, graph_faults}: the program's (or, with
        ``program``, another path's (losses, first gradients, weights
        after), such as the control's) against the reference's."""
        losses, first, after = program if program is not None else (
            self.losses, self.first_grad, self.after)
        r_losses, r_first, r_after = self.reference()
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
        keep = check.kept_leaves(r_first)
        grad_gap, grad_leaf = check.leaf_gap(first, r_first, keep)
        change = {k: after[k] - self.weights[k] for k in keep}
        r_change = {k: r_after[k] - self.weights[k] for k in keep}
        change_gap, change_leaf = check.leaf_gap(change, r_change, keep)
        self.details = {
            "losses": [list(losses), list(r_losses)],
            "left_out": sorted(set(r_first) - set(keep)),
            "grad_leaf": grad_leaf, "change_leaf": change_leaf,
            "grad_norms": {k: [float(first[k].norm()),
                               float(r_first[k].norm())] for k in keep},
            "change_norms": {k: [float(change[k].norm()),
                                 float(r_change[k].norm())] for k in keep}}
        return {"loss_gap": loss_gap, "grad_gap": grad_gap,
                "change_gap": change_gap, "graph_faults": float(self._faults)}
