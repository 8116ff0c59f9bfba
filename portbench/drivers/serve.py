"""Forecast serving, closed loop: one client sends a forecast request,
waits for the forecast on the host, and sends the next.

A request is ``rollouts_per_dispatch`` initial states (one forecast, or
the members of an amortized dispatch through the batched model), each an
input window [G, obs, C] on the host; it runs as the program's
``evaluate_model`` runs a dispatch: the window to the device in the serve
dtype, ``rollout_predict`` over the serve copy (``serving_copy``) for
``ar_steps`` AR steps, and the forecast [.., G, steps, C] back to the host
in fp32.  The windows come from a pool of ``input_pool`` fields made from
the seed in set-up; request d takes the next ``rollouts_per_dispatch`` of
them, cycling.

Arrivals: with ``rate_per_s`` null the loop is closed, one client that
always has its next request waiting (the load above the knee, where the
forecasts completed per second are what is measured); with a rate, the
loop is open, requests due at a fixed interval, served one at a time,
and each request's latency runs from the time it was due, so that a late
request delays those behind it.

Traffic keys: driver, rate_per_s, rollouts_per_dispatch, ar_steps,
input_pool, warmup, profile_units, check_sample (requests compared with
the reference after the window, drawn from the seed among those
finished).
"""

from __future__ import annotations

import gc
import random
import sys
import time
import traceback

import numpy as np
import torch

from portbench.harness import check, system

OBS_FIELD = 3   # generator streams of the run's seed
SAMPLE = 4


class Driver:
    def __init__(self, run):
        self.run = run
        t = run.traffic
        self.k = int(t["rollouts_per_dispatch"])
        self.steps = int(t["ar_steps"])
        self.pool_size = int(t["input_pool"])
        self.sample = int(t["check_sample"])
        self.next = 0
        self.kept = {}
        self.model = self.graphs = None

    # ---------------------------------------------------------------- set-up
    def setup(self):
        from graphcast_lite_torch.inference.predict import serving_copy
        from graphcast_lite_torch.training.rollout import RolloutSpec

        run, cfg = self.run, self.run.config
        d = cfg["data"]
        self.obs, self.c = d["obs_window_used"], d["num_features_used"]
        model, graphs, self.weights = system.build_model(cfg, run.device,
                                                         run.seed)
        self.dtype = system.compute_dtype(cfg)
        self.model, self.graphs = serving_copy(model, graphs, run.device,
                                               self.dtype)
        del model, graphs
        self.g = self.model.num_grid_nodes
        self.spec = RolloutSpec(
            obs_window=self.obs, num_features=self.c,
            use_residual=cfg["use_residual"], remat=False,
            static_channels=tuple(cfg["static_channels"]),
            forcing_channels=tuple(cfg["forcing_channels"]))
        self.pool = self._fields(run.seed).cpu().numpy()
        self.rng = random.Random(system.sub_seed(run.seed, SAMPLE))
        for _ in range(int(run.traffic["warmup"])):
            self.unit()
        self.next = 0

    def _fields(self, seed):
        """[P, G, obs, C] standard-normal input windows, the static
        channels equal over the window's frames."""
        dev = self.run.device
        x = torch.randn((self.pool_size, self.g, self.obs, self.c),
                        generator=system.generator(seed, OBS_FIELD, dev),
                        device=dev)
        st = list(self.run.config["static_channels"])
        if st:
            x[:, :, :, st] = x[:, :, :1, st]
        return x

    def inputs(self, d: int) -> np.ndarray:
        """Request d's windows: [G, obs, C], or [K, G, obs, C]."""
        if self.k == 1:
            return self.pool[d % self.pool_size]
        idx = [(d * self.k + j) % self.pool_size for j in range(self.k)]
        return np.stack([self.pool[i] for i in idx])

    def model_fn(self, inp, mask, thr, prune):
        return self.model(inp, self.graphs, mask)

    # ---------------------------------------------------------------- window
    def unit(self):
        """One request: (its number, the forecast on the host, seconds)."""
        from graphcast_lite_torch.training.rollout import rollout_predict

        run = self.run
        d = self.next
        self.next += 1
        x = self.inputs(d)
        t0 = time.perf_counter()
        with run.annotate("portbench::h2d"):
            window = torch.from_numpy(x).to(run.device, self.dtype)
        with torch.inference_mode(), run.annotate("portbench::rollout"):
            out = rollout_predict(self.model_fn, window, self.steps,
                                  self.spec)
        with run.annotate("portbench::d2h"):
            res = out.float().cpu().numpy()
        return d, res, time.perf_counter() - t0

    def window(self, seconds: float):
        w = self.run.window
        rate = self.run.traffic.get("rate_per_s")
        t0 = time.perf_counter()
        while True:
            due = t0 + w.attempted / rate if rate else time.perf_counter()
            if due - t0 >= seconds:
                break
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            else:
                w.late_s = max(w.late_s, -wait)
            w.attempted += 1
            try:
                d, res, _ = self.unit()
            except Exception:  # noqa: BLE001 - the loop counts and goes on
                traceback.print_exc(file=sys.stderr)
                w.failed += 1
                continue
            w.units += 1
            w.points += self.k * self.g * self.steps
            w.latencies_s.append(time.perf_counter() - due)
            # Reservoir sample, from the seed, of the finished requests.
            if len(self.kept) < self.sample:
                self.kept[d] = res
            else:
                j = self.rng.randrange(w.units)
                if j < self.sample:
                    self.kept.pop(sorted(self.kept)[j])
                    self.kept[d] = res
        w.seconds = time.perf_counter() - t0

    # ----------------------------------------------------------------- check
    def release(self):
        """Keep the graphs the timed path used (their real edges, on the
        host) for the judge; free the rest of the program's state."""
        self.prog_graphs = check.program_edges(self.graphs)
        self.model = self.graphs = None
        gc.collect()

    def check(self, pr=None):
        """{rel_rms, max_rel, graph_faults} of the sampled requests'
        forecasts against the reference's; with ``pr`` (the control), of
        the reference computed at that precision in the program's
        place."""
        run, cfg = self.run, self.run.config
        ref = system.reference_module(cfg)
        if getattr(self, "_ref_graphs", None) is None:
            self._faults, self._ref_graphs = check.reference_graphs(
                cfg, self.prog_graphs, run.device)
            self._ref_out = {}
        gr = self._ref_graphs
        rel_rms = rel_max = 0.0
        self.details = []
        with check.fp32_exact(), torch.no_grad():
            for d, res in sorted(self.kept.items()):
                x = torch.as_tensor(self.inputs(d), device=run.device)
                res = torch.as_tensor(res, device=run.device)
                if self.k == 1:
                    x, res = x[None], res[None]
                for j in range(x.shape[0]):
                    want = self._ref_out.get((d, j))
                    if want is None:
                        want = self._ref_out[(d, j)] = ref.rollout(
                            self.weights, gr, x[j], self.steps, cfg)
                    got = res[j] if pr is None else ref.rollout(
                        self.weights, gr, x[j], self.steps, cfg, pr)
                    steps = check.forecast_step_gaps(got, want, x[j, :, -1])
                    self.details.append([d, j, steps])
                    rel_rms = max([rel_rms] + [a for a, _ in steps])
                    rel_max = max([rel_max] + [b for _, b in steps])
        return {"rel_rms": rel_rms, "max_rel": rel_max,
                "graph_faults": float(self._faults)}
