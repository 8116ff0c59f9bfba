"""AR-rollout inference & evaluation engine (torch counterpart of
``graphcast_lite_tpu.inference.predict``).

For each sample of the dataset: the AR rollout on the device, then
streaming NumPy metrics on the host —

* persistence baseline (last input frame repeated) and
  skill = 1 − RMSE/RMSE_persistence;
* overall / per-horizon / per-channel metrics;
* optional region restriction (lat/lon bbox or inner boundary zone);
* static/forcing carry-forward during the rollout;
* optional data-assimilation hook invoked after each AR step (nudging /
  OI plug in here), and a post-processing hook on the finished
  trajectory (the lapse / MOS / IDW / cascade ladder);
* physical-unit per-channel RMSE via the dataset scalers;
* raw predictions + ground truth + sample offsets saved as .npz.

``rollouts_per_dispatch=K > 1`` is the amortized serve of the JAX
package: without an assimilator and for a one-step model, K samples'
whole trajectories run as one batched rollout (``[K, G, obs, C]``, one
model call a step for the K of them), buffered per sample and reported in
sample order.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..build import resolve_device, resolve_dtype
from ..data.dataset import ChunkedTimeseriesDataset, DatasetMetadata
from ..models.weather import ModelGraphs, WeatherModel
from ..training.rollout import RolloutSpec, _one_step, carry_forward, \
    rollout_predict
from .metrics import StreamingMetrics, skill_score

__all__ = ["EvalReport", "evaluate_model", "region_node_mask",
           "serving_copy"]

# An assimilator hook: (state_out [G, C], step_idx) -> [G, C].
AssimilatorFn = Callable[[np.ndarray, int], np.ndarray]
# A post-processing hook: (pred_flat [G, steps·C], sample_idx) -> same.
PostprocessFn = Callable[[np.ndarray, int], np.ndarray]


def region_node_mask(
    meta: DatasetMetadata,
    region: Optional[Tuple[float, float, float, float]] = None,
    boundary_width: int = 0,
) -> Optional[np.ndarray]:
    """Boolean [G] node mask for region-restricted metrics.

    Priority: explicit bbox > is_regional flat mask > inner boundary zone.
    """
    if region is not None and meta.coordinates is not None:
        lat_min, lat_max, lon_min, lon_max = region
        lats, lons = meta.coordinates
        if meta.flat_grid:
            nl, no = lats, lons
        else:
            lo, la = np.meshgrid(lons, lats)
            nl, no = la.reshape(-1), lo.reshape(-1)
        m = (nl >= lat_min) & (nl <= lat_max)
        if lon_min <= lon_max:
            m &= (no >= lon_min) & (no <= lon_max)
        else:  # wrap
            m &= (no >= lon_min) | (no <= lon_max)
        return m
    if meta.flat_grid and meta.is_regional is not None:
        return meta.is_regional.astype(bool)
    if boundary_width > 0 and not meta.flat_grid:
        m = np.zeros((meta.num_latitudes, meta.num_longitudes), bool)
        m[boundary_width:-boundary_width, boundary_width:-boundary_width] = True
        return m.reshape(-1)
    return None


@dataclasses.dataclass
class EvalReport:
    num_samples: int
    ar_steps: int
    rmse: float
    mae: float
    acc: float
    baseline_rmse: float
    baseline_acc: float
    skill: float
    per_horizon: List[Dict[str, float]]
    per_channel_rmse: np.ndarray
    per_channel_rmse_physical: Optional[np.ndarray]
    per_channel_acc: np.ndarray
    region: Optional[Dict[str, object]] = None
    variables: Optional[List[str]] = None

    def to_json(self) -> Dict:
        out = dataclasses.asdict(self)
        for k in ("per_channel_rmse", "per_channel_rmse_physical",
                  "per_channel_acc"):
            if out[k] is not None:
                out[k] = np.asarray(out[k]).tolist()
        return out

    def summary(self) -> str:
        lines = [
            f"=== Inference summary ({self.num_samples} samples, "
            f"AR={self.ar_steps}) ===",
            f"Overall: RMSE={self.rmse:.6f} | MAE={self.mae:.6f} | "
            f"ACC={self.acc:.4f}",
            f"Persistence: RMSE={self.baseline_rmse:.6f} | "
            f"ACC={self.baseline_acc:.4f}",
            f"Skill vs persistence: {self.skill * 100:.2f}%",
        ]
        for h in self.per_horizon:
            lines.append(
                f"  +{int(h['horizon']):02d}: RMSE={h['rmse']:.6f} | "
                f"base={h['baseline_rmse']:.6f} | "
                f"skill={h['skill'] * 100:.2f}% | ACC={h['acc']:.4f}"
            )
        if self.region is not None:
            r = self.region
            lines.append(
                f"Region ({int(r['num_nodes'])} nodes): "
                f"RMSE={r['rmse']:.6f} | skill={r['skill'] * 100:.2f}% | "
                f"ACC={r['acc']:.4f}"
            )
            for h in r.get("per_horizon", []):
                lines.append(
                    f"  region +{int(h['horizon']):02d}: "
                    f"RMSE={h['rmse']:.6f} | skill={h['skill'] * 100:.2f}%"
                )
        if self.variables and self.per_channel_rmse_physical is not None:
            lines.append("Per-channel physical RMSE:")
            for name, v in zip(self.variables, self.per_channel_rmse_physical):
                lines.append(f"  {name:>8s}: {v:.4f}")
        return "\n".join(lines)


def serving_copy(model: WeatherModel, graphs: Optional[ModelGraphs],
                 device: torch.device, dtype: torch.dtype):
    """(model, graphs) on ``device`` with params and float graph arrays in
    ``dtype``.  The caller's model is copied, never modified, when it is
    not already there; ``graphs`` None (a model that carries its own)
    stays None."""
    p = next(model.parameters())
    if p.device != device or p.dtype != dtype:
        model = copy.deepcopy(model).to(device=device, dtype=dtype)
    return model.eval(), (None if graphs is None
                          else graphs.to(device, dtype))


def evaluate_model(
    model: torch.nn.Module,
    graphs: Optional[ModelGraphs],
    dataset: ChunkedTimeseriesDataset,
    meta: DatasetMetadata,
    ar_steps: int = 1,
    use_residual: bool = True,
    static_channels: Tuple[int, ...] = (),
    forcing_channels: Tuple[int, ...] = (),
    max_samples: Optional[int] = None,
    region: Optional[Tuple[float, float, float, float]] = None,
    boundary_width: int = 0,
    assimilator: Optional[AssimilatorFn] = None,
    scalers_std: Optional[np.ndarray] = None,
    save_predictions: Optional[str] = None,
    horizon_hours: int = 6,
    postprocess: Optional[PostprocessFn] = None,
    skip_samples: int = 0,
    direct_steps: int = 1,
    edge_mask: Optional[torch.Tensor] = None,
    rollouts_per_dispatch: int = 1,
    device: Union[str, torch.device, None] = None,
    dtype: Union[str, torch.dtype] = "fp32",
) -> EvalReport:
    """Run AR evaluation over `dataset` and return the metric report.

    ``model(x [G, obs·C], graphs, edge_mask) -> (delta [G, C], mask)`` is a
    ``WeatherModel`` on ``graphs``, or a model that carries its own graphs
    (``graphs`` None), such as the regional composition
    ``cli.train_regional.RegionalModel``, served with ``region=`` as the
    JAX package's ``cli.train_regional`` serves its composed apply.
    Each sample is one whole-trajectory rollout on ``device`` (default
    ``cuda``; raises without a card unless ``device='cpu'``) with the
    params and float graph arrays in ``dtype`` (``fp32`` | ``bf16``).
    ``edge_mask`` is SparseGAT's processing-edge mask (default: the
    graph's own, as the JAX package's ``cli.predict`` serves it).
    ``rollouts_per_dispatch=K > 1`` (no assimilator, ``direct_steps`` 1
    only) batches K samples' whole trajectories into one rollout of the
    batched model (the JAX package's amortized serve): the chunk is
    ``range(i, min(i + K, n))``, its AR steps are its first sample's, each
    sample's forcing comes from its own targets, and the metrics
    accumulate in sample order, so that they equal K = 1's up to the
    rounding of the batched products.

    ``postprocess(pred_flat [G, steps·C], sample_idx) -> pred_flat``
    corrects the finished trajectory before the metrics; unlike
    ``assimilator`` it is NOT fed back into the AR window.
    ``skip_samples`` drops the first samples (e.g. a MOS calibration
    period); ``max_samples`` counts from there.

    Dispatch policy, the JAX package's:
    * ``direct_steps > 1`` — direct multi-step model: one forward per
      sample; an ``assimilator`` is applied OFFLINE per step (there is no
      AR window to feed it back into).
    * ``assimilator is None`` — the whole-trajectory rollout.
    * otherwise — per AR step: one forward on the device, carry-forward
      with that step's target, the output to the host as fp32, the
      assimilator, and its result written back into the window's last
      frame in the serve dtype."""
    dev = resolve_device(device)
    fdt = resolve_dtype(dtype)
    model, graphs = serving_copy(model, graphs, dev, fdt)
    if edge_mask is not None:
        edge_mask = edge_mask.to(dev, fdt)

    c = dataset.n_feat
    obs = dataset.obs_window
    g = dataset.n_nodes
    spec = RolloutSpec(
        obs_window=obs,
        num_features=c,
        use_residual=use_residual,
        remat=False,
        static_channels=tuple(static_channels),
        forcing_channels=tuple(forcing_channels),
        direct_steps=direct_steps,
    )
    exclude = sorted(set(static_channels) | set(forcing_channels))

    def model_fn(inp, m, t, p):
        return model(inp, graphs, m)

    sm_pred = StreamingMetrics(c, exclude)
    sm_base = StreamingMetrics(c, exclude)
    sm_pred_h = [StreamingMetrics(c, exclude) for _ in range(ar_steps)]
    sm_base_h = [StreamingMetrics(c, exclude) for _ in range(ar_steps)]

    rmask = region_node_mask(meta, region, boundary_width)
    if rmask is not None:
        sm_pred_r = StreamingMetrics(c, exclude)
        sm_base_r = StreamingMetrics(c, exclude)
        sm_pred_rh = [StreamingMetrics(c, exclude) for _ in range(ar_steps)]
        sm_base_rh = [StreamingMetrics(c, exclude) for _ in range(ar_steps)]
        ridx = np.flatnonzero(rmask)

    saved_preds, saved_gt, saved_offsets = [], [], []
    pending: Dict[int, np.ndarray] = {}  # the amortized serve's chunk
    amortized = (rollouts_per_dispatch > 1 and assimilator is None
                 and direct_steps == 1)

    n = len(dataset)
    if max_samples is not None:
        n = min(n, skip_samples + max_samples)
    for i in range(skip_samples, n):
        x, y = dataset.get(i)
        p_avail = y.shape[-1] // c
        steps = min(ar_steps, p_avail)
        if direct_steps > 1:
            steps = min(steps, direct_steps)
        targets = y.reshape(g, p_avail, c)
        persistence = x.reshape(g, obs, c)[:, -1, :]

        window = torch.from_numpy(x.reshape(g, obs, c)).to(dev, fdt)
        forcing = torch.from_numpy(targets).to(dev, fdt)
        with torch.inference_mode():
            if amortized:
                if i not in pending:
                    idxs = range(i, min(i + rollouts_per_dispatch, n))
                    ws, ts = [], []
                    for j in idxs:
                        xj, yj = dataset.get(j)
                        ws.append(xj.reshape(g, obs, c))
                        ts.append(yj.reshape(g, -1, c))
                    outb = rollout_predict(
                        model_fn, torch.from_numpy(np.stack(ws)).to(dev, fdt),
                        steps, spec, edge_mask,
                        forcing=torch.from_numpy(np.stack(ts)).to(dev, fdt))
                    outb = outb.float().cpu().numpy()  # [K, G, steps, C]
                    pending.update({j: outb[k] for k, j in enumerate(idxs)})
                pred_flat = pending.pop(i).reshape(g, steps * c)
            elif assimilator is None or direct_steps > 1:
                out = rollout_predict(model_fn, window, steps, spec,
                                      edge_mask, forcing=forcing)
                out = out.float().cpu().numpy()           # [G, steps, C]
                if assimilator is not None:
                    # Direct multi-step: offline per-step assimilation.
                    for step in range(steps):
                        out[:, step, :] = assimilator(out[:, step, :], step)
                pred_flat = out.reshape(g, steps * c)
            else:
                outs = []
                for step in range(steps):
                    out, _ = _one_step(model_fn, window, edge_mask, 0.0,
                                       False, spec)
                    out = carry_forward(out, window[:, -1, :],
                                        forcing[:, step, :], spec)
                    out_np = assimilator(out.float().cpu().numpy(), step)
                    back = torch.from_numpy(
                        np.asarray(out_np, np.float32)).to(dev, fdt)
                    window = torch.cat([window[:, 1:, :], back[:, None, :]],
                                       dim=1)
                    outs.append(out_np)
                pred_flat = np.concatenate(outs, axis=1)  # [G, steps·C]
        if postprocess is not None:
            pred_flat = postprocess(pred_flat, i)
        gt_flat = targets[:, :steps, :].reshape(g, steps * c)
        base_flat = np.tile(persistence, (1, steps))

        sm_pred.update(gt_flat, pred_flat)
        sm_base.update(gt_flat, base_flat)
        for s in range(steps):
            sl = slice(s * c, (s + 1) * c)
            sm_pred_h[s].update(gt_flat[:, sl], pred_flat[:, sl])
            sm_base_h[s].update(gt_flat[:, sl], base_flat[:, sl])
        if rmask is not None:
            sm_pred_r.update(gt_flat[ridx], pred_flat[ridx])
            sm_base_r.update(gt_flat[ridx], base_flat[ridx])
            for s in range(steps):
                sl = slice(s * c, (s + 1) * c)
                sm_pred_rh[s].update(gt_flat[ridx][:, sl],
                                     pred_flat[ridx][:, sl])
                sm_base_rh[s].update(gt_flat[ridx][:, sl],
                                     base_flat[ridx][:, sl])

        if save_predictions:
            saved_preds.append(pred_flat.astype(np.float32))
            saved_gt.append(gt_flat.astype(np.float32))
            saved_offsets.append(dataset._samples[i][1])

    per_horizon = []
    for s in range(ar_steps):
        if sm_pred_h[s].n == 0:
            continue
        per_horizon.append({
            "horizon": (s + 1) * horizon_hours,
            "rmse": sm_pred_h[s].rmse,
            "baseline_rmse": sm_base_h[s].rmse,
            "skill": skill_score(sm_pred_h[s].rmse, sm_base_h[s].rmse),
            "acc": sm_pred_h[s].acc,
        })

    region_report = None
    if rmask is not None:
        region_report = {
            "num_nodes": int(rmask.sum()),
            "rmse": sm_pred_r.rmse,
            "acc": sm_pred_r.acc,
            "skill": skill_score(sm_pred_r.rmse, sm_base_r.rmse),
            "per_horizon": [
                {
                    "horizon": (s + 1) * horizon_hours,
                    "rmse": sm_pred_rh[s].rmse,
                    "baseline_rmse": sm_base_rh[s].rmse,
                    "skill": skill_score(sm_pred_rh[s].rmse,
                                         sm_base_rh[s].rmse),
                }
                for s in range(ar_steps)
                if sm_pred_rh[s].n
            ],
        }

    phys = None
    if scalers_std is not None:
        phys = sm_pred.rmse_per_channel * scalers_std[:c]

    if save_predictions:
        np.savez_compressed(
            save_predictions,
            predictions=np.stack(saved_preds),
            ground_truth=np.stack(saved_gt),
            sample_offsets=np.asarray(saved_offsets),
            n_features=c,
            ar_steps=ar_steps,
            obs_window=obs,
            n_lon=meta.num_longitudes,
            n_lat=meta.num_latitudes,
        )

    return EvalReport(
        num_samples=sm_pred.n,
        ar_steps=ar_steps,
        rmse=sm_pred.rmse,
        mae=sm_pred.mae,
        acc=sm_pred.acc,
        baseline_rmse=sm_base.rmse,
        baseline_acc=sm_base.acc,
        skill=skill_score(sm_pred.rmse, sm_base.rmse),
        per_horizon=per_horizon,
        per_channel_rmse=sm_pred.rmse_per_channel,
        per_channel_rmse_physical=phys,
        per_channel_acc=sm_pred.acc_per_channel,
        region=region_report,
        variables=meta.variables,
    )
