"""Regional refinement training CLI (dual-mesh or ROI-residual head):
``python -m graphcast_lite_torch.cli.train_regional <exp_dir> --roi ...``.

~ reference ``scripts/train_dual_mesh.py`` / ``scripts/train_roi_residual.py``
(the JAX package's ``cli.train_regional``): a frozen pretrained global model
provides predictions + latents; a regional corrector is trained on the ROI
with an ROI-only loss.  Includes the single-sample overfit sanity harness
the reference runs before real training (train_dual_mesh.py:63-135).

The global model is the experiment's ``best_model.pt``, or the JAX
package's ``best_model.msgpack``; it runs under ``torch.no_grad()`` in
every step.  Each head step runs inside ``training_trace()``, so the head
takes its training routes (the dual-mesh processor at 131,072 edges or
more trains through the fused edge unit), with ``torch.optim.Adam`` at
``--lr``.  The best head is saved as ``<out_dir>/regional_head.pt``;
``--evaluate-only`` reads it, or the JAX package's
``regional_head.msgpack``.  ``--evaluate`` runs the AR evaluation of the
composed model with region metrics (~ reference predict_dual_mesh.py).
Runs on the card (``--device``, default ``cuda``; ``cpu`` runs the
kernels' plain versions).

Usage:
  python -m graphcast_lite_torch.cli.train_regional <exp_dir> \\
      --head dual_mesh --roi 50 60 80 100 [--data-dir D] \\
      [--reg-level 3] [--epochs 20] [--overfit-test] [--evaluate]
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from ..graphs.structure import Graph
from ..models.dual_mesh import RegionalDeviceGraphs, dual_mesh_forward
from ..models.roi_residual import roi_residual_forward
from ..models.weather import ModelGraphs, WeatherModel
from ..ops.fused_edge import training_trace
from ..training.loss import weighted_mse

__all__ = ["RegionalModel", "build_head", "head_step", "main"]

HEADS = ("dual_mesh", "roi_residual")


class RegionalModel(nn.Module):
    """The frozen global model composed with a regional head.

    ``forward(x [G, obs·C], graphs=None, edge_mask=None) -> (delta [G, C],
    edge_mask)``: the global prediction with the head's correction added
    on the ROI rows, the signature ``inference.predict.evaluate_model``
    serves (``graphs`` is ignored: the model carries its own).  The
    global parameters need no gradient.  The graphs are kept on the host
    and moved with the module (``to``), cast to its floating dtype."""

    def __init__(self, global_model: WeatherModel, global_graphs: ModelGraphs,
                 head: nn.Module, head_graphs: Union[RegionalDeviceGraphs,
                                                     Graph],
                 roi_idx: torch.Tensor):
        super().__init__()
        self.global_model = global_model.requires_grad_(False)
        self.head = head
        self.kind = ("dual_mesh" if isinstance(head_graphs,
                                               RegionalDeviceGraphs)
                     else "roi_residual")
        self._host_graphs = (global_graphs.to("cpu"), head_graphs.to("cpu"))
        self.register_buffer("roi_idx", roi_idx.to(torch.int64),
                             persistent=False)
        self._place_graphs()

    def _place_graphs(self):
        p = next(self.head.parameters())
        self.global_graphs, self.head_graphs = (
            g.to(p.device, p.dtype) for g in self._host_graphs)

    def _apply(self, fn, *args, **kwargs):
        out = super()._apply(fn, *args, **kwargs)
        self._place_graphs()
        return out

    def _global(self, x):
        pred, _, grid_latent, mesh_latent = self.global_model(
            x, self.global_graphs, with_latents=True)
        return pred, grid_latent, mesh_latent

    def forward(self, x: torch.Tensor, graphs=None,
                edge_mask: Optional[torch.Tensor] = None):
        if self.kind == "dual_mesh":
            out = dual_mesh_forward(
                self._global,
                lambda rr, rl, ml: self.head(rr, rl, ml, self.head_graphs),
                x, self.head_graphs)
        else:
            out = roi_residual_forward(self._global, self.head, x,
                                       self.roi_idx, self.head_graphs)
        return out, edge_mask

    def loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The ROI-only weighted MSE of the composed prediction."""
        out, _ = self(x)
        return weighted_mse(out.index_select(0, self.roi_idx),
                            y.index_select(0, self.roi_idx))


def build_head(kind: str, gs, roi, num_features: int, obs_window: int,
               latent_dim: int, hidden: int = 256, reg_level: int = 7,
               global_level: Optional[int] = None,
               processor_steps: Optional[int] = None, roi_k: int = 8):
    """(head module, its graphs, roi_idx [n_roi] int64) of a ``kind`` head
    over the global graph set ``gs`` (fp32, on the host, weights from a
    generator seeded with 1, as the JAX package's CLI inits its head from
    ``PRNGKey(1)``).  ``global_level`` defaults to the finest level of
    ``gs``'s mesh."""
    from ..graphs.regional import build_regional_graphs, build_roi_knn_graph
    from ..models.dual_mesh import DualMeshRegional
    from ..models.roi_residual import ROIResidualModule

    gen = torch.Generator().manual_seed(1)
    c, raw = num_features, obs_window * num_features
    if kind == "dual_mesh":
        rg = build_regional_graphs(
            gs.mesh_lat, gs.mesh_lon, gs.grid_lat, gs.grid_lon, tuple(roi),
            reg_mesh_level=reg_level,
            global_level=(global_level if global_level is not None
                          else len(gs.meshes) - 1))
        head = DualMeshRegional(raw, latent_dim, hidden, c,
                                processor_steps or 4, generator=gen)
        graphs = RegionalDeviceGraphs.from_host(rg, gs.num_grid_nodes)
        return head, graphs, graphs.roi_idx
    if kind != "roi_residual":
        raise ValueError(f"unknown head {kind!r} (one of {HEADS})")
    roi_mask, graph = build_roi_knn_graph(gs.grid_lat, gs.grid_lon,
                                          tuple(roi), k=roi_k)
    head = ROIResidualModule(raw, latent_dim, hidden, c,
                             processor_steps or 6, generator=gen)
    return head, graph, torch.from_numpy(np.flatnonzero(roi_mask))


def head_step(model: RegionalModel, optimizer: torch.optim.Optimizer,
              x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One Adam step of the head on the ROI loss of (x, y), inside
    ``training_trace()``; returns the loss before the update."""
    with training_trace():
        loss = model.loss(x, y)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    optimizer.step()
    return loss.detach()


def _restore(module: nn.Module, path: str, what: str) -> bool:
    from ..training import checkpoint as ckpt_lib

    if not os.path.exists(path):
        return False
    module.load_state_dict(ckpt_lib.load_params(path))
    print(f"[regional] loaded {what} from {path}")
    return True


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("exp_dir", help="global experiment dir (config.json "
                        "+ best_model.pt or the JAX package's "
                        "best_model.msgpack)")
    parser.add_argument("--head", choices=list(HEADS), default="dual_mesh")
    parser.add_argument("--roi", type=float, nargs=4, required=True,
                        metavar=("LAT_MIN", "LAT_MAX", "LON_MIN", "LON_MAX"))
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--out-dir", default=None)
    parser.add_argument("--hidden", type=int, default=256)
    parser.add_argument("--reg-level", type=int, default=7)
    parser.add_argument("--global-level", type=int, default=None,
                        help="global mesh prefix level (default: max "
                        "mesh_levels of the config)")
    parser.add_argument("--processor-steps", type=int, default=None)
    parser.add_argument("--roi-k", type=int, default=8)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--max-steps-per-epoch", type=int, default=None)
    parser.add_argument("--overfit-test", action="store_true",
                        help="run the 1-sample overfit sanity check first")
    parser.add_argument("--evaluate", action="store_true",
                        help="after training (or on a saved head) run AR "
                        "evaluation of the composed model with region "
                        "metrics (~ reference predict_dual_mesh.py)")
    parser.add_argument("--evaluate-only", action="store_true")
    parser.add_argument("--ar-steps", type=int, default=1)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                        "kernels' plain versions)")
    args = parser.parse_args(argv)

    from ..build import build_weather_model, resolve_device
    from ..config import load_experiment_config
    from ..data.dataset import load_chunked_datasets
    from ..training import checkpoint as ckpt_lib

    dev = resolve_device(args.device)
    cfg = load_experiment_config(os.path.join(args.exp_dir, "config.json"))
    data_dir = args.data_dir or cfg.data_dir
    out_dir = args.out_dir or os.path.join(args.exp_dir, f"{args.head}_head")
    os.makedirs(out_dir, exist_ok=True)
    roi = tuple(args.roi)

    train_ds, val_ds, _, meta = load_chunked_datasets(
        data_dir, obs_window=cfg.data.obs_window_used,
        pred_steps=1, n_features=cfg.data.num_features_used,
    )
    c = cfg.data.num_features_used
    obs = cfg.data.obs_window_used

    # Frozen global model.
    model, graphs, gs = build_weather_model(cfg, meta, device=dev)
    if not any(_restore(model, os.path.join(args.exp_dir, name),
                        "global params")
               for name in ("best_model.pt", "best_model.msgpack")):
        print("[regional] WARNING: no global checkpoint; frozen random init")

    head, head_graphs, roi_idx = build_head(
        args.head, gs, roi, c, obs, model.latent_dim, hidden=args.hidden,
        reg_level=args.reg_level,
        global_level=args.global_level or max(cfg.graph.mesh_levels),
        processor_steps=args.processor_steps, roi_k=args.roi_k)
    composed = RegionalModel(model, graphs, head.to(dev), head_graphs,
                             roi_idx).to(dev)
    n_params = sum(p.numel() for p in head.parameters())
    print(f"[regional] {args.head} head: {n_params:,} trainable params, "
          f"{roi_idx.numel()} ROI nodes")

    def batch(ds, i):
        x, y = ds.get(i)
        return (torch.from_numpy(x).to(dev),
                torch.from_numpy(y.reshape(-1, 1, c)[:, 0, :]).to(dev))

    head_path = os.path.join(out_dir, "regional_head.pt")

    def run_evaluation():
        from ..inference.predict import evaluate_model

        _, _, eval_ds, _ = load_chunked_datasets(
            data_dir, obs_window=obs, pred_steps=max(args.ar_steps, 1),
            n_features=c,
        )
        report = evaluate_model(
            composed, None, eval_ds, meta, ar_steps=args.ar_steps,
            use_residual=cfg.use_residual,
            static_channels=tuple(cfg.static_channels),
            forcing_channels=tuple(cfg.forcing_channels),
            region=roi, device=dev,
        )
        print(report.summary())
        return report

    if args.evaluate_only:
        _restore(head, head_path, "head") or _restore(
            head, head_path.replace(".pt", ".msgpack"), "head")
        return run_evaluation()

    opt = torch.optim.Adam(head.parameters(), lr=args.lr)
    if args.overfit_test:
        saved = copy.deepcopy(head.state_dict())
        x0, y0 = batch(train_ds, 0)
        trial = torch.optim.Adam(head.parameters(), lr=args.lr)
        with torch.no_grad():
            l0 = composed.loss(x0, y0).item()
        for _ in range(100):
            loss = head_step(composed, trial, x0, y0).item()
        print(f"[overfit-test] loss {l0:.5f} -> {loss:.5f} "
              f"({'OK' if loss < l0 * 0.5 else 'WEAK'}) "
              "(weights discarded)")
        head.load_state_dict(saved)

    best = float("inf")
    for epoch in range(args.epochs):
        total, nb = 0.0, 0
        for i in range(len(train_ds)):
            if args.max_steps_per_epoch and i >= args.max_steps_per_epoch:
                break
            total += head_step(composed, opt, *batch(train_ds, i)).item()
            nb += 1
        vtotal, vn = 0.0, 0
        with torch.no_grad():
            for i in range(len(val_ds)):
                vtotal += composed.loss(*batch(val_ds, i)).item()
                vn += 1
        v = vtotal / max(vn, 1)
        print(f"[epoch {epoch + 1}] train={total / max(nb, 1):.5f} "
              f"val={v:.5f}")
        if v < best:
            best = v
            ckpt_lib.save_params(head_path, head)
    print(f"[done] best val {best:.5f}; head saved in {out_dir}")
    if args.evaluate:
        return run_evaluation()
    return None


if __name__ == "__main__":
    main()
