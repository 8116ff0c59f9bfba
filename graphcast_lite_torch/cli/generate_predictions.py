"""Frozen-model predictions over a dataset split as a memmap:
``python -m graphcast_lite_torch.cli.generate_predictions <exp_dir>``.

Runs the trained global model over the training (or any) split and stores
its single-step predictions as ``gnn_pred.npy`` (float16 [N, G, C]) with
``gnn_pred.npy.json`` (``n_samples``, ``n_nodes``, ``n_feat``, ``split``):
the training inputs of the downscaler cascade (``cli.train_downscaler
--gnn-input``), so that it learns on model output, not on truth.  The
params are ``<exp_dir>/best_model.pt``, else the JAX package's
``best_model.msgpack`` (read without flax).  ``--device`` defaults to
``cuda`` and raises without a card unless ``cpu``.

Usage: python -m graphcast_lite_torch.cli.generate_predictions <exp_dir>
           [--data-dir D] [--split train] [--out gnn_pred.npy] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("exp_dir")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--split", default="train",
                        choices=["train", "val", "test", "test_only", "all"])
    parser.add_argument("--out", default=None)
    parser.add_argument("--max-samples", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for a run "
                        "without a card)")
    args = parser.parse_args(argv)

    import torch

    from ..build import build_weather_model
    from ..config import load_experiment_config
    from ..data.dataset import ChunkedTimeseriesDataset, load_chunked_datasets
    from ..training import checkpoint as ckpt_lib

    cfg = load_experiment_config(os.path.join(args.exp_dir, "config.json"))
    data_dir = args.data_dir or cfg.data_dir
    c, obs = cfg.data.num_features_used, cfg.data.obs_window_used

    ds = ChunkedTimeseriesDataset(
        data_dir, obs_window=obs, pred_steps=1, split=args.split,
        n_features=c,
    )
    _, _, _, meta = load_chunked_datasets(data_dir, obs_window=obs,
                                          pred_steps=1, n_features=c)
    model, graphs, gs = build_weather_model(cfg, meta, device=args.device)
    candidates = [os.path.join(args.exp_dir, name)
                  for name in ("best_model.pt", "best_model.msgpack")]
    ckpt = next((p for p in candidates if os.path.exists(p)), None)
    if ckpt is None:
        raise SystemExit(f"no best_model.pt or best_model.msgpack in "
                         f"{args.exp_dir}")
    model.load_state_dict(ckpt_lib.load_params(ckpt))
    model.eval()
    device = next(model.parameters()).device
    g = gs.num_grid_nodes

    n = len(ds)
    if args.max_samples:
        n = min(n, args.max_samples)
    out_path = args.out or os.path.join(data_dir, "gnn_pred.npy")
    mm = np.memmap(out_path, np.float16, "w+", shape=(n, g, c))
    with torch.no_grad():
        for i in range(n):
            x, _ = ds.get(i)
            x = torch.as_tensor(x, dtype=torch.float32, device=device)
            delta, _ = model(x, graphs)
            pred = x.reshape(g, obs, c)[:, -1, :] + delta \
                if cfg.use_residual else delta
            mm[i] = pred.cpu().numpy().astype(np.float16)
            if (i + 1) % 50 == 0:
                print(f"  [{i + 1}/{n}]")
    mm.flush()
    with open(out_path + ".json", "w") as f:
        json.dump({"n_samples": n, "n_nodes": g, "n_feat": c,
                   "split": args.split}, f)
    print(f"[generate] {n} predictions -> {out_path} (from {ckpt})")


if __name__ == "__main__":
    main()
