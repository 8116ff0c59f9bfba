"""Downscaler (coarse→fine) training CLI:
``python -m graphcast_lite_torch.cli.train_downscaler <out_dir>``.

Learns the coarse→fine refinement from (bilinearly upsampled coarse, fine
truth) pairs built by ``data.etl.build_downscaler_dataset``.  With
obs_window 1 and residual learning the shared engine's output is
``coarse_upsampled + delta``: the cascade refinement.  ``--gnn-input``
trains on a frozen GNN's predictions instead of truth-derived coarse
fields (the ``gnn_pred.npy`` memmap of ``cli.generate_predictions``),
``--spectral-weight`` / ``--gradient-weight`` add the FFT and Sobel
sharpness losses.  The run ends with the validation RMSE against the
bilinear baseline (skill), computed with the trained model on the device.
``--device`` defaults to ``cuda`` and raises without a card unless
``cpu``.

Usage:
  python -m graphcast_lite_torch.cli.train_downscaler <out_dir> \\
      --data-dir <downscaler_dataset> [--gnn-input gnn_pred.npy] ...
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("out_dir")
    parser.add_argument("--data-dir", required=True,
                        help="dir from build_downscaler_dataset "
                        "(X_coarse.npy / Y_fine.npy)")
    parser.add_argument(
        "--config", default=None,
        help="reference-style flat downscaler config.json; its fields "
        "become defaults",
    )
    parser.add_argument("--gnn-input", default=None,
                        help="optional gnn_pred.npy to use as inputs")
    parser.add_argument("--base-filters", type=int, default=48)
    parser.add_argument("--epochs", type=int, default=60)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--spectral-weight", type=float, default=0.0)
    parser.add_argument("--gradient-weight", type=float, default=0.0)
    parser.add_argument("--test-fraction", type=float, default=0.2)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--max-steps-per-epoch", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for a run "
                        "without a card)")
    args = parser.parse_args(argv)

    if args.config:
        from ..config import GridExperimentConfig, load_experiment_config

        gc = load_experiment_config(args.config)
        if not isinstance(gc, GridExperimentConfig):
            parser.error(f"{args.config} is a GNN experiment config")
        args.base_filters = gc.base_filters
        args.epochs = gc.num_epochs
        args.lr = gc.learning_rate
        args.spectral_weight = gc.spectral_weight
        args.gradient_weight = gc.gradient_weight
        args.batch_size = gc.batch_size

    import torch

    from ..build import resolve_device
    from ..config import DataConfig, ExperimentConfig, to_dict
    from ..data.dataset import DatasetMetadata
    from ..data.legacy_pt import ArrayDataset
    from ..models.grid_adapter import GridImageModel
    from ..models.unet import DownscalerUNet
    from ..training.loss import image_extra_loss
    from ..training.optim import ClippedAdamW
    from ..training.trainer import Trainer

    device = resolve_device(args.device)
    with open(os.path.join(args.data_dir, "dataset_info.json")) as f:
        info = json.load(f)
    t, h, w, c = info["n_time"], info["n_lat"], info["n_lon"], info["n_feat"]
    x = np.memmap(os.path.join(args.data_dir, "X_coarse.npy"), np.float16,
                  "r", shape=(t, h, w, c))
    y = np.memmap(os.path.join(args.data_dir, "Y_fine.npy"), np.float16,
                  "r", shape=(t, h, w, c))
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    if args.gnn_input:
        with open(args.gnn_input + ".json") as f:
            gmeta = json.load(f)
        gp = np.memmap(args.gnn_input, np.float16, "r",
                       shape=(gmeta["n_samples"], gmeta["n_nodes"],
                              gmeta["n_feat"]))
        n = min(len(gp), t)
        x = np.asarray(gp[:n], np.float32).reshape(n, h, w, c)
        y = y[:n]
        t = n
        print(f"[downscaler] training on frozen-GNN inputs ({n} samples)")

    # Normalize with the fine grid's scalers.
    scl = np.load(os.path.join(args.data_dir, "scalers.npz"))
    mean, std = scl["mean"][:c], scl["std"][:c]
    x = (x - mean) / std
    y = (y - mean) / std

    g = h * w
    xs = x.reshape(t, g, c)
    ys = y.reshape(t, g, c)
    split = int(t * (1 - args.test_fraction))
    n_val = max((t - split) // 2, 1)
    train_ds = ArrayDataset(xs[:split], ys[:split], 1, c)
    val_ds = ArrayDataset(xs[split:split + n_val], ys[split:split + n_val],
                          1, c)

    coords = np.load(os.path.join(args.data_dir, "coords.npz"))
    meta = DatasetMetadata(
        flattened=True, num_latitudes=h, num_longitudes=w, num_features=c,
        obs_window=1, pred_window=1, num_grid_nodes=g,
        coordinates=(coords["latitude"], coords["longitude"]),
    )
    cfg = ExperimentConfig(
        batch_size=args.batch_size, learning_rate=args.lr,
        num_epochs=args.epochs, max_ar_steps=1,
        static_channels=info.get("static_channels", []),
        data=DataConfig(dataset_name="downscaler", num_features_used=c,
                        obs_window_used=1, pred_window_used=1,
                        want_feats_flattened=True),
        data_dir=args.data_dir,
    )
    model = GridImageModel(DownscalerUNet(c, c, args.base_filters), h, w)
    steps = max(split // args.batch_size, 1)
    opt = ClippedAdamW(model.parameters(), args.lr, args.epochs * steps)
    extra = image_extra_loss(h, w, c, args.spectral_weight,
                             args.gradient_weight)

    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "config.json"), "w") as f:
        json.dump(to_dict(cfg), f, indent=1)
    trainer = Trainer(model, None, cfg, meta, args.out_dir, optimizer=opt,
                      extra_loss_fn=extra, device=device)
    state = trainer.init_state(seed=cfg.random_seed)
    trainer.fit(state, train_ds, val_ds,
                max_steps_per_epoch=args.max_steps_per_epoch)

    # Skill against the bilinear-coarse baseline (the reference's headline
    # metric).
    base_rmse = float(np.sqrt(np.mean(
        (xs[split:split + n_val] - ys[split:split + n_val]) ** 2
    )))
    net = trainer.final_state.model.eval()
    errs = []
    with torch.no_grad():
        for i in range(len(val_ds)):
            xv, yv = val_ds.get(i)
            xb = torch.as_tensor(xv, device=device)
            pred = xb + net(xb)[0]
            errs.append(torch.mean(torch.square(
                pred - torch.as_tensor(yv, device=device))).item())
    rmse = float(np.sqrt(np.mean(errs)))
    skill = 1 - rmse / (base_rmse + 1e-12)
    print(f"[downscaler] val RMSE {rmse:.4f} vs bilinear {base_rmse:.4f} "
          f"-> skill {skill * 100:.1f}%")
    return {"rmse": rmse, "bilinear_rmse": base_rmse, "skill": skill}


if __name__ == "__main__":
    main()
