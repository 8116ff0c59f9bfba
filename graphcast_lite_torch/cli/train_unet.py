"""U-Net training CLI (the CNN regional stack):
``python -m graphcast_lite_torch.cli.train_unet <out_dir>``.

``--arch v1`` trains ``WeatherUNet``, ``v2`` ``WeatherUNetV2``, both
through the shared ``Trainer`` / rollout / evaluation engine by way of
``GridImageModel``, with global-norm clipping (1.0) and AdamW at a cosine
decay over ``epochs × steps per epoch`` (``training.optim.ClippedAdamW``)
and, where their weights are positive, the spectral (FFT amplitude) and
Sobel gradient loss terms.  ``--config`` reads the reference's flat U-Net
``config.json`` (its fields become the defaults; a positive spectral or
gradient weight selects v2).  ``--device`` defaults to ``cuda`` and
raises without a card unless ``cpu``.

Usage:
  python -m graphcast_lite_torch.cli.train_unet <out_dir> --data-dir D \\
      [--arch v1|v2] [--base-filters 64] [--epochs 40] [--max-ar 2] \\
      [--spectral-weight 0.05] [--gradient-weight 0.05] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("out_dir")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument(
        "--config", default=None,
        help="reference-style flat U-Net config.json; its fields become "
        "the defaults below",
    )
    parser.add_argument("--arch", choices=["v1", "v2"], default="v1")
    parser.add_argument("--base-filters", type=int, default=64)
    parser.add_argument("--obs-window", type=int, default=2)
    parser.add_argument("--max-ar", type=int, default=2)
    parser.add_argument("--n-features", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--spectral-weight", type=float, default=0.0)
    parser.add_argument("--gradient-weight", type=float, default=0.0)
    parser.add_argument("--static-channels", type=int, nargs="*", default=[])
    parser.add_argument("--forcing-channels", type=int, nargs="*", default=[])
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
            parser.error(f"{args.config} is a GNN experiment config; "
                         "use cli.train for it")
        args.data_dir = args.data_dir or gc.data_dir
        args.base_filters = gc.base_filters
        args.obs_window = gc.obs_window
        args.max_ar = gc.max_ar_steps
        args.n_features = gc.num_features
        args.epochs = gc.num_epochs
        args.lr = gc.learning_rate
        args.spectral_weight = gc.spectral_weight
        args.gradient_weight = gc.gradient_weight
        args.static_channels = gc.static_channels
        args.forcing_channels = gc.forcing_channels
        args.batch_size = gc.batch_size
        if gc.spectral_weight > 0 or gc.gradient_weight > 0:
            args.arch = "v2"
    if not args.data_dir:
        parser.error("--data-dir (or a --config with data_dir) is required")

    from ..build import resolve_device
    from ..config import DataConfig, ExperimentConfig, to_dict
    from ..data.dataset import load_chunked_datasets
    from ..models.grid_adapter import GridImageModel
    from ..models.unet import WeatherUNet, WeatherUNetV2
    from ..training.loss import image_extra_loss
    from ..training.optim import ClippedAdamW
    from ..training.trainer import Trainer

    device = resolve_device(args.device)
    train_ds, val_ds, _, meta = load_chunked_datasets(
        args.data_dir, obs_window=args.obs_window, pred_steps=args.max_ar,
        n_features=args.n_features,
    )
    c = meta.num_features
    n_lat, n_lon = meta.num_latitudes, meta.num_longitudes
    if meta.flat_grid:
        raise SystemExit("U-Nets need a regular lat/lon grid")

    cfg = ExperimentConfig(
        batch_size=args.batch_size,
        learning_rate=args.lr,
        num_epochs=args.epochs,
        max_ar_steps=args.max_ar,
        static_channels=list(args.static_channels),
        forcing_channels=list(args.forcing_channels),
        data=DataConfig(
            dataset_name="unet", num_features_used=c,
            obs_window_used=args.obs_window, pred_window_used=args.max_ar,
            want_feats_flattened=True,
        ),
        data_dir=args.data_dir,
    )
    arch = WeatherUNet if args.arch == "v1" else WeatherUNetV2
    model = GridImageModel(arch(args.obs_window * c, c, args.base_filters),
                           n_lat, n_lon)
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    opt = ClippedAdamW(model.parameters(), args.lr,
                       args.epochs * steps_per_epoch)
    extra = image_extra_loss(n_lat, n_lon, c, args.spectral_weight,
                             args.gradient_weight)

    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "config.json"), "w") as f:
        json.dump(to_dict(cfg), f, indent=1)
    trainer = Trainer(model, None, cfg, meta, args.out_dir, optimizer=opt,
                      extra_loss_fn=extra, device=device)
    state = trainer.init_state(seed=cfg.random_seed)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"[model] U-Net {args.arch}, base {args.base_filters}, "
          f"{n_lat}x{n_lon} grid, {n_params:,} parameters")
    trainer.fit(state, train_ds, val_ds,
                max_steps_per_epoch=args.max_steps_per_epoch)
    print(f"[done] results in {args.out_dir}")


if __name__ == "__main__":
    main()
