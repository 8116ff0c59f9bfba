"""Training CLI: ``python -m graphcast_lite_torch.cli.train <exp_dir>``.

The experiment directory contains ``config.json`` (the JAX package's
schema, see ``graphcast_lite_torch.config``); results, logs, checkpoints
and the best model (``best_model.pt``) are written back into it.

  * ``--resume``      continue from <exp_dir>/checkpoint (epoch, curriculum
                      position, optimizer state), written by this package
                      (``state.pt``) or by the JAX package (``state.msgpack``)
  * ``--pretrained``  warm-start from a params file, ``.pt`` or the JAX
                      package's ``.msgpack``, with a non-strict restore
                      (missing/unexpected keys reported)
  * processor freeze + differential LR honored from the config
    (``freeze_processor_epochs`` / ``finetune_processor_lr_factor``)
  * ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
    versions).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("exp_dir", help="experiment directory with config.json")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--pretrained", default=None,
                        help="params file to warm-start from (.pt, or the "
                        "JAX package's .msgpack)")
    parser.add_argument("--data-dir", default=None,
                        help="override config.data_dir")
    parser.add_argument("--max-steps-per-epoch", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                        "kernels' plain versions)")
    args = parser.parse_args(argv)

    from ..build import build_weather_model
    from ..config import GridExperimentConfig, load_experiment_config
    from ..data.dataset import load_chunked_datasets
    from ..training import checkpoint as ckpt_lib
    from ..training.trainer import Trainer

    cfg = load_experiment_config(os.path.join(args.exp_dir, "config.json"))
    if isinstance(cfg, GridExperimentConfig):
        parser.error(f"{args.exp_dir} holds a U-Net / downscaler config; "
                     "use cli.train_unet or cli.train_downscaler")
    data_dir = args.data_dir or cfg.data_dir
    if data_dir is None:
        raise SystemExit("Set data_dir in config.json or pass --data-dir")

    train_ds, val_ds, test_ds, meta = load_chunked_datasets(
        data_dir,
        obs_window=cfg.data.obs_window_used,
        pred_steps=cfg.data.pred_window_used,
        n_features=cfg.data.num_features_used,
    )
    print(f"[data] train={len(train_ds)} val={len(val_ds)} "
          f"test={len(test_ds)} nodes={meta.num_grid_nodes} "
          f"feat={meta.num_features}")

    model, graphs, gs = build_weather_model(cfg, meta, device=args.device)
    print(f"[model] grid={gs.num_grid_nodes} mesh={gs.num_mesh_nodes} "
          f"enc_edges={gs.encoding.num_edges} "
          f"proc_edges={gs.processing.num_edges} "
          f"dec_edges={gs.decoding.num_edges}")

    lr_factor = (
        cfg.finetune_processor_lr_factor
        if cfg.freeze_processor_epochs > 0 else 1.0
    )
    trainer = Trainer(model, graphs, cfg, meta, args.exp_dir,
                      processor_lr_factor=lr_factor, device=args.device)
    state = trainer.init_state(seed=cfg.random_seed)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"[model] parameters: {n_params:,}")

    if args.pretrained:
        ckpt_lib.partial_restore(state.model,
                                 ckpt_lib.load_params(args.pretrained))
        print(f"[pretrained] restored from {args.pretrained}")

    trainer.fit(
        state, train_ds, val_ds, resume=args.resume,
        max_steps_per_epoch=args.max_steps_per_epoch,
    )
    print(f"[done] results in {args.exp_dir}")


if __name__ == "__main__":
    main()
