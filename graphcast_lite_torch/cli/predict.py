"""Inference/evaluation CLI: ``python -m graphcast_lite_torch.cli.predict``.

AR rollout over the test split on the card, with persistence-skill
streaming metrics, per-horizon / per-channel (physical units) tables,
region metrics, optional data assimilation with simulated sparse station
observations (nudging on the host; optimal interpolation solves on
``--device``) and raw predictions export.

The checkpoint is a ``.pt`` state dict (``cli.train`` writes
``best_model.pt``) or the JAX package's ``.msgpack`` params, read without
flax; one whose structure differs from the config's model is restored
non-strictly (the matching entries; missing / mismatched reported).  A
SparseGAT model is served on the processing graph's own edge mask (the
params file holds no pruned mask), as the JAX package's CLI serves it.

Examples:
  predict <exp_dir> --data-dir D --ar-steps 4 --per-channel
  predict <exp_dir> --data-dir D --dtype bf16 --region 50 60 80 100
  predict <exp_dir> --data-dir D --checkpoint best_model.msgpack
  predict <exp_dir> --data-dir D --rollouts-per-dispatch 4
  predict <exp_dir> --data-dir D --device cpu
  predict <exp_dir> --data-dir D --da nudging --da-alpha 0.5 \\
      --obs-sparsity 0.1 --region 50 60 80 100
  predict <exp_dir> --data-dir D --da oi --obs-roi-only \\
      --region 20 60 60 140 --oi-length-km 150 --oi-sigma-o 0.5
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def da_hook(args, test_ds, meta, device):
    """The ``--da`` assimilator: per sample, sparse station observations
    regenerated from that sample's ground truth, assimilated by nudging
    or by optimal interpolation (solved on ``device``).  Sample i's hook
    is made at its AR step 0, so it follows ``evaluate_model``'s order."""
    from ..assimilation.observations import make_sparse_observations
    from ..inference.predict import region_node_mask

    region = tuple(args.region) if args.region else None
    roi_for_obs = None
    if args.obs_roi_only:
        roi_for_obs = region_node_mask(meta, region, args.boundary_width)

    c = meta.num_features
    if args.da == "nudging":
        from ..assimilation.nudging import NudgingAssimilator

        da_obj = NudgingAssimilator(alpha=args.da_alpha)
    else:
        from ..assimilation.optimal_interpolation import OptimalInterpolation

        lats, lons = meta.coordinates
        roi_idx = None
        if roi_for_obs is not None:
            roi_idx = np.flatnonzero(roi_for_obs)
        da_obj = OptimalInterpolation(
            lats, lons, args.oi_sigma_b, args.oi_sigma_o,
            args.oi_length_km * 1000.0, flat_grid=meta.flat_grid,
            roi_idx=roi_idx, device=device,
        )

    state = {"i": -1, "hook": None}

    def assimilator(out, step):
        if step == 0:
            state["i"] += 1
            _, y = test_ds.get(state["i"])
            truth = y.reshape(-1, y.shape[-1] // c, c)
            obs = make_sparse_observations(
                truth, args.obs_sparsity, roi_for_obs,
                args.obs_channels, args.obs_seed,
            )
            state["hook"] = da_obj.make_step_hook(obs, args.da_steps)
        return state["hook"](out, step)

    return assimilator


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("exp_dir")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--checkpoint", default=None,
                        help="params: a .pt state dict or the JAX "
                        "package's .msgpack (default <exp_dir>/"
                        "best_model.pt, then best_model.msgpack)")
    parser.add_argument("--ar-steps", type=int, default=None)
    parser.add_argument("--split", default="test_only",
                        choices=["test_only", "val", "test", "train", "all"])
    parser.add_argument("--max-samples", type=int, default=None)
    parser.add_argument("--region", type=float, nargs=4, default=None,
                        metavar=("LAT_MIN", "LAT_MAX", "LON_MIN", "LON_MAX"))
    parser.add_argument("--boundary-width", type=int, default=0)
    parser.add_argument("--per-channel", action="store_true")
    parser.add_argument("--save-preds", default=None)
    parser.add_argument("--report-json", default=None)
    parser.add_argument("--rollouts-per-dispatch", type=int, default=1,
                        help="amortized serve: K samples' whole "
                        "trajectories as one batched rollout (no --da, "
                        "one-step models)")
    # Data assimilation.
    parser.add_argument("--da", choices=["none", "nudging", "oi"],
                        default="none")
    parser.add_argument("--da-alpha", type=float, default=0.25)
    parser.add_argument("--da-steps", type=int, default=None,
                        help="assimilate only the first k AR steps")
    parser.add_argument("--obs-sparsity", type=float, default=0.1)
    parser.add_argument("--obs-roi-only", action="store_true")
    parser.add_argument("--obs-channels", type=int, nargs="*", default=None)
    parser.add_argument("--obs-seed", type=int, default=0)
    parser.add_argument("--oi-sigma-b", type=float, default=1.0)
    parser.add_argument("--oi-sigma-o", type=float, default=0.5)
    parser.add_argument("--oi-length-km", type=float, default=150.0)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                        "kernels' plain versions)")
    parser.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"],
                        help="params and float graph arrays in this dtype")
    parser.add_argument("--seed", type=int, default=0,
                        help="random-init seed when there is no checkpoint")
    args = parser.parse_args(argv)

    from ..build import build_weather_model, config_direct_steps
    from ..config import GridExperimentConfig, load_experiment_config
    from ..data.dataset import load_chunked_datasets
    from ..inference.predict import evaluate_model
    from ..training import checkpoint as ckpt_lib

    cfg = load_experiment_config(os.path.join(args.exp_dir, "config.json"))
    if isinstance(cfg, GridExperimentConfig):
        parser.error(f"{args.exp_dir} holds a U-Net / downscaler config; "
                     "use cli.train_unet or cli.train_downscaler")
    data_dir = args.data_dir or cfg.data_dir
    ar_steps = args.ar_steps or cfg.max_ar_steps

    _, _, test_ds, meta = load_chunked_datasets(
        data_dir,
        obs_window=cfg.data.obs_window_used,
        pred_steps=max(cfg.data.pred_window_used, ar_steps),
        n_features=cfg.data.num_features_used,
        test_split=args.split,
    )
    model, graphs, _ = build_weather_model(cfg, meta, device=args.device,
                                           seed=args.seed)
    ckpt = args.checkpoint
    if ckpt is None:
        candidates = [os.path.join(args.exp_dir, name)
                      for name in ("best_model.pt", "best_model.msgpack")]
        ckpt = next((p for p in candidates if os.path.exists(p)),
                    candidates[0])
    if os.path.exists(ckpt):
        state = ckpt_lib.load_params(ckpt)
        try:
            model.load_state_dict(state)
            print(f"[predict] loaded {ckpt}")
        except RuntimeError:
            # Structure changed (e.g. a pruned-mesh rebuild of a global
            # checkpoint): restore the matching entries.
            report = ckpt_lib.partial_restore(model, state)
            print(f"[predict] non-strict restore from {ckpt} "
                  f"(missing={len(report['missing'])}, "
                  f"mismatched={len(report['mismatched'])})")
    else:
        print(f"[predict] WARNING: no checkpoint at {ckpt}; "
              f"evaluating random init (seed {args.seed})")

    assimilator = None
    if args.da != "none":
        assimilator = da_hook(args, test_ds, meta, args.device)

    scalers = np.load(os.path.join(data_dir, "scalers.npz"))
    report = evaluate_model(
        model, graphs, test_ds, meta,
        ar_steps=ar_steps,
        use_residual=cfg.use_residual,
        static_channels=tuple(cfg.static_channels),
        forcing_channels=tuple(cfg.forcing_channels),
        max_samples=args.max_samples,
        region=tuple(args.region) if args.region else None,
        boundary_width=args.boundary_width or cfg.boundary_mask_width,
        assimilator=assimilator,
        scalers_std=scalers["std"] if args.per_channel else None,
        save_predictions=args.save_preds,
        direct_steps=config_direct_steps(cfg),
        rollouts_per_dispatch=args.rollouts_per_dispatch,
        device=args.device,
        dtype=args.dtype,
    )
    print(report.summary())
    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump(report.to_json(), f, indent=1)
        print(f"[predict] report -> {args.report_json}")


if __name__ == "__main__":
    main()
