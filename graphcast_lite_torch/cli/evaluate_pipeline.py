"""Full-pipeline ladder evaluation: model vs DA vs post-processing variants
(torch counterpart of ``graphcast_lite_tpu.cli.evaluate_pipeline``).

~ reference ``scripts/evaluate_full_pipeline.py`` (config list :416-422):
run the AR forecast once per rung of the DA/post-processing ladder and
compare skills side by side:

  raw              plain AR rollout
  +nudging         sequential nudging of simulated station obs
  +oi              optimal interpolation of the same obs (over the whole
                   grid: B is G x G float64 on the host)
  +lapse           t2m lapse-rate adjustment from the z_surf channel
  +mos             station-bias MOS correction of t2m (biases calibrated on
                   a held-out leading slice of the test period)
  +idw             the MOS station biases spread to the whole grid by
                   inverse-distance weighting
  +lapse+mos+idw   the stacked ladder
  +cascade         optional U-Net refinement rung (--unet-exp; the
                   downscaler applied on the same grid, on the card)

The forecasts, the MOS calibration rollouts, the OI solves and the
cascade's U-Net run on ``--device`` (default ``cuda``) in fp32.  The
cascade reads ``<unet-exp>/best_model.pt`` (the port's state dict of a
``DownscalerUNet``, or of ``cli.train_downscaler``'s ``GridImageModel``
around one) or the JAX package's ``best_model.msgpack`` (bare
``DownscalerUNet`` params, as the JAX CLI reads it); an ``image_module``
prefix or level is dropped in both.

Prints a comparison table and writes <exp_dir>/pipeline_eval.json.

Usage:
  python -m graphcast_lite_torch.cli.evaluate_pipeline <exp_dir> \\
      [--data-dir D] [--ar-steps 4] [--obs-sparsity 0.1] [--max-samples 50] \\
      [--t2m-channel 0] [--zsurf-channel 7] [--unet-exp UNET_DIR] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def load_downscaler(unet_exp: str, c: int, device):
    """The cascade rung's ``DownscalerUNet`` (c -> c channels, base filters
    from ``<unet_exp>/config.json``, default 48) with the experiment's
    weights, on ``device``."""
    from ..models.unet import DownscalerUNet
    from ..utils.flax_msgpack import load_msgpack
    from ..utils.params import from_flax_image_params

    with open(os.path.join(unet_exp, "config.json")) as f:
        base_filters = json.load(f).get("base_filters", 48)
    unet = DownscalerUNet(c, c, base_filters)
    pt = os.path.join(unet_exp, "best_model.pt")
    if os.path.exists(pt):
        state = torch.load(pt, map_location="cpu", weights_only=True)
    else:
        state = from_flax_image_params(load_msgpack(
            os.path.join(unet_exp, "best_model.msgpack")))
    prefix = "image_module."
    state = {k[len(prefix):] if k.startswith(prefix) else k: v
             for k, v in state.items()}
    unet.load_state_dict(state)
    return unet.to(device).eval()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("exp_dir")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--ar-steps", type=int, default=None)
    parser.add_argument("--max-samples", type=int, default=50)
    parser.add_argument("--obs-sparsity", type=float, default=0.1)
    parser.add_argument("--da-alpha", type=float, default=0.5)
    parser.add_argument("--oi-length-km", type=float, default=150.0)
    parser.add_argument("--obs-seed", type=int, default=0)
    parser.add_argument("--t2m-channel", type=int, default=0,
                        help="t2m channel index (canonical 19-var order: 0)")
    parser.add_argument("--zsurf-channel", type=int, default=7,
                        help="z_surf channel index (-1 disables +lapse)")
    parser.add_argument("--mos-calibration", type=int, default=10,
                        help="leading test samples used to fit MOS biases "
                        "(excluded from every rung's metrics)")
    parser.add_argument("--idw-radius-km", type=float, default=500.0)
    parser.add_argument("--unet-exp", default=None,
                        help="downscaler experiment dir for the cascade rung")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                        "kernels' plain versions)")
    args = parser.parse_args(argv)

    from ..assimilation.nudging import NudgingAssimilator
    from ..assimilation.observations import make_sparse_observations
    from ..assimilation.optimal_interpolation import OptimalInterpolation
    from ..build import build_weather_model
    from ..config import load_experiment_config
    from ..data.dataset import load_chunked_datasets
    from ..inference.predict import evaluate_model
    from ..inference.regional_pipelines import unet_apply_nhwc
    from ..postprocessing.corrections import (
        apply_lapse_rate,
        geopotential_to_elevation,
        idw_interpolate_bias,
    )
    from ..training import checkpoint as ckpt_lib

    cfg = load_experiment_config(os.path.join(args.exp_dir, "config.json"))
    data_dir = args.data_dir or cfg.data_dir
    ar = args.ar_steps or cfg.max_ar_steps
    c = cfg.data.num_features_used

    _, _, test_ds, meta = load_chunked_datasets(
        data_dir, obs_window=cfg.data.obs_window_used,
        pred_steps=max(cfg.data.pred_window_used, ar), n_features=c,
    )
    model, graphs, gs = build_weather_model(cfg, meta, device=args.device)
    for name in ("best_model.pt", "best_model.msgpack"):
        ckpt = os.path.join(args.exp_dir, name)
        if os.path.exists(ckpt):
            model.load_state_dict(ckpt_lib.load_params(ckpt))
            break
    model.eval()
    device = next(model.parameters()).device

    g = gs.num_grid_nodes
    lats, lons = meta.coordinates
    calib = min(args.mos_calibration, max(len(test_ds) - 2, 0))

    def run(name, assimilator=None, postprocess=None):
        rep = evaluate_model(
            model, graphs, test_ds, meta, ar_steps=ar,
            use_residual=cfg.use_residual,
            static_channels=tuple(cfg.static_channels),
            forcing_channels=tuple(cfg.forcing_channels),
            max_samples=args.max_samples, assimilator=assimilator,
            postprocess=postprocess, skip_samples=calib, device=device,
        )
        print(f"[{name:>15s}] skill={rep.skill * 100:6.2f}% "
              f"rmse={rep.rmse:.6f} acc={rep.acc:.4f}")
        return {"skill": rep.skill, "rmse": rep.rmse, "acc": rep.acc,
                "per_horizon": rep.per_horizon}

    # --- DA hooks (feed back into the AR window) -------------------------
    def per_sample_hook(da_obj):
        state = {"i": -1, "hook": None}

        def hook(out, step):
            if step == 0:
                state["i"] += 1
                _, y = test_ds.get(calib + state["i"])
                truth = y.reshape(-1, y.shape[-1] // c, c)
                obs = make_sparse_observations(
                    truth, args.obs_sparsity, seed=args.obs_seed,
                )
                state["hook"] = da_obj.make_step_hook(obs)
            return state["hook"](out, step)

        return hook

    oi = OptimalInterpolation(
        lats, lons, sigma_b=1.0, sigma_o=0.5,
        length_scale_m=args.oi_length_km * 1000.0, flat_grid=meta.flat_grid,
        device=device,
    )

    # --- post-processing rungs (correct the finished trajectory) ----------
    t2m, zsf = args.t2m_channel, args.zsurf_channel

    sc = np.load(os.path.join(data_dir, "scalers.npz"))
    sc_mean, sc_std = sc["mean"], sc["std"]

    def lapse_pp(pred_flat, _i):
        if zsf < 0 or zsf >= c or t2m >= c:
            return pred_flat
        p = pred_flat.reshape(g, -1, c).copy()
        # Physical-units correction: elevation drift of the z_surf channel
        # over the rollout cools t2m by 6.5 K/km — T_corr = T −
        # lapse·(elev_k − elev_1), the trajectory's FIRST step being the
        # reference elevation.
        z_phys = p[:, :, zsf] * sc_std[zsf] + sc_mean[zsf]
        elev = geopotential_to_elevation(z_phys)
        t2m_phys = p[:, :, t2m] * sc_std[t2m] + sc_mean[t2m]
        corr = apply_lapse_rate(t2m_phys, elev[:, :1], elev)
        p[:, :, t2m] = (corr - sc_mean[t2m]) / sc_std[t2m]
        return p.reshape(pred_flat.shape)

    # MOS calibration: mean per-station, per-horizon t2m bias of the RAW
    # model over the leading `calib` samples (additive (station, horizon)
    # biases + optional IDW spread).
    rs = np.random.RandomState(args.obs_seed)
    n_st = max(int(g * args.obs_sparsity), 2)
    station_idx = rs.choice(g, size=n_st, replace=False)
    station_bias = np.zeros((n_st, ar), np.float64)
    if calib > 0 and t2m < c:
        from ..training.rollout import RolloutSpec, rollout_predict

        spec = RolloutSpec(
            obs_window=cfg.data.obs_window_used, num_features=c,
            use_residual=cfg.use_residual, remat=False,
            static_channels=tuple(cfg.static_channels),
            forcing_channels=tuple(cfg.forcing_channels),
        )

        def model_fn(inp, m, t, p):
            return model(inp, graphs, m)

        cnt = 0
        for i in range(calib):
            x, y = test_ds.get(i)
            p_avail = y.shape[-1] // c
            if p_avail < ar:
                continue
            window = x.reshape(g, -1, c)
            targets = y.reshape(g, p_avail, c)[:, :ar, :]
            with torch.inference_mode():
                preds = rollout_predict(
                    model_fn, torch.from_numpy(window).to(device), ar, spec,
                    forcing=torch.from_numpy(targets).to(device),
                ).cpu().numpy()
            station_bias += (
                targets[station_idx, :, t2m] - preds[station_idx, :, t2m]
            )
            cnt += 1
        if cnt:
            station_bias /= cnt

    def mos_pp(pred_flat, _i):
        p = pred_flat.reshape(g, -1, c).copy()
        s = min(p.shape[1], ar)
        p[station_idx, :s, t2m] += station_bias[:, :s]
        return p.reshape(pred_flat.shape)

    bias_field = idw_interpolate_bias(
        {int(si): station_bias[k] for k, si in enumerate(station_idx)},
        np.asarray(lats if meta.flat_grid else np.repeat(
            lats, len(lons))),
        np.asarray(lons if meta.flat_grid else np.tile(lons, len(lats))),
        ar, max_radius_km=args.idw_radius_km,
    )

    def idw_pp(pred_flat, _i):
        p = pred_flat.reshape(g, -1, c).copy()
        s = min(p.shape[1], ar)
        p[:, :s, t2m] += bias_field[:, :s]
        return p.reshape(pred_flat.shape)

    def stack_pp(*pps):
        def pp(pred_flat, i):
            for f in pps:
                pred_flat = f(pred_flat, i)
            return pred_flat

        return pp

    configs = {
        "raw": {},
        "+nudging": {"assimilator": per_sample_hook(
            NudgingAssimilator(alpha=args.da_alpha))},
        "+oi": {"assimilator": per_sample_hook(oi)},
        "+lapse": {"postprocess": lapse_pp},
        "+mos": {"postprocess": mos_pp},
        "+idw": {"postprocess": idw_pp},
        # mos_pp is deliberately omitted from the stack: the IDW field is
        # built from the station-level MOS corrections, so it already carries
        # the full station bias — stacking mos_pp on top would double-correct
        # station nodes.  The rung name mirrors the reference's ladder label.
        "+lapse+mos+idw": {"postprocess": stack_pp(lapse_pp, idw_pp)},
    }

    # --- optional cascade rung (reference predict_cascade refinement) -----
    if args.unet_exp and not meta.flat_grid:
        uapply = unet_apply_nhwc(load_downscaler(args.unet_exp, c, device),
                                 device)
        h, w = meta.num_latitudes, meta.num_longitudes

        def cascade_pp(pred_flat, _i):
            # The reference's arithmetic: the normalized predictions go in
            # and the U-Net's delta is added (ROADMAP trap 9).
            p = pred_flat.reshape(g, -1, c)
            steps = p.shape[1]
            imgs = np.moveaxis(p.reshape(h, w, steps, c), 2, 0)
            out = imgs + uapply(imgs.astype(np.float32))
            return np.moveaxis(out, 0, 2).reshape(g, steps * c)

        configs["+cascade"] = {"postprocess": cascade_pp}
        configs["+cascade+lapse+mos+idw"] = {
            "postprocess": stack_pp(cascade_pp, lapse_pp, idw_pp)
        }

    results = {}
    for name, kw in configs.items():
        results[name] = run(name, **kw)

    print()
    print(f"{'config':>17s} {'skill':>8s} {'Δ vs raw':>9s} {'rmse':>10s}")
    base = results["raw"]["skill"]
    for name, r in results.items():
        print(f"{name:>17s} {r['skill'] * 100:7.2f}% "
              f"{(r['skill'] - base) * 100:+8.2f}pp {r['rmse']:10.6f}")

    out_path = os.path.join(args.exp_dir, "pipeline_eval.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"\n[evaluate_pipeline] -> {out_path}")
    return results


if __name__ == "__main__":
    main()
