"""Per-pixel metric maps and comparison figures (a NumPy copy of
``graphcast_lite_tpu.inference.maps``; matplotlib is imported only by the
plotting functions).

~ reference ``scripts/metrics_maps.py`` (per-pixel RMSE/MAE/BIAS/ACC maps
from a saved predictions file), ``plot_region_multires.py`` (scatter maps
for flat grids) and the comparison figure scripts.  Matplotlib with the Agg
backend; every function can also return the raw metric fields without
plotting.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = [
    "pixel_metrics",
    "plot_metric_maps",
    "plot_flat_scatter",
    "extract_field",
    "plot_compare_algos",
    "plot_diff",
    "plot_triad",
    "plot_final_trio",
]


def pixel_metrics(
    predictions: np.ndarray,     # [N, G, C] or [N, G, P·C]
    ground_truth: np.ndarray,
    num_channels: int,
) -> Dict[str, np.ndarray]:
    """Per-node metrics over the sample axis: RMSE, MAE, BIAS [G, C]
    (horizons pooled per channel) and temporal ACC [G, C]."""
    n, g, cp = predictions.shape
    p = cp // num_channels
    pr = predictions.reshape(n, g, p, num_channels)
    gt = ground_truth.reshape(n, g, p, num_channels)
    err = pr - gt
    rmse = np.sqrt((err**2).mean(axis=(0, 2)))
    mae = np.abs(err).mean(axis=(0, 2))
    bias = err.mean(axis=(0, 2))
    pa = pr - pr.mean(axis=0, keepdims=True)
    ga = gt - gt.mean(axis=0, keepdims=True)
    denom = (
        np.sqrt((pa**2).sum(axis=0)) * np.sqrt((ga**2).sum(axis=0)) + 1e-9
    )
    acc = ((pa * ga).sum(axis=0) / denom).mean(axis=1)
    return {"rmse": rmse, "mae": mae, "bias": bias, "acc": acc}


def plot_metric_maps(
    metrics: Dict[str, np.ndarray],
    lats: np.ndarray,
    lons: np.ndarray,
    channel: int,
    out_path: str,
    title: str = "",
) -> str:
    """4-panel (RMSE/MAE/BIAS/ACC) map figure for one channel."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(12, 6), constrained_layout=True)
    panels = [("rmse", "RMSE"), ("mae", "MAE"), ("bias", "BIAS"),
              ("acc", "ACC")]
    for ax, (key, label) in zip(axes.ravel(), panels):
        field = metrics[key][:, channel].reshape(len(lats), len(lons))
        cmap = "coolwarm" if key == "bias" else "viridis"
        im = ax.pcolormesh(lons, lats, field, cmap=cmap, shading="auto")
        ax.set_title(f"{label} {title}")
        fig.colorbar(im, ax=ax, shrink=0.85)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def plot_flat_scatter(
    values: np.ndarray,            # [G]
    node_lats: np.ndarray,
    node_lons: np.ndarray,
    out_path: str,
    title: str = "",
    is_regional: Optional[np.ndarray] = None,
) -> str:
    """Scatter map for flat multires grids (point size marks resolution)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 5), constrained_layout=True)
    size = np.full(len(values), 6.0)
    if is_regional is not None:
        size = np.where(is_regional, 2.0, 6.0)
    sc = ax.scatter(node_lons, node_lats, c=values, s=size, cmap="viridis")
    ax.set_title(title)
    ax.set_xlabel("lon")
    ax.set_ylabel("lat")
    fig.colorbar(sc, ax=ax, shrink=0.85)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


# ------------------------------------------------------ comparison figures
def extract_field(
    preds: np.ndarray,            # [N, G, P·C] (the saved-predictions layout)
    sample: int,
    step: int,
    channel: int,
    num_channels: int,
    n_lat: int,
    n_lon: int,
    mean: float = 0.0,
    std: float = 1.0,
) -> np.ndarray:
    """One denormalized [n_lat, n_lon] map from a predictions array
    (reference plot_compare_algos.py get_map; lat-major here — the
    framework's single node order, see training/loss.py)."""
    n, g, pc = preds.shape
    p = pc // num_channels
    fld = preds.reshape(n, g, p, num_channels)[sample, :, step, channel]
    return (fld * std + mean).reshape(n_lat, n_lon)


def _imshow_panel(ax, fig, field, lats, lons, title, cmap="RdYlBu_r",
                  vmin=None, vmax=None):
    im = ax.pcolormesh(lons, lats, field, cmap=cmap, shading="auto",
                       vmin=vmin, vmax=vmax)
    ax.set_title(title, fontsize=10)
    fig.colorbar(im, ax=ax, shrink=0.8)
    return im


def plot_compare_algos(
    truth: np.ndarray,                     # [n_lat, n_lon]
    algo_fields: Dict[str, np.ndarray],    # name -> [n_lat, n_lon]
    lats: np.ndarray,
    lons: np.ndarray,
    out_path: str,
    title: str = "",
) -> str:
    """Truth + one panel per algorithm on a shared color scale, plus an
    error row (~ reference scripts/plot_compare_algos.py: truth vs
    nudge vs OI maps with per-algo headline numbers in the titles — pass
    them inside the dict keys)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = list(algo_fields)
    ncol = 1 + len(names)
    fig, axes = plt.subplots(2, ncol, figsize=(4.2 * ncol, 6),
                             constrained_layout=True)
    if ncol == 1:
        axes = axes.reshape(2, 1)
    allv = np.concatenate([truth.ravel()] +
                          [f.ravel() for f in algo_fields.values()])
    vmin, vmax = np.percentile(allv, [1, 99])
    _imshow_panel(axes[0, 0], fig, truth, lats, lons, f"truth {title}",
                  vmin=vmin, vmax=vmax)
    axes[1, 0].axis("off")
    errs = {k: f - truth for k, f in algo_fields.items()}
    emax = max(np.abs(e).max() for e in errs.values()) or 1.0
    for j, name in enumerate(names, start=1):
        _imshow_panel(axes[0, j], fig, algo_fields[name], lats, lons, name,
                      vmin=vmin, vmax=vmax)
        _imshow_panel(axes[1, j], fig, errs[name], lats, lons,
                      f"{name} − truth", cmap="coolwarm",
                      vmin=-emax, vmax=emax)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def plot_diff(
    truth: np.ndarray,
    base: np.ndarray,
    exp: np.ndarray,
    lats: np.ndarray,
    lons: np.ndarray,
    out_path: str,
    labels: Sequence[str] = ("base", "experiment"),
    title: str = "",
) -> str:
    """4-panel truth / base / experiment / (experiment − base) figure
    (~ reference scripts/plot_diff.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(11, 7), constrained_layout=True)
    allv = np.concatenate([truth.ravel(), base.ravel(), exp.ravel()])
    vmin, vmax = np.percentile(allv, [1, 99])
    _imshow_panel(axes[0, 0], fig, truth, lats, lons, f"truth {title}",
                  vmin=vmin, vmax=vmax)
    _imshow_panel(axes[0, 1], fig, base, lats, lons, labels[0],
                  vmin=vmin, vmax=vmax)
    _imshow_panel(axes[1, 0], fig, exp, lats, lons, labels[1],
                  vmin=vmin, vmax=vmax)
    d = exp - base
    dmax = np.abs(d).max() or 1.0
    _imshow_panel(axes[1, 1], fig, d, lats, lons,
                  f"{labels[1]} − {labels[0]}", cmap="coolwarm",
                  vmin=-dmax, vmax=dmax)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def plot_triad(
    truth: np.ndarray,
    pred: np.ndarray,
    lats: np.ndarray,
    lons: np.ndarray,
    out_path: str,
    title: str = "",
) -> str:
    """truth / prediction / error triad (~ reference scripts/plot_triad.py,
    plot_final_trio.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(14, 3.6), constrained_layout=True)
    allv = np.concatenate([truth.ravel(), pred.ravel()])
    vmin, vmax = np.percentile(allv, [1, 99])
    _imshow_panel(axes[0], fig, truth, lats, lons, f"truth {title}",
                  vmin=vmin, vmax=vmax)
    _imshow_panel(axes[1], fig, pred, lats, lons, f"prediction {title}",
                  vmin=vmin, vmax=vmax)
    err = pred - truth
    emax = np.abs(err).max() or 1.0
    _imshow_panel(axes[2], fig, err, lats, lons, "error", cmap="coolwarm",
                  vmin=-emax, vmax=emax)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def plot_final_trio(
    truth: np.ndarray,
    pred_base: np.ndarray,
    pred_best: np.ndarray,
    lats: np.ndarray,
    lons: np.ndarray,
    out_path: str,
    labels=("control", "best"),
    title: str = "",
) -> str:
    """Truth / control forecast / best forecast side by side on a shared
    scale (~ reference scripts/plot_final_trio.py: the presentation's
    final-shot figure comparing the baseline and the improved pipeline
    against ERA5 truth at one horizon)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(14, 3.6), constrained_layout=True)
    allv = np.concatenate(
        [truth.ravel(), pred_base.ravel(), pred_best.ravel()]
    )
    vmin, vmax = np.percentile(allv, [1, 99])
    _imshow_panel(axes[0], fig, truth, lats, lons, f"truth {title}",
                  vmin=vmin, vmax=vmax)
    rmse_b = float(np.sqrt(np.mean((pred_base - truth) ** 2)))
    rmse_x = float(np.sqrt(np.mean((pred_best - truth) ** 2)))
    _imshow_panel(axes[1], fig, pred_base, lats, lons,
                  f"{labels[0]} (RMSE {rmse_b:.2f})", vmin=vmin, vmax=vmax)
    _imshow_panel(axes[2], fig, pred_best, lats, lons,
                  f"{labels[1]} (RMSE {rmse_x:.2f})", vmin=vmin, vmax=vmax)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
