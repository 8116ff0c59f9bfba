"""Diagnostics CLI: checkpoint/graph/scaler sanity checks (torch
counterpart of ``graphcast_lite_tpu.cli.check``).

~ reference diagnostic scripts (SURVEY §4.3):
  * ``weights``  ~ scripts/check_weights.py — missing/unexpected/shape-
    mismatched keys between a saved params file (the port's ``.pt`` state
    dict, or the JAX package's ``.msgpack`` through
    ``utils.params.from_flax_params``) and a freshly built model
  * ``graph``    ~ scripts/check_tf_graph.py — compare the freshly built
    graphs against the graph summary recorded at training time (edge
    counts, degree stats, checksum of edge lists: the bytes of the padded
    int32 sender and receiver arrays, so a summary the JAX package
    recorded matches the port's rebuild)
  * ``scalers``  ~ scripts/compare_scalers.py + check_23f_data.py — compare
    two scalers.npz and validate raw data against its scalers

``weights`` and ``graph`` build the model on ``--device`` (default
``cuda``).

Usage:
  python -m graphcast_lite_torch.cli.check weights <exp_dir> [--data-dir D]
  python -m graphcast_lite_torch.cli.check graph <exp_dir> [--data-dir D]
  python -m graphcast_lite_torch.cli.check scalers <dir_a> [<dir_b>]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import numpy as np


def _int32(a) -> np.ndarray:
    if hasattr(a, "cpu"):
        a = a.cpu().numpy()
    return np.asarray(a, np.int32)


def graph_summary(gs) -> dict:
    def edge_digest(graph):
        h = hashlib.sha256()
        h.update(_int32(graph.senders).tobytes())
        h.update(_int32(graph.receivers).tobytes())
        return h.hexdigest()[:16]

    def degree_stats(graph):
        deg = np.bincount(
            _int32(graph.receivers)[: graph.num_edges],
            minlength=graph.num_receivers,
        )
        return {"min": int(deg.min()), "max": int(deg.max()),
                "mean": round(float(deg.mean()), 3)}

    return {
        "num_grid_nodes": gs.num_grid_nodes,
        "num_mesh_nodes": gs.num_mesh_nodes,
        "encoding_edges": gs.encoding.num_edges,
        "processing_edges": gs.processing.num_edges,
        "decoding_edges": gs.decoding.num_edges,
        "encoding_digest": edge_digest(gs.encoding),
        "processing_digest": edge_digest(gs.processing),
        "decoding_digest": edge_digest(gs.decoding),
        "encoding_degree": degree_stats(gs.encoding),
        "processing_degree": degree_stats(gs.processing),
        "decoding_degree": degree_stats(gs.decoding),
    }


def _load_meta_and_model(exp_dir, data_dir, device):
    from ..build import build_weather_model
    from ..config import load_experiment_config
    from ..data.dataset import load_chunked_datasets

    cfg = load_experiment_config(os.path.join(exp_dir, "config.json"))
    data_dir = data_dir or cfg.data_dir
    _, _, _, meta = load_chunked_datasets(
        data_dir, obs_window=cfg.data.obs_window_used,
        pred_steps=cfg.data.pred_window_used,
        n_features=cfg.data.num_features_used,
    )
    return cfg, meta, build_weather_model(cfg, meta, device=device), \
        data_dir


def cmd_weights(args):
    from ..training import checkpoint as ckpt_lib

    _, _, (model, _, _), _ = _load_meta_and_model(
        args.exp_dir, args.data_dir, args.device
    )
    path = args.checkpoint
    if path is None:
        candidates = [os.path.join(args.exp_dir, name)
                      for name in ("best_model.pt", "best_model.msgpack")]
        path = next((p for p in candidates if os.path.exists(p)),
                    candidates[0])
    saved = ckpt_lib.load_params(path)
    report = ckpt_lib.partial_restore(model, saved, verbose=False)
    ok = not (report["missing"] or report["unexpected"]
              or report["mismatched"])
    print(f"[check weights] {path}")
    print(f"  missing={len(report['missing'])} "
          f"unexpected={len(report['unexpected'])} "
          f"shape-mismatched={len(report['mismatched'])} "
          f"-> {'OK' if ok else 'PROBLEMS'}")
    for k in (report["missing"] + report["mismatched"])[:20]:
        print(f"  ! {k}")
    return 0 if ok else 1


def cmd_graph(args):
    _, _, (_, _, gs), _ = _load_meta_and_model(
        args.exp_dir, args.data_dir, args.device
    )
    summary = graph_summary(gs)
    record = os.path.join(args.exp_dir, "graph_summary.json")
    if os.path.exists(record) and not args.record:
        with open(record) as f:
            saved = json.load(f)
        diffs = {k: (saved.get(k), v) for k, v in summary.items()
                 if saved.get(k) != v}
        if diffs:
            print("[check graph] MISMATCH vs recorded summary:")
            for k, (a, b) in diffs.items():
                print(f"  {k}: recorded={a} rebuilt={b}")
            return 1
        print("[check graph] rebuilt graphs match the recorded summary — OK")
        return 0
    with open(record, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"[check graph] summary recorded -> {record}")
    for k, v in summary.items():
        print(f"  {k}: {v}")
    return 0


def cmd_scalers(args):
    a = np.load(os.path.join(args.dir_a, "scalers.npz"))
    print(f"[check scalers] {args.dir_a}")
    print(f"  mean range [{a['mean'].min():.4g}, {a['mean'].max():.4g}] "
          f"std range [{a['std'].min():.4g}, {a['std'].max():.4g}]")
    bad = np.flatnonzero(~np.isfinite(a["mean"]) | ~np.isfinite(a["std"])
                         | (a["std"] <= 0))
    if len(bad):
        print(f"  ! invalid channels: {bad.tolist()}")
        return 1
    if args.dir_b:
        b = np.load(os.path.join(args.dir_b, "scalers.npz"))
        dm = np.abs(a["mean"] - b["mean"]) / (np.abs(b["mean"]) + 1e-9)
        ds = np.abs(a["std"] - b["std"]) / (b["std"] + 1e-9)
        print(f"  vs {args.dir_b}: max rel Δmean={dm.max():.3%} "
              f"Δstd={ds.max():.3%}")
        worst = np.argsort(-np.maximum(dm, ds))[:5]
        for i in worst:
            print(f"    ch{i}: mean {b['mean'][i]:.4g}->{a['mean'][i]:.4g} "
                  f"std {b['std'][i]:.4g}->{a['std'][i]:.4g}")
    # Raw-data sanity: sample frames should be ~N(0,1) after normalization.
    info = os.path.join(args.dir_a, "dataset_info.json")
    if os.path.exists(info):
        from ..data.dataset import ChunkedTimeseriesDataset

        ds = ChunkedTimeseriesDataset(args.dir_a, obs_window=1, pred_steps=1,
                                      split="all")
        x, _ = ds.get(0)
        z = x.reshape(-1, ds.n_feat)
        print(f"  normalized frame 0: mean {z.mean():+.3f} std {z.std():.3f}"
              f" (expect ~0 / ~1)")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("weights")
    w.add_argument("exp_dir")
    w.add_argument("--data-dir", default=None)
    w.add_argument("--device", default="cuda",
                   help="torch device for the model (default cuda)")
    w.add_argument("--checkpoint", default=None,
                   help="a .pt state dict or the JAX package's .msgpack "
                   "(default <exp_dir>/best_model.pt, then "
                   "best_model.msgpack)")
    g = sub.add_parser("graph")
    g.add_argument("exp_dir")
    g.add_argument("--data-dir", default=None)
    g.add_argument("--device", default="cuda",
                   help="torch device for the model (default cuda)")
    g.add_argument("--record", action="store_true",
                   help="overwrite the recorded summary")
    s = sub.add_parser("scalers")
    s.add_argument("dir_a")
    s.add_argument("dir_b", nargs="?", default=None)
    args = parser.parse_args(argv)
    return {"weights": cmd_weights, "graph": cmd_graph,
            "scalers": cmd_scalers}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
