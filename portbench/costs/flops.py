"""Matrix-product FLOPs (2 per multiply-add) of one forward of the
encode-process-decode model, as its equations are written: a function of
the configuration alone, never of the route that computes it.

* encoder and decoder: each MLP layer and each GCN convolution's
  ``x @ W`` on every grid and mesh node (N + M rows);
* processor: the edge encoder (4 -> h) on every mesh edge, and in each of
  the steps the edge MLP on the concatenation [x_s | x_r | e] (3h -> h ->
  h) on every mesh edge and the node MLP on [x | agg] (2h -> h -> h) on
  every mesh node.

Aggregations, LayerNorms and activations are not counted.  Training
counts three forwards a forward (recomputation not counted)."""

from __future__ import annotations

__all__ = ["graph_sizes", "forward_flops", "serve_flops", "train_flops"]


def graph_sizes(cfg: dict):
    """(grid nodes N, mesh nodes M, directed mesh edges E) of a
    configuration: an icosahedral multimesh of levels L has 10*4^max(L)+2
    vertices, and level l adds 30*4^l undirected edges."""
    g = cfg["grid"]
    levels = cfg["graph"]["mesh_levels"]
    return (g["num_lat"] * g["num_lon"], 10 * 4 ** max(levels) + 2,
            2 * sum(30 * 4 ** lv for lv in levels))


def _chain(rows: int, dims) -> int:
    return sum(2 * rows * a * b for a, b in zip(dims[:-1], dims[1:]))


def forward_flops(cfg: dict) -> int:
    n, m, e = graph_sizes(cfg)
    d, p = cfg["data"], cfg["pipeline"]
    enc, proc, dec = p["encoder"], p["processor"]["gcn"], p["decoder"]
    h = proc["output_dim"]
    rows = n + m
    enc_in = d["num_features_used"] * d["obs_window_used"] + 6
    flops = _chain(rows, [enc_in] + enc["mlp"]["mlp_hidden_dims"]
                   + [enc["mlp"]["output_dim"]])
    flops += _chain(rows, [enc["mlp"]["output_dim"]]
                    + enc["gcn"]["hidden_dims"] + [enc["gcn"]["output_dim"]])
    flops += 2 * e * proc["edge_feature_dim"] * h
    per_step = 2 * e * (3 * h * h + h * h) + 2 * m * (2 * h * h + h * h)
    flops += proc["num_message_passing_steps"] * per_step
    flops += _chain(rows, [h] + dec["mlp"]["mlp_hidden_dims"]
                    + [dec["mlp"]["output_dim"]])
    flops += _chain(rows, [dec["mlp"]["output_dim"]]
                    + dec["gcn"]["hidden_dims"] + [dec["gcn"]["output_dim"]])
    return flops


def serve_flops(cfg: dict, members: int, ar_steps: int) -> int:
    """One dispatch of ``members`` forecasts of ``ar_steps`` steps."""
    return members * ar_steps * forward_flops(cfg)


def train_flops(cfg: dict, batch: int, ar_steps: int) -> int:
    """One AR BPTT train step on ``batch`` samples."""
    return 3 * batch * ar_steps * forward_flops(cfg)
