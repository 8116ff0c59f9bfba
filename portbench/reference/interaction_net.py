"""Plain PyTorch reference of the encode-process-decode weather model with
an InteractionNet processor: forward, autoregressive rollout, the AR
training loss and Adam, in float32 with TF32 off.

It follows the published equations (GraphCast, arXiv:2212.12794, and the
configuration files of this repository's experiments) on plain COO edge
lists, one sample at a time, with ``index_add_`` for every aggregation:

  encoder   MLP (Linear, PReLU, Linear, node LayerNorm) on every grid and
            mesh node, then GCN convolutions over the grid-to-mesh edges;
  processor an edge encoder (Linear, swish) on the 4 mesh edge features,
            then N InteractionNet steps with unshared weights:
              u  = W2 swish(W1 [x_s | x_r | e] + b1) + b2   on every edge
              x' = LN_node(x + MLP_n([x | mean_{e -> x} u]))
              e' = LN_graph(e + u)   (one mean and variance over all edges)
  decoder   MLP (Linear, PReLU, Linear) on every node, then GCN
            convolutions over the mesh-to-grid edges, read at grid nodes;
  rollout   the forecast is the last input frame plus the decoded
            increment, the static channels copied from the last frame,
            and the window moves on by one frame each AR step.

A GCN convolution is  out_r = sum_{s->r} x_s W / sqrt((d_s + 1)(d_r + 1))
+ x_r W / (d_r + 1) + b,  d the in-degree over the graph's receivers.

Every matrix product and every stored value goes through a ``Precision``
(exact float32 by default), so that the control of the benchmark can
compute the same model at a lower precision.  Parameter
names follow the program's, so that one set of weights made by the
benchmark loads into both.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["param_spec", "RefGraphs", "rollout", "ar_loss", "train_steps",
           "Precision", "EXACT"]


class Precision:
    """How the reference computes: ``mm`` a matrix product, ``q`` the
    rounding of every value it stores."""

    def __init__(self, mm, q):
        self.mm, self.q = mm, q


EXACT = Precision(mm=lambda a, b: a @ b, q=lambda x: x)


def _dims(cfg: dict):
    p = cfg["pipeline"]
    c = cfg["data"]["num_features_used"]
    obs = cfg["data"]["obs_window_used"]
    enc, proc, dec = p["encoder"], p["processor"], p["decoder"]
    for block in (enc, dec):
        if block["gcn"]["layer_type"] != "conv_gcn":
            raise ValueError("reference: encoder and decoder must be conv_gcn")
    if proc["gcn"]["layer_type"] != "interaction_net" or proc["mlp"]:
        raise ValueError("reference: processor must be a bare interaction_net")
    if proc["gcn"]["activation"] != "swish":
        raise ValueError("reference: the processor's activation is swish")
    return c, obs, enc, proc, dec


def _mlp_spec(prefix, d_in, mlp):
    dims = [d_in] + list(mlp["mlp_hidden_dims"] or []) + [mlp["output_dim"]]
    out = []
    for i in range(len(dims) - 1):
        out += [(f"{prefix}.lin_{i}.kernel", (dims[i], dims[i + 1]),
                 "fan_in", dims[i]),
                (f"{prefix}.lin_{i}.bias", (dims[i + 1],), "fan_in", dims[i])]
        if i < len(dims) - 2:
            out.append((f"{prefix}.prelu_{i}.alpha", (1,), "alpha", 0))
    if mlp["use_layer_norm"]:
        out += [(f"{prefix}.norm.weight", (dims[-1],), "ln_weight", 0),
                (f"{prefix}.norm.bias", (dims[-1],), "ln_bias", 0)]
    return out, dims[-1]


def _gcn_spec(prefix, d_in, gcn):
    dims = [d_in] + list(gcn["hidden_dims"] or []) + [gcn["output_dim"]]
    out = []
    for i in range(len(dims) - 1):
        out += [(f"{prefix}.conv_{i}.kernel", (dims[i], dims[i + 1]),
                 "glorot", dims[i] + dims[i + 1]),
                (f"{prefix}.conv_{i}.bias", (dims[i + 1],), "gcn_bias", 0)]
    out.append((f"{prefix}.act.alpha", (1,), "alpha", 0))
    return out, dims[-1]


def param_spec(cfg: dict):
    """[(name, shape, init kind, fan)] of every parameter, in order."""
    c, obs, enc, proc, dec = _dims(cfg)
    spec, h = _mlp_spec("encoder.mlp", c * obs + 6, enc["mlp"])
    s, h = _gcn_spec("encoder.graph_layer", h, enc["gcn"])
    spec += s
    de = proc["gcn"]["edge_feature_dim"]
    pre = "processor.graph_layer.inet"
    spec += [(f"{pre}.edge_encoder_lin.kernel", (de, h), "fan_in", de),
             (f"{pre}.edge_encoder_lin.bias", (h,), "fan_in", de)]
    for k in range(proc["gcn"]["num_message_passing_steps"]):
        p = f"{pre}.steps.{k}"
        spec += [
            (f"{p}.edge_mlp.lin_0.kernel", (3 * h, h), "fan_in", 3 * h),
            (f"{p}.edge_mlp.lin_0.bias", (h,), "fan_in", 3 * h),
            (f"{p}.edge_mlp.lin_1.kernel", (h, h), "fan_in", h),
            (f"{p}.edge_mlp.lin_1.bias", (h,), "fan_in", h),
            (f"{p}.node_mlp.lin_0.kernel", (2 * h, h), "fan_in", 2 * h),
            (f"{p}.node_mlp.lin_0.bias", (h,), "fan_in", 2 * h),
            (f"{p}.node_mlp.lin_1.kernel", (h, h), "fan_in", h),
            (f"{p}.node_mlp.lin_1.bias", (h,), "fan_in", h),
            (f"{p}.edge_norm.weight", (h,), "ln_weight", 0),
            (f"{p}.edge_norm.bias", (h,), "ln_bias", 0),
            (f"{p}.node_norm.weight", (h,), "ln_weight", 0),
            (f"{p}.node_norm.bias", (h,), "ln_bias", 0),
        ]
    s, h = _mlp_spec("decoder.mlp", h, dec["mlp"])
    spec += s
    s, _ = _gcn_spec("decoder.graph_layer", h, dec["gcn"])
    return spec + s


class RefGraphs:
    """The reference's graphs on ``device``: edge lists and the GCN
    normalizers of the encoder and decoder graphs, the mesh edges and their
    features, the static node features."""

    def __init__(self, g: dict, device):
        self.n, self.m = g["num_grid"], g["num_mesh"]
        nodes = self.n + self.m

        def t(a, dtype=torch.long):
            return torch.as_tensor(a, dtype=dtype, device=device)

        self.gcn = {}
        for key in ("enc", "dec"):
            s, r = t(g[key][0]), t(g[key][1])
            deg = torch.zeros(nodes, dtype=torch.float32, device=device)
            deg.index_add_(0, r, torch.ones_like(r, dtype=torch.float32))
            dinv = torch.rsqrt(deg + 1.0)
            self.gcn[key] = (s, r, dinv[s] * dinv[r], deg + 1.0)
        self.ps, self.pr = t(g["proc"][0]), t(g["proc"][1])
        deg = torch.zeros(self.m, dtype=torch.float32, device=device)
        deg.index_add_(0, self.pr, torch.ones_like(self.pr,
                                                   dtype=torch.float32))
        self.inv_deg = 1.0 / deg.clamp(min=1.0)
        self.proc_attr = t(g["proc_attr"], torch.float32)
        self.grid_static = t(g["grid_static"], torch.float32)
        self.mesh_static = t(g["mesh_static"], torch.float32)


def _prelu(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


def _ln(x, w, b, dims):
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5) * w + b


def _linear(P, name, x, pr):
    return pr.q(pr.mm(x, P[f"{name}.kernel"]) + P[f"{name}.bias"])


def _mlp(P, prefix, x, mlp, pr):
    n = len(mlp["mlp_hidden_dims"] or [])
    for i in range(n + 1):
        x = _linear(P, f"{prefix}.lin_{i}", x, pr)
        if i < n:
            x = pr.q(_prelu(x, P[f"{prefix}.prelu_{i}.alpha"]))
    if mlp["use_layer_norm"]:
        x = pr.q(_ln(x, P[f"{prefix}.norm.weight"], P[f"{prefix}.norm.bias"],
                     -1))
    return x


def _gcn(P, prefix, x, gcn, graph, pr):
    s, r, norm, deg1 = graph
    n = len(gcn["hidden_dims"] or []) + 1
    for i in range(n):
        xw = pr.q(pr.mm(x, P[f"{prefix}.conv_{i}.kernel"]))
        msgs = pr.q(xw[s] * norm[:, None])
        agg = pr.q(torch.zeros_like(xw).index_add_(0, r, msgs))
        x = pr.q(agg + xw / deg1[:, None] + P[f"{prefix}.conv_{i}.bias"])
        if i < n - 1:
            x = pr.q(_prelu(x, P[f"{prefix}.act.alpha"]))
    return x


def _interaction_step(P, p, x, e, G, pr):
    h = _linear(P, f"{p}.edge_mlp.lin_0",
                torch.cat([x[G.ps], x[G.pr], e], dim=-1), pr)
    u = _linear(P, f"{p}.edge_mlp.lin_1", pr.q(F.silu(h)), pr)
    agg = pr.q(torch.zeros_like(x).index_add_(0, G.pr, u)
               * G.inv_deg[:, None])
    hn = _linear(P, f"{p}.node_mlp.lin_0", torch.cat([x, agg], dim=-1), pr)
    x_new = pr.q(x + _linear(P, f"{p}.node_mlp.lin_1", pr.q(F.silu(hn)), pr))
    e_new = pr.q(_ln(pr.q(e + u), P[f"{p}.edge_norm.weight"],
                     P[f"{p}.edge_norm.bias"], (-2, -1)))
    x_new = pr.q(_ln(x_new, P[f"{p}.node_norm.weight"],
                     P[f"{p}.node_norm.bias"], -1))
    return x_new, e_new


def forward(P, G: RefGraphs, x, cfg, pr=None, remat=False):
    """One sample's increment [N, C] from its flattened window [N, obs*C]."""
    pr = pr or EXACT
    _, _, enc, proc, dec = _dims(cfg)
    h_in = pr.q(torch.cat([torch.cat([x, G.grid_static], -1),
                           torch.cat([x.new_zeros(G.m, x.shape[-1]),
                                      G.mesh_static], -1)]))
    h = _mlp(P, "encoder.mlp", h_in, enc["mlp"], pr)
    h = _gcn(P, "encoder.graph_layer", h, enc["gcn"], G.gcn["enc"], pr)
    grid_lat, x_mesh = h[:G.n], h[G.n:]
    pre = "processor.graph_layer.inet"
    e = pr.q(F.silu(_linear(P, f"{pre}.edge_encoder_lin",
                            pr.q(G.proc_attr), pr)))
    for k in range(proc["gcn"]["num_message_passing_steps"]):
        args = (P, f"{pre}.steps.{k}", x_mesh, e, G, pr)
        if remat:
            x_mesh, e = checkpoint(_interaction_step, *args,
                                   use_reentrant=False)
        else:
            x_mesh, e = _interaction_step(*args)
    h = _mlp(P, "decoder.mlp", torch.cat([grid_lat, x_mesh]), dec["mlp"], pr)
    h = _gcn(P, "decoder.graph_layer", h, dec["gcn"], G.gcn["dec"], pr)
    return h[:G.n]


def _static_mask(cfg, device):
    c = cfg["data"]["num_features_used"]
    m = torch.zeros(c, device=device)
    m[list(cfg.get("static_channels") or [])] = 1.0
    return m


def _step(P, G, window, cfg, pr, remat):
    """One AR step of one sample: (forecast [N, C], next window)."""
    n, obs, c = window.shape
    delta = forward(P, G, window.reshape(n, obs * c), cfg, pr, remat)
    last = window[:, -1]
    out = last + delta if cfg.get("use_residual", True) else delta
    sm = _static_mask(cfg, window.device)
    out = pr.q(out * (1 - sm) + last * sm)
    return out, torch.cat([window[:, 1:], out[:, None]], dim=1)


def rollout(P, G, window, steps, cfg, pr=None):
    """[N, steps, C] forecast of one sample's window [N, obs, C]."""
    pr = pr or EXACT
    window = pr.q(window)
    outs = []
    for _ in range(steps):
        out, window = _step(P, G, window, cfg, pr, False)
        outs.append(out)
    return torch.stack(outs, dim=1)


def loss_weights(cfg, device):
    """(latitude weights [N], channel mask [C]) of the training loss:
    cos of an even -90..90 latitude axis over the mean, lat-major; the
    static channels left out."""
    nlat, nlon = cfg["grid"]["num_lat"], cfg["grid"]["num_lon"]
    lat = torch.linspace(-90.0, 90.0, nlat, dtype=torch.float64)
    w = torch.cos(torch.deg2rad(lat))
    w = (w / w.mean()).repeat_interleave(nlon).float().to(device)
    return w, 1.0 - _static_mask(cfg, device)


def ar_loss(P, G, window, targets, cfg, pr=None):
    """One sample's AR loss: the mean over the AR steps of the weighted
    MSE sum w (p - t)^2 / sum w, in float32 (BPTT; each step recomputed
    in the backward)."""
    pr = pr or EXACT
    lat_w, chan = loss_weights(cfg, window.device)
    w = lat_w[:, None] * chan[None, :]
    window, targets = pr.q(window), pr.q(targets)
    total = 0.0
    for k in range(targets.shape[1]):
        out, window = checkpoint(_step, P, G, window, cfg, pr, True,
                                 use_reentrant=False)
        total = total + (w * (out - targets[:, k]) ** 2).sum() / w.sum()
    return total / targets.shape[1]


def train_steps(params, G, batches, cfg, pr=None):
    """Adam over ``batches`` (a list of (x [B, N, obs*C], y [B, N, P*C])):
    returns (losses, the first step's gradients, the parameters after the
    last step).  A batch's loss is the mean of its samples' losses; Adam
    as torch.optim.Adam with its defaults and the config's rate, on
    float32 weights (a lower ``pr`` rounds them where they are used)."""
    lr = cfg["learning_rate"]
    b1, b2, eps = 0.9, 0.999, 1e-8
    c, obs = cfg["data"]["num_features_used"], cfg["data"]["obs_window_used"]
    P = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    losses, first = [], None
    for t, (x, y) in enumerate(batches, start=1):
        grads = {k: torch.zeros_like(p) for k, p in P.items()}
        total = 0.0
        for i in range(x.shape[0]):
            window = x[i].reshape(x.shape[1], obs, c)
            targets = y[i].reshape(y.shape[1], -1, c)
            loss = ar_loss(P, G, window, targets, cfg, pr) / x.shape[0]
            gs = torch.autograd.grad(loss, list(P.values()),
                                     allow_unused=True)
            for (k, _), g in zip(P.items(), gs):
                if g is not None:
                    grads[k] += g
            total += float(loss.detach())
        losses.append(total)
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        with torch.no_grad():
            for k, p in P.items():
                g = grads[k]
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
    return losses, first, {k: p.detach() for k, p in P.items()}
