"""Smoke run of the PyTorch port on one NVIDIA card: ``python3 chip_smoke.py``.

Builds the port's three hand-written CUDA kernels (nvcc, sm_90a, one nvcc
per source, all at once) from ``graphcast_lite_torch/csrc/``, then:

1. Holds each kernel against its plain PyTorch version on the card, in
   fp32 and bf16: the segment sum (``segment_sum.cu``), the edge-MLP tail
   fused with its aggregation (``edge_mlp.cu``) and the fused lazy-LN edge
   step (``edge_step.cu``), on empty receivers, padding rows, pruned edges,
   a receiver with thousands of edges and receiver counts that are not a
   multiple of the kernels' receiver tile.  The segment sum also on the
   shapes that cut its merge-path designs' tiles: no edges (R = 50,000),
   R = 1, a 50,000-edge receiver, long receivers that end exactly on tile
   boundaries and the encoder's layout (131,072 empty rows, then a skewed
   band), each at F in {19, 64, 256} (F = 19 and bf16 F = 64 take the
   narrow design, the others the balanced one), with PR 1's warp-per-row
   design on the same skew at F = 19 and 256, two balanced (F = 256) and
   two narrow (F = 19) launches compared bitwise; the narrow design also
   batched [2, E, F] and on a misaligned view (data one element past a
   16-byte boundary, equal bitwise to the aligned tensor's sum) at F in
   {1, 4, 19, 33} on the 50,000-edge receiver's CSR; and the library's
   design and tile-size queries (both merge-path designs) checked against
   the wrapper's Python mirror.  Both fused kernels also on the tilings
   their bf16 Hopper kernels meet (in-degree 1, alternating in-degrees 0
   and 13, receivers of exactly 64 and 128 rows, one receiver, R = 33) and
   on bf16 rows wider than those kernels take (H = 384), which run the
   16-receiver design.  Both fused kernels at H, De in {128, 256} take their Hopper
   design in both dtypes (asserted: ``hopper_bf16``, ``hopper_fp32``); the
   fp32 ones also on rows up to |h| = 30 (``edge_mlp``: h_pre; ``edge_step``:
   h, with W1e's columns scaled by 2^10 and 2^-10) with W2's columns
   scaled by 2^10 and 2^-10 at each of their widths, and two fp32 launches
   of each are compared bitwise.  Checks that both libraries' design
   selection (``gclt_edge_mlp_design``, ``gclt_edge_step_design``) and
   group sizes agree with the wrappers' Python mirrors and prints each
   layout's shared memory.
1c. The segment sum against its plain version, fp32 and bf16, at the
   shapes the GAT, SparseGAT and product-graph families add on the WB2
   64x32 graphs: GAT aggregations (F = 256 at 4 heads x 64, 64 at one
   head), softmax denominators (F = 4, 1; F = 1 is also the degree sum
   under a pruned mask), the product-graph GCN's aggregations (F = 64,
   33) and the backward's gather adjoints over the sender CSRs; the
   narrow rows also in PR 1's design, and two launches bitwise equal.
2. Serves the flagship forecast (``presets.interaction_net_512x256``: 19
   features, obs 2, AR 4, hidden 256, 12 InteractionNet steps, mesh [4, 6])
   in bf16 through the port's ``evaluate_model`` for 3 requests on a seeded
   synthetic 512x256 dataset with seeded random weights, on the default
   reg-block route, checks that every rollout launched the segment sum
   exactly 8 times (2 encoder GCNConv aggregations x 4 AR steps), and holds
   one request's bf16 rollout against the fp32 rollout of the same weights.
2b. Serves one request on each of the three COO routes (``GCLT_REG_EDGE=0``;
   plus ``GCLT_EDGE_STEP=1`` or ``GCLT_MEGA_EDGE=1``), checks each route's
   exact launch counts per rollout, and holds its bf16 rollout against the
   fp32 reg-block rollout; times each route and profiles one rollout of it
   (device busy time and idle share).
2c. Serves one request with the plain InteractionNet step
   (``GCLT_LAZY_EDGE=0``) on the composed route (56 segment sums a
   rollout) and on the mega route (8 segment sums, 48 ``edge_mlp``
   launches through the step's ``_MegaEdgeMLP`` counterpart): rollout
   time by stage, idle share, peak memory, bf16 against the fp32 plain
   rollout, and the fp32 plain rollout against the fp32 lazy one within
   ``NONLAZY_FP32_RTOL``.
3. Times each kernel at the flagship shapes (the segment sum at the encoder
   shape, also in fp32 as ``Trainer.fit``'s evaluation runs it, and at the
   processor shape, the two fused kernels at the processor shape)
   against its bound, its plain version and, where there is one, one
   PyTorch call; the segment sum in the design it picks and in PR 1's
   warp-per-row design, in turns, through the wrapper and, where it picks
   the narrow design, also alone (raw launches queued back to back behind
   a sleep kernel, CUDA events) beside the launch floor (an empty kernel
   on the narrow design's grid, timed alike); the fused kernels also
   against their earlier (wmma) times, and ``edge_mlp`` with the design it took
   (asserted: the Hopper one) and its persistent blocks' sub-tile counts;
   the segment sum also at the four sender-sorted scatters of phase 5a
   (the decoder's F = 19 gather adjoint is narrow);
   3b the segment sum at phase 1c's shapes in fp32.
4. Runs the 64x32 flagship architecture in fp32 (TF32 off) on the card and
   on the CPU (the plain versions) with the same weights and inputs through
   AR-4, on the reg-block route and on each COO route, and compares them.
   4b: the four WB2 64x32 BASELINE configurations at their published
   widths (GCN, GAT at 4 heads, SparseGAT at its 0.1356 threshold, the
   obs-5 product graph), seeded weights, fp32: one request (exact
   segment-sum launches) and one train step, card against CPU, and
   SparseGAT's pruned mask equal on every edge whose alpha lies more
   than 1e-5 from the threshold.
5. Training.  5a: the segment sum against its plain version, fp32 and
   bf16, on the sender-sorted CSRs of the train step's backward (the
   reg-edge unit's sender scatter, the encoder's and the decoder's GCNConv
   gather adjoints; a decoder sender reaches 696 edges), on the permuted
   cotangent rows the backward builds.  5b: the 64x32 architecture's fp32
   AR-4 train step (``make_train_step``) on the card against the CPU:
   loss, every gradient and the exact segment-sum launches, then the
   card's Adam update against its closed form.  5c: the flagship in bf16
   mixed precision, 5 train steps on one seeded batch through
   ``make_train_step`` on the default route: exact launches every step
   (80 segment sums, by CSR and by design: 76 balanced, 4 narrow; no
   fused kernel), the loss falls, step and
   forward-loss times, peak memory and one profiled step.
6. The trainer and the user surface.  6a: the flagship in bf16 mixed
   precision through ``Trainer.fit`` on a seeded 11-frame synthetic
   512x256 dataset: 4 epochs of 2 steps climbing the AR curriculum 1, 2,
   3, 4 (one AR level an epoch), an fp32 evaluation of the validation
   sample before and after each epoch, a checkpoint every epoch.  Checks
   the AR level of every epoch and step, every step's segment-sum launches
   by CSR and shape (``_train_launches`` at the step's AR level: 20 a
   level), 2 a validation sample in each evaluation, no fused kernel,
   finite losses, the files the fit writes and no sample loaded past the
   epoch's last step; then a new ``Trainer`` on a
   new model resumes the checkpoint for epoch 5, with its params and Adam
   state bitwise the saved ones before its first step and Adam's step
   count continuing.  Times per AR level: step ms (CUDA events), evaluate
   ms per validation sample, checkpoint save ms, epoch wall, the host share
   of the epoch (1 - step time / epoch wall) and peak memory.  6b: the
   README's demo loop through the CLIs' ``main(argv)`` on the card:
   ``make_demo --size medium``, ``train --max-steps-per-epoch 8`` (at
   least one segment sum every step, the loss falls), ``predict --ar-steps
   2`` at K = 1 and ``--rollouts-per-dispatch 4`` (accepted as the JAX
   package's CLI takes it, no effect yet: the same report).  6c: on a
   synthetic 64x32 set of 33 features, SparseGAT through ``cli.train``
   for 12 epochs (pruning from epoch index 6; the live edges after each
   epoch), a ``--resume`` from its checkpoint after epoch 11 ending on the
   same mask, the product graph for 2 epochs, and ``cli.predict`` on
   each.

7. The COO training units and the regional stack.  7a: the segment sum
   on the CSRs of the dual-mesh head's reg-level-8 graphs over the
   README's ROI (20-60 N, 60-140 E: processing receivers and senders,
   cross, encoding and decoding receivers and senders, F = 256) and on the
   flagship multimesh's sender CSR (the fused unit's d_xs), and
   ``edge_mlp`` at the regional processing shape (R 41,046, E 228,276,
   H = De = 256), each against its plain version in fp32 and bf16 and
   timed (fp32 for the regional shapes, which ``train_regional`` trains
   in; bf16 for the flagship's) against its bound, its plain version and
   ``torch.segment_reduce``; fp32 ``edge_mlp`` and ``edge_step`` at the
   flagship processor shape the same way (both against their 3xTF32 bound
   with the FMA bound beside it, fp32 ``edge_mlp`` also beside
   ``torch.addmm`` of its product alone, TF32 off), and an fp32 AR-4
   rollout on the COO edge-step route (exactly 48 ``edge_step`` launches)
   and on the COO composed route (56 segment sums), timed in turns,
   profiled and held to each other.  7b: the flagship bf16 train step on the
   fused edge unit (``GCLT_REG_EDGE=0``: route ``fused``;
   ``GCLT_LAZY_EDGE=0``: ``nonlazy_fused``; each also under
   ``GCLT_MEGA_EDGE=1``, which launches ``edge_mlp`` in training) beside
   the composed routes it replaces (``GCLT_FUSED_EDGE=0``) and
   ``GCLT_GCN_AGG=1`` on the default route: exact launches every step by
   CSR and shape, the route of every processor step, the loss falls, step
   ms and peak memory; each switch's fp32 step (TF32 off) against the
   same step without it: the loss and every gradient.  7c:
   ``cli.train_regional`` through its ``main``: the dual-mesh head at
   reg-level 8, hidden 256 (its processor on ``nonlazy_fused``), with and
   without ``GCLT_MEGA_EDGE=1``, and the ROI-residual head, one epoch of
   3 steps and ``--evaluate`` over a seeded flagship global model on an
   11-frame synthetic set: exact launches every head step, finite losses,
   step ms beside the global forward's, peak memory; one head step of
   each head over the 64x32 architecture, card against CPU in fp32.  7d:
   a regional-mesh model (61x41 grid at 0.25 deg, mesh [3, 5] pruned to
   the region, 19 features, hidden 128, 8 steps) and the 64x32
   architecture on a flat grid, card against CPU in fp32: one AR-4
   request and one AR-4 train step each.
8. The CNN stacks (no hand-written kernel: cuDNN, cuFFT, cuBLAS) at the
   reference's regional widths on its 41x61 grid, fp32: 8a ``WeatherUNet``
   (92 -> 23 channels, base 64), ``WeatherUNetV2`` (4 heads, 4 modes) and
   ``DownscalerUNet`` (base 48), their parameter counts asserted, one
   forward and one batch-8 train step (V1 and V2 over AR 4, V2 with the
   spectral and Sobel terms) on the card against the CPU, the card's
   gradients against a float64 evaluation of the step; 8b
   ``cli.train_unet`` (v2 from the flat config, v1 from flags) on a
   seeded synthetic 41x61 x 23 set, ``evaluate_model`` AR 4, then train
   step and AR-4 rollout ms (CUDA events), peak memory and a profiled
   step's idle share; 8c ``data.etl.build_downscaler_dataset``,
   ``cli.train_downscaler``, ``cli.generate_predictions`` of a seeded GNN
   on the fine grid and ``cli.train_downscaler --gnn-input``.

9. Data assimilation and the serving entry points (no new kernel: the
   GNN forwards launch the segment sum; the OI solve is
   ``torch.linalg.solve``).  9a: the flagship through ``cli.predict``'s
   ``main`` (seeded weights, default route, bf16 and fp32 with TF32 off)
   on phase 6a's seeded 11-frame 512x256 set, 3 AR-4 requests each: raw,
   ``--da nudging`` (13,107 stations) and ``--da oi --obs-roi-only
   --region 20 60 60 140`` (6,498 ROI points, one ~650 x 650 fp32 solve a
   step on the card): exactly 8 segment sums a rollout, the nudged AR-step-1
   RMSE below the raw one, OI changing only ROI rows, each fp32 solve
   within cond(A) x n x 2^-24 of a float64 host solve (the distance
   printed), request ms and OI analysis ms a step; an identity assimilator
   (the per-step path) against the whole-trajectory rollout in fp32.
   9b: ``cli.evaluate_pipeline`` (nine rungs, ``--unet-exp`` a seeded
   ``DownscalerUNet`` base 48 saved as the port's ``.pt``) on the WB2
   64x32 GCN BASELINE, fp32, AR 4: exact launches, the raw rung equal to
   ``evaluate_model``'s report, the same ladder on the CPU rung by rung,
   the cascade rung's RMSE beside the raw one.  9c: a flagship fp32 AR-1
   forecast through ``cascade_refine`` onto a 41 x 61 grid at 0.25 deg
   with a seeded ``DownscalerUNet`` on the card (card vs CPU), then
   ``blend_with_background``.  9d: ``export_runtime_bundle`` of 9a's
   experiment and ``run_live_forecast`` AR 4 with a seeded ``fetch_fn``:
   8 segment sums, predictions bitwise a direct fp32 rollout, ms.

10. The offline tooling (no new kernel; 10b's rollouts launch the
   segment sum).  10a: ``data.remote.stream_build_dataset`` from a seeded
   in-memory ``ChannelSource`` at 512 x 256 and the flagship's 19
   channels, 11 frames in two time chunks; then a build cut at its second
   chunk (a child process that exits there, leaving ``progress.json``)
   and resumed, whose files equal the whole build's byte for byte; the
   scalers against float64 moments of the fields, and the port's loader
   reading the fields' float16 values.  10b: the seeded flagship's
   weights as a reference ``WeatherPrediction`` checkpoint (torch layout,
   ``model_state_dict`` in a ``.pth``) through ``utils.torch_convert``
   into ``best_model.pt`` (bitwise the weights), served by
   ``cli.predict --checkpoint ... --save-preds ... --device cuda`` in
   fp32 for 2 AR-4 requests on 10a's set: exactly 8 segment sums a
   rollout, predictions bitwise the seeded weights' rollouts.  10c:
   ``cli.compare_wrf.main`` on 10b's predictions, 10a's scalers and
   coords and a seeded WRF JSON export; its domain means against NumPy.
   10d: ``graphs.partition`` of the flagship graph set, its graphs on
   the card, 4 shards by latitude and by tiles as the JAX package's
   ``build_sharding_plan`` draws them: the scatter / gather round trips,
   every edge placed once, rows exchanged a step and the host ms.  The
   learned-MOS fit does not run on the card (no sklearn or joblib there).

Prints the card's name and power limit, ``{"serve": ...}``,
``{"train": ...}``, ``{"baseline_64x32": ...}``, ``{"fit": ...}``,
``{"regional": ...}``, ``{"cnn": ...}``, ``{"assimilation": ...}``,
``{"offline": ...}`` and ``{"kernels": [...]}`` lines (the kernels'
launches counted in the serve, the train steps, the fit, the demo's
training, the regional head steps and phases 9 and 10; the segment sum's
also by design in the serve and the train step) and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero without the last line; so does a machine without a
card.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Stated tolerance of the segment sum against its plain version, per
# element:
#   |kernel - plain| <= atol + rtol * |plain| + ORDER_RTOL * sum_e |msgs_e|.
# Both accumulate in fp32 and differ only in the order of the additions;
# that difference grows with the sum of magnitudes, not with the result,
# which cancels in a long row (a 2,500-edge row of N(0, 1) messages sums
# to about 1 while its partial sums reach about 50).  bf16 rounds the fp32
# sum once, so the two differ by at most one bf16 ulp (2^-8 relative) more.
FP32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-5, rtol=1e-2)
ORDER_RTOL = 1e-5
# The fused kernels (edge_mlp, edge_step) against their plain versions.
# Per output element, atol + rtol * |plain|; the aggregates add the order
# term above over their rows' |u|.  fp32: both accumulate products of up to
# 256 terms (magnitudes up to about 4) in fp32 in other orders, a few fp32
# roundings of the partial sums.  bf16: both round at the same points, but
# where the two fp32 accumulations fall on either side of a bf16 rounding
# boundary an intermediate differs by one bf16 ulp (2^-6 at magnitude 2-4),
# and the output by up to about two.
FUSED_FP32_TOL = dict(atol=1e-4, rtol=1e-4)
FUSED_BF16_TOL = dict(atol=2.0 ** -5, rtol=2.0 ** -6)
# The edge step's statistics are fp32 sums over up to 67M elements, in
# other orders: |kernel - plain| <= STATS_RTOL * (sum of the terms'
# magnitudes); the row count (sum of the mask) is exact.
STATS_RTOL = 1e-5
# The 64x32 model on the card against the CPU, fp32 with TF32 off.
E2E_TOL = dict(atol=1e-3, rtol=1e-3)
# The flagship bf16 serve against fp32 (TF32 off), same weights and request:
# per AR step, RMS(bf16 - fp32) <= BF16_SERVE_RTOL * RMS(fp32).  bf16 keeps
# 8 significant bits (a rounding is within 2^-9 relative); the bound allows
# about 16 such roundings' worth of drift.  The CPU tests hold the same
# serve at a small size to the JAX package's own bf16 error.
BF16_SERVE_RTOL = 2.0 ** -5
# H100 SXM data-sheet rates: HBM3 bytes/s and dense bf16 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
# fp32 outside the tensor cores (the fp32 edge step's FMA design), and
# dense TF32 on the tensor cores (the fp32 edge MLP's 3xTF32 products).
FP32_FLOPS = 67e12
TF32_TC_FLOPS = 495e12
# edge_step at the flagship processor shape before its Hopper redesign:
# the wmma kernel of commit c6b0bb6, H100 80GB HBM3 at 700 W.
EDGE_STEP_EARLIER_MS = 2.1121
# edge_mlp there before its Hopper redesign: the 16-receiver wmma kernel of
# commit 14a3db7, two runs, H100 80GB HBM3 at 700 W.
EDGE_MLP_EARLIER_MS = (0.7095, 0.7006)
# The 64x32 model's train step on the card against the CPU, fp32 with TF32
# off: the loss within TRAIN_LOSS_RTOL relative, and each parameter's
# gradient within TRAIN_GRAD_RTOL of the leaf's largest CPU gradient
# (+ 1e-6).  fp32 rounding alone moves the encoder's first-layer gradients
# of the small CPU-test model (hidden 128, 2 steps) by about 1.2e-4 of
# their largest value (measured there against float64); the card and the
# CPU sum in other orders throughout a model twice as wide and six times
# as deep, so the bound allows about eight times that.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-3
# Train steps of the flagship on one batch: a warm-up, three timed, one
# profiled.
TRAIN_STEPS = 5
REQUESTS = 3
AR_STEPS = 4
# Phase 6a: epochs of Trainer.fit (AR 1, 2, 3, 4 at epochs_per_stage 1),
# steps an epoch, and the frames of its dataset: 6 windows of obs 2 +
# AR 4, 4 of them train samples, 1 validation and 1 test sample.
FIT_EPOCHS = 4
FIT_STEPS = 2
FIT_FRAMES = 11
# Phase 6b: the demo's steps an epoch, and a --rollouts-per-dispatch K
# (accepted, no effect until the batched forward).
DEMO_STEPS = 8
DEMO_K = 4
# The COO routes of the processor, the switches that pick them (the JAX
# package's own), and their exact kernel launches per AR-4 rollout
# (48 = 12 processor steps x 4 AR steps; 8 = 2 encoder GCNConv x 4).
COO_ROUTES = {
    "composed": ({"GCLT_REG_EDGE": "0"},
                 {"segment_sum": 8 + 48, "edge_mlp": 0, "edge_step": 0}),
    "edge_step": ({"GCLT_REG_EDGE": "0", "GCLT_EDGE_STEP": "1"},
                  {"segment_sum": 8, "edge_mlp": 0, "edge_step": 48}),
    "mega": ({"GCLT_REG_EDGE": "0", "GCLT_MEGA_EDGE": "1"},
             {"segment_sum": 8, "edge_mlp": 48, "edge_step": 0}),
}
_SWITCHES = ("GCLT_REG_EDGE", "GCLT_EDGE_STEP", "GCLT_MEGA_EDGE",
             "GCLT_LAZY_EDGE", "GCLT_FUSED_EDGE", "GCLT_GCN_AGG",
             "GCLT_FUSED_SAVE_HPRE")
# The plain (non-lazy) InteractionNet step at the flagship: its routes, the
# switches that pick them, their exact launches per AR-4 rollout and the
# route its steps record.
NONLAZY_ROUTES = {
    "composed": ({"GCLT_LAZY_EDGE": "0"},
                 {"segment_sum": 8 + 48, "edge_mlp": 0, "edge_step": 0},
                 "nonlazy"),
    "mega": ({"GCLT_LAZY_EDGE": "0", "GCLT_MEGA_EDGE": "1"},
             {"segment_sum": 8, "edge_mlp": 48, "edge_step": 0},
             "nonlazy_mega"),
}
# The fp32 plain rollout against the fp32 lazy reg-block rollout of the
# same weights and request, per AR step: RMS(plain - lazy) <=
# NONLAZY_FP32_RTOL * RMS(lazy).  The two differ by the edge LayerNorm's
# variance formula (E[(v - mu)^2] against E[v^2] - mu^2), by the lazy fold
# of each LN into the next step's weights and by the order of the sums, a
# few fp32 roundings (1e-7) a step; the bound allows 10^4 times that over
# 12 steps and 4 AR steps of random weights.
NONLAZY_FP32_RTOL = 1e-3
# The WB2 64x32 BASELINE configurations at their published widths (the
# presets; GAT at the 4 heads of experiments/wb2_64x32_gat), and the
# SparseGAT threshold (its sparsity_thresholds).
BASELINE_CONFIGS = {
    "gcn": ("baseline_gcn_64x32", {}),
    "gat": ("gat_64x32", {"heads": 4}),
    "sparse_gat": ("sparse_gat_64x32", {}),
    "product_graph": ("product_graph_64x32", {}),
}
SPARSE_THR = 0.1356
# SparseGAT masks are compared on the edges whose alpha lies farther than
# this from the threshold (fp32 alpha differs by about 1e-7 card to CPU).
ALPHA_MARGIN = 1e-5
# Phase 6c: the SparseGAT fit's epochs (the schedule prunes from epoch
# index 6), the epoch after which its checkpoint is kept for a resume, the
# product-graph fit's epochs, and the steps an epoch of both.
SPARSE_EPOCHS = 12
SPARSE_RESUME_AFTER = 10
PRODUCT_EPOCHS = 2
USER_STEPS = 4
# Phase 7b: the flagship train step's routes with the fused edge unit and
# the composed routes it replaces: (switches, the route every processor
# step records, COO processor, GCLT_MEGA_EDGE, GCLT_GCN_AGG), and the
# steps of each on one batch (a warm-up, then timed; the loss falls).
FUSED_ROUTES = {
    "fused": ({"GCLT_REG_EDGE": "0"}, "fused", True, False, False),
    "fused_mega": ({"GCLT_REG_EDGE": "0", "GCLT_MEGA_EDGE": "1"}, "fused",
                   True, True, False),
    "composed": ({"GCLT_REG_EDGE": "0", "GCLT_FUSED_EDGE": "0"},
                 "composed", True, False, False),
    "nonlazy_fused": ({"GCLT_LAZY_EDGE": "0"}, "nonlazy_fused", True, False,
                      False),
    "nonlazy_fused_mega": ({"GCLT_LAZY_EDGE": "0", "GCLT_MEGA_EDGE": "1"},
                           "nonlazy_fused", True, True, False),
    "nonlazy": ({"GCLT_LAZY_EDGE": "0", "GCLT_FUSED_EDGE": "0"}, "nonlazy",
                True, False, False),
    "gcn_agg": ({"GCLT_GCN_AGG": "1"}, "reg_block", False, False, True),
}
FUSED_TRAIN_STEPS = 4
# The fp32 steps (TF32 off) held to each other in phase 7b: a switch's
# step and the same step without it, on the same weights and batch (loss
# within TRAIN_LOSS_RTOL, each gradient within TRAIN_GRAD_RTOL of its
# leaf's largest).  They compute the same function with the sums in other
# orders.
FP32_PAIRS = {
    "fused": ({"GCLT_REG_EDGE": "0"},
              {"GCLT_REG_EDGE": "0", "GCLT_FUSED_EDGE": "0"}),
    "fused_mega": ({"GCLT_REG_EDGE": "0", "GCLT_MEGA_EDGE": "1"},
                   {"GCLT_REG_EDGE": "0", "GCLT_FUSED_EDGE": "0"}),
    "nonlazy_fused": ({"GCLT_LAZY_EDGE": "0"},
                      {"GCLT_LAZY_EDGE": "0", "GCLT_FUSED_EDGE": "0"}),
    "gcn_agg": ({"GCLT_GCN_AGG": "1"}, {}),
}
# Phase 7c: cli.train_regional over the README's ROI, the dual-mesh head
# at reg-level 8 (41,046 regional mesh nodes, 228,276 processing edges:
# the fused unit's size), hidden 256, head steps in its one epoch.
REGIONAL_ROI = (20.0, 60.0, 60.0, 140.0)
REGIONAL_LEVEL = 8
REGIONAL_HIDDEN = 256
REGIONAL_STEPS = 3


def _log(*args):
    print(*args, flush=True)


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, flops: float):
    """(least ms, "bytes" | "operations"): the larger of the bytes over the
    HBM rate and the operations over the bf16 tensor-core rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_TC_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def _kernel_modules():
    from graphcast_lite_torch.ops import cuda_segment, edge_mlp, edge_step

    return {"segment_sum": cuda_segment, "edge_mlp": edge_mlp,
            "edge_step": edge_step}


def _reset_launches():
    for mod in _kernel_modules().values():
        mod.launches = 0
    seg = _kernel_modules()["segment_sum"]
    seg.launches_by_csr.clear()
    seg.launches_by_design.update(dict.fromkeys(seg.launches_by_design, 0))


def _launches():
    return {name: mod.launches for name, mod in _kernel_modules().items()}


def _launches_by_design():
    """The segment sum's launches since the last reset, by design."""
    return dict(_kernel_modules()["segment_sum"].launches_by_design)


@contextlib.contextmanager
def _route(env):
    """Set the processor's route switches for the block; restore after."""
    saved = {k: os.environ.get(k) for k in _SWITCHES}
    for k in _SWITCHES:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _sorted_case(gen, num_edges, num_receivers, f, dtype, batch=None,
                 recv=None):
    """Receiver-sorted messages padded to a multiple of 128 rows; padding
    rows are zero and belong to the last receiver.  Returns
    (msgs, indptr) on the card."""
    from graphcast_lite_torch.graphs.structure import indptr_from_receivers

    if recv is None:
        recv = torch.sort(torch.randint(0, num_receivers, (num_edges,),
                                        generator=gen)).values
    e = recv.numel()
    e_pad = ((e + 127) // 128) * 128
    full = torch.full((e_pad,), num_receivers - 1, dtype=torch.int64)
    full[:e] = recv
    shape = ((batch,) if batch else ()) + (e_pad, f)
    msgs = torch.randn(shape, generator=gen)
    msgs[..., e:, :] = 0.0
    indptr = indptr_from_receivers(full, num_receivers)
    return msgs.to("cuda", dtype), indptr.to("cuda")


def _check_kernel(label, msgs, indptr, num_receivers, design=None) -> float:
    """Segment-sum kernel (the design the library picks, or ``design``)
    against the plain version on the same card inputs; returns the max abs
    error."""
    from graphcast_lite_torch.ops import cuda_segment

    out = cuda_segment.segment_sum(msgs, indptr, num_receivers, design)
    ref = cuda_segment.segment_sum_reference(msgs, indptr, num_receivers)
    mag = cuda_segment.segment_sum_reference(msgs.float().abs(), indptr,
                                             num_receivers)
    torch.cuda.synchronize()
    tol = FP32_TOL if msgs.dtype == torch.float32 else BF16_TOL
    err = _close(f"{label} {msgs.dtype}", out, ref, tol, ORDER_RTOL * mag)
    took = design or cuda_segment.segment_design(msgs.dtype, msgs.shape[-1])
    _log(f"  {label:<44s} {str(msgs.dtype):<15s} max|err| {err:.3e} ok "
         f"({took})")
    return err


SEGMENT_DESIGN_WIDTHS = (1, 4, 19, 33, 63, 64, 65, 127, 128, 129, 256, 512,
                         1024)


def _segment_design_check() -> None:
    """Raises unless the segment-sum library and the Python mirror agree on
    the balanced design's tile size, on the narrow design's tile size and
    on the design of every dtype, width and alignment."""
    from graphcast_lite_torch.ops import cuda_segment, nvcc_build

    lib = nvcc_build.load(cuda_segment.SOURCE, cuda_segment.SIGNATURES)
    items = lib.gclt_segment_sum_tile_items()
    if items != cuda_segment.TILE_ITEMS:
        raise AssertionError(f"segment_sum: library tiles of {items} items, "
                             f"Python {cuda_segment.TILE_ITEMS}")
    names = {code: name for name, code in cuda_segment.DESIGNS.items()}
    for dtype, code in nvcc_build.DTYPE_CODES.items():
        for f in SEGMENT_DESIGN_WIDTHS:
            for aligned in (True, False):
                lib_says = names[lib.gclt_segment_sum_design(
                    code, f, int(aligned))]
                py_says = cuda_segment.segment_design(dtype, f, aligned)
                if lib_says != py_says:
                    raise AssertionError(
                        f"segment_sum {dtype} F={f} aligned={aligned}: "
                        f"library {lib_says}, Python {py_says}")
            narrow = cuda_segment.segment_design(dtype, f, False) == "narrow"
            lib_items = lib.gclt_segment_sum_narrow_items(code, f)
            py_items = cuda_segment.narrow_tile_items(dtype, f) \
                if narrow else 0
            if lib_items != py_items:
                raise AssertionError(
                    f"segment_sum {dtype} F={f}: narrow tiles of "
                    f"{lib_items} items in the library, {py_items} in Python")


def _skew_cases(gen):
    """(label, R, sorted receivers) that put receivers on and across the
    balanced design's tiles: no edges at all, one receiver, one receiver of
    50,000 edges among small ones, long receivers that end exactly on tile
    boundaries, and the encoder's layout (a long band of empty rows, then a
    skewed band with 300-edge rows in its middle)."""
    from graphcast_lite_torch.ops import cuda_segment

    small = torch.sort(torch.randint(1, 3_000, (6_000,),
                                     generator=gen)).values
    # 256 receivers of a tile's items (edges and end), one whole tile each,
    # long enough not to be moved (E = 256 x (TILE_ITEMS - 1) rows, a
    # multiple of 128: no padding rows).
    edges = cuda_segment.TILE_ITEMS - 1
    exact = torch.arange(256).repeat_interleave(edges)
    band = torch.randint(0, 10, (20_000,), generator=gen)
    band[9_990:10_010] = 300
    grid = 131_072
    encoder = grid + torch.arange(20_000).repeat_interleave(band)
    return [
        ("E=0, R=50000", 50_000, torch.zeros(0, dtype=torch.int64)),
        ("R=1", 1, torch.zeros(777, dtype=torch.int64)),
        ("receiver with 50000 edges", 3_000,
         torch.cat([torch.zeros(50_000, dtype=torch.int64), small])),
        (f"{edges}-edge receivers, ends on tile ends, R=256", 256, exact),
        ("encoder-shaped: 131072 empty rows, skewed band", grid + 20_000,
         encoder),
    ]


def _bitwise_twice(label, msgs, indptr, r, design=None):
    """Two launches of the segment sum on the same inputs: bitwise equal."""
    from graphcast_lite_torch.ops import cuda_segment

    first = cuda_segment.segment_sum(msgs, indptr, r, design)
    if not torch.equal(first, cuda_segment.segment_sum(msgs, indptr, r,
                                                       design)):
        raise AssertionError(f"{label} {msgs.dtype}: two {design or ''} "
                             "launches differ")


def _misaligned(msgs):
    """The same values in a contiguous view whose data starts one element
    past a 16-byte boundary (msgs.data_ptr() % 16 != 0)."""
    flat = torch.empty(msgs.numel() + 8, dtype=msgs.dtype,
                       device=msgs.device)
    view = flat[1:1 + msgs.numel()].view(msgs.shape)
    view.copy_(msgs)
    if view.data_ptr() % 16 == 0 or not view.is_contiguous():
        raise AssertionError("misaligned view is aligned")
    return view


def phase_kernel_cases():
    from graphcast_lite_torch.ops import cuda_segment

    _log("phase 1: segment_sum kernel vs plain version on the card "
         f"(fp32 {FP32_TOL}, bf16 {BF16_TOL}, order term "
         f"{ORDER_RTOL} * sum|msgs|)")
    _segment_design_check()
    _log(f"  segment_sum design selection: library and Python agree on fp32 "
         f"and bf16 at F in {set(SEGMENT_DESIGN_WIDTHS)}, aligned or not, "
         f"on balanced tiles of {cuda_segment.TILE_ITEMS} merge items and "
         "on the narrow design's tile size at every width")
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for f in (19, 64, 256):
            m, ip = _sorted_case(gen, 60_000, 20_000, f, dtype)
            _check_kernel(f"random sorted E=60000 R=20000 F={f}", m, ip,
                          20_000)
        m, ip = _sorted_case(gen, 30_000, 9_000, 64, dtype, batch=3)
        _check_kernel("batched [3, E, 64]", m, ip, 9_000)
        m, ip = _sorted_case(gen, 0, 50_000, 19, dtype,
                             recv=torch.sort(torch.randint(
                                 20_000, 30_000, (3_001,),
                                 generator=gen)).values)
        _check_kernel("empty receivers + padding rows, F=19", m, ip, 50_000)
        hog = torch.cat([torch.zeros(2_500, dtype=torch.int64),
                         torch.sort(torch.randint(1, 4_000, (8_000,),
                                                  generator=gen)).values])
        m, ip = _sorted_case(gen, 0, 4_000, 256, dtype, recv=hog)
        _check_kernel("receiver with 2500 edges, F=256", m, ip, 4_000)
        for label, r, recv in _skew_cases(gen):
            for f in (19, 64, 256):
                m, ip = _sorted_case(gen, 0, r, f, dtype, recv=recv)
                _check_kernel(f"{label}, F={f}", m, ip, r)
                if f == 19:
                    # The narrow design's shape: PR 1's design on the same
                    # skew, and two narrow launches bitwise equal.
                    _check_kernel(f"{label}, F=19", m, ip, r, design="warp")
                    _bitwise_twice(f"{label}, F=19", m, ip, r, "narrow")
            if "ends on tile ends" in label:
                split = cuda_segment.split_rows(ip).numel()
                if split:
                    raise AssertionError(f"{label}: {split} split rows")
            # PR 1's design on the same skew, and the balanced design twice
            # on the same inputs: bitwise equal.
            _check_kernel(f"{label}, F=256", m, ip, r, design="warp")
            first = cuda_segment.segment_sum(m, ip, r, "balanced")
            again = cuda_segment.segment_sum(m, ip, r, "balanced")
            if not torch.equal(first, again):
                raise AssertionError(f"{label}: two balanced launches differ")
        m, ip = _sorted_case(gen, 30_000, 9_000, 128, dtype, batch=3)
        _check_kernel("batched [3, E, 128]", m, ip, 9_000)
        _bitwise_twice("batched [3, E, 128]", m, ip, 9_000)
        # The narrow design: B = 2 and a misaligned view at every width the
        # port runs narrow (the decoder's F = 19, the 64x32 layers' 1, 4,
        # 33), on the 50,000-edge receiver's CSR.
        hog_r, hog = _skew_cases(gen)[2][1:]
        for f in (1, 4, 19, 33):
            m, ip = _sorted_case(gen, 0, hog_r, f, dtype, batch=2, recv=hog)
            _check_kernel(f"receiver with 50000 edges, batched [2, E, {f}]",
                          m, ip, hog_r)
            _bitwise_twice(f"batched [2, E, {f}]", m, ip, hog_r)
            view = _misaligned(m[0])
            if cuda_segment.segment_design(dtype, f, False) != "narrow":
                raise AssertionError(f"F={f}: misaligned view not narrow")
            _check_kernel(f"receiver with 50000 edges, misaligned view, "
                          f"F={f}", view, ip, hog_r)
            _check_kernel(f"receiver with 50000 edges, misaligned view, "
                          f"F={f}", view, ip, hog_r, design="warp")
            _bitwise_twice(f"misaligned view, F={f}", view, ip, hog_r)
            if not torch.equal(cuda_segment.segment_sum(view, ip, hog_r),
                               cuda_segment.segment_sum(m[0].contiguous(),
                                                        ip, hog_r)):
                raise AssertionError(f"F={f}: a misaligned view sums other "
                                     "bits than the aligned tensor")
        _log(f"  {dtype}: two launches bitwise equal on every skew case at "
             "F=256 (balanced) and F=19 (narrow), batched at F=128, and on "
             "the narrow batched [2, E, F] and misaligned cases at F in "
             "{1, 4, 19, 33}; a misaligned view sums the aligned "
             "tensor's bits")


def _fused_case(gen, num_edges, num_receivers, hid, de, dtype, recv=None):
    """Inputs of both fused kernels on the card: receiver-sorted rows padded
    to a multiple of 128 onto receiver R-1 (mask 0), every 7th real edge
    pruned (mask 0); a and c in fp32."""
    from graphcast_lite_torch.graphs.structure import indptr_from_receivers

    if recv is None:
        recv = torch.sort(torch.randint(0, num_receivers, (num_edges,),
                                        generator=gen)).values
    e = recv.numel()
    e_pad = ((e + 127) // 128) * 128
    full = torch.full((e_pad,), num_receivers - 1, dtype=torch.int64)
    full[:e] = recv
    mask = torch.zeros(e_pad)
    mask[:e] = 1.0
    mask[:e:7] = 0.0

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    t = dict(h_pre=randn(e_pad, hid, scale=2.0), xsg=randn(e_pad, hid),
             v=randn(e_pad, de), xr=randn(num_receivers, hid),
             w1e=randn(de, hid, scale=0.1), b_eff=randn(hid, scale=0.1),
             w2=randn(hid, de, scale=0.1), b2=randn(de, scale=0.1),
             mask=mask)
    out = {k: x.to("cuda", dtype) for k, x in t.items()}
    out["a"] = (1.0 + randn(de, scale=0.1)).cuda()
    out["c"] = randn(de, scale=0.1).cuda()
    out["indptr"] = indptr_from_receivers(full, num_receivers).cuda()
    return out


def _close(label, out, ref, tol, extra=None, unit=None) -> float:
    """Raise unless |out - ref| <= atol * unit + rtol |ref| (+ extra)
    everywhere and out is finite (``unit``: 1, or a per-column scale that
    broadcasts against the output); returns the max abs error."""
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{label}: non-finite kernel output")
    diff = (out - ref).abs()
    atol = tol["atol"] if unit is None else tol["atol"] * unit
    allowed = atol + tol["rtol"] * ref.abs()
    if extra is not None:
        allowed = allowed + extra
    if (diff > allowed).any():
        worst = int(torch.argmax(diff - allowed))
        raise AssertionError(
            f"{label}: {int((diff > allowed).sum())} elements out of "
            f"tolerance; worst |err| {diff.flatten()[worst]:.3e} > "
            f"{allowed.flatten()[worst]:.3e} at flat index {worst} (kernel "
            f"{out.flatten()[worst]:.6e}, plain {ref.flatten()[worst]:.6e})")
    return diff.max().item()


def _tol_share(out, ref, tol, extra=None, unit=None) -> float:
    """The largest share of its tolerance (as ``_close`` states it) that
    any element of ``out`` takes: 1.0 would be at the limit."""
    out, ref = out.float(), ref.float()
    atol = tol["atol"] if unit is None else tol["atol"] * unit
    allowed = atol + tol["rtol"] * ref.abs()
    if extra is not None:
        allowed = allowed + extra
    return ((out - ref).abs() / allowed).max().item()


def _step_fp64(t, r, act="swish"):
    """The edge step evaluated in float64 on the card: (v', agg) and the
    magnitude each element's error is measured against, |a v| + |c| + the
    sum of u's terms' magnitudes (|act(h)| @ |W2| + |b2|) for v', that
    sum masked and summed by receiver for agg."""
    from graphcast_lite_torch.ops import cuda_segment, edge_mlp

    d = {k: t[k].double() for k in ("xsg", "v", "xr", "w1e", "b_eff", "w2",
                                     "b2", "a", "c", "mask")}
    counts = (t["indptr"][1:] - t["indptr"][:-1]).long()
    recv = torch.repeat_interleave(torch.arange(r, device="cuda"), counts,
                                   output_size=d["v"].shape[0])
    h = ((d["xsg"] + d["xr"][recv]) + d["v"] @ d["w1e"]) + d["b_eff"]
    ha = edge_mlp.act_fn(act)(h)
    u = ha @ d["w2"] + d["b2"]
    umag = ha.abs() @ d["w2"].abs() + d["b2"].abs()
    w = d["mask"][:, None]
    v_new = (d["a"] * d["v"] + d["c"]) + u
    vmag = (d["a"] * d["v"]).abs() + d["c"].abs() + umag
    agg = cuda_segment.segment_sum_reference(u * w, t["indptr"], r)
    aggmag = cuda_segment.segment_sum_reference(umag * w, t["indptr"], r)
    return v_new, vmag, agg, aggmag


def _rel_errs(out, ref, mag):
    """(max, RMS) over the elements of |out - ref| / mag (0 where mag is
    0: empty receivers, whose aggregate is exactly 0 in every version)."""
    diff = (out.double() - ref).abs()
    rel = torch.where(mag > 0, diff / mag.clamp_min(1e-300), diff)
    return rel.max().item(), rel.square().mean().sqrt().item()


def _mlp_fp64(t, r, act="swish"):
    """The edge MLP tail evaluated in float64 on the card: (u, agg) and the
    magnitudes their errors are measured against, as ``_step_fp64``."""
    from graphcast_lite_torch.ops import cuda_segment, edge_mlp

    ha = edge_mlp.act_fn(act)(t["h_pre"].double())
    w2, b2 = t["w2"].double(), t["b2"].double()
    u = ha @ w2 + b2
    umag = ha.abs() @ w2.abs() + b2.abs()
    w = t["mask"].double()[:, None]
    return (u, umag, cuda_segment.segment_sum_reference(u * w, t["indptr"], r),
            cuda_segment.segment_sum_reference(umag * w, t["indptr"], r))


def _fp64_errs(label, oracle, kernel, plain):
    """A fp32 kernel's and its plain fp32 version's (rows, agg) against
    their float64 evaluation ``oracle`` (``_step_fp64``, ``_mlp_fp64``):
    max and RMS of the per-element error over the terms' magnitudes, each
    of the four, and the kernel's over the plain version's; logged, and
    returned.  A measurement, not a check: on the card the 3xTF32 products
    accumulate in the tensor cores, whose sums round otherwise than IEEE
    fp32 addition (PERF.md), and the kernels are held to their plain
    versions at FUSED_FP32_TOL instead."""
    errs = {}
    for name, out in (("kernel", kernel), ("plain", plain)):
        errs[name] = (_rel_errs(out[0], oracle[0], oracle[1])
                      + _rel_errs(out[1], oracle[2], oracle[3]))
    names = ("rows max", "rows RMS", "agg max", "agg RMS")
    ratios = [k / p if p > 0 else (0.0 if k == 0 else float("inf"))
              for k, p in zip(errs["kernel"], errs["plain"])]
    _log(f"    vs fp64 {label}: " + "; ".join(
        f"{n} {k:.2e} (plain {p:.2e}, x{q:.2f})"
        for n, k, p, q in zip(names, errs["kernel"], errs["plain"], ratios)))
    return {"kernel": errs["kernel"], "plain": errs["plain"],
            "ratios": ratios}


def _mlp_design(dtype, hid, de) -> str:
    """The design the built edge_mlp library takes at these widths
    ("hopper_bf16", "hopper_fp32" or "tile16"); raises unless it and its
    receivers per group agree with the wrapper's Python mirror."""
    from graphcast_lite_torch.ops import edge_mlp, nvcc_build

    lib = nvcc_build.load(edge_mlp.SOURCE, edge_mlp.SIGNATURES)
    code = nvcc_build.DTYPE_CODES[dtype]
    took = edge_mlp.DESIGNS[lib.gclt_edge_mlp_design(code, hid, de)]
    tile = lib.gclt_edge_mlp_tile_receivers(code, hid, de)
    if (took != edge_mlp.design(dtype, hid, de)
            or tile != edge_mlp.tile_receivers(dtype, hid, de)):
        raise AssertionError(
            f"edge_mlp {dtype} H={hid} De={de}: library says {took}, "
            f"{tile} receivers; Python says "
            f"{edge_mlp.design(dtype, hid, de)}, "
            f"{edge_mlp.tile_receivers(dtype, hid, de)}")
    return took


def _step_design(dtype, hid, de) -> str:
    """The design the built edge_step library takes at these widths
    ("hopper_bf16", "hopper_fp32" or "tile16"); raises unless it and its
    receivers per group agree with the wrapper's Python mirror."""
    from graphcast_lite_torch.ops import edge_step, nvcc_build

    lib = nvcc_build.load(edge_step.SOURCE, edge_step.SIGNATURES)
    code = nvcc_build.DTYPE_CODES[dtype]
    took = edge_step.DESIGNS[lib.gclt_edge_step_design(code, hid, de)]
    tile = lib.gclt_edge_step_tile_receivers(code, hid, de)
    if (took != edge_step.design(dtype, hid, de)
            or tile != edge_step.tile_receivers(dtype, hid, de)):
        raise AssertionError(
            f"edge_step {dtype} H={hid} De={de}: library says {took}, "
            f"{tile} receivers; Python says "
            f"{edge_step.design(dtype, hid, de)}, "
            f"{edge_step.tile_receivers(dtype, hid, de)}")
    return took


def _check_edge_mlp(label, t, r, act="swish", design=None, unit=None):
    """edge_mlp kernel against its plain version, and the design it took
    against ``design`` where given; ``unit`` scales atol per column (a
    case whose W2 columns are scaled by powers of two); fp32: both
    versions' distance to the float64 tail is measured and logged
    (``_fp64_errs``).  Returns the max abs error over u and agg."""
    from graphcast_lite_torch.ops import cuda_segment, edge_mlp

    args = (t["h_pre"], t["w2"], t["b2"], t["mask"], t["indptr"], r, act)
    hid, de = t["w2"].shape
    took = _mlp_design(t["h_pre"].dtype, hid, de)
    if design is not None and took != design:
        raise AssertionError(f"edge_mlp {label}: design {took}, expected "
                             f"{design}")
    u, agg = edge_mlp.edge_mlp(*args)
    u_ref, agg_ref = edge_mlp.edge_mlp_reference(*args)
    mag = cuda_segment.segment_sum_reference(
        u_ref.float().abs() * t["mask"].float()[:, None], t["indptr"], r)
    torch.cuda.synchronize()
    tol = FUSED_FP32_TOL if u.dtype == torch.float32 else FUSED_BF16_TOL
    err = max(_close(f"edge_mlp {label} u", u, u_ref, tol, unit=unit),
              _close(f"edge_mlp {label} agg", agg, agg_ref, tol,
                     ORDER_RTOL * mag, unit=unit))
    share = max(_tol_share(u, u_ref, tol, unit=unit),
                _tol_share(agg, agg_ref, tol, ORDER_RTOL * mag, unit=unit))
    _log(f"  edge_mlp  {label:<46s} {str(u.dtype):<15s} max|err| "
         f"{err:.3e} ({share:.3f} of the tolerance) ok ({took})")
    if u.dtype == torch.float32:
        _fp64_errs(f"edge_mlp {label}", _mlp_fp64(t, r, act), (u, agg),
                   (u_ref, agg_ref))
    return err


def _bitwise_edge_mlp(label, t, r):
    """Two launches of edge_mlp on the same inputs give the same bits."""
    from graphcast_lite_torch.ops import edge_mlp

    args = (t["h_pre"], t["w2"], t["b2"], t["mask"], t["indptr"], r,
            "swish")
    u1, agg1 = edge_mlp.edge_mlp(*args)
    u2, agg2 = edge_mlp.edge_mlp(*args)
    if not (torch.equal(u1, u2) and torch.equal(agg1, agg2)):
        raise AssertionError(f"edge_mlp {label}: two launches differ")
    _log(f"  edge_mlp  {label}: two launches bitwise equal")


def _step_args(t, r, act="swish"):
    return (t["xsg"], t["v"], t["xr"], t["w1e"], t["b_eff"], t["w2"],
            t["b2"], t["a"], t["c"], t["mask"], t["indptr"], r, act)


def _check_edge_step(label, t, r, act="swish", design=None, unit=None,
                     details=None):
    """edge_step kernel against its plain version, and the design it took
    against ``design`` where given; ``unit`` scales atol per column (a
    case whose W2 columns are scaled by powers of two).  fp32: both
    versions' distance to the float64 step is measured and logged
    (``_fp64_errs``).  Returns the max abs error over v_new and agg,
    and that of the stats; ``details``, a dict, takes the largest share of
    the tolerance used and the fp64 figures."""
    from graphcast_lite_torch.ops import cuda_segment, edge_step

    args = _step_args(t, r, act)
    de, hid = t["w1e"].shape
    took = _step_design(t["v"].dtype, hid, de)
    if design is not None and took != design:
        raise AssertionError(f"edge_step {label}: design {took}, expected "
                             f"{design}")
    v_new, agg, stats = edge_step.edge_step(*args)
    v_ref, agg_ref, stats_ref = edge_step.edge_step_reference(*args)
    w = t["mask"].float()[:, None]
    u_mag = (v_ref.float() - t["a"] * t["v"].float() - t["c"]).abs() * w
    agg_mag = cuda_segment.segment_sum_reference(u_mag, t["indptr"], r)
    vf = v_ref.float()
    stats_mag = torch.stack([(vf.abs() * w).sum(), (vf.square() * w).sum(),
                             w.sum()])
    torch.cuda.synchronize()
    tol = FUSED_FP32_TOL if v_new.dtype == torch.float32 else FUSED_BF16_TOL
    err = max(_close(f"edge_step {label} v_new", v_new, v_ref, tol,
                     unit=unit),
              _close(f"edge_step {label} agg", agg, agg_ref, tol,
                     ORDER_RTOL * agg_mag, unit=unit))
    stats_err = _close(f"edge_step {label} stats", stats, stats_ref,
                       dict(atol=0.0, rtol=0.0), STATS_RTOL * stats_mag)
    if stats.dtype != torch.float32 or stats[2].item() != stats_ref[2].item():
        raise AssertionError(f"edge_step {label}: row count {stats[2]} "
                             f"!= {stats_ref[2]}")
    share = max(_tol_share(v_new, v_ref, tol, unit=unit),
                _tol_share(agg, agg_ref, tol, ORDER_RTOL * agg_mag,
                           unit=unit))
    _log(f"  edge_step {label:<46s} {str(v_new.dtype):<15s} max|err| "
         f"{err:.3e} ({share:.3f} of the tolerance), stats {stats_err:.3e} "
         f"ok ({took})")
    fp64 = None
    if v_new.dtype == torch.float32:
        fp64 = _fp64_errs(f"edge_step {label}", _step_fp64(t, r, act),
                          (v_new, agg), (v_ref, agg_ref))
    if details is not None:
        details.update(tolerance_share=share, fp64=fp64)
    return err, stats_err


def _bitwise_edge_step(label, t, r):
    """Two launches of edge_step on the same inputs give the same bits."""
    from graphcast_lite_torch.ops import edge_step

    args = _step_args(t, r)
    out1 = edge_step.edge_step(*args)
    out2 = edge_step.edge_step(*args)
    if not all(torch.equal(x, y) for x, y in zip(out1, out2)):
        raise AssertionError(f"edge_step {label}: two launches differ")
    _log(f"  edge_step {label}: two launches bitwise equal (v_new, agg, "
         "stats)")


def _scaled_step_case(gen, hid, de):
    """The fp32 edge step on rows whose h reaches about |h| = 30, with
    W1e's columns 0, 4, 8, ... scaled by 2^10 and 1, 5, 9, ... by 2^-10
    (and the whole of W1e by 2^-10, so that h stays near that range) and
    W2's and b2's columns scaled the same way by ``unit``; returns (case,
    unit)."""
    t = _fused_case(gen, 60_000, 20_001, hid, de, torch.float32)
    unit1 = torch.ones(hid, device="cuda")
    unit1[0::4] = 2.0 ** 10
    unit1[1::4] = 2.0 ** -10
    unit = torch.ones(de, device="cuda")
    unit[0::4] = 2.0 ** 10
    unit[1::4] = 2.0 ** -10
    t["xsg"] = (t["xsg"] * 5.0).clamp(-12.0, 12.0)
    t["xr"] = (t["xr"] * 5.0).clamp(-12.0, 12.0)
    t["w1e"] = t["w1e"] * (unit1 * 2.0 ** -10)
    t["w2"] = t["w2"] * unit
    t["b2"] = t["b2"] * unit
    return t, unit


def phase_fused_cases():
    _log("phase 1b: edge_mlp and edge_step kernels vs plain versions on the "
         f"card (fp32 {FUSED_FP32_TOL}, bf16 {FUSED_BF16_TOL}; aggregates "
         f"+ {ORDER_RTOL} * sum|u|, stats {STATS_RTOL} * sum of magnitudes)")
    from graphcast_lite_torch.ops import edge_mlp, edge_step, nvcc_build

    lib = nvcc_build.load(edge_mlp.SOURCE, edge_mlp.SIGNATURES)
    step_lib = nvcc_build.load(edge_step.SOURCE, edge_step.SIGNATURES)
    for dtype in (torch.float32, torch.bfloat16):
        for hid in (128, 256, 384, 512):
            for de in (128, 256, 384, 512):
                _mlp_design(dtype, hid, de)
                _step_design(dtype, hid, de)
    _log("  edge_mlp design selection: library and Python agree on fp32 and "
         "bf16 at H, De in {128, 256, 384, 512}; shared memory a block: "
         + ", ".join(
             f"{str(dt)[6:]} {hid}x{de} "
             f"{lib.gclt_edge_mlp_smem(nvcc_build.DTYPE_CODES[dt], hid, de)}"
             f" ({_mlp_design(dt, hid, de)})"
             for dt, hid, de in ((torch.bfloat16, 128, 128),
                                 (torch.bfloat16, 128, 256),
                                 (torch.bfloat16, 256, 128),
                                 (torch.bfloat16, 256, 256),
                                 (torch.bfloat16, 384, 384),
                                 (torch.bfloat16, 384, 128),
                                 (torch.float32, 128, 128),
                                 (torch.float32, 256, 256),
                                 (torch.float32, 384, 384))))
    _log("  edge_step design selection: library and Python agree on fp32 "
         "and bf16 at H, De in {128, 256, 384, 512}; shared memory a block: "
         + ", ".join(
             f"{str(dt)[6:]} {hid}x{de} "
             f"{step_lib.gclt_edge_step_smem(nvcc_build.DTYPE_CODES[dt], hid,
                                             de)}"
             f" ({_step_design(dt, hid, de)})"
             for dt, hid, de in ((torch.bfloat16, 256, 256),
                                 (torch.bfloat16, 384, 384),
                                 (torch.float32, 128, 128),
                                 (torch.float32, 128, 256),
                                 (torch.float32, 256, 128),
                                 (torch.float32, 256, 256),
                                 (torch.float32, 384, 384))))
    gen = torch.Generator().manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        # H, De in {128, 256}: the Hopper design of the dtype, asserted.
        hop = "hopper_fp32" if dtype == torch.float32 else "hopper_bf16"
        for hid, de in ((128, 128), (256, 256), (128, 256)):
            label = f"E=60000 R=20001 H={hid} De={de}"
            t = _fused_case(gen, 60_000, 20_001, hid, de, dtype)
            _check_edge_mlp(label, t, 20_001, design=hop)
            _check_edge_step(label, t, 20_001, design=hop)
        t = _fused_case(gen, 0, 12_003, 256, 256, dtype,
                        recv=torch.sort(torch.randint(
                            5_000, 7_000, (20_001,), generator=gen)).values)
        label = "empty receivers + padding rows, R=12003"
        _check_edge_mlp(label, t, 12_003, "relu", design=hop)
        _check_edge_step(label, t, 12_003, "relu", design=hop)
        hog = torch.cat([torch.zeros(2_500, dtype=torch.int64),
                         torch.sort(torch.randint(1, 4_001, (9_000,),
                                                  generator=gen)).values])
        t = _fused_case(gen, 0, 4_001, 256, 256, dtype, recv=hog)
        label = "receiver with 2500 edges, R=4001"
        _check_edge_mlp(label, t, 4_001, design=hop)
        _check_edge_step(label, t, 4_001, design=hop)
        if dtype == torch.float32:
            _bitwise_edge_mlp(label, t, 4_001)
            _bitwise_edge_step(label, t, 4_001)
        for label, r, recv in _tiling_cases(gen):
            t = _fused_case(gen, 0, r, 256, 256, dtype, recv=recv)
            _check_edge_mlp(label, t, r, design=hop)
            _check_edge_step(label, t, r, design=hop)
    # The fp32 Hopper design (3xTF32 products) on rows up to |h| = 30 with
    # W2's and b2's columns 0, 4, 8, ... scaled by 2^10 and 1, 5, 9, ... by
    # 2^-10, at each of its widths: atol in each column's unit (scaling a
    # column by a power of two scales both versions' results exactly).
    for hid, de in ((128, 128), (256, 128), (128, 256), (256, 256)):
        t = _fused_case(gen, 60_000, 20_001, hid, de, torch.float32)
        unit = torch.ones(de, device="cuda")
        unit[0::4] = 2.0 ** 10
        unit[1::4] = 2.0 ** -10
        t["h_pre"] = (t["h_pre"] * 5.0).clamp(-30.0, 30.0)
        t["w2"] = t["w2"] * unit
        t["b2"] = t["b2"] * unit
        label = f"|h|<=30, W2 cols x 2^+-10, H={hid} De={de}"
        _check_edge_mlp(label, t, 20_001, design="hopper_fp32", unit=unit)
        _bitwise_edge_mlp(label, t, 20_001)
    # The fp32 edge step's Hopper design (3xTF32 products, both of them) the
    # same way: h up to about |h| = 30, W1e's columns and W2's and b2's
    # scaled by 2^10 and 2^-10, atol in each output column's unit.
    for hid, de in ((128, 128), (256, 128), (128, 256), (256, 256)):
        t, unit = _scaled_step_case(gen, hid, de)
        label = f"|h|<=30, W1e, W2 cols x 2^+-10, H={hid} De={de}"
        _check_edge_step(label, t, 20_001, design="hopper_fp32", unit=unit)
        _bitwise_edge_step(label, t, 20_001)
    # Rows wider than the Hopper kernels take run the 16-receiver design
    # (wmma products in bf16, FMA in fp32), where its shared memory holds
    # them: the fp32 edge step at 384 x 384 needs 284,416 bytes, and its
    # wrapper raises.
    for dtype in (torch.float32, torch.bfloat16):
        for hid, de in ((384, 384), (384, 128), (128, 384)):
            t = _fused_case(gen, 20_000, 6_001, hid, de, dtype)
            label = f"E=20000 R=6001 H={hid} De={de}"
            _check_edge_mlp(label, t, 6_001, design="tile16")
            smem = step_lib.gclt_edge_step_smem(
                nvcc_build.DTYPE_CODES[dtype], hid, de)
            if smem <= edge_mlp.MAX_SMEM:
                _check_edge_step(label, t, 6_001, design="tile16")
                continue
            try:
                edge_step.edge_step(*_step_args(t, 6_001))
            except ValueError as exc:
                _log(f"  edge_step {label:<46s} {str(dtype):<15s} raises: "
                     f"{exc}")
            else:
                raise AssertionError(f"edge_step {label} {dtype}: {smem} "
                                     "bytes a block, and no error")


def _tiling_cases(gen):
    """(label, R, sorted receivers) that put receiver runs on and across
    the fused kernels' 64-row sub-tiles and receiver groups."""
    def seq(*runs):
        return torch.cat([torch.full((n,), r, dtype=torch.int64)
                          for r, n in runs])

    rand = torch.sort(torch.randint(4, 50, (300,), generator=gen)).values
    return [
        ("in-degree 1, R=4096", 4_096, torch.arange(4_096)),
        ("in-degrees 0 / 13 alternating, R=4001", 4_001,
         torch.arange(0, 4_001, 2).repeat_interleave(13)),
        ("receivers of exactly 64 and 128 rows, R=50", 50,
         torch.cat([seq((0, 64), (1, 128), (2, 5), (3, 64)), rand])),
        ("one receiver, R=1", 1, torch.zeros(300, dtype=torch.int64)),
        ("R=33", 33, torch.sort(torch.randint(0, 33, (700,),
                                              generator=gen)).values),
    ]


def phase_serve(workdir):
    """The flagship bf16 AR-4 serve through the port's entry points, on the
    default (reg-block) route.  Returns what the later phases reuse."""
    from graphcast_lite_torch import presets
    from graphcast_lite_torch.build import build_weather_model
    from graphcast_lite_torch.data.dataset import load_chunked_datasets
    from graphcast_lite_torch.data.synthetic import generate_synthetic_dataset
    from graphcast_lite_torch.inference.predict import evaluate_model
    from graphcast_lite_torch.training.rollout import RolloutSpec

    _log("phase 2: flagship 512x256 AR-4 bf16 serve "
         "(presets.interaction_net_512x256, seeded random weights), "
         "default route (reg-block)")
    cfg = presets.interaction_net_512x256()
    n_feat, obs = cfg.data.num_features_used, cfg.data.obs_window_used
    t0 = time.perf_counter()
    # 36 frames: 31 windows of obs 2 + AR 4, 4 of them in the test split.
    data_dir = generate_synthetic_dataset(
        os.path.join(workdir, "data"), n_time=36, n_lon=512, n_lat=256,
        n_feat=n_feat, static_channels=list(cfg.static_channels), seed=0)
    _, _, test_ds, meta = load_chunked_datasets(
        data_dir, obs_window=obs, pred_steps=AR_STEPS, n_features=n_feat)
    if len(test_ds) < REQUESTS:
        raise AssertionError(f"test split holds {len(test_ds)} samples")
    _log(f"  synthetic dataset: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    model, graphs, gs = build_weather_model(cfg, meta, device="cuda",
                                            seed=0)
    torch.cuda.synchronize()
    enc, proc = gs.encoding, gs.processing
    _log(f"  graphs + model: {time.perf_counter() - t0:.1f} s; "
         f"G2M E={enc.num_edges} E_pad={enc.padded_num_edges} "
         f"R={enc.num_receivers} max in-degree "
         f"{int(enc.static_in_degree.max())}; multimesh E={proc.num_edges} "
         f"E_pad={proc.padded_num_edges} R={proc.num_receivers} in-degree "
         f"{int(proc.static_in_degree.min())}-"
         f"{int(proc.static_in_degree.max())}; "
         f"params {sum(p.numel() for p in model.parameters())}")
    kw = dict(ar_steps=AR_STEPS, use_residual=cfg.use_residual,
              static_channels=tuple(cfg.static_channels), device="cuda",
              dtype="bf16")

    # Warm-up request (cuBLAS handles, the kernel library), not counted.
    evaluate_model(model, graphs, test_ds, meta, max_samples=1, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    preds_path = os.path.join(workdir, "preds.npz")
    _reset_launches()
    report = evaluate_model(model, graphs, test_ds, meta,
                            max_samples=REQUESTS,
                            save_predictions=preds_path, **kw)
    torch.cuda.synchronize()
    counts = _launches()
    by_design = _launches_by_design()
    peak = torch.cuda.max_memory_allocated()
    # The same requests again, timed without the compressed .npz write.
    t0 = time.perf_counter()
    evaluate_model(model, graphs, test_ds, meta, max_samples=REQUESTS, **kw)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0

    g = gs.num_grid_nodes
    preds = np.load(preds_path)["predictions"]
    if preds.shape != (REQUESTS, g, AR_STEPS * n_feat):
        raise AssertionError(f"predictions shape {preds.shape}")
    if not np.isfinite(preds).all():
        raise AssertionError("non-finite predictions")
    if report.num_samples != REQUESTS or not np.isfinite(report.rmse):
        raise AssertionError(f"report {report.num_samples} {report.rmse}")
    expected = {"segment_sum": 8 * REQUESTS, "edge_mlp": 0, "edge_step": 0}
    if counts != expected:
        raise AssertionError(f"launches {counts} for {REQUESTS} rollouts "
                             f"(expected {expected})")
    launches = counts["segment_sum"]
    _log(f"  {REQUESTS} requests: predictions {preds.shape} finite; "
         f"RMSE {report.rmse:.6f}, persistence {report.baseline_rmse:.6f}, "
         f"skill {report.skill * 100:.2f}% (random weights)")
    _log(f"  segment_sum launches: {launches} "
         f"({launches // REQUESTS} per rollout)")
    _log(f"  evaluate_model wall time per request (host clock, incl. data "
         f"loading and metrics): {wall_s / REQUESTS * 1e3:.1f} ms")

    spec = RolloutSpec(obs_window=obs, num_features=n_feat,
                       use_residual=cfg.use_residual, remat=False,
                       static_channels=tuple(cfg.static_channels))
    ctx = dict(model=model, graphs=graphs, gs=gs, test_ds=test_ds,
               meta=meta, kw=kw, spec=spec, request=test_ds.get(0))
    # Device time of one AR-4 rollout (CUDA events, after a warm-up).
    rollout, smodel = _rollout(ctx, torch.bfloat16)
    rollout_ms = _time_ms(rollout, iters=5, warmup=1)
    stages = _stage_ms(smodel, rollout)
    busy_ms, wall_ms, top = _profile(rollout)
    # The fp32 rollout (TF32 off) that every route's bf16 serve is held to.
    ctx["p32"] = _rollout(ctx, torch.float32)[0]().float()
    bf16_rel_rms = _rel_rms(rollout().float(), ctx["p32"], "reg-block")
    serve = {
        "rollout_ms": rollout_ms,
        "grid_points_per_s": g * AR_STEPS / (rollout_ms / 1e3),
        "peak_mem_bytes": peak,
        "wall_ms_per_request": wall_s / REQUESTS * 1e3,
        "launches": launches,
        "launches_by_design": by_design,
        "stage_ms": stages,
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "bf16_vs_fp32_rel_rms": bf16_rel_rms,
    }
    _log(f"  AR-4 rollout (CUDA events, mean of 5): {rollout_ms:.2f} ms; "
         f"{serve['grid_points_per_s']:.4g} grid-points/s "
         f"({g} points x {AR_STEPS} steps); peak allocated "
         f"{peak / 2**30:.3f} GiB")
    _log("  one rollout by stage (CUDA events around the model's encoder, "
         "processor and decoder; rest = rollout loop): "
         + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items()))
    _log(f"  torch.profiler, one rollout: device busy {busy_ms:.2f} ms of "
         f"{wall_ms:.2f} ms wall (idle share "
         f"{serve['device_idle_share']:.3f}); top kernels by device time:")
    for name, n, ms in top:
        _log(f"    {ms:9.3f} ms  {n:5d} calls  {name[:90]}")
    return ctx, serve


def _rollout(ctx, dtype):
    """(rollout, serving model): one AR-4 rollout of the flagship request
    in ``dtype`` on the card, through ``rollout_predict``."""
    from graphcast_lite_torch.inference.predict import serving_copy
    from graphcast_lite_torch.training.rollout import rollout_predict

    smodel, sgraphs = serving_copy(ctx["model"], ctx["graphs"],
                                   torch.device("cuda"), dtype)
    spec, (x, y) = ctx["spec"], ctx["request"]
    g, obs, c = x.shape[0], spec.obs_window, spec.num_features
    window = torch.from_numpy(x.reshape(g, obs, c)).to("cuda", dtype)
    forcing = torch.from_numpy(y.reshape(g, AR_STEPS, c)).to("cuda", dtype)

    def model_fn(inp, m, t, p):
        return smodel(inp, sgraphs)[0], None

    def rollout():
        with torch.inference_mode():
            return rollout_predict(model_fn, window, AR_STEPS, spec,
                                   forcing=forcing)

    return rollout, smodel


def _rel_rms(p16, p32, label, ref="the fp32 reg-block rollout",
             tol=BF16_SERVE_RTOL, what="bf16"):
    """Relative RMS distance, per AR step, of a rollout (by default bf16)
    from ``ref`` (by default the fp32 reg-block rollout) of the same
    weights on the same request; raises above ``tol`` or on a non-finite
    value."""
    if not torch.isfinite(p16).all():
        raise AssertionError(f"{label}: non-finite {what} rollout")
    rel = [(torch.linalg.vector_norm(p16[:, s] - p32[:, s])
            / torch.linalg.vector_norm(p32[:, s])).item()
           for s in range(AR_STEPS)]
    _log(f"  {label}: {what} against {ref} (TF32 off), same weights and "
         f"request, RMS({what} - ref) / RMS(ref) per AR step: "
         + ", ".join(f"{r:.4e}" for r in rel) + f" (tolerance {tol:.4e})")
    if not all(np.isfinite(rel)) or max(rel) > tol:
        raise AssertionError(f"{label}: {what} rollout off {ref}: {rel}")
    return rel


def phase_coo_serve(ctx):
    """One flagship bf16 request through ``evaluate_model`` on each COO
    route: exact launch counts, finite predictions, bf16 against the fp32
    reg-block rollout, rollout time and peak memory."""
    from graphcast_lite_torch.inference.predict import evaluate_model

    _log("phase 2b: flagship 512x256 AR-4 bf16 serve on the COO routes "
         "(one request each)")
    g = ctx["gs"].num_grid_nodes
    out = {}
    for route, (env, expected) in COO_ROUTES.items():
        with _route(env):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            report = evaluate_model(ctx["model"], ctx["graphs"],
                                    ctx["test_ds"], ctx["meta"],
                                    max_samples=1, **ctx["kw"])
            torch.cuda.synchronize()
            counts = _launches()
            peak = torch.cuda.max_memory_allocated()
            # A non-finite prediction makes the RMSE non-finite.
            if report.num_samples != 1 or not np.isfinite(report.rmse):
                raise AssertionError(f"{route}: report {report.num_samples} "
                                     f"{report.rmse}")
            if counts != expected:
                raise AssertionError(f"{route}: launches per rollout "
                                     f"{counts}, expected {expected}")
            rollout, smodel = _rollout(ctx, torch.bfloat16)
            rollout_ms = _time_ms(rollout, iters=5, warmup=1)
            stages = _stage_ms(smodel, rollout)
            busy_ms, wall_ms, top = _profile(rollout, top_n=3)
            rel = _rel_rms(rollout().float(), ctx["p32"], route)
        out[route] = {
            "switches": env, "launches_per_rollout": counts,
            "rollout_ms": rollout_ms,
            "grid_points_per_s": g * AR_STEPS / (rollout_ms / 1e3),
            "peak_mem_bytes": peak, "stage_ms": stages,
            "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "bf16_vs_fp32_rel_rms": rel, "rmse": report.rmse,
        }
        _log(f"  {route} {env}: launches per rollout {counts}; RMSE "
             f"{report.rmse:.6f} (finite); rollout {rollout_ms:.2f} ms, "
             f"{out[route]['grid_points_per_s']:.4g} grid-points/s, peak "
             f"allocated {peak / 2**30:.3f} GiB; by stage "
             + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items()))
        _log(f"    torch.profiler, one rollout: device busy {busy_ms:.2f} ms "
             f"of {wall_ms:.2f} ms wall (idle share "
             f"{out[route]['device_idle_share']:.3f}); top kernels: "
             + "; ".join(f"{name[:40]} {n} calls {ms:.2f} ms"
                         for name, n, ms in top))
    return out


def _stage_ms(model, run):
    """Device ms of the encoder, processor and decoder over one run, from
    CUDA events recorded by forward hooks; ``rest`` is the remainder."""
    events = {name: [] for name in ("encoder", "processor", "decoder")}
    handles = []
    for name, evs in events.items():
        mod = getattr(model, name)

        def pre(_m, _args, evs=evs):
            evs.append([torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True)])
            evs[-1][0].record()

        def post(_m, _args, _out, evs=evs):
            evs[-1][1].record()

        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    out = {name: sum(a.elapsed_time(b) for a, b in evs)
           for name, evs in events.items()}
    out["rest"] = start.elapsed_time(end) - sum(out.values())
    return out


def _profile(run, top_n=12):
    """(device busy ms, wall ms, [(kernel, calls, device ms)]) of one run
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    top = [(e.key, e.count, e.self_device_time_total / 1e3)
           for e in kernels[:top_n]]
    return busy_ms, wall_ms, top


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _segment_raw(msgs, indptr, r, design, floor=False, lib=None):
    """A raw launch of the segment-sum library (``lib``, by default the
    package's) in ``design`` (no wrapper: the output, scratch and the 15
    arguments made once, outside the call; the scratch sized by the
    library's own tile queries), or with ``floor`` an empty kernel on that
    design's grid, block and shared memory (``gclt_segment_sum_floor``).
    Launches made this way are not counted in ``cuda_segment.launches``."""
    from graphcast_lite_torch.ops import cuda_segment, nvcc_build

    if lib is None:
        lib = nvcc_build.load(cuda_segment.SOURCE, cuda_segment.SIGNATURES)
    batch = msgs.shape[0] if msgs.dim() == 3 else 1
    e, f = msgs.shape[-2], msgs.shape[-1]
    dtype = nvcc_build.DTYPE_CODES[msgs.dtype]
    code = cuda_segment.DESIGNS[design]
    stream = torch.cuda.current_stream().cuda_stream
    if floor:
        args = (code, dtype, r, e, f, batch, stream)

        def call():
            err = lib.gclt_segment_sum_floor(*args)
            if err != 0:
                raise RuntimeError(f"floor {design}: CUDA error {err}")
        return call
    out = torch.empty(msgs.shape[:-2] + (r, f), dtype=msgs.dtype,
                      device=msgs.device)
    items = {"balanced": lib.gclt_segment_sum_tile_items, "warp": lambda: 1,
             "narrow": lambda: lib.gclt_segment_sum_narrow_items(dtype, f)}[
        design]()
    tiles = batch * max(1, -(-(r + e) // max(1, items)))
    ws = torch.empty(tiles * 2 * f, dtype=torch.float32, device=msgs.device)
    counters = torch.zeros(tiles, dtype=torch.int32, device=msgs.device)
    args = (msgs.data_ptr(), indptr.data_ptr(), out.data_ptr(),
            ws.data_ptr(), ws.numel() * 4, counters.data_ptr(), dtype, r, e,
            f, batch, e * f, r * f, code, stream)

    def call():
        err = lib.gclt_segment_sum(*args)
        if err != 0:
            raise RuntimeError(f"{design}: CUDA error {err}")
        return out

    call.keep = (msgs, indptr, out, ws, counters)  # alive with the call
    return call


# GPU cycles of the sleep kernel that holds the stream while the host
# queues the launches _device_ms times (about 3 ms on an H100).
SLEEP_CYCLES = 5_000_000


def _device_ms(call, iters: int = 50) -> float:
    """Mean device time a launch of ``call`` (which launches one kernel)
    over ``iters`` launches queued back to back behind a sleep kernel
    (``torch.cuda._sleep``), CUDA events around them: the kernel's own time
    and the card's gap between two launches, without the host's time a
    call.  Raises if the host took longer to queue them than the sleep
    lasted (the queue ran dry)."""
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    slept = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_start = torch.cuda.Event(enable_timing=True)
    sleep_start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    slept.record()
    torch.cuda.synchronize()
    sleep_ms = sleep_start.elapsed_time(slept)
    if host_ms > sleep_ms:
        raise AssertionError(f"queueing {iters} launches took {host_ms:.3f} "
                             f"ms on the host, the sleep {sleep_ms:.3f} ms")
    return start.elapsed_time(end) / iters


def _time_segment_sum(label, msgs, indptr, r):
    """The segment sum at one shape: checked against the plain version in
    the design the library picks and in PR 1's warp-per-row design; both
    timed in turns (picked, warp, warp, picked) through the wrapper (CUDA
    events over 50 calls, the host's share of a call included) and, where
    the picked design is narrow, alone (raw launches queued behind a sleep
    kernel: ``_device_ms``) beside the launch floor (an empty kernel on the
    narrow grid, timed the same way); against the bound, the plain version
    and one PyTorch call."""
    from graphcast_lite_torch.ops import cuda_segment

    design = cuda_segment.segment_design(msgs.dtype, msgs.shape[-1])
    err = _check_kernel(f"{label} E_pad={msgs.shape[-2]} R={r} "
                        f"F={msgs.shape[-1]}", msgs, indptr, r)
    _check_kernel(f"{label} (warp design)", msgs, indptr, r, design="warp")
    # 50 launches a timing, as scripts/torch_segment_split.py times them:
    # the two designs differ by a few percent at the processor shape.
    picked = []
    warp = []
    for times in (picked, warp, warp, picked):
        which = design if times is picked else "warp"
        times.append(_time_ms(lambda: cuda_segment.segment_sum(
            msgs, indptr, r, which), iters=50, warmup=10))
    alone = {}
    if design == "narrow":
        raw = {d: _segment_raw(msgs, indptr, r, d) for d in (design, "warp")}
        for which in (design, "warp", "warp", design):
            alone.setdefault(which, []).append(_device_ms(raw[which]))
        alone["floor"] = [_device_ms(_segment_raw(msgs, indptr, r, design,
                                                  floor=True))]
    ms = sum(picked) / 2
    plain_ms = _time_ms(
        lambda: cuda_segment.segment_sum_reference(msgs, indptr, r))
    # The yardstick: one PyTorch call computing the same function.
    lengths = (indptr[1:] - indptr[:-1]).long()
    library_call = "torch.segment_reduce(msgs, 'sum', lengths)"
    library_ms = _time_ms(lambda: torch.segment_reduce(
        msgs, "sum", lengths=lengths, axis=0))
    nbytes = _nbytes(msgs, indptr) + r * msgs.shape[-1] * msgs.element_size()
    bound_ms, bound_by = _bound(nbytes, msgs.numel())
    line = (f"  segment_sum {label}: {design} wrapper "
            + ", ".join(f"{t * 1e3:.1f}" for t in picked)
            + " us (fraction " + ", ".join(f"{bound_ms / t:.3f}"
                                           for t in picked)
            + ") | warp-per-row (PR 1) wrapper "
            + ", ".join(f"{t * 1e3:.1f}" for t in warp) + " us")
    if alone:
        line += (f" | kernel alone: {design} "
                 + ", ".join(f"{t * 1e3:.2f}" for t in alone[design])
                 + " us (fraction " + ", ".join(
                     f"{bound_ms / t:.3f}" for t in alone[design])
                 + "), warp " + ", ".join(f"{t * 1e3:.2f}"
                                          for t in alone["warp"])
                 + f" us, launch floor {alone['floor'][0] * 1e3:.2f} us")
    _log(line + f" | bound {bound_ms * 1e3:.2f} us ({bound_by}; "
         f"{nbytes / 1e6:.2f} MB) | plain {plain_ms * 1e3:.1f} us | "
         f"{library_call} {library_ms * 1e3:.1f} us")
    out = {"max_abs_err": err, "ms": ms, "ms_runs": picked,
           "design": design, "earlier_ms": sum(warp) / 2,
           "earlier_ms_runs": warp, "earlier_design": "warp",
           "fraction_of_bound": bound_ms / ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms, "library_call": library_call}
    if alone:
        out.update(kernel_ms=sum(alone[design]) / 2,
                   kernel_ms_runs=alone[design],
                   earlier_kernel_ms=sum(alone["warp"]) / 2,
                   earlier_kernel_ms_runs=alone["warp"],
                   floor_ms=alone["floor"][0],
                   kernel_fraction_of_bound=bound_ms / (
                       sum(alone[design]) / 2))
    return out


def phase_kernel_flagship(gs, n_feat):
    """Each kernel at its flagship shapes in bf16: the segment sum at the
    encoder shape (the default route), at the processor shape (the COO
    composed route) and at the sender-sorted scatters of the train step's
    backward, the fused kernels at the processor shape."""
    from graphcast_lite_torch.ops import edge_mlp, edge_step

    _log("phase 3: kernel times at the flagship shapes, bf16 (CUDA events; "
         f"bound = max(bytes / {HBM_BYTES_PER_S:.3g} B/s, operations / "
         f"{BF16_TC_FLOPS:.3g} FLOP/s))")
    gen = torch.Generator().manual_seed(1)
    enc = gs.encoding.to("cuda")
    msgs = (torch.randn(enc.padded_num_edges, 256, generator=gen)
            * enc.edge_mask.cpu()[:, None]).to("cuda", torch.bfloat16)
    seg_enc = _time_segment_sum("flagship G2M", msgs, enc.indptr,
                                enc.num_receivers)
    # Trainer.fit evaluates in fp32 on the uncast graphs: the same shape in
    # fp32.
    seg_enc32 = _time_segment_sum("flagship G2M fp32", msgs.float(),
                                  enc.indptr, enc.num_receivers)

    proc = gs.processing.to("cuda", torch.bfloat16)
    r, e_pad, hid = proc.num_receivers, proc.padded_num_edges, 256
    t = _fused_case(gen, 0, r, hid, hid, torch.bfloat16,
                    recv=gs.processing.receivers.long())
    t["mask"] = proc.edge_mask
    mask2 = t["mask"][:, None]
    seg_proc = _time_segment_sum("flagship multimesh", (t["v"] * mask2),
                                 t["indptr"], r)
    seg_send = {}
    for label, perm, indptr, rows, n, f in _sender_csrs(gs, n_feat):
        seg_send[label] = _time_segment_sum(
            label, _sender_msgs(gen, perm, rows, f, torch.bfloat16),
            indptr.to("cuda"), n)

    label = f"flagship multimesh E_pad={e_pad} R={r} H=De={hid}"
    mlp_err = _check_edge_mlp(label, t, r, design="hopper_bf16")
    mlp_args = (t["h_pre"], t["w2"], t["b2"], t["mask"], t["indptr"], r,
                "swish")
    mlp_bytes = _nbytes(t["h_pre"], t["w2"], t["b2"], t["mask"],
                        t["indptr"]) + (e_pad + r) * hid * 2
    mlp_bound, mlp_by = _bound(mlp_bytes, 2 * e_pad * hid * hid)
    mlp = {"max_abs_err": mlp_err,
           "ms": _time_ms(lambda: edge_mlp.edge_mlp(*mlp_args)),
           "plain_ms": _time_ms(lambda: edge_mlp.edge_mlp_reference(
               *mlp_args), iters=5, warmup=1),
           "bound_ms": mlp_bound, "bound_by": mlp_by,
           "design": "hopper_bf16"}
    mlp["fraction_of_bound"] = mlp["bound_ms"] / mlp["ms"]

    step_err, stats_err = _check_edge_step(label, t, r, design="hopper_bf16")
    step_args = _step_args(t, r)
    step_bytes = _nbytes(*step_args[:11]) + (e_pad + r) * hid * 2 + 3 * 4
    step_bound, step_by = _bound(step_bytes, 4 * e_pad * hid * hid)
    step = {"max_abs_err": step_err, "stats_abs_err": stats_err,
            "ms": _time_ms(lambda: edge_step.edge_step(*step_args)),
            "plain_ms": _time_ms(lambda: edge_step.edge_step_reference(
                *step_args), iters=5, warmup=1),
            "bound_ms": step_bound, "bound_by": step_by,
            "design": "hopper_bf16"}
    step["fraction_of_bound"] = step["bound_ms"] / step["ms"]
    for name, k, nbytes in (("edge_mlp", mlp, mlp_bytes),
                            ("edge_step", step, step_bytes)):
        k.update(library_ms=None, library_call=None)
        _log(f"  {name}: kernel {k['ms'] * 1e3:.1f} us | bound "
             f"{k['bound_ms'] * 1e3:.1f} us ({k['bound_by']}; "
             f"{nbytes / 1e6:.1f} MB) | plain {k['plain_ms'] * 1e3:.1f} us "
             "| no single PyTorch call computes this fused function")
    _log(f"  edge_step: bound / kernel = {step['fraction_of_bound']:.4f}; "
         f"earlier (wmma) kernel {EDGE_STEP_EARLIER_MS * 1e3:.1f} us")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = edge_mlp.subtiles_per_block(t["indptr"], sms)
    groups, blocks = edge_mlp.hopper_geometry(r, sms)
    _log(f"  edge_mlp: design {mlp['design']} (W2 resident, wgmma, "
         f"persistent blocks); bound / kernel = "
         f"{mlp['fraction_of_bound']:.4f}; earlier (16-receiver wmma) kernel "
         + ", ".join(f"{ms * 1e3:.1f}" for ms in EDGE_MLP_EARLIER_MS)
         + f" us; {groups} groups of {edge_mlp.HOPPER_RECEIVERS} receivers "
         f"on {blocks} blocks: {int(tiles.sum())} sub-tiles, "
         f"{int(tiles.max())} on the busiest block, "
         f"{tiles.float().mean().item():.1f} on average")
    return seg_enc, seg_enc32, seg_proc, seg_send, mlp, step


def phase_numerics():
    """The 64x32 flagship architecture, fp32: card against CPU, on the
    reg-block route and on each COO route."""
    import copy

    from graphcast_lite_torch import presets
    from graphcast_lite_torch.graphs.build import build_graph_set
    from graphcast_lite_torch.models.weather import ModelGraphs, WeatherModel
    from graphcast_lite_torch.training.rollout import RolloutSpec, \
        rollout_predict

    _log("phase 4: 64x32 flagship architecture, fp32, card vs CPU, AR-4 "
         f"(matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
         f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, {E2E_TOL})")
    cfg = presets.interaction_net_64x32()
    lat, lon = presets.wb2_64x32_grid()
    gs = build_graph_set(lat, lon, cfg.graph.mesh_levels,
                         cfg.graph.grid2mesh_radius_query)
    c, obs = cfg.data.num_features_used, cfg.data.obs_window_used
    g = gs.num_grid_nodes
    model = WeatherModel(cfg.pipeline, cfg.data, g, gs.num_mesh_nodes,
                         generator=torch.Generator().manual_seed(0)).eval()
    graphs = ModelGraphs.from_graph_set(gs)
    rng = np.random.RandomState(0)
    window = torch.from_numpy(rng.randn(g, obs, c).astype(np.float32))
    spec = RolloutSpec(obs_window=obs, num_features=c, remat=False)

    def run(device):
        m = copy.deepcopy(model).to(device)
        gr = graphs.to(device)

        def model_fn(inp, mask, t, p):
            return m(inp, gr)[0], None

        with torch.inference_mode():
            out = rollout_predict(model_fn, window.to(device), AR_STEPS, spec)
        return out.cpu()

    routes = {"reg-block": ({}, {"segment_sum": 8, "edge_mlp": 0,
                                 "edge_step": 0})}
    routes.update(COO_ROUTES)
    for name, (env, expected) in routes.items():
        with _route(env):
            _reset_launches()
            card = run("cuda")
            counts = _launches()
            cpu = run("cpu")
        if card.shape != (g, AR_STEPS, c) or not torch.isfinite(card).all():
            raise AssertionError(f"{name}: card output {tuple(card.shape)} "
                                 "not finite")
        if counts != expected:
            raise AssertionError(f"{name}: launches {counts}, expected "
                                 f"{expected}")
        err = (card - cpu).abs().max().item()
        torch.testing.assert_close(card, cpu, **E2E_TOL)
        _log(f"  {name}: output {tuple(card.shape)}; launches {counts}; "
             f"max|card - cpu| {err:.3e} ok")


def _sender_csrs(gs, n_feat):
    """(label, perm, indptr, message rows, R, F) of the sender-sorted
    scatters in the flagship train step's backward: the reg-edge unit's
    sender scatter and the encoder's and decoder's GCNConv gather adjoints
    (the decoder's second conv at the output width ``n_feat``)."""
    rb = gs.processing.reg_blocks
    enc, dec = gs.encoding, gs.decoding
    return [
        ("reg-edge sender scatter F=256", rb.s_perm, rb.s_indptr,
         rb.rows_padded, rb.num_nodes, 256),
        ("encoder GCN gather adjoint F=256", enc.s_perm, enc.s_indptr,
         enc.padded_num_edges, enc.num_nodes, 256),
        ("decoder GCN gather adjoint F=256", dec.s_perm, dec.s_indptr,
         dec.padded_num_edges, dec.num_nodes, 256),
        (f"decoder GCN gather adjoint F={n_feat}", dec.s_perm,
         dec.s_indptr, dec.padded_num_edges, dec.num_nodes, n_feat),
    ]


def _sender_msgs(gen, perm, rows, f, dtype):
    """Random cotangent rows [rows, F] put in sender order on the card, as
    the backward builds them (an ``index_select`` by the sort)."""
    g = torch.randn(rows, f, generator=gen).to("cuda", dtype)
    return g.index_select(0, perm.to("cuda"))


def phase_sender_scatter_cases(gs, n_feat):
    """5a: the segment sum against its plain version, fp32 and bf16, on the
    sender-sorted CSRs of the flagship graphs, and two launches bitwise
    equal."""
    from graphcast_lite_torch.ops import cuda_segment

    _log("phase 5a: segment_sum on the train step's sender-sorted CSRs "
         "(permuted cotangent rows), fp32 and bf16")
    gen = torch.Generator().manual_seed(5)
    for label, perm, indptr, rows, r, f in _sender_csrs(gs, n_feat):
        deg = indptr[1:] - indptr[:-1]
        _log(f"  {label}: {rows} rows into R={r}; out-degree max "
             f"{int(deg.max())}, {int((deg == 0).sum())} empty rows")
        ip = indptr.to("cuda")
        for dtype in (torch.float32, torch.bfloat16):
            msgs = _sender_msgs(gen, perm, rows, f, dtype)
            _check_kernel(f"{label} F={f}", msgs, ip, r)
            first = cuda_segment.segment_sum(msgs, ip, r)
            if not torch.equal(first, cuda_segment.segment_sum(msgs, ip, r)):
                raise AssertionError(f"{label} {dtype}: two launches differ")


def _train_launches(model, graphs, ar_steps=AR_STEPS) -> dict:
    """The segment-sum launches one AR-``ar_steps`` train step (BPTT, a
    checkpoint per AR step) should make, by the CSR and shape the wrapper
    counts them at (``cuda_segment.launches_by_csr``): label -> [key,
    count].  Per AR step: each encoder GCNConv aggregates over the
    receiver CSR in the forward and again in the recompute (the decoder's
    constant in-degree aggregation is a reshape-sum); each reg-block
    processor step scatters over its senders' CSR; each GCNConv of the
    encoder and the decoder takes its gather adjoint over its graph's
    senders' CSR."""
    enc, dec = graphs.encoding, graphs.decoding
    rb = graphs.processing.reg_blocks
    if dec.const_in_degree <= 0:
        raise AssertionError("decoder graph without constant in-degree")
    out = {}

    def add(label, indptr, r, e, f, n):
        entry = out.setdefault(f"{label} F={f}",
                               [(indptr.data_ptr(), r, e, f), 0])
        entry[1] += ar_steps * n

    def widths(layer):
        return [getattr(layer, f"conv_{i}").kernel.shape[1]
                for i in range(layer.num_convs)]

    for f in widths(model.encoder.graph_layer):
        add("encoder aggregation (forward + recompute)", enc.indptr,
            enc.num_receivers, enc.padded_num_edges, f, 2)
    for s in model.processor.graph_layer.inet.steps:
        add("reg-edge sender scatter", rb.s_indptr, rb.num_nodes,
            rb.rows_padded, s.hidden_dim, 1)
    for f in widths(model.encoder.graph_layer):
        add("encoder GCN gather adjoint", enc.s_indptr, enc.num_nodes,
            enc.padded_num_edges, f, 1)
    for f in widths(model.decoder.graph_layer):
        add("decoder GCN gather adjoint", dec.s_indptr, dec.num_nodes,
            dec.padded_num_edges, f, 1)
    return out


def _csr_launches(expected: dict) -> dict:
    """The segment-sum launches counted since the last reset, by the labels
    of ``expected`` (``_train_launches``); raises on launches at a CSR or
    shape that ``expected`` does not name."""
    from graphcast_lite_torch.ops import cuda_segment

    counted = dict(cuda_segment.launches_by_csr)
    got = {label: counted.pop(key, 0) for label, (key, _) in expected.items()}
    if counted:
        raise AssertionError(f"segment_sum launched at unexpected CSRs or "
                             f"shapes (indptr, R, E, F): {counted}")
    return got


def _grads(model):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().cpu() for n, p in model.named_parameters()}


def phase_train_numerics():
    """5b: the 64x32 flagship architecture's fp32 train step (TF32 off) on
    the card against the CPU: loss and every gradient; then the card's Adam
    update against the closed form of a first Adam step on its own
    gradients."""
    import copy

    from graphcast_lite_torch import presets
    from graphcast_lite_torch.graphs.build import build_graph_set
    from graphcast_lite_torch.models.weather import ModelGraphs, WeatherModel
    from graphcast_lite_torch.training.loss import lat_weights_from_axis
    from graphcast_lite_torch.training.rollout import RolloutSpec
    from graphcast_lite_torch.training.trainer import make_train_step

    _log("phase 5b: 64x32 flagship architecture, fp32 AR-4 train step, card "
         f"vs CPU (loss rtol {TRAIN_LOSS_RTOL}, each gradient "
         f"{TRAIN_GRAD_RTOL} x its largest + 1e-6)")
    cfg = presets.interaction_net_64x32()
    lat, lon = presets.wb2_64x32_grid()
    gs = build_graph_set(lat, lon, cfg.graph.mesh_levels,
                         cfg.graph.grid2mesh_radius_query)
    c, obs, g = (cfg.data.num_features_used, cfg.data.obs_window_used,
                 gs.num_grid_nodes)
    model = WeatherModel(cfg.pipeline, cfg.data, g, gs.num_mesh_nodes,
                         generator=torch.Generator().manual_seed(0))
    graphs = ModelGraphs.from_graph_set(gs)
    spec = RolloutSpec(obs_window=obs, num_features=c,
                       use_residual=cfg.use_residual, remat=True)
    rng = np.random.RandomState(0)
    x = rng.randn(1, g, obs * c).astype(np.float32)
    y = rng.randn(1, g, AR_STEPS * c).astype(np.float32)
    lw = lat_weights_from_axis(len(lat), len(lon))
    out = {}
    for device in ("cuda", "cpu"):
        m = copy.deepcopy(model)
        step = make_train_step(m, graphs, spec, cfg, device=device,
                               lat_weights=lw)
        parts = _train_launches(m, step.graphs)
        before = {n: p.detach().cpu().clone()
                  for n, p in m.named_parameters()}
        _reset_launches()
        loss = step(x, y).item()
        counts = dict(_launches(), by_csr=_csr_launches(parts))
        out[device] = (loss, _grads(m), before,
                       {n: p.detach().cpu() for n, p in m.named_parameters()},
                       counts, parts)
    loss, grads, before, after, counts, parts = out["cuda"]
    loss_cpu, grads_cpu = out["cpu"][:2]
    by_csr = {label: n for label, (_, n) in parts.items()}
    expected = sum(by_csr.values())
    if counts != {"segment_sum": expected, "edge_mlp": 0, "edge_step": 0,
                  "by_csr": by_csr}:
        raise AssertionError(f"64x32 train step launches {counts}, expected "
                             f"{expected} segment sums ({by_csr})")
    if not (np.isfinite(loss)
            and abs(loss - loss_cpu) <= TRAIN_LOSS_RTOL * abs(loss_cpu)):
        raise AssertionError(f"64x32 train loss card {loss} cpu {loss_cpu}")
    worst = (0.0, "")
    for name, ref in grads_cpu.items():
        got = grads[name]
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite card gradient")
        err = (got - ref).abs().max().item()
        tol = TRAIN_GRAD_RTOL * ref.abs().max().item() + 1e-6
        if err > tol:
            raise AssertionError(f"{name}: card gradient off the CPU's by "
                                 f"{err:.3e} > {tol:.3e}")
        worst = max(worst, (err / tol, name))
    # A first Adam step moves each parameter by lr * g / (|g| + eps); the
    # fp32 result rounds it once more (2^-23 relative).
    lr, eps = cfg.learning_rate, 1e-8
    adam_err = 0.0
    for name, p0 in before.items():
        g64 = grads[name].double()
        expect = p0.double() - lr * g64 / (g64.abs() + eps)
        err = (after[name].double() - expect).abs()
        if (err > 1e-4 * lr + 2.0 ** -23 * expect.abs()).any():
            raise AssertionError(f"{name}: card Adam step off its closed "
                                 f"form by {err.max().item():.3e}")
        adam_err = max(adam_err, err.max().item())
    _log(f"  loss card {loss:.7f} cpu {loss_cpu:.7f}; {len(grads)} gradients, "
         f"largest error {worst[0]:.3f} of its tolerance ({worst[1]}); "
         f"segment_sum launches {expected}; Adam step within "
         f"{adam_err:.2e} of lr * g / (|g| + eps) (lr {lr})")
    return {"loss_card": loss, "loss_cpu": loss_cpu,
            "worst_grad_err_of_tol": worst[0], "worst_grad_leaf": worst[1],
            "adam_max_abs_err": adam_err, "launches": expected}


def phase_train(ctx):
    """5c: the flagship 512x256 train step in bf16 mixed precision through
    ``make_train_step`` on the default route: TRAIN_STEPS steps on one
    seeded batch; exact launch counts each step; the loss falls; step and
    forward-loss times, peak memory and one profiled step."""
    from graphcast_lite_torch import presets
    from graphcast_lite_torch.training.loss import channel_mask, \
        lat_weights_from_axis
    from graphcast_lite_torch.training.rollout import RolloutSpec
    from graphcast_lite_torch.training.trainer import make_train_step

    cfg = presets.interaction_net_512x256()
    cfg.tpu.compute_dtype = "bfloat16"
    n_feat, obs = cfg.data.num_features_used, cfg.data.obs_window_used
    meta, model, graphs = ctx["meta"], ctx["model"], ctx["graphs"]
    _log("phase 5c: flagship 512x256 AR-4 train step (BPTT, a checkpoint "
         "per AR step, Adam at lr "
         f"{cfg.learning_rate}), bf16 compute against fp32 masters, default "
         f"route, {TRAIN_STEPS} steps on one seeded batch")
    spec = RolloutSpec(obs_window=obs, num_features=n_feat,
                       use_residual=cfg.use_residual,
                       remat=cfg.tpu.remat_rollout,
                       static_channels=tuple(cfg.static_channels),
                       forcing_channels=tuple(cfg.forcing_channels))
    step = make_train_step(
        model, graphs, spec, cfg, device="cuda",
        lat_weights=lat_weights_from_axis(meta.num_latitudes,
                                          meta.num_longitudes),
        chan_mask=channel_mask(n_feat, cfg.static_channels,
                               cfg.forcing_channels))
    x, y = (torch.from_numpy(a[None]).cuda() for a in ctx["request"])
    parts = _train_launches(model, step.graphs)
    by_csr = {label: n for label, (_, n) in parts.items()}
    expected = {"segment_sum": sum(by_csr.values()), "edge_mlp": 0,
                "edge_step": 0, "by_csr": by_csr}
    # By design: each CSR and shape's F in bf16 (the decoder's F = 19
    # gather adjoint narrow, the F = 256 sums balanced).
    expected_design = dict.fromkeys(
        _kernel_modules()["segment_sum"].DESIGNS, 0)
    for key, n in parts.values():
        expected_design[_kernel_modules()["segment_sum"].segment_design(
            torch.bfloat16, key[3])] += n
    losses, step_ms, step_counts = [], [], []
    busy_ms = wall_ms = top = None
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        if i == TRAIN_STEPS - 1:
            holder = []
            busy_ms, wall_ms, top = _profile(
                lambda: holder.append(step(x, y)))
            loss = holder[0]
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(x, y)
            end.record()
            torch.cuda.synchronize()
            if i > 0:
                step_ms.append(start.elapsed_time(end))
        if i == TRAIN_STEPS - 2:
            peak = torch.cuda.max_memory_allocated()
        counts = dict(_launches(), by_csr=_csr_launches(parts))
        if counts != expected:
            raise AssertionError(f"train step {i}: launches {counts}, "
                                 f"expected {expected}")
        if _launches_by_design() != expected_design:
            raise AssertionError(
                f"train step {i}: segment sums by design "
                f"{_launches_by_design()}, expected {expected_design}")
        step_counts.append(counts)
        losses.append(loss.item())
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train loss did not fall: {losses}")
    _reset_launches()
    fwd_ms = _time_ms(lambda: step.forward_loss(x, y), iters=3, warmup=1)
    fwd_launches = _launches()["segment_sum"] // 4
    ms = sum(step_ms) / len(step_ms)
    g = ctx["gs"].num_grid_nodes
    train = {
        "train_step_ms": ms, "train_step_ms_runs": step_ms,
        "train_grid_points_per_s": g * AR_STEPS / (ms / 1e3),
        "forward_loss_ms": fwd_ms, "peak_mem_bytes": peak,
        "losses": losses, "launches_per_step": step_counts[-1],
        "segment_sum_launches_by_csr": step_counts[-1]["by_csr"],
        "segment_sum_launches_by_design": expected_design,
        "forward_loss_segment_sum_launches": fwd_launches,
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
    }
    _log("  losses (before each update): "
         + ", ".join(f"{v:.6f}" for v in losses))
    _log(f"  segment_sum launches counted in each step: "
         f"{step_counts[-1]['segment_sum']} ("
         + ", ".join(f"{k} {v}" for k, v in step_counts[-1]["by_csr"].items())
         + "); by design " + ", ".join(f"{k} {v}" for k, v in
                                       expected_design.items())
         + "; edge_step and edge_mlp 0")
    _log(f"  train step (CUDA events, steps 2-{TRAIN_STEPS - 1}): "
         + ", ".join(f"{t:.2f}" for t in step_ms)
         + f" ms, mean {ms:.2f} ms; {train['train_grid_points_per_s']:.4g} "
         f"grid-points/s ({g} points x {AR_STEPS} steps); forward loss "
         f"{fwd_ms:.2f} ms ({fwd_launches} segment sums); peak allocated "
         f"{peak / 2**30:.3f} GiB")
    _log(f"  torch.profiler, one train step: device busy {busy_ms:.2f} ms of "
         f"{wall_ms:.2f} ms wall (idle share "
         f"{train['device_idle_share']:.3f}); top kernels by device time:")
    for name, n, t in top:
        _log(f"    {t:9.3f} ms  {n:5d} calls  {name[:90]}")
    return train


def _launch_snapshot():
    """The launch counters as they stand (``_launch_diff`` subtracts two)."""
    from graphcast_lite_torch.ops import cuda_segment

    return _launches(), dict(cuda_segment.launches_by_csr)


def _launch_diff(before, after):
    """(launches per kernel, segment-sum launches by CSR and shape) made
    between two snapshots."""
    counts = {k: after[0][k] - before[0][k] for k in after[0]}
    by_csr = {key: n - before[1].get(key, 0) for key, n in after[1].items()
              if n != before[1].get(key, 0)}
    return counts, by_csr


class _FitRecorder:
    """Wraps a ``Trainer``'s ``train_step`` and ``evaluate`` and the
    checkpoint module's ``save_checkpoint`` and ``save_params`` (the best
    model) to time them (CUDA events and the host clock) and to count the
    kernel launches each makes; calls
    ``before_first_step(state)`` before the first step.  An epoch's wall
    time runs from the end of the previous epoch's checkpoint save (or of
    the evaluation before epoch 1) to the end of its own.  The counters
    run on: the whole fit's launches stay readable."""

    def __init__(self, trainer, before_first_step=None):
        from graphcast_lite_torch.training import checkpoint as ckpt_lib

        self.steps, self.evals, self.saves, self.best = [], [], [], []
        self._ckpt = ckpt_lib
        self._save, self._save_params = (ckpt_lib.save_checkpoint,
                                         ckpt_lib.save_params)
        self._epoch_start()
        step, evaluate = trainer.train_step, trainer.evaluate

        def train_step(state, x, y, steps, *args, **kwargs):
            if before_first_step is not None and not self.steps:
                before_first_step(state)
            torch.cuda.synchronize()
            before = _launch_snapshot()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, loss = step(state, x, y, steps, *args, **kwargs)
            end.record()
            torch.cuda.synchronize()
            counts, by_csr = _launch_diff(before, _launch_snapshot())
            self.steps.append({"ar": steps, "ms": start.elapsed_time(end),
                               "loss": loss.item(), "launches": counts,
                               "by_csr": by_csr})
            return state, loss

        def timed_evaluate(state, loader):
            torch.cuda.synchronize()
            before, t0 = _launch_snapshot(), time.perf_counter()
            out = evaluate(state, loader)
            torch.cuda.synchronize()
            counts, _ = _launch_diff(before, _launch_snapshot())
            self.evals.append({"ms": (time.perf_counter() - t0) * 1e3,
                               "samples": len(loader.dataset),
                               "launches": counts})
            if not self.steps:      # the evaluation before epoch 1
                self._epoch_start()
            return out

        def timed_save(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._save(*args, **kwargs)
            t1 = time.perf_counter()
            self.saves.append({"ms": (t1 - t0) * 1e3,
                               "epoch_wall_ms": (t1 - self._mark) * 1e3,
                               "peak_mem_bytes":
                                   torch.cuda.max_memory_allocated()})
            self._epoch_start()

        def timed_save_params(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._save_params(*args, **kwargs)
            self.best.append((len(self.saves), (time.perf_counter() - t0)
                              * 1e3))

        trainer.train_step, trainer.evaluate = train_step, timed_evaluate
        ckpt_lib.save_checkpoint = timed_save
        ckpt_lib.save_params = timed_save_params

    def _epoch_start(self):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self._mark = time.perf_counter()

    def close(self):
        self._ckpt.save_checkpoint = self._save
        self._ckpt.save_params = self._save_params


def _assert_fit_launches(rec, model, graphs):
    """Every step launched exactly ``_train_launches(k)`` segment sums by
    CSR and shape at its AR level k and no fused kernel; every evaluation
    2 segment sums a validation sample (the encoder's two GCNConv
    aggregations of a one-step rollout) and nothing else."""
    for i, st in enumerate(rec.steps):
        parts = _train_launches(model, graphs, st["ar"])
        by_csr = dict(st["by_csr"])
        got = {label: by_csr.pop(key, 0)
               for label, (key, _) in parts.items()}
        want = {label: n for label, (_, n) in parts.items()}
        if by_csr or got != want or st["launches"] != {
                "segment_sum": sum(want.values()), "edge_mlp": 0,
                "edge_step": 0}:
            raise AssertionError(f"fit step {i} (AR {st['ar']}): launches "
                                 f"{st['launches']}, by CSR {got} + "
                                 f"unexpected {by_csr}; expected {want}")
        st["by_csr"] = got
    for ev in rec.evals:
        want = {"segment_sum": 2 * ev["samples"], "edge_mlp": 0,
                "edge_step": 0}
        if ev["launches"] != want:
            raise AssertionError(f"evaluation launches {ev['launches']}, "
                                 f"expected {want}")


def phase_fit(workdir):
    """6a: the flagship through ``Trainer.fit`` (bf16 against fp32
    masters), FIT_EPOCHS epochs of FIT_STEPS steps climbing the AR
    curriculum 1..4, then a resume for one more epoch."""
    from graphcast_lite_torch import presets
    from graphcast_lite_torch.build import build_weather_model
    from graphcast_lite_torch.data.dataset import load_chunked_datasets
    from graphcast_lite_torch.data.synthetic import generate_synthetic_dataset
    from graphcast_lite_torch.models.weather import WeatherModel
    from graphcast_lite_torch.training.trainer import Trainer

    cfg = presets.interaction_net_512x256()
    cfg.tpu.compute_dtype = "bfloat16"
    cfg.num_epochs = FIT_EPOCHS
    n_feat, obs = cfg.data.num_features_used, cfg.data.obs_window_used
    _log(f"phase 6a: flagship 512x256 through Trainer.fit, bf16 against "
         f"fp32 masters, {FIT_EPOCHS} epochs x {FIT_STEPS} steps (AR "
         f"curriculum 1..{cfg.max_ar_steps}), batch {cfg.batch_size}, then "
         "a resume for epoch 5")
    data_dir = generate_synthetic_dataset(
        os.path.join(workdir, "fit_data"), n_time=FIT_FRAMES, n_lon=512,
        n_lat=256, n_feat=n_feat, static_channels=list(cfg.static_channels),
        seed=1)
    train_ds, val_ds, _, meta = load_chunked_datasets(
        data_dir, obs_window=obs, pred_steps=cfg.data.pred_window_used,
        n_features=n_feat)
    if len(train_ds) < FIT_STEPS * cfg.batch_size or len(val_ds) < 1:
        raise AssertionError(f"train {len(train_ds)} / val {len(val_ds)} "
                             "samples")
    nbytes = os.path.getsize(os.path.join(data_dir, "data.npy"))
    _log(f"  synthetic dataset: {FIT_FRAMES} frames x 512 x 256 x {n_feat} "
         f"float16, {nbytes} bytes; {len(train_ds)} train, {len(val_ds)} "
         "validation samples")
    model, graphs, gs = build_weather_model(cfg, meta, device="cuda", seed=0)
    results_dir = os.path.join(workdir, "fit")
    trainer = Trainer(model, graphs, cfg, meta, results_dir, device="cuda")
    state = trainer.init_state(seed=0)
    rec = _FitRecorder(trainer)
    # Host ms of each sample load, by the epoch it falls in (the count of
    # checkpoint saves so far): the batch loader's and the evaluation's.
    loads = {"train": [], "val": []}
    for key, ds in (("train", train_ds), ("val", val_ds)):
        def timed_get(idx, get=ds.get, out=loads[key]):
            t0 = time.perf_counter()
            sample = get(idx)
            out.append((len(rec.saves), (time.perf_counter() - t0) * 1e3))
            return sample
        ds.get = timed_get
    _reset_launches()
    t0 = time.perf_counter()
    try:
        results = trainer.fit(state, train_ds, val_ds,
                              max_steps_per_epoch=FIT_STEPS)
    finally:
        rec.close()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts, by_csr = _launch_snapshot()
    cast = trainer._graphs_for(torch.bfloat16)
    _assert_fit_launches(rec, model, cast)
    if counts["segment_sum"] != sum(
            st["launches"]["segment_sum"] for st in rec.steps) + sum(
            ev["launches"]["segment_sum"] for ev in rec.evals) \
            or counts["segment_sum"] == 0:
        raise AssertionError(f"fit launches {counts} are not its steps' "
                             "and evaluations'")
    with open(os.path.join(results_dir, "metrics.jsonl")) as f:
        epochs = [json.loads(line) for line in f]
    ar_levels = [e["ar_steps"] for e in epochs]
    if ar_levels != list(range(1, FIT_EPOCHS + 1)) or [
            st["ar"] for st in rec.steps] != [
            k for k in ar_levels for _ in range(FIT_STEPS)]:
        raise AssertionError(f"AR levels by epoch {ar_levels}, by step "
                             f"{[st['ar'] for st in rec.steps]}")
    losses = results["train_losses"] + results["val_losses"]
    if len(losses) != 2 * FIT_EPOCHS or not all(np.isfinite(losses)):
        raise AssertionError(f"fit losses {results}")
    for name in ("checkpoint/state.pt", "checkpoint/meta.json",
                 "best_model.pt", "results.json", "training_log.txt",
                 "metrics.jsonl"):
        if not os.path.exists(os.path.join(results_dir, name)):
            raise AssertionError(f"fit wrote no {name}")

    # Resume: a new Trainer on a new model continues at epoch 5 from the
    # checkpoint, with the saved state bitwise before its first step.
    saved_params = {n: p.detach().clone() for n, p in model.named_parameters()}
    saved_opt = {i: {k: v.detach().clone() for k, v in st.items()}
                 for i, st in trainer.optimizer.state_dict()["state"].items()}
    steps_taken = len(rec.steps)
    del trainer, state
    check = {}

    def before_first_step(st):
        params = dict(st.model.named_parameters())
        opt = st.optimizer.state_dict()["state"]
        check["params_equal"] = all(torch.equal(params[n], p)
                                    for n, p in saved_params.items())
        check["adam_equal"] = set(opt) == set(saved_opt) and all(
            torch.equal(opt[i][k], v) for i, s in saved_opt.items()
            for k, v in s.items())
        check["adam_step"] = {float(s["step"]) for s in opt.values()}

    cfg.num_epochs = FIT_EPOCHS + 1
    model2 = WeatherModel(cfg.pipeline, cfg.data, gs.num_grid_nodes,
                          gs.num_mesh_nodes,
                          generator=torch.Generator().manual_seed(1))
    trainer2 = Trainer(model2, graphs, cfg, meta, results_dir, device="cuda")
    rec2 = _FitRecorder(trainer2, before_first_step)
    try:
        results2 = trainer2.fit(trainer2.init_state(seed=1), train_ds,
                                val_ds, resume=True,
                                max_steps_per_epoch=FIT_STEPS)
    finally:
        rec2.close()
    _assert_fit_launches(rec2, model2, trainer2._graphs_for(torch.bfloat16))
    step_after = {float(s["step"]) for s in
                  trainer2.optimizer.state_dict()["state"].values()}
    if not (check.get("params_equal") and check.get("adam_equal")
            and check["adam_step"] == {float(steps_taken)}
            and step_after == {float(steps_taken + FIT_STEPS)}
            and len(rec2.evals) == 1 and [st["ar"] for st in rec2.steps]
            == [FIT_EPOCHS] * FIT_STEPS
            and results2["train_losses"][:FIT_EPOCHS]
            == results["train_losses"]
            and len(results2["train_losses"]) == FIT_EPOCHS + 1
            and np.isfinite(results2["train_losses"][-1])):
        raise AssertionError(f"resume: {check}, Adam step after "
                             f"{step_after}, evaluations {len(rec2.evals)}, "
                             f"AR {[st['ar'] for st in rec2.steps]}, "
                             f"losses {results2}")

    levels = []
    for e, (epoch, save) in enumerate(zip(epochs, rec.saves)):
        steps = rec.steps[e * FIT_STEPS:(e + 1) * FIT_STEPS]
        ev = rec.evals[e + 1]
        step_ms = [st["ms"] for st in steps]
        best_ms = sum(ms for i, ms in rec.best if i == e)
        batch_ms = [ms for i, ms in loads["train"] if i == e]
        # Each evaluation loads the validation set once, the first before
        # epoch 1.
        n_val = len(val_ds)
        val_ms = sum(ms for _, ms in
                     loads["val"][(e + 1) * n_val:(e + 2) * n_val])
        levels.append({
            "epoch": epoch["epoch"], "ar": epoch["ar_steps"],
            "step_ms": step_ms,
            "evaluate_ms_per_sample": ev["ms"] / ev["samples"],
            "evaluate_loading_ms_per_sample": val_ms / ev["samples"],
            "batch_loads": len(batch_ms),
            "batch_loading_ms": sum(batch_ms),
            "checkpoint_save_ms": save["ms"],
            "best_model_save_ms": best_ms,
            "epoch_wall_ms": save["epoch_wall_ms"],
            # logs and the rest of the loop's host work
            "other_ms": save["epoch_wall_ms"] - sum(step_ms) - ev["ms"]
            - save["ms"] - best_ms - sum(batch_ms),
            "host_share": 1.0 - sum(step_ms) / save["epoch_wall_ms"],
            "peak_mem_bytes": save["peak_mem_bytes"],
            "train_loss": epoch["train_loss"], "val_loss": epoch["val_loss"],
            "segment_sum_launches_per_step": steps[0]["launches"][
                "segment_sum"],
            "segment_sum_launches_by_csr": steps[0]["by_csr"],
        })
    # The loader stops at max_steps_per_epoch: no sample loaded unused.
    if [lv["batch_loads"] for lv in levels] \
            != [FIT_STEPS * cfg.batch_size] * FIT_EPOCHS:
        raise AssertionError("batch loads by epoch "
                             f"{[lv['batch_loads'] for lv in levels]}")
    for lv in levels:
        _log(f"  epoch {lv['epoch']} AR {lv['ar']}: steps "
             + ", ".join(f"{t:.2f}" for t in lv["step_ms"])
             + f" ms ({lv['segment_sum_launches_per_step']} segment sums "
             f"each); {lv['batch_loads']} batch loads "
             f"{lv['batch_loading_ms']:.2f} ms; evaluate "
             f"{lv['evaluate_ms_per_sample']:.2f} ms per validation sample "
             f"({lv['evaluate_loading_ms_per_sample']:.2f} ms of it "
             f"loading); checkpoint save "
             f"{lv['checkpoint_save_ms']:.2f} ms, best model save "
             f"{lv['best_model_save_ms']:.2f} ms, other host work "
             f"{lv['other_ms']:.2f} ms; epoch wall "
             f"{lv['epoch_wall_ms']:.2f} ms, host share "
             f"{lv['host_share']:.3f}; peak allocated "
             f"{lv['peak_mem_bytes'] / 2**30:.3f} GiB; train loss "
             f"{lv['train_loss']:.6f}, val loss {lv['val_loss']:.6f}")
    _log(f"  fit {fit_s:.1f} s; segment_sum launches {counts['segment_sum']} "
         f"({len(rec.steps)} steps, {len(rec.evals)} evaluations), edge_step "
         f"and edge_mlp 0; resume at epoch {FIT_EPOCHS + 1}: params and "
         f"Adam state bitwise equal to the saved ones, Adam step "
         f"{steps_taken} -> {steps_taken + FIT_STEPS}; its AR-"
         f"{FIT_EPOCHS} steps "
         + ", ".join(f"{st['ms']:.2f}" for st in rec2.steps) + " ms")
    return {"levels": levels, "fit_s": fit_s, "data_bytes": nbytes,
            "launches": counts, "steps": len(rec.steps),
            "evaluation_launches": sum(ev["launches"]["segment_sum"]
                                       for ev in rec.evals),
            "evaluations": len(rec.evals),
            "init_evaluate_ms_per_sample":
                rec.evals[0]["ms"] / rec.evals[0]["samples"],
            "resume": {"epoch": FIT_EPOCHS + 1, "adam_step_before":
                       steps_taken, "bitwise_equal": True,
                       "step_ms": [st["ms"] for st in rec2.steps],
                       "train_loss": results2["train_losses"][-1]}}


def phase_demo(workdir):
    """6b: the README's demo loop through the CLIs on the card:
    make_demo (medium), train, predict at K = 1 and K = 4."""
    from graphcast_lite_torch.cli import make_demo
    from graphcast_lite_torch.cli import predict as predict_cli
    from graphcast_lite_torch.cli import train as train_cli
    from graphcast_lite_torch.training.trainer import Trainer

    exp = os.path.join(workdir, "demo")
    _log("phase 6b: make_demo --size medium -> train --max-steps-per-epoch "
         f"{DEMO_STEPS} -> predict --ar-steps 2 (K = 1 and "
         f"--rollouts-per-dispatch {DEMO_K}), through the CLIs' main()")
    make_demo.main([exp, "--size", "medium"])
    per_step = []
    step = Trainer.train_step

    def counted_step(self, *args, **kwargs):
        before = _launches()["segment_sum"]
        out = step(self, *args, **kwargs)
        per_step.append(_launches()["segment_sum"] - before)
        return out

    Trainer.train_step = counted_step
    _reset_launches()
    t0 = time.perf_counter()
    try:
        train_cli.main([exp, "--max-steps-per-epoch", str(DEMO_STEPS)])
    finally:
        Trainer.train_step = step
    train_s = time.perf_counter() - t0
    train_counts = _launches()
    with open(os.path.join(exp, "results.json")) as f:
        losses = json.load(f)["train_losses"]
    if not (per_step and min(per_step) >= 1
            and train_counts["segment_sum"] >= sum(per_step)):
        raise AssertionError(f"demo train: segment sums per step {per_step}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"demo train loss did not fall: {losses}")
    reports = []
    for k in (1, DEMO_K):
        path = os.path.join(workdir, f"demo_report_k{k}.json")
        _reset_launches()
        predict_cli.main([exp, "--ar-steps", "2", "--report-json", path,
                          "--rollouts-per-dispatch", str(k)])
        with open(path) as f:
            reports.append(json.load(f))
        if _launches()["segment_sum"] == 0:
            raise AssertionError(f"predict K={k} launched no segment sum")
    if reports[0] != reports[1]:
        raise AssertionError(f"--rollouts-per-dispatch {DEMO_K} report "
                             "differs from K = 1's")
    rep = reports[0]
    _log(f"  train {train_s:.1f} s: {len(per_step)} steps, segment sums per "
         f"step {min(per_step)}-{max(per_step)}, {train_counts}; loss "
         + ", ".join(f"{v:.4f}" for v in losses))
    _log(f"  predict ({rep['num_samples']} samples, AR 2): skill vs "
         f"persistence {rep['skill'] * 100:.2f}% (RMSE {rep['rmse']:.6f}, "
         f"persistence {rep['baseline_rmse']:.6f}); K = {DEMO_K} report "
         "equal to K = 1's")
    return {"train_s": train_s, "steps": len(per_step),
            "segment_sum_launches_per_step": [min(per_step), max(per_step)],
            "launches": train_counts, "train_losses": losses,
            "skill": rep["skill"], "rmse": rep["rmse"],
            "baseline_rmse": rep["baseline_rmse"],
            "samples": rep["num_samples"], "k_equal": True}


def _baseline_graphs():
    """(GraphSet, ModelGraphs with the product graph) of the WB2 64x32
    BASELINE configurations: mesh [3, 5] (E_pad 65,280), and the product
    graph over obs 5 x 2,048 grid nodes (k = 4, Kronecker)."""
    from graphcast_lite_torch import presets
    from graphcast_lite_torch.graphs.build import build_graph_set
    from graphcast_lite_torch.models.weather import ModelGraphs

    cfg = presets.product_graph_64x32()
    lat, lon = presets.wb2_64x32_grid()
    gs = build_graph_set(lat, lon, cfg.graph.mesh_levels,
                         cfg.graph.grid2mesh_radius_query)
    graphs = ModelGraphs.from_graph_set(gs, cfg.pipeline.product_graph,
                                        cfg.data.obs_window_used)
    return gs, graphs


def _new_shapes(graphs):
    """(label, perm or None, indptr, rows, R, F) of the segment sums the
    new layer families add, on the 64x32 graphs: GAT's aggregations at
    4 x 64 and 1 x 64, its softmax denominators at H = 4 and 1 (H = 1 is
    also the degree sum under a pruned mask), the product-graph GCN's
    aggregations, and the gather adjoints of the backward over the sender
    CSRs (GAT's xW and a_src, the product GCN's)."""
    proc, prod = graphs.processing, graphs.product
    shapes = []
    for f, what in ((256, "GAT 4x64 aggregation"),
                    (64, "GAT 1x64 aggregation"),
                    (4, "GAT softmax denominators H=4"),
                    (1, "denominators H=1, degrees under a mask")):
        shapes.append((f"multimesh {what} F={f}", None, proc.indptr,
                       proc.padded_num_edges, proc.num_receivers, f))
    for f in (64, 33):
        shapes.append((f"product GCN aggregation F={f}", None, prod.indptr,
                       prod.padded_num_edges, prod.num_receivers, f))
    for f, what in ((256, "GAT xW"), (4, "GAT a_src")):
        shapes.append((f"multimesh {what} gather adjoint F={f}",
                       proc.s_perm, proc.s_indptr, proc.padded_num_edges,
                       proc.num_nodes, f))
    for f in (64, 33):
        shapes.append((f"product GCN gather adjoint F={f}", prod.s_perm,
                       prod.s_indptr, prod.padded_num_edges, prod.num_nodes,
                       f))
    return shapes


def _new_shape_msgs(gen, perm, rows, f, dtype):
    """Messages at one new shape on the card: receiver-sorted rows under a
    pruned mask (half the edges), or permuted cotangent rows."""
    if perm is not None:
        return _sender_msgs(gen, perm, rows, f, dtype)
    msgs = torch.randn(rows, f, generator=gen)
    keep = torch.rand(rows, generator=gen) < 0.5
    return (msgs * keep[:, None]).to("cuda", dtype)


def phase_new_shape_cases(graphs):
    """1c: the segment sum against its plain version at the shapes the
    new layer families add, fp32 and bf16, and two launches bitwise
    equal."""
    from graphcast_lite_torch.ops import cuda_segment

    _log("phase 1c: segment_sum at the new families' shapes on the 64x32 "
         "graphs (multimesh E_pad 65,280, product E_pad 32,768 over 10,240 "
         "nodes), fp32 and bf16")
    gen = torch.Generator().manual_seed(9)
    for label, perm, indptr, rows, r, f in _new_shapes(graphs):
        ip = indptr.to("cuda")
        for dtype in (torch.float32, torch.bfloat16):
            msgs = _new_shape_msgs(gen, perm, rows, f, dtype)
            _check_kernel(label, msgs, ip, r)
            if cuda_segment.segment_design(dtype, f) == "narrow":
                _check_kernel(label, msgs, ip, r, design="warp")
            _bitwise_twice(label, msgs, ip, r)


def phase_kernel_new_shapes(graphs):
    """3b: the segment sum timed at the new shapes in fp32 (the BASELINE
    configurations train and serve in fp32)."""
    _log("phase 3b: segment_sum times at the new families' shapes, fp32")
    gen = torch.Generator().manual_seed(10)
    out = {}
    for label, perm, indptr, rows, r, f in _new_shapes(graphs):
        msgs = _new_shape_msgs(gen, perm, rows, f, torch.float32)
        out[label] = _time_segment_sum(label, msgs, indptr.to("cuda"), r)
    return out


def _serve_launches(model, graphs) -> int:
    """Segment sums of one 64x32 forward: every graph layer on a graph
    without constant in-degree sums once a GCNConv, twice a GAT conv (the
    softmax denominators and the aggregation), once a SimpleConv."""
    from graphcast_lite_torch.config import GraphLayerType as L

    n = 0
    for block, graph in ((model.product_model, graphs.product),
                         (model.encoder, graphs.encoding),
                         (model.processor, graphs.processing),
                         (model.decoder, graphs.decoding)):
        if block is None or graph.const_in_degree > 0:
            continue
        gl = block.graph_layer
        n += {L.ConvGCN: getattr(gl, "num_convs", 0),
              L.GATConv: 2 * getattr(gl, "num_convs", 0),
              L.SparseGATConv: 2, L.SimpleConv: 1}[gl.layer_type]
    return n


def _far_mask_check(label, card_mask, cpu_mask, alphas, thr):
    """SparseGAT masks of the card and the CPU equal on the edges whose
    alpha (the CPU's, at each pruning call) lies farther than ALPHA_MARGIN
    from the threshold; returns (live edges, near edges)."""
    far = torch.ones(cpu_mask.numel(), dtype=torch.bool)
    for alpha in alphas:
        far &= (alpha - thr).abs() > ALPHA_MARGIN
    card_mask, cpu_mask = card_mask.float().cpu(), cpu_mask.float().cpu()
    if not torch.equal(card_mask[far], cpu_mask[far]):
        raise AssertionError(f"{label}: pruned masks differ card vs CPU")
    return int(cpu_mask.sum()), int((~far).sum())


def phase_baseline_numerics(gs, graphs):
    """4b: the four WB2 64x32 BASELINE configurations at their published
    widths, seeded weights, fp32 (TF32 off): one request (AR 1) and one
    train step on the card against the CPU, exact segment-sum launches of
    the request, and SparseGAT's pruned mask at its threshold."""
    import copy

    from graphcast_lite_torch import presets
    from graphcast_lite_torch.models.weather import WeatherModel
    from graphcast_lite_torch.training.loss import lat_weights_from_axis
    from graphcast_lite_torch.training.rollout import RolloutSpec, \
        rollout_predict
    from graphcast_lite_torch.training.trainer import make_train_step

    _log("phase 4b: WB2 64x32 BASELINE configurations (GCN, GAT 4 heads, "
         "SparseGAT, product graph), fp32, card vs CPU: one request "
         f"({E2E_TOL}) and one train step (loss rtol {TRAIN_LOSS_RTOL}, each "
         f"gradient {TRAIN_GRAD_RTOL} x its largest + 1e-6); SparseGAT "
         f"pruned at {SPARSE_THR}, masks equal beyond {ALPHA_MARGIN} of it")
    g, m = gs.num_grid_nodes, gs.num_mesh_nodes
    lw = lat_weights_from_axis(32, 64)
    out = {}
    for name, (fn, kw) in BASELINE_CONFIGS.items():
        cfg = getattr(presets, fn)(**kw)
        c, obs = cfg.data.num_features_used, cfg.data.obs_window_used
        model = WeatherModel(cfg.pipeline, cfg.data, g, m,
                             generator=torch.Generator().manual_seed(0))
        sparse = name == "sparse_gat"
        rng = np.random.RandomState(0)
        x = rng.randn(1, g, obs * c).astype(np.float32)
        y = rng.randn(1, g, c).astype(np.float32)
        spec = RolloutSpec(obs_window=obs, num_features=c, remat=True)
        res = {}
        for device in ("cuda", "cpu"):
            mdl = copy.deepcopy(model).to(device)
            gr = graphs.to(device)
            mask0 = gr.processing.edge_mask.clone() if sparse else None
            alphas = []
            if sparse:
                mdl.processor.graph_layer.conv_0.core.register_forward_hook(
                    lambda mod, a, o: alphas.append(o[1].detach().cpu()))
            masks = []

            def model_fn(inp, mask, t, p, mdl=mdl, gr=gr, masks=masks):
                o, nm = mdl(inp, gr, mask, SPARSE_THR, sparse)
                masks.append(nm)
                return o, nm

            window = torch.from_numpy(x[0].reshape(g, obs, c)).to(device)
            _reset_launches()
            with torch.inference_mode():
                pred = rollout_predict(model_fn, window, 1, spec, mask0)
            counts = _launches()
            req_alphas = list(alphas)
            step = make_train_step(mdl, gr, spec, cfg, steps=1,
                                   device=device, lat_weights=lw)
            _reset_launches()
            loss, mask = step.run(x, y, mask0, SPARSE_THR, sparse)
            train_counts = _launches()
            res[device] = dict(pred=pred.cpu(), req_mask=masks[0],
                               req_alphas=req_alphas, loss=loss.item(),
                               grads=_grads(mdl), mask=mask,
                               train_alphas=alphas[len(req_alphas):],
                               counts=counts, train_counts=train_counts,
                               expected=_serve_launches(mdl, gr))
        card, cpu = res["cuda"], res["cpu"]
        if card["pred"].shape != (g, 1, c) \
                or not torch.isfinite(card["pred"]).all():
            raise AssertionError(f"{name}: card output not finite")
        err = (card["pred"] - cpu["pred"]).abs().max().item()
        torch.testing.assert_close(card["pred"], cpu["pred"], **E2E_TOL)
        want = {"segment_sum": card["expected"], "edge_mlp": 0,
                "edge_step": 0}
        if card["counts"] != want:
            raise AssertionError(f"{name}: request launches "
                                 f"{card['counts']}, expected {want}")
        if card["train_counts"]["segment_sum"] <= card["expected"]:
            raise AssertionError(f"{name}: train step launches "
                                 f"{card['train_counts']}")
        loss, loss_cpu = card["loss"], cpu["loss"]
        if not (np.isfinite(loss) and abs(loss - loss_cpu)
                <= TRAIN_LOSS_RTOL * abs(loss_cpu)):
            raise AssertionError(f"{name}: train loss card {loss} cpu "
                                 f"{loss_cpu}")
        worst = (0.0, "")
        for n, ref in cpu["grads"].items():
            got = card["grads"][n]
            e = (got - ref).abs().max().item()
            tol = TRAIN_GRAD_RTOL * ref.abs().max().item() + 1e-6
            if not (torch.isfinite(got).all() and e <= tol):
                raise AssertionError(f"{name} {n}: card gradient off the "
                                     f"CPU's by {e:.3e} > {tol:.3e}")
            worst = max(worst, (e / tol, n))
        row = {"max_abs_err_request": err, "loss_card": loss,
               "loss_cpu": loss_cpu, "worst_grad_err_of_tol": worst[0],
               "worst_grad_leaf": worst[1],
               "launches_per_request": card["counts"]["segment_sum"],
               "launches_per_train_step":
                   card["train_counts"]["segment_sum"]}
        if sparse:
            total = int(graphs.processing.edge_mask.sum())
            live_req, near_req = _far_mask_check(
                f"{name} request", card["req_mask"], cpu["req_mask"],
                cpu["req_alphas"], SPARSE_THR)
            live, near = _far_mask_check(
                f"{name} train step", card["mask"], cpu["mask"],
                cpu["train_alphas"], SPARSE_THR)
            if not 0 < live_req < total:
                raise AssertionError(f"{name}: the threshold cut {total} "
                                     f"edges to {live_req}")
            row.update(live_edges=total, live_after_request=live_req,
                       near_threshold_request=near_req,
                       live_after_train_step=live,
                       near_threshold_train_step=near)
        out[name] = row
        _log(f"  {name}: request max|card - cpu| {err:.3e}; loss card "
             f"{loss:.7f} cpu {loss_cpu:.7f}; {len(cpu['grads'])} gradients, "
             f"largest error {worst[0]:.3f} of its tolerance ({worst[1]}); "
             f"segment_sum launches {row['launches_per_request']} a request "
             f"(expected {card['expected']}), "
             f"{row['launches_per_train_step']} a train step"
             + (f"; live edges {row['live_edges']} -> "
                f"{row['live_after_request']} (request), "
                f"{row['live_after_train_step']} (train step); "
                f"{row['near_threshold_request']} edges within "
                f"{ALPHA_MARGIN} of the threshold" if sparse else ""))
    return out


def phase_nonlazy_serve(ctx):
    """2c: the flagship bf16 AR-4 serve with the plain InteractionNet step
    (``GCLT_LAZY_EDGE=0``) on the composed and the mega route: exact
    launches, times, peak memory, bf16 against the fp32 plain rollout and
    the fp32 plain rollout against the fp32 lazy one."""
    from graphcast_lite_torch.inference.predict import evaluate_model

    _log("phase 2c: flagship 512x256 AR-4 bf16 serve, plain InteractionNet "
         "step (GCLT_LAZY_EDGE=0), one request a route")
    g = ctx["gs"].num_grid_nodes
    with _route(NONLAZY_ROUTES["composed"][0]):
        p32 = _rollout(ctx, torch.float32)[0]().float()
    lazy_rel = _rel_rms(p32, ctx["p32"], "plain composed fp32",
                        ref="the fp32 lazy reg-block rollout",
                        tol=NONLAZY_FP32_RTOL, what="fp32 plain")
    out = {"fp32_plain_vs_lazy_rel_rms": lazy_rel}
    for route, (env, expected, step_route) in NONLAZY_ROUTES.items():
        with _route(env):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            report = evaluate_model(ctx["model"], ctx["graphs"],
                                    ctx["test_ds"], ctx["meta"],
                                    max_samples=1, **ctx["kw"])
            torch.cuda.synchronize()
            counts = _launches()
            peak = torch.cuda.max_memory_allocated()
            if report.num_samples != 1 or not np.isfinite(report.rmse):
                raise AssertionError(f"plain {route}: report "
                                     f"{report.num_samples} {report.rmse}")
            if counts != expected:
                raise AssertionError(f"plain {route}: launches per rollout "
                                     f"{counts}, expected {expected}")
            rollout, smodel = _rollout(ctx, torch.bfloat16)
            rollout_ms = _time_ms(rollout, iters=5, warmup=1)
            steps = smodel.processor.graph_layer.inet.steps
            if {s.route for s in steps} != {step_route}:
                raise AssertionError(f"plain {route}: steps took "
                                     f"{ {s.route for s in steps} }")
            stages = _stage_ms(smodel, rollout)
            busy_ms, wall_ms, top = _profile(rollout, top_n=3)
            rel = _rel_rms(rollout().float(), p32, f"plain {route}",
                           ref="the fp32 plain composed rollout")
        out[route] = {
            "switches": env, "launches_per_rollout": counts,
            "rollout_ms": rollout_ms,
            "grid_points_per_s": g * AR_STEPS / (rollout_ms / 1e3),
            "peak_mem_bytes": peak, "stage_ms": stages,
            "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "bf16_vs_fp32_plain_rel_rms": rel, "rmse": report.rmse,
        }
        _log(f"  plain {route} {env}: launches per rollout {counts}; RMSE "
             f"{report.rmse:.6f} (finite); rollout {rollout_ms:.2f} ms, "
             f"{out[route]['grid_points_per_s']:.4g} grid-points/s, peak "
             f"allocated {peak / 2**30:.3f} GiB; by stage "
             + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items()))
        _log(f"    torch.profiler, one rollout: device busy {busy_ms:.2f} ms "
             f"of {wall_ms:.2f} ms wall (idle share "
             f"{out[route]['device_idle_share']:.3f}); top kernels: "
             + "; ".join(f"{name[:40]} {n} calls {ms:.2f} ms"
                         for name, n, ms in top))
    return out


def _user_experiment(workdir, name, cfg, data_dir):
    """An experiment directory holding ``cfg`` (on ``data_dir``)."""
    from graphcast_lite_torch.config import to_dict

    exp = os.path.join(workdir, name)
    os.makedirs(exp, exist_ok=True)
    cfg.data_dir = data_dir
    with open(os.path.join(exp, "config.json"), "w") as f:
        json.dump(to_dict(cfg), f, indent=1)
    return exp


def _train_cli(exp, *extra):
    """``cli.train`` on the card: (train losses, segment sums launched)."""
    from graphcast_lite_torch.cli import train as train_cli

    _reset_launches()
    train_cli.main([exp, "--max-steps-per-epoch", str(USER_STEPS)]
                   + list(extra))
    launched = _launches()["segment_sum"]
    with open(os.path.join(exp, "results.json")) as f:
        losses = json.load(f)["train_losses"]
    if launched == 0 or not all(np.isfinite(losses)):
        raise AssertionError(f"{exp}: train launched {launched} segment "
                             f"sums, losses {losses}")
    return losses, launched


def _predict_cli(exp):
    """``cli.predict`` on the card (AR 1): the report."""
    from graphcast_lite_torch.cli import predict as predict_cli

    path = os.path.join(exp, "report.json")
    _reset_launches()
    predict_cli.main([exp, "--ar-steps", "1", "--report-json", path])
    with open(path) as f:
        rep = json.load(f)
    if _launches()["segment_sum"] == 0 or not np.isfinite(rep["rmse"]):
        raise AssertionError(f"{exp}: predict {rep['rmse']}")
    return rep


def phase_user_loop(workdir, proc_edges):
    """6c: SparseGAT and the product graph through the CLIs on the card,
    on a seeded synthetic 64x32 set with 33 features: SparseGAT trains
    SPARSE_EPOCHS epochs from the multimesh's ``proc_edges`` live edges
    (the schedule prunes from epoch index 6; the live edges after each
    epoch), and a resume from its checkpoint after epoch index
    SPARSE_RESUME_AFTER ends on the same mask; the product graph trains
    PRODUCT_EPOCHS epochs; then ``cli.predict`` on each."""
    import shutil

    from graphcast_lite_torch import presets
    from graphcast_lite_torch.data.synthetic import generate_synthetic_dataset
    from graphcast_lite_torch.training import checkpoint as ckpt_lib
    from graphcast_lite_torch.training.trainer import \
        attention_threshold_schedule

    _log(f"phase 6c: SparseGAT ({SPARSE_EPOCHS} epochs, resume after epoch "
         f"{SPARSE_RESUME_AFTER + 1}) and product graph ({PRODUCT_EPOCHS} "
         f"epochs) through cli.train --max-steps-per-epoch {USER_STEPS}, "
         "then cli.predict, on a synthetic 64x32 set of 33 features")
    t0 = time.perf_counter()
    data_dir = generate_synthetic_dataset(
        os.path.join(workdir, "wb2_64x32_data"), n_time=40, n_lon=64,
        n_lat=32, n_feat=33, seed=3)
    cfg = presets.sparse_gat_64x32()
    cfg.num_epochs = SPARSE_EPOCHS
    exp = _user_experiment(workdir, "sparse_gat", cfg, data_dir)
    live, kept = [], os.path.join(workdir, "sparse_gat_mid")
    save = ckpt_lib.save_checkpoint

    def recording_save(ckpt_dir, model, optimizer, meta, edge_mask=None):
        save(ckpt_dir, model, optimizer, meta, edge_mask=edge_mask)
        if os.path.dirname(ckpt_dir) == exp:
            live.append(int(edge_mask.sum()))
            if meta["epoch"] == SPARSE_RESUME_AFTER:
                shutil.copytree(exp, kept)

    ckpt_lib.save_checkpoint = recording_save
    try:
        losses, launched = _train_cli(exp)
    finally:
        ckpt_lib.save_checkpoint = save
    thr = [attention_threshold_schedule(e) for e in range(SPARSE_EPOCHS)]
    full = torch.load(os.path.join(exp, "checkpoint", "state.pt"),
                      weights_only=True)["edge_mask"]
    first = min(e for e, t in enumerate(thr) if t > 0)
    if (len(live) != SPARSE_EPOCHS
            or live[:first] != [proc_edges] * first
            or any(b > a for a, b in zip(live, live[1:]))
            or not live[-1] < proc_edges or int(full.sum()) != live[-1]):
        raise AssertionError(f"SparseGAT live edges by epoch {live} "
                             f"(from {proc_edges})")
    _log(f"  SparseGAT: live edges after each epoch {live} (of "
         f"{proc_edges}; thresholds " + ", ".join(f"{t:.4f}" for t in thr)
         + "); losses " + ", ".join(f"{v:.4f}" for v in losses)
         + f"; {launched} segment sums")
    resumed_losses, _ = _train_cli(kept, "--resume")
    again = torch.load(os.path.join(kept, "checkpoint", "state.pt"),
                       weights_only=True)["edge_mask"]
    if not torch.equal(again, full):
        raise AssertionError(f"SparseGAT resume: final mask "
                             f"{int(again.sum())} live edges, the whole "
                             f"run's {int(full.sum())}")
    loss_diff = max(abs(a - b) for a, b in zip(resumed_losses, losses))
    _log(f"  SparseGAT resumed after epoch {SPARSE_RESUME_AFTER + 1}: the "
         f"same final mask; losses max |diff| {loss_diff:.3e}")
    sparse_rep = _predict_cli(exp)
    pcfg = presets.product_graph_64x32()
    pcfg.num_epochs = PRODUCT_EPOCHS
    pexp = _user_experiment(workdir, "product_graph", pcfg, data_dir)
    plosses, plaunched = _train_cli(pexp)
    product_rep = _predict_cli(pexp)
    wall_s = time.perf_counter() - t0
    _log(f"  product graph: losses " + ", ".join(f"{v:.4f}" for v in plosses)
         + f"; {plaunched} segment sums; predict skill "
         f"{product_rep['skill'] * 100:.2f}% (SparseGAT "
         f"{sparse_rep['skill'] * 100:.2f}%); phase wall {wall_s:.1f} s")
    return {"sparse_gat": {"live_edges_by_epoch": live,
                           "live_edges_start": proc_edges, "thresholds": thr,
                           "train_losses": losses, "launches": launched,
                           "resume_same_mask": True,
                           "resume_loss_max_abs_diff": loss_diff,
                           "predict_skill": sparse_rep["skill"],
                           "predict_rmse": sparse_rep["rmse"]},
            "product_graph": {"train_losses": plosses, "launches": plaunched,
                              "predict_skill": product_rep["skill"],
                              "predict_rmse": product_rep["rmse"]},
            "wall_s": wall_s}


# ---- phase 7: the COO training units and the regional stack -------------


def _bound_fp32(nbytes: float, flops: float):
    """``_bound`` for fp32 work done outside the tensor cores (the fp32
    edge step's 16-receiver design, and the FMA figure beside the fp32
    edge-MLP kernel's 3xTF32 bound): operations over FP32_FLOPS."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def _bound_tf32x3(nbytes: float, flops: float):
    """``_bound`` for fp32 products in 3xTF32 on the tensor cores (the fp32
    edge-MLP kernel's Hopper design): three TF32 products, 3 * flops over
    TF32_TC_FLOPS."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * flops / TF32_TC_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def _regional_graphs(gs):
    """The dual-mesh head's graphs at ``REGIONAL_LEVEL`` over the ROI of
    the README, on the flagship grid and its level-6 global mesh (as
    ``cli.train_regional`` builds them)."""
    from graphcast_lite_torch.graphs.regional import build_regional_graphs

    return build_regional_graphs(
        gs.mesh_lat, gs.mesh_lon, gs.grid_lat, gs.grid_lon, REGIONAL_ROI,
        reg_mesh_level=REGIONAL_LEVEL, global_level=len(gs.meshes) - 1)


def _regional_shapes(rg, gs):
    """(label, perm or None, indptr, rows, R, F, dtype) of the segment sums
    the regional head step and the fused unit's backward add: the
    reg-level-8 graphs' receiver CSRs (aggregations, receiver-gather
    adjoints, the fused d_xr) and sender CSRs (gather adjoints, the fused
    d_xs) at F = 256 in fp32 (``train_regional`` trains in fp32), and the
    flagship multimesh's sender CSR (the fused d_xs of the flagship train
    step; its d_xr is phase 3's processor shape) in bf16."""
    proc, cross, enc, dec = (rg.processing, rg.cross_g2r, rg.encoding,
                             rg.decoding)
    fp, f32, f = gs.processing, torch.float32, REGIONAL_HIDDEN
    return [
        ("regional processing receivers", None, proc.indptr,
         proc.padded_num_edges, proc.num_receivers, f, f32),
        ("regional processing senders", proc.s_perm, proc.s_indptr,
         proc.padded_num_edges, proc.num_nodes, f, f32),
        ("cross g2r receivers", None, cross.indptr, cross.padded_num_edges,
         cross.num_receivers, f, f32),
        ("encoding receivers", None, enc.indptr, enc.padded_num_edges,
         enc.num_receivers, f, f32),
        ("encoding senders", enc.s_perm, enc.s_indptr,
         enc.padded_num_edges, enc.num_nodes, f, f32),
        ("decoding receivers", None, dec.indptr, dec.padded_num_edges,
         dec.num_receivers, f, f32),
        ("decoding senders", dec.s_perm, dec.s_indptr,
         dec.padded_num_edges, dec.num_nodes, f, f32),
        ("flagship multimesh senders (fused d_xs)", fp.s_perm, fp.s_indptr,
         fp.padded_num_edges, fp.num_nodes, 256, torch.bfloat16),
    ]


def phase_regional_kernels(gs):
    """7a: the segment sum on the regional graphs' CSRs and the fused
    backward's scatter, and ``edge_mlp`` at the reg-level-8 processing
    shape, against their plain versions in fp32 and bf16 (two segment-sum
    launches bitwise equal), each timed against its bound, its plain
    version and (the segment sum) ``torch.segment_reduce``; fp32
    ``edge_mlp`` also against the FMA bound and ``torch.addmm``."""
    from graphcast_lite_torch.ops import cuda_segment

    t0 = time.perf_counter()
    rg = _regional_graphs(gs)
    _log(f"phase 7a: the regional head's graphs at level {REGIONAL_LEVEL} "
         f"over ROI {REGIONAL_ROI} ({time.perf_counter() - t0:.1f} s to "
         f"build): mesh {rg.n_reg_mesh} nodes, processing E="
         f"{rg.processing.num_edges} E_pad={rg.processing.padded_num_edges}"
         f", cross E_pad={rg.cross_g2r.padded_num_edges}, encoding E_pad="
         f"{rg.encoding.padded_num_edges}, decoding E_pad="
         f"{rg.decoding.padded_num_edges} onto {rg.n_roi} ROI points; "
         "segment_sum and edge_mlp against their plain versions, fp32 and "
         "bf16, then timed")
    gen = torch.Generator().manual_seed(17)
    seg = {}
    for label, perm, indptr, rows, r, f, timed in _regional_shapes(rg, gs):
        ip = indptr.to("cuda")
        for dtype in (torch.float32, torch.bfloat16):
            msgs = _new_shape_msgs(gen, perm, rows, f, dtype)
            _check_kernel(f"{label} F={f}", msgs, ip, r)
            first = cuda_segment.segment_sum(msgs, ip, r)
            if not torch.equal(first, cuda_segment.segment_sum(msgs, ip, r)):
                raise AssertionError(f"{label} {dtype}: two launches differ")
        seg[label] = dict(_time_segment_sum(
            f"{label} {str(timed)[6:]}",
            _new_shape_msgs(gen, perm, rows, f, timed), ip, r),
            dtype=str(timed)[6:], rows=rows, receivers=r, features=f)

    proc = rg.processing
    r, e_pad, hid = proc.num_receivers, proc.padded_num_edges, REGIONAL_HIDDEN
    label = f"regional processing E_pad={e_pad} R={r} H=De={hid}"
    mlp = {}
    for dtype in (torch.float32, torch.bfloat16):
        t = _fused_case(gen, 0, r, hid, hid, dtype,
                        recv=proc.receivers.long())
        t["mask"] = proc.edge_mask.to("cuda", dtype)
        mlp[str(dtype)[6:]] = _time_edge_mlp(label, t, r)
    return seg, mlp


def _time_edge_mlp(label, t, r):
    """``edge_mlp`` on ``t`` against its plain version, then timed against
    its bound and its plain version; in fp32 also the product alone
    through ``torch.addmm`` (TF32 off; context: one call does not compute
    the fused function) and the bound on the FMA units beside the 3xTF32
    one."""
    from graphcast_lite_torch.ops import edge_mlp

    dtype = t["h_pre"].dtype
    e_pad, hid = t["h_pre"].shape
    de = t["w2"].shape[1]
    design = edge_mlp.design(dtype, hid, de)
    err = _check_edge_mlp(label, t, r, design=design)
    args = (t["h_pre"], t["w2"], t["b2"], t["mask"], t["indptr"], r,
            "swish")
    nbytes = _nbytes(*args[:5]) + (e_pad + r) * de * t["h_pre"].element_size()
    flops = 2 * e_pad * hid * de
    ms = _time_ms(lambda: edge_mlp.edge_mlp(*args))
    plain = _time_ms(lambda: edge_mlp.edge_mlp_reference(*args),
                     iters=5, warmup=1)
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
           "design": design, "library_ms": None}
    if dtype == torch.bfloat16:
        row["bound_ms"], row["bound_by"] = _bound(nbytes, flops)
        extra = ""
    else:
        row["bound_ms"], row["bound_by"] = _bound_tf32x3(nbytes, flops)
        row["fma_bound_ms"] = _bound_fp32(nbytes, flops)[0]
        a = edge_mlp.act_fn("swish")(t["h_pre"])
        row["addmm_fp32_ms"] = _time_ms(
            lambda: torch.addmm(t["b2"], a, t["w2"]))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        steps = edge_mlp.fp32_steps_per_block(t["indptr"], sms)
        row["steps_per_block"] = [int(steps.min()), int(steps.max())]
        extra = (f" | FMA bound {row['fma_bound_ms'] * 1e3:.1f} us | "
                 f"addmm alone (TF32 off) {row['addmm_fp32_ms'] * 1e3:.1f} "
                 f"us | {int(steps.sum())} steps of "
                 f"{edge_mlp.F32_STEP_ROWS} rows on {steps.numel()} blocks, "
                 f"{int(steps.min())}-{int(steps.max())} a block")
    row["fraction_of_bound"] = row["bound_ms"] / ms
    _log(f"  edge_mlp {label} {str(dtype)[6:]}: kernel {ms * 1e3:.1f} us "
         f"({design}) | bound {row['bound_ms'] * 1e3:.1f} us "
         f"({row['bound_by']}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} "
         f"GFLOP; fraction {row['fraction_of_bound']:.3f}) | plain "
         f"{plain * 1e3:.1f} us" + extra)
    return row


def phase_fp32_kernels(ctx):
    """7a, fp32 at the flagship processor shape (E_pad 261,120, R 40,962,
    H = De = 256; ``Trainer.fit``'s evaluation and the fp32 train-step
    pairs run these): ``edge_mlp`` and ``edge_step`` against their plain
    versions and timed, and one fp32 AR-4 rollout on the COO edge-step
    route (its 48 ``edge_step`` launches) and on the COO composed route
    (its 56 segment sums), each timed, the two held to each other."""
    from graphcast_lite_torch.ops import edge_step

    gs = ctx["gs"]
    proc = gs.processing
    r, e_pad, hid = proc.num_receivers, proc.padded_num_edges, 256
    label = f"flagship processing E_pad={e_pad} R={r} H=De={hid}"
    _log(f"phase 7a: fp32 at the {label}")
    gen = torch.Generator().manual_seed(23)
    t = _fused_case(gen, 0, r, hid, hid, torch.float32,
                    recv=proc.receivers.long())
    t["mask"] = proc.edge_mask.to("cuda", torch.float32)
    mlp = _time_edge_mlp(label, t, r)

    design = edge_step.design(torch.float32, hid, hid)
    details = {}
    step_err, stats_err = _check_edge_step(label, t, r, design=design,
                                           details=details)
    args = _step_args(t, r)
    nbytes = _nbytes(*args[:11]) + (e_pad + r) * hid * 4 + 3 * 4
    flops = 4 * e_pad * hid * hid
    bound, by = _bound_tf32x3(nbytes, flops)
    fma_bound = _bound_fp32(nbytes, flops)[0]
    ms = _time_ms(lambda: edge_step.edge_step(*args))
    plain = _time_ms(lambda: edge_step.edge_step_reference(*args), iters=5,
                     warmup=1)
    step = {"max_abs_err": step_err, "stats_abs_err": stats_err, "ms": ms,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "fraction_of_bound": bound / ms, "fma_bound_ms": fma_bound,
            "design": design, "library_ms": None, **details}
    _log(f"  edge_step {label} float32: kernel {ms * 1e3:.1f} us "
         f"({design}) | bound {bound * 1e3:.1f} us ({by}, 3xTF32 at "
         f"{TF32_TC_FLOPS:.3g} FLOP/s; {nbytes / 1e6:.1f} MB, "
         f"{flops / 1e9:.1f} GFLOP; fraction {bound / ms:.3f}) | FMA bound "
         f"{fma_bound * 1e3:.1f} us | plain {plain * 1e3:.1f} us")
    # The fp32 AR-4 rollout of the flagship request on the edge-step route
    # and on the composed route, in turns (edge-step, composed, composed,
    # edge-step) after a counted run of each.
    runs = {}
    for route in ("edge_step", "composed"):
        env, expected = COO_ROUTES[route]
        with _route(env):
            rollout, _ = _rollout(ctx, torch.float32)
            _reset_launches()
            out = rollout()
            torch.cuda.synchronize()
            counts = _launches()
        if not torch.isfinite(out).all():
            raise AssertionError(f"fp32 {route} rollout: non-finite output")
        if counts != expected:
            raise AssertionError(f"fp32 {route} rollout launches {counts}, "
                                 f"expected {expected}")
        runs[route] = {"env": env, "rollout": rollout, "out": out,
                       "counts": counts, "ms": []}
    for route in ("edge_step", "composed", "composed", "edge_step"):
        with _route(runs[route]["env"]):
            runs[route]["ms"].append(
                _time_ms(runs[route]["rollout"], iters=2, warmup=0))
    # Both routes compute the same step; the edge-step route's LayerNorm
    # variance is E[v^2] - mu^2 where the composed route's is
    # E[(v - mu)^2] (ROADMAP Queue C, trap 2), a few fp32 roundings apart.
    rel = _rel_rms(runs["edge_step"]["out"], runs["composed"]["out"],
                   "fp32 edge-step rollout", ref="the fp32 composed rollout",
                   tol=NONLAZY_FP32_RTOL, what="fp32")
    rollouts = {}
    for route, run in runs.items():
        with _route(run["env"]):
            busy_ms, wall_ms, top = _profile(run["rollout"], top_n=3)
        rollouts[route] = {
            "switches": run["env"], "launches_per_rollout": run["counts"],
            "rollout_ms": run["ms"], "profiled_wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms}
        _log(f"  fp32 AR-4 rollout, {route} {run['env']}: "
             + ", ".join(f"{x:.2f}" for x in run["ms"]) + " ms (mean of 2 "
             f"each, in turns); launches {run['counts']}; torch.profiler: "
             f"device busy {busy_ms:.2f} of {wall_ms:.2f} ms wall; top "
             "kernels: " + "; ".join(f"{name[:40]} {n} calls {t_ms:.2f} ms"
                                     for name, n, t_ms in top))
    step.update(launches_per_fp32_rollout=runs["edge_step"]["counts"][
        "edge_step"], route=runs["edge_step"]["env"],
                fp32_rollouts=rollouts, edge_step_vs_composed_rel_rms=rel)
    return {"edge_mlp": mlp, "edge_step": step}


def _coo_train_launches(model, graphs, coo: bool, mega: bool,
                        gcn: bool = False, ar_steps=AR_STEPS):
    """(segment-sum launches by CSR label -> [key, count], edge_mlp
    launches) of one flagship AR-``ar_steps`` train step.  Per AR step, as
    ``_train_launches``, but with the processor on the COO layout
    (``coo``): each step aggregates over the receiver CSR in the forward
    and again in the recompute (``edge_mlp`` in their place under
    ``mega``) and scatters over the receiver CSR (d_xr, or the receiver
    gather's adjoint) and over the sender CSR (d_xs, or the sender
    gather's adjoint) in the backward; ``gcn`` (``GCLT_GCN_AGG=1``) adds
    the decoder's 128-multiple GCNConv aggregations over its receiver CSR
    (forward and recompute; their backward scatter replaces the gather
    adjoint)."""
    if not coo:
        parts = _train_launches(model, graphs, ar_steps)
        mlp = 0
    else:
        enc, dec, proc = graphs.encoding, graphs.decoding, graphs.processing
        parts = {}

        def add(label, indptr, r, e, f, n):
            entry = parts.setdefault(f"{label} F={f}",
                                     [(indptr.data_ptr(), r, e, f), 0])
            entry[1] += ar_steps * n

        def widths(layer):
            return [getattr(layer, f"conv_{i}").kernel.shape[1]
                    for i in range(layer.num_convs)]

        for f in widths(model.encoder.graph_layer):
            add("encoder aggregation (forward + recompute)", enc.indptr,
                enc.num_receivers, enc.padded_num_edges, f, 2)
            add("encoder GCN gather adjoint", enc.s_indptr, enc.num_nodes,
                enc.padded_num_edges, f, 1)
        steps = model.processor.graph_layer.inet.steps
        for s in steps:
            add("processor receiver CSR", proc.indptr, proc.num_receivers,
                proc.padded_num_edges, s.hidden_dim, 1 if mega else 3)
            add("processor sender CSR", proc.s_indptr, proc.num_nodes,
                proc.padded_num_edges, s.hidden_dim, 1)
        for f in widths(model.decoder.graph_layer):
            add("decoder GCN gather adjoint", dec.s_indptr, dec.num_nodes,
                dec.padded_num_edges, f, 1)
        mlp = 2 * len(steps) * ar_steps if mega else 0
    if gcn:
        dec = graphs.decoding
        for i in range(model.decoder.graph_layer.num_convs):
            f = getattr(model.decoder.graph_layer, f"conv_{i}").kernel.shape[1]
            if f % 128 == 0:
                entry = parts.setdefault(
                    f"decoder aggregation (forward + recompute) F={f}",
                    [(dec.indptr.data_ptr(), dec.num_receivers,
                      dec.padded_num_edges, f), 0])
                entry[1] += 2 * ar_steps
    return parts, mlp


def _flagship_step(ctx, base, dtype):
    """(model copy of ``base`` on the card, its ``make_train_step``) for
    the flagship in ``dtype``."""
    import copy

    from graphcast_lite_torch import presets
    from graphcast_lite_torch.training.loss import channel_mask, \
        lat_weights_from_axis
    from graphcast_lite_torch.training.rollout import RolloutSpec
    from graphcast_lite_torch.training.trainer import make_train_step

    cfg = presets.interaction_net_512x256()
    cfg.tpu.compute_dtype = dtype
    meta = ctx["meta"]
    n_feat = cfg.data.num_features_used
    spec = RolloutSpec(obs_window=cfg.data.obs_window_used,
                       num_features=n_feat, use_residual=cfg.use_residual,
                       remat=cfg.tpu.remat_rollout,
                       static_channels=tuple(cfg.static_channels),
                       forcing_channels=tuple(cfg.forcing_channels))
    model = copy.deepcopy(base)
    step = make_train_step(
        model, ctx["graphs"], spec, cfg, device="cuda",
        lat_weights=lat_weights_from_axis(meta.num_latitudes,
                                          meta.num_longitudes),
        chan_mask=channel_mask(n_feat, cfg.static_channels,
                               cfg.forcing_channels))
    return model, step


def _grads_within(label, grads, ref, rtol=TRAIN_GRAD_RTOL):
    """Raise unless every gradient is finite and within ``rtol`` of its
    leaf's largest reference value (+ 1e-6); returns (worst share of the
    tolerance, its leaf)."""
    worst = (0.0, "")
    for name, r in ref.items():
        got = grads[name]
        err = (got - r).abs().max().item()
        tol = rtol * r.abs().max().item() + 1e-6
        if not (torch.isfinite(got).all() and err <= tol):
            raise AssertionError(f"{label} {name}: gradient off by "
                                 f"{err:.3e} > {tol:.3e}")
        worst = max(worst, (err / tol, name))
    return worst


def phase_fused_train(ctx):
    """7b: the flagship bf16 train step on the fused routes (lazy COO
    ``fused`` and plain ``nonlazy_fused``, each also with
    ``GCLT_MEGA_EDGE=1``) beside the composed routes they replace
    (``GCLT_FUSED_EDGE=0``): exact launches every step by CSR and shape,
    the route every processor step took, the loss falls over
    FUSED_TRAIN_STEPS steps, step ms and peak memory; one fp32 step (TF32
    off) of each fused route against ``GCLT_FUSED_EDGE=0`` on the same
    weights and batch; ``GCLT_GCN_AGG=1`` on the default route: its
    launches, and its fp32 gradients against the switch off.  Every
    route starts from the same seeded weights (a fresh model, as phase
    5c's)."""
    from graphcast_lite_torch import presets
    from graphcast_lite_torch.models.weather import WeatherModel

    cfg, gs = presets.interaction_net_512x256(), ctx["gs"]
    base = WeatherModel(cfg.pipeline, cfg.data, gs.num_grid_nodes,
                        gs.num_mesh_nodes,
                        generator=torch.Generator().manual_seed(0)).cuda()
    x, y = (torch.from_numpy(a[None]).cuda() for a in ctx["request"])
    _log(f"phase 7b: flagship 512x256 AR-4 train step on the fused routes "
         f"and the composed routes they replace, bf16 against fp32 masters,"
         f" {FUSED_TRAIN_STEPS} steps each on one batch; fp32 (TF32 off) "
         f"fused against GCLT_FUSED_EDGE=0 (loss rtol {TRAIN_LOSS_RTOL}, "
         f"each gradient {TRAIN_GRAD_RTOL} x its largest + 1e-6); "
         "GCLT_GCN_AGG=1 on the default route")
    out = {}
    for name, (env, route, coo, mega, gcn) in FUSED_ROUTES.items():
        with _route(env):
            model, step = _flagship_step(ctx, base, "bfloat16")
            parts, n_mlp = _coo_train_launches(model, step.graphs, coo,
                                               mega, gcn)
            by_csr = {label: n for label, (_, n) in parts.items()}
            expected = {"segment_sum": sum(by_csr.values()),
                        "edge_mlp": n_mlp, "edge_step": 0, "by_csr": by_csr}
            losses, ms = [], []
            for i in range(FUSED_TRAIN_STEPS):
                torch.cuda.synchronize()
                if i == 1:
                    torch.cuda.reset_peak_memory_stats()
                _reset_launches()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                loss = step(x, y)
                end.record()
                torch.cuda.synchronize()
                if i > 0:
                    ms.append(start.elapsed_time(end))
                counts = dict(_launches(), by_csr=_csr_launches(parts))
                if counts != expected:
                    raise AssertionError(f"{name} step {i}: launches "
                                         f"{counts}, expected {expected}")
                losses.append(loss.item())
            peak = torch.cuda.max_memory_allocated()
            took = {s.route for s in model.processor.graph_layer.inet.steps}
            if took != {route}:
                raise AssertionError(f"{name}: routes {took}, expected "
                                     f"{route}")
            if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
                raise AssertionError(f"{name}: losses {losses}")
            del model, step
        out[name] = {"route": route, "step_ms": sum(ms) / len(ms),
                     "step_ms_runs": ms, "peak_mem_bytes": peak,
                     "losses": losses,
                     "launches_per_step": {k: v for k, v in counts.items()
                                           if k != "by_csr"},
                     "segment_sum_launches_by_csr": by_csr}
        _log(f"  {name:<20s} route {route:<14s} step "
             + ", ".join(f"{t:.2f}" for t in ms)
             + f" ms (mean {out[name]['step_ms']:.2f}); peak "
             f"{peak / 2**30:.3f} GiB; losses "
             + ", ".join(f"{v:.6f}" for v in losses)
             + f"; launches a step: segment_sum {expected['segment_sum']} ("
             + ", ".join(f"{k} {v}" for k, v in by_csr.items())
             + f"), edge_mlp {n_mlp}")

    # fp32 (TF32 off): each fused route and the GCN switch against the
    # same step without them, on the same weights and batch.
    runs = {}

    def fp32_step(env):
        key = tuple(sorted(env.items()))
        if key not in runs:
            with _route(env):
                model, step = _flagship_step(ctx, base, "float32")
                loss = step(x, y).item()
                runs[key] = (loss, _grads(model), sorted(
                    {s.route for s in
                     model.processor.graph_layer.inet.steps}))
                del model, step
        return runs[key]

    fp32 = {}
    for name, (on, off) in FP32_PAIRS.items():
        (loss, grads, r_on), (loss_ref, grads_ref, r_off) = \
            fp32_step(on), fp32_step(off)
        if not (np.isfinite(loss)
                and abs(loss - loss_ref) <= TRAIN_LOSS_RTOL * abs(loss_ref)):
            raise AssertionError(f"{name} fp32: loss {loss} against "
                                 f"{loss_ref}")
        worst = _grads_within(f"{name} fp32", grads, grads_ref)
        fp32[name] = {"loss": loss, "loss_ref": loss_ref, "routes": r_on,
                      "routes_ref": r_off,
                      "worst_grad_err_of_tol": worst[0],
                      "worst_grad_leaf": worst[1]}
        _log(f"  fp32 {name}: routes {r_on} against {r_off}: loss "
             f"{loss:.7f} / {loss_ref:.7f}; {len(grads)} gradients, largest "
             f"error {worst[0]:.2e} of its tolerance ({worst[1]})")
    return {"bf16": out, "fp32": fp32}


class _HeadRecorder:
    """Wraps ``cli.train_regional.head_step`` to time each head step (CUDA
    events), its peak memory and its kernel launches, the route of every
    processor step of the head, and, on the first step, the frozen global
    forward alone (CUDA events, 3 runs)."""

    def __init__(self):
        from graphcast_lite_torch.cli import train_regional

        self.mod, self.step = train_regional, train_regional.head_step
        self.steps, self.global_ms, self.model = [], None, None

        def head_step(model, optimizer, x, y):
            if self.model is None:
                self.model = model
                with torch.no_grad():
                    self.global_ms = _time_ms(lambda: model._global(x),
                                              iters=3, warmup=1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = _launch_snapshot()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = self.step(model, optimizer, x, y)
            end.record()
            torch.cuda.synchronize()
            counts, by_csr = _launch_diff(before, _launch_snapshot())
            self.steps.append({
                "ms": start.elapsed_time(end), "loss": loss.item(),
                "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                "launches": counts, "by_csr": by_csr,
                "routes": sorted(_head_routes(model.head))})
            return loss

        train_regional.head_step = head_step

    def close(self):
        self.mod.head_step = self.step


def _head_routes(head):
    from graphcast_lite_torch.models.gnn import InteractionNetLayer

    return {m.route for m in head.modules()
            if isinstance(m, InteractionNetLayer)}


def _head_step_launches(model, mega):
    """(segment-sum launches by (indptr, R, E, F) key, edge_mlp launches)
    of one head step of ``RegionalModel`` ``model``: the frozen global
    forward's encoder aggregations (reg-block route, no gradient), and the
    head's forward and backward.  Dual mesh: the encoder and cross
    aggregations, the processor steps' aggregation (``edge_mlp`` under
    ``mega``), d_xr and d_xs (the fused unit), the decoder's aggregation,
    the cross receiver gather's and the encoder's and decoder's sender
    gathers' adjoints.  ROI residual (lazy COO composed): each step's
    aggregation and its receiver and sender gather adjoints."""
    counts = {}

    def add(g, f, n, senders=False):
        key = ((g.s_indptr.data_ptr(), g.num_nodes) if senders
               else (g.indptr.data_ptr(), g.num_receivers)) \
            + (g.padded_num_edges, f)
        counts[key] = counts.get(key, 0) + n

    gm, genc = model.global_model, model.global_graphs.encoding
    for i in range(gm.encoder.graph_layer.num_convs):
        add(genc, getattr(gm.encoder.graph_layer, f"conv_{i}")
            .kernel.shape[1], 1)
    head, hg = model.head, model.head_graphs
    if model.kind == "dual_mesh":
        f, steps = head.reg_processor.step.hidden_dim, \
            head.reg_processor.num_steps
        add(hg.encoding, f, 1)
        add(hg.encoding, f, 1, senders=True)
        add(hg.cross_g2r, f, 2)
        add(hg.processing, f, steps * (1 if mega else 2))
        add(hg.processing, f, steps, senders=True)
        add(hg.decoding, f, 1)
        add(hg.decoding, f, 1, senders=True)
        return counts, (steps if mega else 0)
    steps = head.processor.steps
    f = steps[0].hidden_dim
    add(hg, f, 2 * len(steps))
    add(hg, f, len(steps), senders=True)
    return counts, 0


def _regional_experiment(workdir, gs):
    """An experiment of the flagship configuration over an 11-frame
    synthetic 512x256x19 set, with a seeded global model (weights from
    seed 3) saved as ``best_model.pt``."""
    from graphcast_lite_torch import presets
    from graphcast_lite_torch.data.synthetic import generate_synthetic_dataset
    from graphcast_lite_torch.models.weather import WeatherModel

    cfg = presets.interaction_net_512x256()
    data_dir = generate_synthetic_dataset(
        os.path.join(workdir, "regional_data"), n_time=FIT_FRAMES,
        n_lon=512, n_lat=256, n_feat=cfg.data.num_features_used,
        static_channels=list(cfg.static_channels), seed=2)
    exp = _user_experiment(workdir, "regional", cfg, data_dir)
    model = WeatherModel(cfg.pipeline, cfg.data, gs.num_grid_nodes,
                         gs.num_mesh_nodes,
                         generator=torch.Generator().manual_seed(3))
    torch.save(model.state_dict(), os.path.join(exp, "best_model.pt"))
    return exp


def phase_regional_train(workdir, gs):
    """7c: ``cli.train_regional`` at full width on the card: the dual-mesh
    head at reg-level 8 (hidden 256) over the README's ROI for one epoch
    of REGIONAL_STEPS steps and ``--evaluate``, with and without
    ``GCLT_MEGA_EDGE=1``, then the ROI-residual head; exact launches every
    head step, the route of every processor step, finite losses, step ms
    beside the global forward's, peak memory; then one head step of each
    head on a 64x32 global model, card against CPU in fp32."""
    from graphcast_lite_torch.cli import train_regional

    exp = _regional_experiment(workdir, gs)
    roi = [str(v) for v in REGIONAL_ROI]
    common = [exp, "--roi"] + roi + [
        "--hidden", str(REGIONAL_HIDDEN), "--epochs", "1",
        "--max-steps-per-epoch", str(REGIONAL_STEPS), "--evaluate"]
    runs = {
        "dual_mesh": ({}, ["--head", "dual_mesh", "--reg-level",
                           str(REGIONAL_LEVEL)], "nonlazy_fused", False),
        "dual_mesh_mega": ({"GCLT_MEGA_EDGE": "1"},
                           ["--head", "dual_mesh", "--reg-level",
                            str(REGIONAL_LEVEL)], "nonlazy_fused", True),
        "roi_residual": ({}, ["--head", "roi_residual"], "composed", False),
    }
    _log(f"phase 7c: cli.train_regional on the card, ROI {REGIONAL_ROI}, "
         f"hidden {REGIONAL_HIDDEN}, 1 epoch x {REGIONAL_STEPS} steps + "
         "--evaluate, over a seeded flagship global model (fp32)")
    out = {}
    for name, (env, extra, route, mega) in runs.items():
        rec = _HeadRecorder()
        _reset_launches()
        t0 = time.perf_counter()
        try:
            with _route(env):
                report = train_regional.main(common + extra
                                             + ["--out-dir", os.path.join(
                                                 exp, name)])
        finally:
            rec.close()
        wall = time.perf_counter() - t0
        want, n_mlp = _head_step_launches(rec.model, mega)
        for i, st in enumerate(rec.steps):
            got = (st["by_csr"], st["launches"]["edge_mlp"],
                   st["launches"]["edge_step"])
            if got != (want, n_mlp, 0):
                raise AssertionError(f"{name} head step {i}: launches "
                                     f"{got}, expected {(want, n_mlp, 0)}")
            if st["routes"] != [route] or not np.isfinite(st["loss"]):
                raise AssertionError(f"{name} head step {i}: {st}")
        if len(rec.steps) != REGIONAL_STEPS or report is None \
                or not np.isfinite(report.region["rmse"]):
            raise AssertionError(f"{name}: {len(rec.steps)} steps, report "
                                 f"{report}")
        ms = [st["ms"] for st in rec.steps]
        timed = ms[1:]
        hg = rec.model.head_graphs
        proc = hg.processing if name.startswith("dual") else hg
        out[name] = {
            "route": route, "step_ms_runs": ms,
            "step_ms": sum(timed) / len(timed),
            "global_forward_ms": rec.global_ms,
            "global_share": rec.global_ms / (sum(timed) / len(timed)),
            "peak_mem_bytes": max(st["peak_mem_bytes"] for st in rec.steps),
            "losses": [st["loss"] for st in rec.steps],
            "launches_per_step": rec.steps[-1]["launches"],
            "processor_edges": proc.num_edges,
            "processor_nodes": proc.num_receivers,
            "roi_points": int(rec.model.roi_idx.numel()),
            "region_rmse": report.region["rmse"], "wall_s": wall}
        _log(f"  {name}: processor {proc.num_receivers} nodes / "
             f"{proc.num_edges} edges, route {route}; head steps "
             + ", ".join(f"{t:.2f}" for t in ms)
             + f" ms, global forward alone {rec.global_ms:.2f} ms (share "
             f"{out[name]['global_share']:.3f} of steps 2-{len(ms)}); peak "
             f"{out[name]['peak_mem_bytes'] / 2**30:.3f} GiB; losses "
             + ", ".join(f"{st['loss']:.6f}" for st in rec.steps)
             + f"; launches a step {rec.steps[-1]['launches']}; region RMSE "
             f"{report.region['rmse']:.6f}; CLI wall {wall:.1f} s")
        rec.model = None
    # The fp32 edge-MLP kernel runs 4 times a mega head step (forward,
    # recompute); the step without mega runs the composed tail instead.
    mega = out["dual_mesh_mega"]
    mega["minus_dual_mesh_step_ms"] = (mega["step_ms"]
                                       - out["dual_mesh"]["step_ms"])
    _log(f"  dual-mesh head step with GCLT_MEGA_EDGE=1 minus without, "
         f"steps 2-{REGIONAL_STEPS}: "
         f"{mega['minus_dual_mesh_step_ms']:+.2f} ms")
    out["card_vs_cpu_64x32"] = _regional_card_vs_cpu()
    return out


def _regional_card_vs_cpu():
    """One head step of each head over the 64x32 flagship architecture
    (seeded weights, reg-level 6 over the README's ROI), card against
    CPU in fp32: the loss and every head gradient."""
    import copy

    from graphcast_lite_torch import presets
    from graphcast_lite_torch.cli.train_regional import RegionalModel, \
        build_head, head_step
    from graphcast_lite_torch.graphs.build import build_graph_set
    from graphcast_lite_torch.models.weather import ModelGraphs, WeatherModel

    cfg = presets.interaction_net_64x32(n_feat=19)
    lat, lon = presets.wb2_64x32_grid()
    gs = build_graph_set(lat, lon, cfg.graph.mesh_levels,
                         cfg.graph.grid2mesh_radius_query)
    c, obs = cfg.data.num_features_used, cfg.data.obs_window_used
    model = WeatherModel(cfg.pipeline, cfg.data, gs.num_grid_nodes,
                         gs.num_mesh_nodes,
                         generator=torch.Generator().manual_seed(4))
    graphs = ModelGraphs.from_graph_set(gs)
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(gs.num_grid_nodes, obs * c)
                         .astype(np.float32))
    y = torch.from_numpy(rng.randn(gs.num_grid_nodes, c).astype(np.float32))
    out = {}
    for kind in ("dual_mesh", "roi_residual"):
        head, hg, roi = build_head(
            kind, gs, REGIONAL_ROI, c, obs, model.latent_dim,
            hidden=REGIONAL_HIDDEN, reg_level=max(cfg.graph.mesh_levels) + 1)
        res = {}
        for device in ("cuda", "cpu"):
            composed = RegionalModel(copy.deepcopy(model), graphs,
                                     copy.deepcopy(head), hg, roi).to(device)
            opt = torch.optim.Adam(composed.head.parameters(), lr=3e-4)
            loss = head_step(composed, opt, x.to(device), y.to(device))
            res[device] = (loss.item(), _grads(composed.head))
        (loss, grads), (loss_cpu, grads_cpu) = res["cuda"], res["cpu"]
        if not (np.isfinite(loss)
                and abs(loss - loss_cpu) <= TRAIN_LOSS_RTOL * abs(loss_cpu)):
            raise AssertionError(f"{kind} 64x32 head step: loss card {loss} "
                                 f"cpu {loss_cpu}")
        worst = _grads_within(f"{kind} 64x32 head step", grads, grads_cpu)
        out[kind] = {"loss_card": loss, "loss_cpu": loss_cpu,
                     "roi_points": int(roi.numel()),
                     "worst_grad_err_of_tol": worst[0],
                     "worst_grad_leaf": worst[1]}
        _log(f"  {kind} head step over the 64x32 model, card vs CPU fp32: "
             f"loss {loss:.7f} / {loss_cpu:.7f}; {len(grads)} gradients, "
             f"largest error {worst[0]:.2e} of its tolerance ({worst[1]})")
    return out


def phase_regional_grids():
    """7d: a regional-mesh model (BASELINE.md's regional GNN widths on a
    61x41 grid at 0.25 deg, 50-60 N, 85-100 E: mesh [3, 5] pruned to the
    region, 19 features, hidden 128, 8 InteractionNet steps) and the
    flagship architecture on a flat 64x32 grid (per-node coordinates), fp32
    with seeded weights: one AR-4 request and one AR-4 train step each,
    card against CPU."""
    import copy

    from graphcast_lite_torch import presets
    from graphcast_lite_torch.graphs.build import build_graph_set
    from graphcast_lite_torch.models.weather import ModelGraphs, WeatherModel
    from graphcast_lite_torch.training.rollout import RolloutSpec, \
        rollout_predict
    from graphcast_lite_torch.training.trainer import make_train_step

    _log("phase 7d: regional mesh (61x41 at 0.25 deg, mesh [3, 5] pruned, "
         "hidden 128, 8 steps) and flat 64x32 grid, fp32, card vs CPU: one "
         f"AR-4 request ({E2E_TOL}) and one AR-4 train step (loss rtol "
         f"{TRAIN_LOSS_RTOL}, each gradient {TRAIN_GRAD_RTOL} x its largest "
         "+ 1e-6)")
    reg_cfg = presets.interaction_net_64x32(n_feat=19, hidden=128,
                                            mp_steps=8)
    lat = (50.0 + 0.25 * np.arange(41)).astype(np.float32)
    lon = (85.0 + 0.25 * np.arange(61)).astype(np.float32)
    reg_gs = build_graph_set(lat, lon, reg_cfg.graph.mesh_levels,
                             reg_cfg.graph.grid2mesh_radius_query,
                             region_bounds=(50.0, 60.0, 85.0, 100.0))
    flat_cfg = presets.interaction_net_64x32(n_feat=19)
    glat, glon = presets.wb2_64x32_grid()
    lon2d, lat2d = np.meshgrid(glon, glat)
    flat_gs = build_graph_set(lat2d.reshape(-1), lon2d.reshape(-1),
                              flat_cfg.graph.mesh_levels,
                              flat_cfg.graph.grid2mesh_radius_query,
                              flat_grid=True)
    out = {}
    for name, cfg, gs, route in (("regional_61x41", reg_cfg, reg_gs,
                                  "composed"),
                                 ("flat_64x32", flat_cfg, flat_gs,
                                  "reg_block")):
        c, obs = cfg.data.num_features_used, cfg.data.obs_window_used
        g = gs.num_grid_nodes
        model = WeatherModel(cfg.pipeline, cfg.data, g, gs.num_mesh_nodes,
                             generator=torch.Generator().manual_seed(5))
        graphs = ModelGraphs.from_graph_set(gs)
        spec = RolloutSpec(obs_window=obs, num_features=c,
                           use_residual=cfg.use_residual, remat=True)
        rng = np.random.RandomState(7)
        x = rng.randn(1, g, obs * c).astype(np.float32)
        y = rng.randn(1, g, AR_STEPS * c).astype(np.float32)
        res = {}
        for device in ("cuda", "cpu"):
            m = copy.deepcopy(model).to(device)
            gr = graphs.to(device)
            window = torch.from_numpy(x[0].reshape(g, obs, c)).to(device)
            _reset_launches()
            with torch.inference_mode():
                pred = rollout_predict(lambda inp, mk, t, p: m(inp, gr, mk),
                                       window, AR_STEPS, spec)
            req = _launches()
            routes = {s.route for s in m.processor.graph_layer.inet.steps}
            step = make_train_step(m, graphs, spec, cfg, device=device)
            _reset_launches()
            loss = step(x, y).item()
            res[device] = (pred.cpu(), loss, _grads(m), req, _launches(),
                           routes)
        pred, loss, grads, req, train, routes = res["cuda"]
        pred_cpu, loss_cpu, grads_cpu = res["cpu"][:3]
        if routes != {route} or not torch.isfinite(pred).all() \
                or req["segment_sum"] == 0 or train["segment_sum"] == 0:
            raise AssertionError(f"{name}: routes {routes}, launches {req} "
                                 f"/ {train}")
        err = (pred - pred_cpu).abs().max().item()
        torch.testing.assert_close(pred, pred_cpu, **E2E_TOL)
        if abs(loss - loss_cpu) > TRAIN_LOSS_RTOL * abs(loss_cpu):
            raise AssertionError(f"{name}: loss card {loss} cpu {loss_cpu}")
        worst = _grads_within(f"{name} train step", grads, grads_cpu)
        out[name] = {"grid_points": g, "mesh_nodes": gs.num_mesh_nodes,
                     "processor_edges": gs.processing.num_edges,
                     "route": route, "max_abs_err_request": err,
                     "loss_card": loss, "loss_cpu": loss_cpu,
                     "worst_grad_err_of_tol": worst[0],
                     "worst_grad_leaf": worst[1],
                     "launches_per_request": req,
                     "launches_per_train_step": train}
        _log(f"  {name}: {g} grid points, mesh {gs.num_mesh_nodes} nodes / "
             f"{gs.processing.num_edges} edges, route {route}; request "
             f"max|card - cpu| {err:.3e}; loss {loss:.7f} / {loss_cpu:.7f};"
             f" {len(grads)} gradients, largest error {worst[0]:.2e} of its "
             f"tolerance ({worst[1]}); segment_sum launches "
             f"{req['segment_sum']} a request, {train['segment_sum']} a "
             "train step")
    return out

# Phase 8: the CNN stacks.  The reference's regional grid (41 x 61, lat x
# lon) and its flat U-Net config (tests/test_config_ingestion.py's dict);
# the models' parameter counts at those widths; the CLI's steps an epoch;
# timed calls after a warm-up.
CNN_GRID = (41, 61)
CNN_CONFIG = {
    "num_features": 23, "obs_window": 4, "batch_size": 8,
    "max_ar_steps": 4, "base_filters": 64, "attn_heads": 4,
    "spectral_modes": 4, "spectral_weight": 0.1, "gradient_weight": 0.05,
    "static_channels": [7, 8], "forcing_channels": [19, 20, 21, 22],
    "learning_rate": 1e-3, "num_epochs": 2,
}
CNN_PARAMS = {"v1": 7_838_423, "v2": 25_493_575, "downscaler": 4_390_583}
CNN_DOWNSCALER_FILTERS = 48
CNN_CLI_STEPS = 3
CNN_TIMED = 5
# 8a holds the card's fp32 train-step gradients against a float64
# evaluation of the same step (on the card; the CPU's float64 agrees with
# it to 1.6e-13): ||g32 - g64|| <= CNN_GRAD_L2_RTOL ||g64|| over every
# parameter.  The BatchStatNorm stacks (V1, the downscaler) are
# ill-conditioned in fp32 at these seeds: the card's gradients sit
# 2.75e-4 and 4.6e-4 from float64, the CPU's 3.55e-3 and 4.0e-6, and
# single leaves up to 9e-3 of their largest value on either side
# (cuDNN's choice of algorithm moves the card's by as much as turning
# cuDNN off does); V2 (GroupNorm) within 1e-5.  The bound allows 4x the
# card's worst.
CNN_GRAD_L2_RTOL = 2e-3


def _cnn_setup(name):
    """(GridImageModel with seeded weights on the CPU, ExperimentConfig,
    RolloutSpec, extra_loss_fn) of one CNN stack at full width: V1 and V2
    over obs 4, AR 4 (V2 with the spectral and Sobel terms), the
    downscaler over obs 1, AR 1 without channel masks."""
    from graphcast_lite_torch.config import GridExperimentConfig
    from graphcast_lite_torch.models.grid_adapter import GridImageModel
    from graphcast_lite_torch.models.unet import DownscalerUNet, \
        WeatherUNet, WeatherUNetV2
    from graphcast_lite_torch.training.loss import image_extra_loss
    from graphcast_lite_torch.training.rollout import RolloutSpec

    gc = GridExperimentConfig(**CNN_CONFIG)
    c, f = gc.num_features, gc.base_filters
    gen = torch.Generator().manual_seed(11)
    extra = None
    if name == "downscaler":
        gc.obs_window = gc.pred_steps = gc.max_ar_steps = 1
        gc.static_channels, gc.forcing_channels = [], []
        net = DownscalerUNet(c, c, CNN_DOWNSCALER_FILTERS, generator=gen)
    elif name == "v1":
        net = WeatherUNet(gc.obs_window * c, c, f, generator=gen)
    else:
        net = WeatherUNetV2(gc.obs_window * c, c, f, gc.attn_heads,
                            gc.spectral_modes, generator=gen)
        extra = image_extra_loss(*CNN_GRID, c, gc.spectral_weight,
                                 gc.gradient_weight)
    cfg = gc.to_experiment_config()
    spec = RolloutSpec(obs_window=gc.obs_window, num_features=c,
                       use_residual=True, remat=True,
                       static_channels=tuple(gc.static_channels),
                       forcing_channels=tuple(gc.forcing_channels))
    return GridImageModel(net, *CNN_GRID), cfg, spec, extra


def _cnn_step(model, cfg, spec, extra, device, decay_steps=100,
              float64=False):
    """The port's train step of a CNN stack: ``make_train_step`` with the
    CNN trainers' optimizer and loss terms, latitude weights and the
    config's channel mask; ``float64``: the same ``TrainStep`` on the
    model in float64 (the oracle of 8a; ``make_train_step`` takes fp32
    masters only)."""
    from graphcast_lite_torch.training.loss import channel_mask, \
        lat_weights_from_axis
    from graphcast_lite_torch.training.optim import ClippedAdamW
    from graphcast_lite_torch.training.trainer import TrainStep, \
        make_train_step

    kw = dict(lat_weights=lat_weights_from_axis(*CNN_GRID),
              chan_mask=channel_mask(spec.num_features,
                                     spec.static_channels,
                                     spec.forcing_channels),
              extra_loss_fn=extra)
    if float64:
        model.to(device, torch.float64)
        opt = ClippedAdamW(model.parameters(), cfg.learning_rate,
                           decay_steps)
        return TrainStep(model, None, spec, cfg.max_ar_steps,
                         torch.device(device), torch.float64, opt, **kw)
    opt = ClippedAdamW(model.parameters(), cfg.learning_rate, decay_steps)
    return make_train_step(model, None, spec, cfg, device=device,
                           optimizer=opt, **kw)


def _rel_l2(grads, ref):
    """||grads - ref|| / ||ref|| over every parameter (float64)."""
    num = sum(float(((grads[n].double() - r) ** 2).sum())
              for n, r in ref.items())
    den = sum(float((r ** 2).sum()) for r in ref.values())
    return (num / den) ** 0.5


def phase_cnn_numerics():
    """8a: each CNN stack at full width on 41 x 61, card against CPU in
    fp32 (TF32 off): one forward and one train step (batch 8) through the
    port's TrainStep on the same seeded weights and batch; the gradients
    of both against a float64 evaluation of the step on the card."""
    import copy

    _log(f"phase 8a: the CNN stacks at full width on {CNN_GRID[0]}x"
         f"{CNN_GRID[1]}, card vs CPU in fp32 (TF32 off): forward "
         f"({E2E_TOL}) and one batch-8 train step (losses within "
         f"{TRAIN_LOSS_RTOL} relative of each other and of float64; the "
         f"card's gradients within {CNN_GRAD_L2_RTOL} relative L2 of a "
         "float64 evaluation, the CPU's distance reported)")
    out = {}
    g = CNN_GRID[0] * CNN_GRID[1]
    for name in ("v1", "v2", "downscaler"):
        model, cfg, spec, extra = _cnn_setup(name)
        n_params = sum(p.numel() for p in model.parameters())
        if n_params != CNN_PARAMS[name]:
            raise AssertionError(f"{name}: {n_params} parameters, expected "
                                 f"{CNN_PARAMS[name]}")
        c, obs = spec.num_features, spec.obs_window
        ar = cfg.max_ar_steps
        rng = np.random.RandomState(3)
        x = rng.randn(cfg.batch_size, g, obs * c).astype(np.float32)
        y = rng.randn(cfg.batch_size, g, ar * c).astype(np.float32)
        res = {}
        for device, float64 in (("cuda", False), ("cpu", False),
                                ("cuda", True)):
            m = copy.deepcopy(model)
            step = _cnn_step(m, cfg, spec, extra, device, float64=float64)
            with torch.no_grad():
                fwd, _ = m(torch.from_numpy(x[0]).to(
                    device, next(m.parameters()).dtype))
            loss = step(x, y).item()
            if device == "cuda":
                off = [n for n, p in m.named_parameters()
                       if p.device.type != "cuda"]
                if off or fwd.device.type != "cuda":
                    raise AssertionError(f"{name}: not on the card: "
                                         f"{off[:3]} / {fwd.device}")
            res[device, float64] = (fwd.cpu(), loss, _grads(m))
        (fwd, loss, grads), (fwd_cpu, loss_cpu, grads_cpu), \
            (_, loss64, grads64) = (res["cuda", False], res["cpu", False],
                                    res["cuda", True])
        if fwd.shape != (g, c) or not torch.isfinite(fwd).all():
            raise AssertionError(f"{name}: forward {tuple(fwd.shape)}")
        err = (fwd - fwd_cpu).abs().max().item()
        torch.testing.assert_close(fwd, fwd_cpu, **E2E_TOL)
        for other in (loss_cpu, loss64):
            if not (np.isfinite(loss) and abs(loss - other)
                    <= TRAIN_LOSS_RTOL * abs(other)):
                raise AssertionError(f"{name}: loss card {loss}, cpu "
                                     f"{loss_cpu}, float64 {loss64}")
        if not all(torch.isfinite(v).all() for v in grads.values()):
            raise AssertionError(f"{name}: a gradient is not finite")
        card_l2, cpu_l2 = _rel_l2(grads, grads64), _rel_l2(grads_cpu,
                                                           grads64)
        if card_l2 > CNN_GRAD_L2_RTOL:
            raise AssertionError(f"{name}: card gradients {card_l2:.3e} "
                                 f"from float64 > {CNN_GRAD_L2_RTOL}")
        gmax = max(float(v.abs().max()) for v in grads64.values())
        worst = max(((grads[n].double() - r).abs().max().item() / gmax, n)
                    for n, r in grads64.items())
        card_cpu = _rel_l2(grads, {n: v.double()
                                   for n, v in grads_cpu.items()})
        out[name] = {"parameters": n_params, "obs": obs, "ar": ar,
                     "batch": cfg.batch_size,
                     "max_abs_err_forward": err,
                     "forward_tol": E2E_TOL,
                     "loss_card": loss, "loss_cpu": loss_cpu,
                     "loss_float64": loss64,
                     "grad_rel_l2_card_vs_float64": card_l2,
                     "grad_rel_l2_cpu_vs_float64": cpu_l2,
                     "grad_rel_l2_card_vs_cpu": card_cpu,
                     "grad_rel_l2_tol": CNN_GRAD_L2_RTOL,
                     "worst_grad_err_of_largest": worst[0],
                     "worst_grad_leaf": worst[1]}
        _log(f"  {name}: {n_params:,} parameters; forward max|card - cpu| "
             f"{err:.3e}; loss {loss:.7f} / cpu {loss_cpu:.7f} / float64 "
             f"{loss64:.7f}; {len(grads)} gradients, relative L2 from "
             f"float64: card {card_l2:.2e} (tol {CNN_GRAD_L2_RTOL}), cpu "
             f"{cpu_l2:.2e}; card vs cpu {card_cpu:.2e}; largest leaf error "
             f"{worst[0]:.2e} of the largest gradient ({worst[1]})")
    return out


def _cnn_measure(name, best_model, train_ds, test_ds, meta):
    """Load ``best_model`` into the stack ``name`` on the card; AR-4 (the
    config's AR) ``evaluate_model`` on 2 samples, then CUDA-event means of
    CNN_TIMED train steps (batch 8) and rollouts a request after a
    warm-up, peak memory over the steps and one profiled step's idle
    share."""
    from graphcast_lite_torch.inference.predict import evaluate_model
    from graphcast_lite_torch.training.rollout import rollout_predict

    model, cfg, spec, extra = _cnn_setup(name)
    model.load_state_dict(torch.load(best_model, map_location="cpu",
                                     weights_only=True))
    model.cuda()
    ar = cfg.max_ar_steps
    report = evaluate_model(model, None, test_ds, meta, ar_steps=ar,
                            static_channels=spec.static_channels,
                            forcing_channels=spec.forcing_channels,
                            max_samples=2, device="cuda")
    if report.num_samples != 2 or not np.isfinite(report.rmse):
        raise AssertionError(f"{name}: evaluate_model {report.num_samples} "
                             f"samples, RMSE {report.rmse}")
    x, y = (np.stack(a) for a in zip(*(train_ds.get(i)
                                       for i in range(cfg.batch_size))))
    step = _cnn_step(model, cfg, spec, extra, "cuda")
    torch.cuda.reset_peak_memory_stats()
    step_ms = _time_ms(lambda: step(x, y), iters=CNN_TIMED, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    busy, wall, top = _profile(lambda: step(x, y), top_n=5)
    loss = float(step(x, y))
    window = torch.as_tensor(test_ds.get(0)[0], device="cuda").reshape(
        -1, spec.obs_window, spec.num_features)
    model.eval()

    def rollout():
        with torch.inference_mode():
            return rollout_predict(lambda inp, mk, t, p: model(inp, None, mk),
                                   window, ar, spec)

    pred = rollout()
    if pred.shape != (window.shape[0], ar, spec.num_features) \
            or not torch.isfinite(pred).all() or not np.isfinite(loss):
        raise AssertionError(f"{name}: rollout {tuple(pred.shape)}, "
                             f"loss {loss}")
    rollout_ms = _time_ms(rollout, iters=CNN_TIMED, warmup=1)
    return {"train_step_ms": step_ms, "rollout_ms": rollout_ms,
            "ar": ar, "batch": cfg.batch_size,
            "peak_allocated_gib": peak / 2**30,
            "step_idle_share": 1 - busy / wall, "step_busy_ms": busy,
            "step_wall_ms": wall,
            "step_top_kernels": [[k, n, round(ms, 4)] for k, n, ms in top],
            "evaluate_rmse": report.rmse, "evaluate_skill": report.skill}


def _cnn_fit_losses(out_dir):
    with open(os.path.join(out_dir, "results.json")) as f:
        res = json.load(f)
    losses = res["train_losses"] + res["val_losses"]
    missing = [n for n in ("best_model.pt", "config.json", "results.json",
                           "training_log.txt", "metrics.jsonl",
                           "checkpoint/state.pt", "checkpoint/meta.json")
               if not os.path.exists(os.path.join(out_dir, n))]
    if missing or not losses or not np.isfinite(losses).all():
        raise AssertionError(f"{out_dir}: missing {missing}, losses "
                             f"{losses}")
    return res


def phase_cnn_cli(workdir):
    """8b: ``cli.train_unet`` on the card (its default device) over a
    seeded synthetic 41 x 61, 23-feature set: v2 from the flat config,
    then v1 from flags, each 2 epochs of CNN_CLI_STEPS steps; then each
    trained model measured (``_cnn_measure``)."""
    from graphcast_lite_torch.cli import train_unet
    from graphcast_lite_torch.data.dataset import load_chunked_datasets
    from graphcast_lite_torch.data.synthetic import \
        generate_synthetic_dataset

    gc = CNN_CONFIG
    c, obs, ar = gc["num_features"], gc["obs_window"], gc["max_ar_steps"]
    data = generate_synthetic_dataset(
        os.path.join(workdir, "cnn_data"), n_time=40, n_lon=CNN_GRID[1],
        n_lat=CNN_GRID[0], n_feat=c, static_channels=gc["static_channels"],
        forcing_channels=gc["forcing_channels"], seed=8)
    cfg_path = os.path.join(workdir, "unet_config.json")
    with open(cfg_path, "w") as f:
        json.dump(dict(gc, data_dir=data), f)
    _log(f"phase 8b: cli.train_unet on the card, {CNN_GRID[0]}x"
         f"{CNN_GRID[1]} x {c} synthetic set (40 frames), v2 from --config "
         f"(spectral 0.1, Sobel 0.05), v1 from flags; 2 epochs x "
         f"{CNN_CLI_STEPS} steps; then evaluate_model AR {ar} on 2 samples, "
         f"{CNN_TIMED} timed train steps (batch 8, AR {ar}) and rollouts")
    train_ds, _, test_ds, meta = load_chunked_datasets(
        data, obs_window=obs, pred_steps=ar, n_features=c)
    flags = ["--data-dir", data, "--arch", "v1", "--obs-window", str(obs),
             "--max-ar", str(ar), "--n-features", str(c), "--batch-size",
             str(gc["batch_size"]), "--epochs", str(gc["num_epochs"]),
             "--base-filters", str(gc["base_filters"]), "--static-channels",
             *map(str, gc["static_channels"]), "--forcing-channels",
             *map(str, gc["forcing_channels"])]
    out = {}
    for arch, argv in (("v2", ["--config", cfg_path]), ("v1", flags)):
        exp = os.path.join(workdir, f"unet_{arch}")
        t0 = time.perf_counter()
        train_unet.main([exp, *argv, "--max-steps-per-epoch",
                         str(CNN_CLI_STEPS)])
        cli_s = time.perf_counter() - t0
        res = _cnn_fit_losses(exp)
        row = _cnn_measure(arch, os.path.join(exp, "best_model.pt"),
                           train_ds, test_ds, meta)
        out[arch] = dict(row, cli_s=cli_s,
                         train_losses=res["train_losses"],
                         val_losses=res["val_losses"])
        _log(f"  {arch}: CLI {cli_s:.1f} s, losses "
             + ", ".join(f"{v:.4f}" for v in res["train_losses"])
             + f"; train step {row['train_step_ms']:.2f} ms (batch 8, AR "
             f"{ar}), AR-{ar} rollout {row['rollout_ms']:.2f} ms, peak "
             f"{row['peak_allocated_gib']:.3f} GiB, step idle share "
             f"{row['step_idle_share']:.3f} ({row['step_busy_ms']:.2f} of "
             f"{row['step_wall_ms']:.2f} ms busy)")
    return out


def phase_cnn_cascade(workdir):
    """8c: the downscaler cascade on the card: ``build_downscaler_dataset``
    from a seeded 15 x 22 coarse and a 41 x 61 fine set (23 features),
    ``cli.train_downscaler`` at base 48; ``cli.generate_predictions`` of
    a seeded small GNN on the fine grid, then ``cli.train_downscaler
    --gnn-input`` on its ``gnn_pred.npy``; the downscaler's step timed."""
    from graphcast_lite_torch import presets
    from graphcast_lite_torch.build import build_weather_model
    from graphcast_lite_torch.cli import generate_predictions, \
        train_downscaler
    from graphcast_lite_torch.config import to_dict
    from graphcast_lite_torch.data import etl
    from graphcast_lite_torch.data.dataset import load_chunked_datasets
    from graphcast_lite_torch.data.synthetic import \
        generate_synthetic_dataset

    c, n_time = CNN_CONFIG["num_features"], 20
    h, w = CNN_GRID
    _log(f"phase 8c: downscaler cascade on the card: 15x22 -> {h}x{w} x "
         f"{c} (20 frames), train_downscaler base "
         f"{CNN_DOWNSCALER_FILTERS} (batch 8, 2 epochs x 2 steps), "
         "generate_predictions of a seeded GNN, train_downscaler "
         "--gnn-input")
    coarse = generate_synthetic_dataset(os.path.join(workdir, "coarse"),
                                        n_time=n_time, n_lon=22, n_lat=15,
                                        n_feat=c, seed=5)
    fine = generate_synthetic_dataset(os.path.join(workdir, "fine"),
                                      n_time=n_time, n_lon=w, n_lat=h,
                                      n_feat=c, seed=5)
    ds = etl.build_downscaler_dataset(coarse, fine,
                                      os.path.join(workdir, "downscale"))
    for name in ("X_coarse.npy", "Y_fine.npy"):
        size = os.path.getsize(os.path.join(ds, name))
        if size != n_time * h * w * c * 2:
            raise AssertionError(f"{name}: {size} bytes")
    common = ["--data-dir", ds, "--base-filters",
              str(CNN_DOWNSCALER_FILTERS), "--epochs", "2",
              "--max-steps-per-epoch", "2", "--batch-size", "8"]
    down = os.path.join(workdir, "downscaler")
    truth = train_downscaler.main([down, *common])
    _cnn_fit_losses(down)

    cfg = presets.interaction_net_64x32(n_feat=c, hidden=32, mp_steps=2)
    cfg.graph.mesh_levels = [1, 2]
    cfg.data_dir = fine
    exp = os.path.join(workdir, "gnn")
    os.makedirs(exp)
    with open(os.path.join(exp, "config.json"), "w") as f:
        json.dump(to_dict(cfg), f)
    _, _, _, meta = load_chunked_datasets(fine, obs_window=2, pred_steps=1,
                                          n_features=c)
    model, _, _ = build_weather_model(cfg, meta, device="cuda", seed=9)
    torch.save(model.state_dict(), os.path.join(exp, "best_model.pt"))
    pred = os.path.join(workdir, "gnn_pred.npy")
    generate_predictions.main([exp, "--out", pred, "--max-samples", "12"])
    with open(pred + ".json") as f:
        info = json.load(f)
    gp = np.fromfile(pred, np.float16)
    if info != {"n_samples": 12, "n_nodes": h * w, "n_feat": c,
                "split": "train"} or gp.size != 12 * h * w * c \
            or not np.isfinite(gp).all():
        raise AssertionError(f"gnn_pred.npy: {info}, {gp.size} values")
    down_gnn = os.path.join(workdir, "downscaler_gnn")
    gnn = train_downscaler.main([down_gnn, *common, "--gnn-input", pred])
    _cnn_fit_losses(down_gnn)

    # The downscaler's train step (batch 8, AR 1) on the trained weights.
    model, dcfg, spec, _ = _cnn_setup("downscaler")
    model.load_state_dict(torch.load(os.path.join(down, "best_model.pt"),
                                     map_location="cpu", weights_only=True))
    model.cuda()
    x, y = (np.fromfile(os.path.join(ds, name), np.float16)
            .reshape(n_time, h * w, c)[:8].astype(np.float32)
            for name in ("X_coarse.npy", "Y_fine.npy"))
    step = _cnn_step(model, dcfg, spec, None, "cuda")
    torch.cuda.reset_peak_memory_stats()
    step_ms = _time_ms(lambda: step(x, y), iters=CNN_TIMED, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    busy, wall, _ = _profile(lambda: step(x, y))
    _log(f"  downscaler: skill vs bilinear {truth['skill'] * 100:.1f}% "
         f"(truth inputs), {gnn['skill'] * 100:.1f}% (GNN inputs, 12 "
         f"samples); train step {step_ms:.2f} ms (batch 8), peak "
         f"{peak / 2**30:.3f} GiB, idle share {1 - busy / wall:.3f}")
    return {"truth_inputs": truth, "gnn_inputs": gnn,
            "gnn_pred": info, "train_step_ms": step_ms,
            "peak_allocated_gib": peak / 2**30,
            "step_idle_share": 1 - busy / wall}


# Phase 9: data assimilation and the serving entry points.
# 9a: the DA requests of each dtype (3 samples each: one window each of
# the 11-frame set's first three), nudging's stations, and the README's
# ROI for OI (6,498 points of the 512x256 grid).
DA_REQUESTS = 3
DA_SPARSITY = 0.1
DA_ROI_POINTS = 6498
# 9b: the ladder's MOS calibration samples and evaluated samples, AR 4.
LADDER_CALIB = 2
LADDER_SAMPLES = 3
LADDER_RUNGS = 9
# 9c: the fine grid of phase 8c (41 x 61 at 0.25 deg), inside the ROI,
# and the width of the Hann border that blends it over the background.
CASCADE_LATS = 40.0 + 0.25 * np.arange(41)
CASCADE_LONS = 90.0 + 0.25 * np.arange(61)
CASCADE_BORDER = 4


def _oi_recorder():
    """Wrap ``OptimalInterpolation.apply`` and ``.solve`` for the block:
    each analysis's ms (host clock, the solve's synchronizing copy back
    included), each solve's ms, device and dtype, the systems solved (for
    the float64 check after the run), and the rows each analysis changed
    (raises when one lies outside the ROI)."""
    from graphcast_lite_torch.assimilation.optimal_interpolation import \
        OptimalInterpolation as OI

    rec = {"apply_ms": [], "solve_ms": [], "systems": [], "changed": []}
    apply, solve = OI.apply, OI.solve

    def timed_solve(self, a, rhs):
        if self.device.type != "cuda":
            raise AssertionError(f"OI solves on {self.device}")
        t0 = time.perf_counter()
        w = solve(self, a, rhs)
        rec["solve_ms"].append((time.perf_counter() - t0) * 1e3)
        if w.dtype != np.float32:
            raise AssertionError(f"OI solve returned {w.dtype}")
        rec["systems"].append((a, rhs, w))
        return w

    def timed_apply(self, forecast, observations):
        t0 = time.perf_counter()
        out = apply(self, forecast, observations)
        rec["apply_ms"].append((time.perf_counter() - t0) * 1e3)
        changed = np.flatnonzero((out != forecast).any(axis=-1))
        if self.roi_idx is not None and not np.isin(changed,
                                                    self.roi_idx).all():
            raise AssertionError("OI changed rows outside the ROI")
        rec["changed"].append(int(changed.size))
        return out

    @contextlib.contextmanager
    def patched():
        OI.apply, OI.solve = timed_apply, timed_solve
        try:
            yield rec
        finally:
            OI.apply, OI.solve = apply, solve

    return patched()


def _oi_float64_check(systems):
    """Each fp32 card solve against a float64 host solve of the same
    system: max|w32 - w64| / max|w64| within the forward-error bound of
    LU with partial pivoting, cond_2(A) * n * 2^-24 (A is symmetric
    positive definite here: B's Gaussian kernel plus sigma_o^2 I).
    Returns the worst (distance, bound, cond, n)."""
    worst = (0.0, 1.0, 0.0, 0)
    for a, rhs, w in systems:
        w64 = np.linalg.solve(a, np.asarray(rhs, np.float64))
        rel = float(np.abs(w - w64).max() / np.abs(w64).max())
        cond = float(np.linalg.cond(a))
        bound = cond * a.shape[0] * 2.0 ** -24
        if not np.isfinite(rel) or rel > bound:
            raise AssertionError(f"OI fp32 solve {rel:.3e} from float64 > "
                                 f"bound {bound:.3e} (cond {cond:.1f}, n "
                                 f"{a.shape[0]})")
        if rel / bound > worst[0] / worst[1]:
            worst = (rel, bound, cond, a.shape[0])
    return worst


@contextlib.contextmanager
def _timed_evaluate(rec):
    """``inference.predict.evaluate_model`` wrapped for the block (the CLIs
    import it when they run): each call's host ms and samples."""
    from graphcast_lite_torch.inference import predict

    inner = predict.evaluate_model

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = inner(*args, **kw)
        torch.cuda.synchronize()
        rec.append(((time.perf_counter() - t0) * 1e3, report.num_samples))
        return report

    predict.evaluate_model = timed
    try:
        yield rec
    finally:
        predict.evaluate_model = inner


@contextlib.contextmanager
def _host_spans(spans):
    """Host ms, summed by label, of the serve's host steps for the block:
    sample loads (``ChunkedTimeseriesDataset.get``, the serve's and the DA
    hook's), station observations (``make_sparse_observations``), nudging
    (``NudgingAssimilator.apply``), the streaming metrics
    (``StreamingMetrics.update``) and the ``--save-preds`` write
    (``np.savez_compressed``).  OI's analyses are timed by
    ``_oi_recorder``."""
    from graphcast_lite_torch.assimilation import nudging, observations
    from graphcast_lite_torch.data import dataset
    from graphcast_lite_torch.inference import metrics

    targets = ((dataset.ChunkedTimeseriesDataset, "get", "sample_load"),
               (observations, "make_sparse_observations", "observations"),
               (nudging.NudgingAssimilator, "apply", "nudging"),
               (metrics.StreamingMetrics, "update", "metrics"),
               (np, "savez_compressed", "npz_write"))
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in
             targets]

    def timed(fn, label):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spans[label] = spans.get(label, 0.0) + (
                    time.perf_counter() - t0) * 1e3
        return call

    for (owner, attr, fn), (_, _, label) in zip(saved, targets):
        setattr(owner, attr, timed(fn, label))
    try:
        yield spans
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def _da_request(exp, dtype, flags, per_rollout):
    """One ``cli.predict`` call of DA_REQUESTS AR-4 requests: (report, ms a
    request, host ms a request by span); raises unless every rollout
    launched the segment sum exactly ``per_rollout`` times and the report
    is finite."""
    from graphcast_lite_torch.cli import predict as predict_cli

    path = os.path.join(exp, f"report_{dtype}.json")
    calls, spans = [], {}
    _reset_launches()
    with _timed_evaluate(calls), _host_spans(spans):
        predict_cli.main([exp, "--split", "all", "--ar-steps",
                          str(AR_STEPS), "--max-samples", str(DA_REQUESTS),
                          "--dtype", dtype, "--report-json", path] + flags)
    counts = _launches()
    expected = {"segment_sum": per_rollout * DA_REQUESTS, "edge_mlp": 0,
                "edge_step": 0}
    if counts != expected:
        raise AssertionError(f"cli.predict {flags} {dtype}: launches "
                             f"{counts} (expected {expected})")
    with open(path) as f:
        report = json.load(f)
    finite = [report["rmse"]] + [h["rmse"] for h in report["per_horizon"]]
    if report["num_samples"] != DA_REQUESTS or not np.isfinite(finite).all():
        raise AssertionError(f"cli.predict {flags} {dtype}: "
                             f"{report['num_samples']} samples, {finite}")
    (ms, n), = calls
    return report, ms / n, {k: v / n for k, v in spans.items()}


def phase_da_serve(workdir):
    """9a: the flagship DA serve through ``cli.predict``'s ``main`` at full
    width, seeded weights, default route, bf16 and fp32 (TF32 off), on
    phase 6a's seeded 11-frame 512x256 set: raw, ``--da nudging`` (13,107
    stations over the grid) and ``--da oi --obs-roi-only --region`` (the
    README's ROI), DA_REQUESTS AR-4 requests each."""
    from graphcast_lite_torch import presets
    from graphcast_lite_torch.build import build_weather_model
    from graphcast_lite_torch.data.dataset import load_chunked_datasets
    from graphcast_lite_torch.data.synthetic import generate_synthetic_dataset
    from graphcast_lite_torch.inference.predict import evaluate_model, \
        region_node_mask

    cfg = presets.interaction_net_512x256()
    n_feat, obs = cfg.data.num_features_used, cfg.data.obs_window_used
    roi = " ".join(f"{v:g}" for v in REGIONAL_ROI)
    _log(f"phase 9a: flagship 512x256 DA serve through cli.predict (seeded "
         f"weights, default route, bf16 and fp32), {DA_REQUESTS} AR-"
         f"{AR_STEPS} requests each: raw, --da nudging (alpha 0.5, sparsity "
         f"{DA_SPARSITY}), --da oi --obs-roi-only --region {roi}")
    data_dir = generate_synthetic_dataset(
        os.path.join(workdir, "da_data"), n_time=FIT_FRAMES, n_lon=512,
        n_lat=256, n_feat=n_feat, static_channels=list(cfg.static_channels),
        seed=1)
    exp = _user_experiment(workdir, "da_exp", cfg, data_dir)
    _, _, all_ds, meta = load_chunked_datasets(
        data_dir, obs_window=obs, pred_steps=AR_STEPS, n_features=n_feat,
        test_split="all")
    model, graphs, gs = build_weather_model(cfg, meta, device="cuda", seed=0)
    torch.save(model.state_dict(), os.path.join(exp, "best_model.pt"))
    g = gs.num_grid_nodes
    roi_idx = np.flatnonzero(region_node_mask(meta, REGIONAL_ROI))
    if roi_idx.size != DA_ROI_POINTS:
        raise AssertionError(f"ROI holds {roi_idx.size} points")
    stations = max(1, int(round(g * DA_SPARSITY)))

    requests = {
        "raw": [],
        "nudging": ["--da", "nudging", "--da-alpha", "0.5",
                    "--obs-sparsity", str(DA_SPARSITY)],
        "oi": ["--da", "oi", "--obs-roi-only", "--region",
               *(f"{v:g}" for v in REGIONAL_ROI),
               "--obs-sparsity", str(DA_SPARSITY)],
    }
    out = {"stations_nudging": stations, "roi_points": int(roi_idx.size),
           "stations_oi": max(1, int(round(roi_idx.size * DA_SPARSITY))),
           "requests": DA_REQUESTS, "ar_steps": AR_STEPS}
    for dtype in ("bf16", "fp32"):
        row, reports = {}, {}
        for name, flags in requests.items():
            if name == "oi":
                with _oi_recorder() as rec:
                    rep, ms, spans = _da_request(exp, dtype, flags, 8)
                spans["oi_analysis"] = sum(rec["apply_ms"]) / DA_REQUESTS
            else:
                rep, ms, spans = _da_request(exp, dtype, flags, 8)
            reports[name] = rep
            row[f"{name}_request_ms"] = ms
            spans["rest"] = ms - sum(spans.values())
            row[f"{name}_host_ms_by_span"] = spans
            _log(f"  {dtype} {name}: {ms:.1f} ms a request; host ms a "
                 "request by span (the rest: rollout, copies, set-up): "
                 + ", ".join(f"{k} {v:.1f}" for k, v in spans.items()))
        h1 = {k: r["per_horizon"][0]["rmse"] for k, r in reports.items()}
        if not h1["nudging"] < h1["raw"]:
            raise AssertionError(f"{dtype}: nudged AR-step-1 RMSE "
                                 f"{h1['nudging']} not below raw {h1['raw']}")
        dist, bound, cond, n = _oi_float64_check(rec["systems"])
        steps = DA_REQUESTS * AR_STEPS
        if len(rec["apply_ms"]) != steps or len(rec["solve_ms"]) != steps:
            raise AssertionError(f"{dtype}: {len(rec['apply_ms'])} OI "
                                 f"analyses, {len(rec['solve_ms'])} solves "
                                 f"for {steps} steps")
        row.update({
            "rmse_step1": h1, "rmse": {k: r["rmse"]
                                       for k, r in reports.items()},
            "region_rmse_oi": reports["oi"]["region"]["rmse"],
            "oi_analysis_ms_per_step": float(np.mean(rec["apply_ms"])),
            "oi_solve_ms_per_step": float(np.mean(rec["solve_ms"])),
            "oi_rows_changed_per_step": float(np.mean(rec["changed"])),
            "oi_system_size": n, "oi_cond": cond,
            "oi_fp32_vs_float64_rel": dist, "oi_fp32_bound": bound,
            "launches_per_rollout": 8})
        out[dtype] = row
        _log(f"  {dtype}: request ms (evaluate_model, host clock, mean of "
             f"{DA_REQUESTS}): raw {row['raw_request_ms']:.1f}, nudging "
             f"{row['nudging_request_ms']:.1f}, OI {row['oi_request_ms']:.1f};"
             f" AR-step-1 RMSE raw {h1['raw']:.6f}, nudging "
             f"{h1['nudging']:.6f}, OI {h1['oi']:.6f}; 8 segment sums a "
             "rollout in every request")
        _log(f"  {dtype} OI: {n} x {n} system a step ({steps} solves, fp32 "
             f"on the card), analysis {row['oi_analysis_ms_per_step']:.2f} "
             f"ms a step (solve {row['oi_solve_ms_per_step']:.2f}), "
             f"{row['oi_rows_changed_per_step']:.0f} ROI rows changed; "
             f"worst fp32 solve {dist:.3e} of max|w| from float64 (bound "
             f"cond {cond:.1f} x n x 2^-24 = {bound:.3e})")

    # The per-step path with an identity assimilator against the
    # whole-trajectory path, fp32 on the card.
    kw = dict(ar_steps=AR_STEPS, use_residual=cfg.use_residual,
              static_channels=tuple(cfg.static_channels), device="cuda",
              dtype="fp32", max_samples=1)
    paths = {}
    for name, hook in (("whole", None), ("per_step", lambda o, s: o)):
        path = os.path.join(workdir, f"ident_{name}.npz")
        _reset_launches()
        evaluate_model(model, graphs, all_ds, meta, assimilator=hook,
                       save_predictions=path, **kw)
        if _launches()["segment_sum"] != 8:
            raise AssertionError(f"{name}: {_launches()} launches")
        paths[name] = torch.from_numpy(np.load(path)["predictions"])
    err = (paths["per_step"] - paths["whole"]).abs().max().item()
    torch.testing.assert_close(paths["per_step"], paths["whole"], **E2E_TOL)
    out["identity_per_step_vs_whole_max_abs"] = err
    _log(f"  identity assimilator (per-step path) against the "
         f"whole-trajectory rollout, fp32: max|diff| {err:.3e} "
         f"({E2E_TOL})")
    return out, dict(model=model, graphs=graphs, gs=gs, cfg=cfg, exp=exp,
                     data_dir=data_dir, meta=meta, ds=all_ds)


def phase_ladder(workdir):
    """9b: ``cli.evaluate_pipeline`` (all nine rungs) on the WB2 64x32 GCN
    BASELINE configuration at its published widths, seeded weights, fp32
    (TF32 off), with ``--unet-exp`` a seeded ``DownscalerUNet`` (base 48)
    saved as the port's ``GridImageModel`` state dict; the same ladder on
    the CPU; the raw rung against ``evaluate_model``'s report."""
    from graphcast_lite_torch import presets
    from graphcast_lite_torch.build import build_weather_model
    from graphcast_lite_torch.cli import evaluate_pipeline
    from graphcast_lite_torch.data.dataset import load_chunked_datasets
    from graphcast_lite_torch.data.synthetic import generate_synthetic_dataset
    from graphcast_lite_torch.inference.predict import evaluate_model
    from graphcast_lite_torch.models.grid_adapter import GridImageModel
    from graphcast_lite_torch.models.unet import DownscalerUNet

    cfg = presets.baseline_gcn_64x32()
    c, obs = cfg.data.num_features_used, cfg.data.obs_window_used
    _log(f"phase 9b: cli.evaluate_pipeline on the WB2 64x32 GCN BASELINE "
         f"({c} features, hidden 64), fp32, AR {AR_STEPS}, MOS calibration "
         f"{LADDER_CALIB}, {LADDER_SAMPLES} samples, --unet-exp a seeded "
         f"DownscalerUNet (base {CNN_DOWNSCALER_FILTERS}); card vs CPU "
         f"({E2E_TOL})")
    data_dir = generate_synthetic_dataset(
        os.path.join(workdir, "ladder_data"), n_time=55, n_lon=64, n_lat=32,
        n_feat=c, seed=2)
    exp = _user_experiment(workdir, "ladder_exp", cfg, data_dir)
    _, _, test_ds, meta = load_chunked_datasets(
        data_dir, obs_window=obs, pred_steps=AR_STEPS, n_features=c)
    if len(test_ds) < LADDER_CALIB + LADDER_SAMPLES:
        raise AssertionError(f"test split holds {len(test_ds)} samples")
    model, graphs, _ = build_weather_model(cfg, meta, device="cuda", seed=3)
    torch.save(model.state_dict(), os.path.join(exp, "best_model.pt"))
    unet_exp = os.path.join(workdir, "ladder_unet")
    os.makedirs(unet_exp)
    unet = GridImageModel(DownscalerUNet(
        c, c, CNN_DOWNSCALER_FILTERS,
        generator=torch.Generator().manual_seed(13)),
        meta.num_latitudes, meta.num_longitudes)
    torch.save(unet.state_dict(), os.path.join(unet_exp, "best_model.pt"))
    with open(os.path.join(unet_exp, "config.json"), "w") as f:
        json.dump({"base_filters": CNN_DOWNSCALER_FILTERS,
                   "num_features": c}, f)
    argv = [exp, "--ar-steps", str(AR_STEPS), "--max-samples",
            str(LADDER_SAMPLES), "--mos-calibration", str(LADDER_CALIB),
            "--unet-exp", unet_exp]
    per_rollout = _serve_launches(model, graphs) * AR_STEPS
    calls = []
    _reset_launches()
    t0 = time.perf_counter()
    with _timed_evaluate(calls):
        card = evaluate_pipeline.main(argv)
    wall_s = time.perf_counter() - t0
    launched = _launches()["segment_sum"]
    rollouts = LADDER_CALIB + LADDER_RUNGS * LADDER_SAMPLES
    if launched != per_rollout * rollouts:
        raise AssertionError(f"ladder: {launched} segment sums for "
                             f"{rollouts} rollouts of {per_rollout}")
    t0 = time.perf_counter()
    cpu = evaluate_pipeline.main(argv + ["--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    if list(card) != list(cpu) or len(card) != LADDER_RUNGS:
        raise AssertionError(f"rungs {list(card)} / {list(cpu)}")
    worst = 0.0
    for name, r in card.items():
        for key in ("rmse", "skill"):
            if not np.isfinite(r[key]):
                raise AssertionError(f"{name}: {key} {r[key]}")
            ref = cpu[name][key]
            diff = abs(r[key] - ref)
            if diff > E2E_TOL["atol"] + E2E_TOL["rtol"] * abs(ref):
                raise AssertionError(f"{name} {key}: card {r[key]} cpu {ref}")
            worst = max(worst, diff / (E2E_TOL["atol"]
                                       + E2E_TOL["rtol"] * abs(ref)))
    raw = evaluate_model(model, graphs, test_ds, meta, ar_steps=AR_STEPS,
                         use_residual=cfg.use_residual,
                         static_channels=tuple(cfg.static_channels),
                         forcing_channels=tuple(cfg.forcing_channels),
                         max_samples=LADDER_SAMPLES,
                         skip_samples=LADDER_CALIB, device="cuda")
    for key in ("rmse", "skill", "acc"):
        if not np.isclose(card["raw"][key], getattr(raw, key), rtol=1e-6,
                          atol=0.0):
            raise AssertionError(f"raw rung {key} {card['raw'][key]} != "
                                 f"evaluate_model's {getattr(raw, key)}")
    rung_ms = {name: ms / n for (ms, n), name in zip(calls, card)}
    _log("  rungs (card): " + ", ".join(
        f"{k} RMSE {r['rmse']:.6f} skill {r['skill'] * 100:.2f}%"
        for k, r in card.items()))
    _log(f"  cascade rung RMSE {card['+cascade']['rmse']:.6f} beside raw "
         f"{card['raw']['rmse']:.6f} (the reference's arithmetic: "
         "normalized predictions in, delta added; ROADMAP trap 9)")
    _log(f"  card vs CPU: worst rung {worst:.3f} of the tolerance; "
         f"{per_rollout} segment sums a rollout x {rollouts} rollouts; "
         f"CLI wall {wall_s:.1f} s on the card, {cpu_s:.1f} s on the CPU; "
         "ms a request by rung: " + ", ".join(f"{k} {v:.1f}"
                                               for k, v in rung_ms.items()))
    return {"rungs": card, "rungs_cpu": cpu, "request_ms_by_rung": rung_ms,
            "card_vs_cpu_worst_share_of_tol": worst,
            "launches_per_rollout": per_rollout, "rollouts": rollouts,
            "cli_wall_s": wall_s, "cli_wall_s_cpu": cpu_s}


def phase_regional_cascade(ctx):
    """9c: one flagship fp32 AR-1 forecast through ``cascade_refine``
    onto a 41 x 61 grid at 0.25 deg inside the ROI with a seeded
    ``DownscalerUNet`` (base 48) on the card, then
    ``blend_with_background`` over ``interpolate_to_region``'s background;
    the U-Net's part card against CPU."""
    import copy

    from graphcast_lite_torch.inference.predict import serving_copy
    from graphcast_lite_torch.inference.regional_pipelines import \
        blend_with_background, cascade_refine, crop_region, \
        interpolate_to_region, unet_apply_nhwc
    from graphcast_lite_torch.models.unet import DownscalerUNet
    from graphcast_lite_torch.training.rollout import RolloutSpec, \
        rollout_predict

    cfg, meta = ctx["cfg"], ctx["meta"]
    c, obs = cfg.data.num_features_used, cfg.data.obs_window_used
    h, w = CASCADE_LATS.size, CASCADE_LONS.size
    _log(f"phase 9c: regional cascade: flagship fp32 AR-1 forecast -> "
         f"cascade_refine onto {h}x{w} at 0.25 deg ({CASCADE_LATS[0]:g}-"
         f"{CASCADE_LATS[-1]:g} N, {CASCADE_LONS[0]:g}-{CASCADE_LONS[-1]:g} "
         f"E) with a seeded DownscalerUNet (base {CNN_DOWNSCALER_FILTERS}) "
         f"on the card, blend_with_background (border {CASCADE_BORDER})")
    smodel, graphs = serving_copy(ctx["model"], ctx["graphs"],
                                  torch.device("cuda"), torch.float32)
    x, y = ctx["ds"].get(0)
    g = x.shape[0]
    spec = RolloutSpec(obs_window=obs, num_features=c, remat=False,
                       use_residual=cfg.use_residual,
                       static_channels=tuple(cfg.static_channels))
    with torch.inference_mode():
        pred = rollout_predict(
            lambda inp, m, t, p: smodel(inp, graphs, m),
            torch.from_numpy(x.reshape(g, obs, c)).cuda(), 1, spec,
            forcing=torch.from_numpy(y.reshape(g, -1, c)).cuda(),
        )[:, 0].cpu().numpy()
    lats, lons = meta.coordinates
    unet = DownscalerUNet(c, c, CNN_DOWNSCALER_FILTERS,
                          generator=torch.Generator().manual_seed(12))
    card = unet_apply_nhwc(copy.deepcopy(unet), "cuda")
    cpu = unet_apply_nhwc(unet, "cpu")
    cascade_refine(card, pred, lats, lons, CASCADE_LATS, CASCADE_LONS,
                   REGIONAL_ROI)                                # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refined = cascade_refine(card, pred, lats, lons, CASCADE_LATS,
                             CASCADE_LONS, REGIONAL_ROI)
    cascade_ms = (time.perf_counter() - t0) * 1e3
    cropped, rl, ro = crop_region(pred, lats, lons, REGIONAL_ROI)
    up = interpolate_to_region(cropped.reshape(-1, c), rl, ro, CASCADE_LATS,
                               CASCADE_LONS)
    delta_cpu = cpu(up[None].astype(np.float32))[0]
    err = float(np.abs((refined - up) - delta_cpu).max())
    torch.testing.assert_close(torch.from_numpy(refined - up),
                               torch.from_numpy(delta_cpu.astype(up.dtype)),
                               **E2E_TOL)
    background = interpolate_to_region(pred, lats, lons, CASCADE_LATS,
                                       CASCADE_LONS)
    blended = blend_with_background(refined, background, CASCADE_BORDER)
    if blended.shape != (h, w, c) or not np.isfinite(blended).all():
        raise AssertionError(f"blended {blended.shape}")
    if not (np.array_equal(blended[h // 2, w // 2], refined[h // 2, w // 2])
            and np.array_equal(blended[0, 0], background[0, 0])):
        raise AssertionError("blend: centre not the cascade or corner not "
                             "the background")
    _log(f"  cascade {cascade_ms:.1f} ms (host clock, crop + bilinear + "
         f"U-Net on the card); U-Net delta card vs CPU max|diff| {err:.3e} "
         f"({E2E_TOL}); blended {h}x{w}x{c} finite")
    return {"fine_grid": [h, w], "cascade_ms": cascade_ms,
            "unet_card_vs_cpu_max_abs": err,
            "delta_rms": float(np.sqrt(np.mean((refined - up) ** 2)))}


def phase_operational(workdir, ctx):
    """9d: ``export_runtime_bundle`` of 9a's seeded flagship experiment
    (the port's ``best_model.pt``), ``run_live_forecast`` AR 4 on the card
    with an injected seeded ``fetch_fn``: exact launches, predictions
    bitwise a direct fp32 ``rollout_predict`` of the same frames and
    weights, live forecast ms."""
    import datetime

    from graphcast_lite_torch.build import build_weather_model
    from graphcast_lite_torch.data.dataset import DatasetMetadata
    from graphcast_lite_torch.operational.bundle import \
        export_runtime_bundle, load_runtime_bundle
    from graphcast_lite_torch.operational.live import _assemble_frame, \
        run_live_forecast
    from graphcast_lite_torch.training.rollout import RolloutSpec, \
        rollout_predict

    _log(f"phase 9d: export_runtime_bundle of the seeded flagship, "
         f"run_live_forecast AR {AR_STEPS} fp32 on the card with a seeded "
         "fetch_fn")
    bundle_dir = export_runtime_bundle(ctx["exp"], ctx["data_dir"],
                                       os.path.join(workdir, "bundle"))
    bundle = load_runtime_bundle(bundle_dir)
    if not bundle.params_path.endswith("params.pt"):
        raise AssertionError(bundle.params_path)

    def fetch(cycle):
        rng = np.random.RandomState(100 + cycle)
        return {name: bundle.mean[i] + bundle.std[i]
                * rng.randn(bundle.num_nodes).astype(np.float32)
                for i, name in enumerate(bundle.variables)}

    base = datetime.datetime(2026, 1, 1, 0)
    times = []
    for _ in range(2):                        # the first call warms up
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fc = run_live_forecast(bundle_dir, fetch, ar_steps=AR_STEPS,
                               base_time=base, device="cuda")
        times.append((time.perf_counter() - t0) * 1e3)
        if _launches()["segment_sum"] != 8:
            raise AssertionError(f"live forecast launches {_launches()}")
    cfg = bundle.config
    c, obs = cfg.data.num_features_used, cfg.data.obs_window_used
    meta = DatasetMetadata(
        flattened=True, num_latitudes=len(bundle.latitude),
        num_longitudes=len(bundle.longitude), num_features=c,
        obs_window=obs, pred_window=AR_STEPS,
        coordinates=(bundle.latitude, bundle.longitude))
    model, graphs, _ = build_weather_model(cfg, meta, device="cuda")
    model.load_state_dict(torch.load(bundle.params_path, map_location="cpu",
                                     weights_only=True))
    model.eval()
    window = np.stack([_assemble_frame(fetch(i), bundle)
                       for i in range(obs)], axis=1)
    spec = RolloutSpec(obs_window=obs, num_features=c, remat=False,
                       use_residual=cfg.use_residual,
                       static_channels=tuple(bundle.static_channels))
    with torch.inference_mode():
        preds = rollout_predict(
            lambda inp, m, t, p: model(inp, graphs, m),
            torch.from_numpy(window).cuda(), AR_STEPS, spec).cpu().numpy()
    expect = preds * bundle.std[:c] + bundle.mean[:c]
    if fc.predictions_phys.shape != expect.shape or not np.array_equal(
            fc.predictions_phys, expect):
        raise AssertionError("live forecast differs from the direct "
                             "rollout: max|diff| "
                             f"{np.abs(fc.predictions_phys - expect).max()}")
    _log(f"  live forecast AR {AR_STEPS}: {times[1]:.1f} ms (host clock, "
         f"bundle load, graphs, model, {obs} frames, rollout; first call "
         f"{times[0]:.1f} ms); 8 segment sums; predictions bitwise the "
         "direct fp32 rollout")
    return {"live_forecast_ms": times[1], "live_forecast_first_ms": times[0],
            "launches": 8, "bundle": sorted(os.listdir(bundle_dir))}


# Phase 10: the offline tooling.  10a: a seeded in-memory ChannelSource at
# the flagship's grid and 19 channels, OFFLINE_FRAMES frames in two time
# chunks of OFFLINE_CHUNK; a cut build is a child process that exits with
# CUT_EXIT at its first read of the second chunk.  10b serves
# OFFLINE_REQUESTS AR-4 requests of the converted checkpoint.  10d shards
# the flagship graph set PARTITION_SHARDS ways, with the JAX package's
# work weight of a mesh node against a grid node when it draws tiles.
OFFLINE_FRAMES = 11
OFFLINE_CHUNK = 6
CUT_EXIT = 75
OFFLINE_REQUESTS = 2
PARTITION_SHARDS = 4
MESH_NODE_WEIGHT = 7.0
# (offset, scale) of each channel's seeded field in physical units before
# the builder's float16 range scaling; None marks the land-sea mask.
OFFLINE_FIELDS = {
    "t2m": (280.0, 10.0), "10u": (0.0, 5.0), "10v": (0.0, 5.0),
    "msl": (101325.0, 500.0), "tp": (0.001, 0.001), "sp": (98000.0, 800.0),
    "tcwv": (20.0, 5.0), "z_surf": (29420.0, 9806.65), "lsm": None,
    "t@850": (280.0, 10.0), "u@850": (0.0, 8.0), "v@850": (0.0, 8.0),
    "z@850": (14700.0, 500.0), "q@850": (0.004, 0.002),
    "t@500": (255.0, 10.0), "u@500": (0.0, 12.0), "v@500": (0.0, 12.0),
    "z@500": (55000.0, 1000.0), "q@500": (0.001, 0.0005),
}
OFFLINE_STATIC = ("z_surf", "lsm")
# 10c: the WRF comparison's domain means (fp32) against a float64 NumPy
# mean of the same points, within this share of the larger of the mean
# and the channel's std (a mean near zero has no relative error to speak
# of).
DOMAIN_MEAN_RTOL = 1e-6


class _SeededSource:
    """A ``data.remote.ChannelSource`` over seeded fields of the flagship's
    512 x 256 grid (lon-major slabs [T, n_lon, n_lat], physical units),
    the static channels constant in time.  With ``cut_at`` set, the
    process exits with CUT_EXIT at the first read at or past that frame."""

    def __init__(self, cut_at=None):
        from graphcast_lite_torch import presets
        from graphcast_lite_torch.data.remote import CANONICAL_19_VARIABLES

        self.latitude, self.longitude = presets.wb2_512x256_grid()
        self.channels = list(CANONICAL_19_VARIABLES)
        self.n_time = OFFLINE_FRAMES
        self.cut_at = cut_at
        self.reads = []
        self._fields = {}

    def field(self, name):
        if name not in self._fields:
            rng = np.random.RandomState(1000 + self.channels.index(name))
            t = 1 if name in OFFLINE_STATIC else self.n_time
            shape = (t, len(self.longitude), len(self.latitude))
            if OFFLINE_FIELDS[name] is None:
                arr = (rng.rand(*shape) > 0.5).astype(np.float32)
            else:
                off, scale = OFFLINE_FIELDS[name]
                arr = (off + scale * rng.randn(*shape)).astype(np.float32)
            self._fields[name] = np.broadcast_to(
                arr, (self.n_time,) + shape[1:])
        return self._fields[name]

    def read(self, name, t0, t1):
        if self.cut_at is not None and t0 >= self.cut_at:
            sys.stdout.flush()
            os._exit(CUT_EXIT)
        self.reads.append(t0)
        return np.array(self.field(name)[t0:t1])


def _cut_build(out_dir):
    """The build of 10a cut at its second chunk (run in a child process:
    ``python3 -c "import chip_smoke; chip_smoke._cut_build(DIR)"``)."""
    from graphcast_lite_torch.data.remote import stream_build_dataset

    stream_build_dataset(_SeededSource(cut_at=OFFLINE_CHUNK), out_dir,
                         time_chunk=OFFLINE_CHUNK)
    raise AssertionError("the cut build ran to its end")


def _file_bytes(path):
    """A file's bytes; an .npz's as its members' (the zip headers carry
    the time of writing)."""
    import zipfile

    if path.endswith(".npz"):
        with zipfile.ZipFile(path) as z:
            return {name: z.read(name) for name in z.namelist()}
    with open(path, "rb") as f:
        return f.read()


def phase_dataset_build(workdir):
    """10a: ``data.remote.stream_build_dataset`` at the flagship's grid and
    channels, whole and cut then resumed; the port's loader reads it."""
    from graphcast_lite_torch.data.dataset import load_chunked_datasets
    from graphcast_lite_torch.data.remote import SCALE_FACTORS, \
        resume_state, stream_build_dataset

    _log(f"phase 10a: data.remote.stream_build_dataset, a seeded in-memory "
         f"ChannelSource at 512 x 256 x 19 channels, {OFFLINE_FRAMES} "
         f"frames in chunks of {OFFLINE_CHUNK}; then a build cut at its "
         "second chunk (a child process that exits) and resumed")
    src = _SeededSource()
    for name in src.channels:
        src.field(name)
    whole = os.path.join(workdir, "built")
    t0 = time.perf_counter()
    stream_build_dataset(src, whole, time_chunk=OFFLINE_CHUNK,
                         time_start="seeded", time_end="seeded")
    build_ms = (time.perf_counter() - t0) * 1e3

    cut = os.path.join(workdir, "cut")
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c",
         "import sys, chip_smoke; chip_smoke._cut_build(sys.argv[1])", cut],
        cwd=os.path.dirname(os.path.abspath(__file__)), timeout=600)
    cut_ms = (time.perf_counter() - t0) * 1e3
    state = resume_state(cut)
    if child.returncode != CUT_EXIT or state != {
            "last_completed_timestep": OFFLINE_CHUNK,
            "chunk_size": OFFLINE_CHUNK}:
        raise AssertionError(f"cut build: exit {child.returncode}, "
                             f"progress {state}")
    resumed = _SeededSource()
    t0 = time.perf_counter()
    stream_build_dataset(resumed, cut, time_chunk=OFFLINE_CHUNK, resume=True,
                         time_start="seeded", time_end="seeded")
    resume_ms = (time.perf_counter() - t0) * 1e3
    # progress.json [6, 6] rolls back one chunk: the resume re-reads both.
    reads = sorted(set(resumed.reads))
    if reads != [0, OFFLINE_CHUNK]:
        raise AssertionError(f"resume read chunks {reads}")
    names = sorted(os.listdir(whole))
    if names != sorted(os.listdir(cut)) or names != [
            "coords.npz", "data.npy", "dataset_info.json", "scalers.npz",
            "variables.json"]:
        raise AssertionError(f"files {names} / {sorted(os.listdir(cut))}")
    for name in names:
        if _file_bytes(os.path.join(whole, name)) \
                != _file_bytes(os.path.join(cut, name)):
            raise AssertionError(f"resumed {name} differs from the whole "
                                 "build's")

    # The scalers against float64 moments of the scaled fields; the
    # loader's first window against the fields rounded to float16.
    sc = np.load(os.path.join(whole, "scalers.npz"))
    c = len(src.channels)
    scaled = [src.field(n) * SCALE_FACTORS[n] if n in SCALE_FACTORS
              else src.field(n) for n in src.channels]
    mean = np.array([a.mean(dtype=np.float64) for a in scaled])
    std = np.array([a.std(dtype=np.float64) for a in scaled])
    if not (np.allclose(sc["mean"], mean, rtol=1e-6, atol=1e-12)
            and np.allclose(sc["std"], np.maximum(std, 1e-6), rtol=1e-6)):
        raise AssertionError(f"scalers {sc['mean']} {sc['std']} against "
                             f"{mean} {std}")
    t0 = time.perf_counter()
    _, _, ds, meta = load_chunked_datasets(
        whole, obs_window=2, pred_steps=AR_STEPS, n_features=c,
        test_split="all")
    x, y = ds.get(0)
    load_ms = (time.perf_counter() - t0) * 1e3
    g = 512 * 256
    if (len(ds), meta.num_latitudes, meta.num_longitudes,
            meta.variables) != (OFFLINE_FRAMES - 2 - AR_STEPS + 1, 256, 512,
                                src.channels) \
            or x.shape != (g, 2 * c) or y.shape != (g, AR_STEPS * c):
        raise AssertionError(f"loaded {len(ds)} samples, {x.shape}, "
                             f"{y.shape}, {meta}")
    expect = np.stack([
        (a[:2].astype(np.float16).astype(np.float32) - sc["mean"][j])
        / sc["std"][j] for j, a in enumerate(scaled)], axis=-1)
    expect = expect.transpose(2, 1, 0, 3).reshape(g, 2 * c)
    if not np.array_equal(x, expect):
        raise AssertionError("loaded window differs from the fields: "
                             f"{np.abs(x - expect).max()}")
    nbytes = os.path.getsize(os.path.join(whole, "data.npy"))
    _log(f"  whole build {build_ms:.1f} ms (host clock; {nbytes} bytes of "
         f"float16), cut child {cut_ms:.1f} ms (exit {child.returncode} "
         f"after chunk 1), resume {resume_ms:.1f} ms (re-read chunks "
         f"{reads}); resumed files byte-equal; scalers within "
         f"1e-6 of float64 moments; loader: {len(ds)} samples, window 0 "
         f"equal to the fields in float16 ({load_ms:.1f} ms)")
    return {"build_ms": build_ms, "cut_child_ms": cut_ms,
            "resume_ms": resume_ms, "load_ms": load_ms,
            "data_bytes": nbytes, "samples": len(ds)}, whole


def _reference_layout(state):
    """The flagship's port state dict in the reference ``WeatherPrediction``
    layout (the inverse of ``utils.torch_convert`` for its families: MLP
    towers, GCN stacks with a shared PReLU, the InteractionNet processor):
    torch ``Linear`` weights [out, in]."""
    import re

    sd = {}
    for name, t in state.items():
        a = t.detach().cpu()
        block, rest = name.split(".", 1)
        m = re.fullmatch(r"mlp\.(lin|prelu)_(\d+)\.(kernel|bias|alpha)", rest)
        if m:
            idx = 2 * int(m[2]) + (m[1] == "prelu")
            sd[f"{block}.mlp.MLP.{idx}."
               f"{'bias' if m[3] == 'bias' else 'weight'}"] = \
                a.T if m[3] == "kernel" else a
            continue
        m = re.fullmatch(r"mlp\.norm\.(weight|bias)", rest)
        if m:
            n = sum(k.startswith(f"{block}.mlp.lin_") and k.endswith("bias")
                    for k in state)
            sd[f"{block}.mlp.MLP.{2 * n - 1}.{m[1]}"] = a
            continue
        m = re.fullmatch(r"graph_layer\.conv_(\d+)\.(kernel|bias)", rest)
        if m:
            p = f"{block}.layers.{2 * int(m[1])}"
            if m[2] == "kernel":
                sd[f"{p}.lin.weight"] = a.T
            else:
                sd[f"{p}.bias"] = a
            continue
        if rest == "graph_layer.act.alpha":
            n = sum(k.startswith(f"{block}.graph_layer.conv_")
                    and k.endswith("kernel") for k in state)
            for i in range(n - 1):
                sd[f"{block}.layers.{2 * i + 1}.weight"] = a
            continue
        m = re.fullmatch(r"graph_layer\.inet\.edge_encoder_lin\.(kernel|bias)",
                         rest)
        if m:
            sd[f"{block}.layers.edge_encoder.0."
               f"{'weight' if m[1] == 'kernel' else 'bias'}"] = \
                a.T if m[1] == "kernel" else a
            continue
        m = re.fullmatch(r"graph_layer\.inet\.steps\.(\d+)\.(edge_mlp|node_mlp)"
                         r"\.lin_(\d)\.(kernel|bias)", rest)
        if m:
            sd[f"{block}.layers.steps.{m[1]}.{m[2]}.{2 * int(m[3])}."
               f"{'weight' if m[4] == 'kernel' else 'bias'}"] = \
                a.T if m[4] == "kernel" else a
            continue
        m = re.fullmatch(r"graph_layer\.inet\.steps\.(\d+)\.(edge_norm|"
                         r"node_norm)\.(weight|bias)", rest)
        if m:
            sd[f"{block}.layers.steps.{m[1]}.{m[2]}.{m[3]}"] = a
            continue
        raise KeyError(f"no reference name for {name}")
    return {k: v.contiguous().clone() for k, v in sd.items()}


def _seeded_model(data_dir):
    """(model, graphs, gs): the flagship with seeded weights (seed 0) on
    the card over ``data_dir``'s grid."""
    from graphcast_lite_torch import presets
    from graphcast_lite_torch.build import build_weather_model
    from graphcast_lite_torch.data.dataset import load_chunked_datasets

    cfg = presets.interaction_net_512x256()
    _, _, _, meta = load_chunked_datasets(
        data_dir, obs_window=cfg.data.obs_window_used, pred_steps=AR_STEPS,
        n_features=cfg.data.num_features_used, test_split="all")
    model, graphs, gs = build_weather_model(cfg, meta, device="cuda", seed=0)
    return model.eval(), graphs, gs


def phase_converted_serve(workdir, data_dir, ctx):
    """10b: a reference-layout ``.pth`` of the seeded flagship through
    ``utils.torch_convert`` into ``best_model.pt``, served by
    ``cli.predict`` in fp32; the rollouts bitwise those of the seeded
    weights."""
    from graphcast_lite_torch import presets
    from graphcast_lite_torch.cli import predict as predict_cli
    from graphcast_lite_torch.data.dataset import load_chunked_datasets
    from graphcast_lite_torch.inference.predict import serving_copy
    from graphcast_lite_torch.training.rollout import RolloutSpec, \
        rollout_predict
    from graphcast_lite_torch.utils.torch_convert import \
        convert_reference_checkpoint, load_torch_state_dict

    cfg = presets.interaction_net_512x256()
    model, graphs = ctx["model"], ctx["graphs"]
    _log(f"phase 10b: the seeded flagship as a reference checkpoint "
         f"(model_state_dict in a .pth) through utils.torch_convert into "
         f"best_model.pt, {OFFLINE_REQUESTS} AR-{AR_STEPS} fp32 requests "
         "through cli.predict on 10a's dataset")
    state = model.state_dict()
    ref_sd = _reference_layout(state)
    pth = os.path.join(workdir, "reference.pth")
    torch.save({"model_state_dict": ref_sd, "epoch": 7}, pth)
    t0 = time.perf_counter()
    converted = convert_reference_checkpoint(load_torch_state_dict(pth), cfg)
    convert_ms = (time.perf_counter() - t0) * 1e3
    if list(converted) != list(state) or not all(
            torch.equal(converted[k], state[k].cpu()) for k in state):
        raise AssertionError("the converted state dict differs from the "
                             "seeded weights")
    exp = _user_experiment(workdir, "converted_exp", cfg, data_dir)
    ckpt = os.path.join(exp, "best_model.pt")
    torch.save(converted, ckpt)

    served = os.path.join(workdir, "served.npz")
    calls, spans = [], {}
    _reset_launches()
    t0 = time.perf_counter()
    with _timed_evaluate(calls), _host_spans(spans):
        predict_cli.main([exp, "--checkpoint", ckpt, "--save-preds", served,
                          "--device", "cuda", "--dtype", "fp32", "--split",
                          "all", "--ar-steps", str(AR_STEPS),
                          "--max-samples", str(OFFLINE_REQUESTS)])
    torch.cuda.synchronize()
    cli_ms = (time.perf_counter() - t0) * 1e3
    counts = _launches()
    expected = {"segment_sum": 8 * OFFLINE_REQUESTS, "edge_mlp": 0,
                "edge_step": 0}
    if counts != expected:
        raise AssertionError(f"cli.predict launches {counts} (expected "
                             f"{expected})")
    (evaluate_ms, _), = calls

    # The seeded weights' rollouts of the same samples, as evaluate_model
    # runs them (serving copy, whole-trajectory rollout with the targets
    # as forcing).
    _, _, ds, _ = load_chunked_datasets(
        data_dir, obs_window=cfg.data.obs_window_used, pred_steps=AR_STEPS,
        n_features=cfg.data.num_features_used, test_split="all")
    smodel, sgraphs = serving_copy(model, graphs, torch.device("cuda"),
                                   torch.float32)
    spec = RolloutSpec(obs_window=cfg.data.obs_window_used,
                       num_features=cfg.data.num_features_used,
                       use_residual=cfg.use_residual, remat=False,
                       static_channels=tuple(cfg.static_channels),
                       forcing_channels=tuple(cfg.forcing_channels))
    g, c = 512 * 256, cfg.data.num_features_used
    expect = []
    for i in range(OFFLINE_REQUESTS):
        x, y = ds.get(i)
        window = torch.from_numpy(x.reshape(g, -1, c)).cuda()
        forcing = torch.from_numpy(y.reshape(g, -1, c)).cuda()
        with torch.inference_mode():
            out = rollout_predict(
                lambda inp, m, t, p_: smodel(inp, sgraphs, m), window,
                AR_STEPS, spec, None, forcing=forcing)
        expect.append(out.float().cpu().numpy().reshape(g, AR_STEPS * c))
    p = np.load(served)["predictions"]
    if p.shape != (OFFLINE_REQUESTS, g, AR_STEPS * c) \
            or not np.isfinite(p).all():
        raise AssertionError(f"served predictions {p.shape}")
    if not np.array_equal(p, np.stack(expect)):
        raise AssertionError("the converted checkpoint's rollout differs "
                             "from the seeded weights': max|d| "
                             f"{np.abs(p - np.stack(expect)).max()}")
    setup_ms = cli_ms - evaluate_ms
    _log(f"  {len(ref_sd)} reference tensors -> {len(converted)} port "
         f"tensors in {convert_ms:.1f} ms, bitwise the seeded weights; "
         f"cli.predict {cli_ms:.1f} ms for {OFFLINE_REQUESTS} requests "
         f"(host clock): set-up (dataset, graphs, model, checkpoint) "
         f"{setup_ms:.1f}, evaluate_model {evaluate_ms:.1f}, of which "
         + ", ".join(f"{k} {v:.1f}" for k, v in spans.items())
         + f"; {counts['segment_sum']} segment sums; predictions bitwise "
         "the seeded weights' fp32 rollouts")
    return {"convert_ms": convert_ms, "cli_predict_ms": cli_ms,
            "cli_setup_ms": setup_ms, "cli_evaluate_ms": evaluate_ms,
            "cli_host_ms_by_span": spans,
            "reference_tensors": len(ref_sd),
            "launches_per_rollout": counts["segment_sum"]
            // OFFLINE_REQUESTS}, served


def phase_compare_wrf(workdir, served, data_dir):
    """10c: ``cli.compare_wrf.main`` on 10b's predictions with a seeded
    WRF JSON export; its domain means against NumPy."""
    from graphcast_lite_torch.cli import compare_wrf

    _log("phase 10c: cli.compare_wrf on 10b's predictions, 10a's scalers "
         "and coords, a seeded WRF JSON export (sample 0)")
    bundle = np.load(served)
    pred, truth = bundle["predictions"], bundle["ground_truth"]
    c = int(bundle["n_features"])
    sc = np.load(os.path.join(data_dir, "scalers.npz"))
    co = np.load(os.path.join(data_dir, "coords.npz"))
    lon2d, lat2d = np.meshgrid(co["longitude"], co["latitude"])
    lat, lon = lat2d.ravel(), lon2d.ravel()
    b = (compare_wrf.WRF_LAT_MIN, compare_wrf.WRF_LAT_MAX,
         compare_wrf.WRF_LON_MIN, compare_wrf.WRF_LON_MAX)
    inside = np.flatnonzero((lat >= b[0]) & (lat <= b[1]) & (lon >= b[2])
                            & (lon <= b[3]))
    with open(os.path.join(data_dir, "variables.json")) as f:
        names = json.load(f)
    n, g = pred.shape[:2]

    def means(a, s, h, vi):
        vals = a[s].reshape(g, AR_STEPS, c)[inside, h, vi] \
            * sc["std"][vi] + sc["mean"][vi]
        return float(vals.astype(np.float64).mean())

    rng = np.random.RandomState(7)
    hourly = {"t2_K": 280.0, "u10_ms": 0.0, "v10_ms": 0.0,
              "psfc_Pa": 98000.0}
    wrf = {"domain": "seeded", "domain_mean": {
        k: [float(v + (300.0 if k == "psfc_Pa" else 2.0) * rng.randn())
            for _ in range(25)] for k, v in hourly.items()}}
    wrf_path = os.path.join(workdir, "wrf.json")
    with open(wrf_path, "w") as f:
        json.dump(wrf, f)
    report = os.path.join(workdir, "wrf_report.json")
    t0 = time.perf_counter()
    compare_wrf.main(["--predictions", served, "--data-dir", data_dir,
                      "--wrf-path", wrf_path, "--wrf-sample", "0",
                      "--report-json", report])
    wrf_ms = (time.perf_counter() - t0) * 1e3
    with open(report) as f:
        result = json.load(f)
    if set(result["wrf"]) != {"t2m", "10u", "10v", "sp"} or inside.size == 0:
        raise AssertionError(f"compared {sorted(result['wrf'])}, "
                             f"{inside.size} points inside")
    worst = 0.0
    for var, table in result["wrf"].items():
        vi = names.index(var)
        for h, row in enumerate(table["rows"]):
            for key, arr in (("ours", pred), ("era5", truth)):
                ref = means(arr, 0, h, vi)
                err = abs(row[key] - ref) / max(abs(ref), sc["std"][vi])
                worst = max(worst, err)
                if err > DOMAIN_MEAN_RTOL:
                    raise AssertionError(f"{var} +{row['horizon_h']}h "
                                         f"{key}: {row[key]} against {ref}")
        if len(table["rows"]) != AR_STEPS:
            raise AssertionError(f"{var}: {len(table['rows'])} rows")
    _log(f"  {inside.size} grid points inside the WRF domain; domain means "
         f"within {worst:.2e} of NumPy's (in units of max(|mean|, std); "
         f"limit {DOMAIN_MEAN_RTOL:g}); compare_wrf {wrf_ms:.1f} ms (host clock)")
    return {"points_inside": int(inside.size), "compare_wrf_ms": wrf_ms,
            "domain_mean_worst_rel": worst, "samples": n}


def _partition_plan(gs, num_shards, mode):
    """(grid partition, mesh partition, {graph: (ShardedGraph, halos)}): the
    graph set sharded as the JAX package's ``build_sharding_plan(gs,
    num_shards, partition=mode)`` shards it."""
    from graphcast_lite_torch.graphs import partition as part

    if mode == "tiles":
        shape = part.TileShape.factor(num_shards)
        lat_e, lon_e = part.tile_boundaries(
            np.concatenate([gs.grid_lat, gs.mesh_lat]),
            np.concatenate([gs.grid_lon, gs.mesh_lon]),
            np.concatenate([np.ones(gs.num_grid_nodes, np.float64),
                            np.full(gs.num_mesh_nodes, MESH_NODE_WEIGHT,
                                    np.float64)]),
            shape)
        grid, mesh = (part.build_node_partition(part.partition_nodes_by_tiles(
            lats, lons, lat_e, lon_e, shape), num_shards)
            for lats, lons in ((gs.grid_lat, gs.grid_lon),
                               (gs.mesh_lat, gs.mesh_lon)))

        def halos(sg):
            return part.build_tiled_halos(sg, shape)
    else:
        grid, mesh = (part.build_node_partition(
            part.partition_nodes_by_latitude(lats, num_shards), num_shards)
            for lats in (gs.grid_lat, gs.mesh_lat))
        halos = part.build_banded_halos
    n = gs.num_grid_nodes
    sharded = {
        "enc": part.shard_graph_bipartite(gs.encoding, grid, mesh, 0, n),
        "proc": part.shard_graph_bipartite(gs.processing, mesh, mesh),
        "dec": part.shard_graph_bipartite(gs.decoding, mesh, grid, n, 0),
    }
    return grid, mesh, {k: (sg, halos(sg)) for k, sg in sharded.items()}


def phase_partition(ctx):
    """10d: the flagship graph set, its graphs on the card, sharded
    PARTITION_SHARDS ways by latitude and by tiles (host planning for the
    sharded model)."""
    import dataclasses

    from graphcast_lite_torch.graphs import partition as part

    graphs, gs = ctx["graphs"], ctx["gs"]
    _log(f"phase 10d: graphs.partition of the flagship graph set (its "
         f"graphs on the card, read through .cpu()), {PARTITION_SHARDS} "
         "shards by latitude (banded halos) and by tiles (tiled halos)")
    if graphs.encoding.senders.device.type != "cuda":
        raise AssertionError("the graphs are not on the card")
    card = dataclasses.replace(gs, encoding=graphs.encoding,
                               processing=graphs.processing,
                               decoding=graphs.decoding)
    rng = np.random.RandomState(11)
    out = {}
    for mode in ("lat", "tiles"):
        t0 = time.perf_counter()
        grid, mesh, plan = _partition_plan(card, PARTITION_SHARDS, mode)
        plan_ms = (time.perf_counter() - t0) * 1e3
        for p, n in ((grid, gs.num_grid_nodes), (mesh, gs.num_mesh_nodes)):
            x = rng.randn(n, 3).astype(np.float32)
            if p.node_mask.sum() != n or not np.array_equal(
                    p.gather(p.scatter(x)), x):
                raise AssertionError(f"{mode}: node partition round trip")
        rows = {}
        for name, (sg, halos) in plan.items():
            graph = getattr(gs, {"enc": "encoding", "proc": "processing",
                                 "dec": "decoding"}[name])
            x = rng.randn(sg.num_nodes, 4).astype(np.float32)
            if sg.edge_mask.sum() != graph.num_edges or not np.array_equal(
                    part.gather_nodes(sg, part.scatter_nodes(sg, x)), x):
                raise AssertionError(f"{mode} {name}: {sg.edge_mask.sum()} "
                                     f"live edges of {graph.num_edges}, or "
                                     "the scatter/gather round trip failed")
            rows[name] = dict(halos.rows_exchanged_per_step(sg),
                              edges_per_shard=int(sg.edge_mask.shape[1]),
                              nodes_per_shard=sg.nodes_per_shard,
                              slab=halos.slab_size, hub=halos.hub_size)
        out[mode] = {"plan_ms": plan_ms, "graphs": rows}
        _log(f"  {mode}: plan {plan_ms:.1f} ms (host clock); rows "
             "exchanged a step (all_gather baseline / halo plan): "
             + ", ".join(f"{k} {r['all_gather_baseline']} / {r['banded']}"
                         for k, r in rows.items()))
    return out


def phase_offline(workdir, smi, ctx=None):
    """Phase 10: the offline tooling on the port, on the card ``smi``
    names.  ``ctx`` (model, graphs and gs of the seeded flagship on the
    card, as phase 9a leaves them) saves a build; without it the flagship
    is built over 10a's grid."""
    t0 = time.perf_counter()
    build, data_dir = phase_dataset_build(workdir)
    if ctx is None:
        model, graphs, gs = _seeded_model(data_dir)
        ctx = dict(model=model, graphs=graphs, gs=gs)
    serve, served = phase_converted_serve(workdir, data_dir, ctx)
    wrf = phase_compare_wrf(workdir, served, data_dir)
    partition = phase_partition(ctx)
    _log("phase 10: the learned-MOS fit and cli.build_learned_mos are not "
         "run on the card: they are host-side scikit-learn and joblib, "
         "which the card's environment does not carry "
         "(tests/test_torch_port_mos_wrf.py holds them against the JAX "
         "package on the CPU)")
    wall_s = time.perf_counter() - t0
    _log(f"  phase 10 wall {wall_s:.1f} s on {smi}")
    return {"card": smi, "dataset_build": build, "converted_serve": serve,
            "compare_wrf": wrf, "partition": partition, "wall_s": wall_s}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from graphcast_lite_torch.ops import nvcc_build

    # fp32 products in full fp32 everywhere (the plain versions included).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    _log(smi)
    _log(f"python {sys.version.split()[0]} | torch {torch.__version__} | "
         f"cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    mods = _kernel_modules()
    t0 = time.perf_counter()
    libs = nvcc_build.build(*(m.SOURCE for m in mods.values()))
    _log(f"kernel build (one nvcc per source, in parallel): "
         f"{time.perf_counter() - t0:.1f} s -> "
         + ", ".join(os.path.relpath(p) for p in libs))

    phase_kernel_cases()
    gs64, graphs64 = _baseline_graphs()
    phase_new_shape_cases(graphs64)
    phase_fused_cases()
    with tempfile.TemporaryDirectory() as workdir:
        ctx, serve = phase_serve(workdir)
        serve["coo_routes"] = phase_coo_serve(ctx)
        serve["plain_routes"] = phase_nonlazy_serve(ctx)
    n_feat = ctx["spec"].num_features
    seg_enc, seg_enc32, seg_proc, seg_send, mlp, step = \
        phase_kernel_flagship(
        ctx["gs"], n_feat)
    seg_new = phase_kernel_new_shapes(graphs64)
    seg_regional, mlp_regional = phase_regional_kernels(ctx["gs"])
    flagship32 = phase_fp32_kernels(ctx)
    phase_numerics()
    baseline = phase_baseline_numerics(gs64, graphs64)
    phase_sender_scatter_cases(ctx["gs"], n_feat)
    train = phase_train_numerics()
    train = dict(phase_train(ctx), card_vs_cpu_64x32=train)
    fused = phase_fused_train(ctx)
    with tempfile.TemporaryDirectory() as workdir:
        fit = {"flagship": phase_fit(workdir), "demo": phase_demo(workdir),
               "user_loop": phase_user_loop(
                   workdir, graphs64.processing.num_edges)}
        regional = {"fused_train": fused,
                    "train_regional": phase_regional_train(workdir,
                                                           ctx["gs"]),
                    "grids": phase_regional_grids()}
    with tempfile.TemporaryDirectory() as workdir:
        cnn = {"card": smi, "numerics": phase_cnn_numerics(),
               "train_unet": phase_cnn_cli(workdir),
               "downscaler": phase_cnn_cascade(workdir)}
    with tempfile.TemporaryDirectory() as workdir:
        da_serve, da_ctx = phase_da_serve(workdir)
        assimilation = {"card": smi, "da_serve": da_serve,
                        "ladder": phase_ladder(workdir),
                        "cascade": phase_regional_cascade(da_ctx),
                        "operational": phase_operational(workdir, da_ctx)}
    with tempfile.TemporaryDirectory() as workdir:
        offline = phase_offline(workdir, smi, da_ctx)
    ladder = assimilation["ladder"]
    fused_steps = {name: row["launches_per_step"]
                   for name, row in fused["bf16"].items()}
    head_steps = {name: row["launches_per_step"]
                  for name, row in regional["train_regional"].items()
                  if "launches_per_step" in row}

    coo, plain = serve["coo_routes"], serve["plain_routes"]
    # Launches counted in a train step at each sender-sorted CSR and shape.
    by_csr = train["segment_sum_launches_by_csr"]
    if set(seg_send) - set(by_csr):
        raise AssertionError(f"timed sender shapes {sorted(seg_send)} not "
                             f"all launched in the train step {by_csr}")
    seg = dict(seg_enc, launches=serve["launches"],
               launches_by_design=serve["launches_by_design"],
               launches_per_rollout=serve["launches"] // REQUESTS,
               launches_per_train_step=train["launches_per_step"][
                   "segment_sum"],
               launches_per_train_step_by_design=train[
                   "segment_sum_launches_by_design"],
               designs={
                   "fp32 or bf16 rows of 256-1024 bytes, a multiple of 16, "
                   "16-byte aligned": "balanced",
                   "rows under 256 bytes": "narrow",
                   "other rows": "warp"},
               at_processor_shape=dict(
                   seg_proc, route="composed",
                   launches_per_rollout=coo["composed"][
                       "launches_per_rollout"]["segment_sum"]),
               at_sender_scatter={
                   label: dict(k, launches_per_train_step=by_csr[label])
                   for label, k in seg_send.items()},
               at_encoder_fp32=dict(
                   seg_enc32, launches_in_fit_evaluations=fit["flagship"][
                       "evaluation_launches"]),
               launches_in_fit=fit["flagship"]["launches"]["segment_sum"],
               launches_in_demo_train=fit["demo"]["launches"][
                   "segment_sum"],
               launches_per_rollout_plain_composed=plain["composed"][
                   "launches_per_rollout"]["segment_sum"],
               at_new_shapes=seg_new,
               at_64x32_configs={
                   name: {k: row[k] for k in ("launches_per_request",
                                              "launches_per_train_step")}
                   for name, row in baseline.items()},
               launches_in_user_loop={
                   name: fit["user_loop"][name]["launches"]
                   for name in ("sparse_gat", "product_graph")},
               at_regional_shapes=seg_regional,
               launches_per_train_step_phase7={
                   name: n["segment_sum"] for name, n in fused_steps.items()},
               launches_per_regional_head_step={
                   name: n["segment_sum"] for name, n in head_steps.items()},
               launches_in_phase9={
                   "da_serve_per_rollout": da_serve["bf16"][
                       "launches_per_rollout"],
                   "ladder_per_rollout": ladder["launches_per_rollout"],
                   "ladder_rollouts": ladder["rollouts"],
                   "live_forecast": assimilation["operational"][
                       "launches"]},
               launches_per_rollout_phase10=offline["converted_serve"][
                   "launches_per_rollout"])
    kernels = [("segment_sum", "segment_sum.cu", "pallas_segment.py:372",
                seg)]
    for name, src, tpu, k in (
            ("edge_mlp", "edge_mlp.cu", "pallas_edge_mlp.py:198", mlp),
            ("edge_step", "edge_step.cu", "pallas_edge_step.py:365", step)):
        n = coo["mega" if name == "edge_mlp" else "edge_step"][
            "launches_per_rollout"][name]
        extra = {}
        if name == "edge_mlp":
            # The plain step's mega route: _MegaEdgeMLP, its second caller;
            # the fused edge unit's forward tail in training, its third.
            extra["launches_per_rollout_plain_mega"] = plain["mega"][
                "launches_per_rollout"][name]
            extra["launches_per_train_step_phase7"] = {
                n: c[name] for n, c in fused_steps.items()}
            extra["launches_per_regional_head_step"] = {
                n: c[name] for n, c in head_steps.items()}
            extra["at_regional_shape"] = mlp_regional
        extra["designs"] = {
            "bf16, H and De in {128, 256}": "hopper_bf16",
            "fp32, H and De in {128, 256}": "hopper_fp32",
            "wider rows": "tile16"}
        extra["at_flagship_fp32"] = flagship32[name]
        kernels.append((name, src, tpu, dict(
            k, **extra, launches=n, launches_per_rollout=n,
            launches_per_train_step=train["launches_per_step"][name],
            launches_in_fit=fit["flagship"]["launches"][name],
            launches_in_demo_train=fit["demo"]["launches"][name],
            library_note="no single PyTorch call computes this fused "
                         "function")))
    _log(json.dumps({"serve": serve}))
    _log(json.dumps({"train": train}))
    _log(json.dumps({"baseline_64x32": baseline}))
    _log(json.dumps({"fit": fit}))
    _log(json.dumps({"regional": regional}))
    _log(json.dumps({"cnn": cnn}))
    _log(json.dumps({"assimilation": assimilation}))
    _log(json.dumps({"offline": offline}))
    _log(json.dumps({"kernels": [dict({
        "name": name,
        "route": "cuda",
        "source": f"graphcast_lite_torch/csrc/{src}",
        "replaces": f"graphcast_lite_tpu/ops/{tpu}",
    }, **k) for name, src, tpu, k in kernels]}))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
