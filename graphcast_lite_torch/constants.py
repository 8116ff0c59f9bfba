"""Canonical artifact filenames (~ reference ``src/constants.py``; a copy
of ``graphcast_lite_tpu.constants``).

Two names differ from the JAX package's, because this package writes
another file there: ``BEST_MODEL`` is ``best_model.pt`` (the state dict
``training.trainer`` saves) and ``REGIONAL_HEAD`` is
``regional_head.pt`` (``cli.train_regional``'s).  Every other name is the
JAX package's.
"""

from __future__ import annotations


class FileNames:
    CONFIG = "config.json"
    BEST_MODEL = "best_model.pt"
    CHECKPOINT_DIR = "checkpoint"
    RESULTS = "results.json"
    TRAINING_LOG = "training_log.txt"
    METRICS = "metrics.jsonl"
    PREDICTIONS = "predictions.npz"
    EVAL_REPORT = "eval_report.json"
    GRAPH_SUMMARY = "graph_summary.json"
    REGIONAL_HEAD = "regional_head.pt"
    # dataset files
    DATA = "data.npy"
    DATASET_INFO = "dataset_info.json"
    SCALERS = "scalers.npz"
    COORDS = "coords.npz"
    VARIABLES = "variables.json"
    PROGRESS = "progress.json"
