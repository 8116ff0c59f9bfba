"""Experiment log parsing and structured metrics logging.

* ``parse_training_log`` — parse the tabular ``training_log.txt`` the
  Trainer writes (and the reference wrote, src/train.py:412-423) back into
  a structured record, the role of the reference's regex log scraper
  (``scripts/parse_da_results.py``).
* ``MetricsLogger`` — append-only JSONL metrics stream per experiment (the
  framework's replacement for the reference's hard-coded wandb logging;
  if wandb happens to be installed and WANDB_API_KEY is set it mirrors
  there too, but never requires it).
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, List, Optional

__all__ = ["parse_training_log", "MetricsLogger", "compare_experiments"]

_ROW = re.compile(
    r"^\s*(\d+)\s+(\d+)\s+([\d.]+|--)\s+([\d.]+)\s+([\d.-]+)\s+([\d.]+|--)"
    r"\s+(\d+|--)"
)


def parse_training_log(path: str) -> List[Dict]:
    """Rows of {epoch, ar, train_loss, val_loss, val_acc, best_vl, patience}."""
    rows = []
    with open(path) as f:
        for line in f:
            m = _ROW.match(line)
            if not m:
                continue
            g = m.groups()
            rows.append({
                "epoch": int(g[0]),
                "ar": int(g[1]),
                "train_loss": None if g[2] == "--" else float(g[2]),
                "val_loss": float(g[3]),
                "val_acc": float(g[4]),
                "best_vl": None if g[5] == "--" else float(g[5]),
                "patience": None if g[6] == "--" else int(g[6]),
            })
    return rows


def compare_experiments(paths: Dict[str, str]) -> str:
    """Markdown table of best val losses across experiments' logs."""
    lines = ["| experiment | best val_loss | best val_ACC | epochs |",
             "|---|---|---|---|"]
    for name, path in paths.items():
        rows = parse_training_log(path)
        if not rows:
            lines.append(f"| {name} | — | — | 0 |")
            continue
        best = min(rows, key=lambda r: r["val_loss"])
        lines.append(
            f"| {name} | {best['val_loss']:.5f} | "
            f"{max(r['val_acc'] for r in rows):.4f} | {len(rows)} |"
        )
    return "\n".join(lines)


class MetricsLogger:
    """Append-only JSONL metrics (one record per step/epoch)."""

    def __init__(self, results_dir: str, run_name: Optional[str] = None,
                 mirror_wandb: bool = True):
        self.path = os.path.join(results_dir, "metrics.jsonl")
        os.makedirs(results_dir, exist_ok=True)
        self._wandb = None
        if mirror_wandb and os.environ.get("WANDB_API_KEY"):
            try:  # pragma: no cover - optional dependency
                import wandb

                self._wandb = wandb.init(project="graphcast-lite-tpu",
                                         name=run_name)
            except Exception:
                self._wandb = None

    def log(self, record: Dict) -> None:
        record = dict(record, ts=time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._wandb is not None:  # pragma: no cover
            self._wandb.log(record)

    def close(self) -> None:  # pragma: no cover
        if self._wandb is not None:
            self._wandb.finish()
