"""The comparison reads a run with a fault planted underneath the timed
path as not correct: each fault that the cell can have, at a tiny size
on the CPU (the harness's look for a card skipped)."""

import time

import pytest
import torch

from portbench.harness import bench, faults

CASES = [
    ("flagship.serve.b1", "state_unchanged"),
    ("flagship.serve.b1", "answer_altered"),
    ("i64x32.serve.k16", "state_unchanged"),
    ("i64x32.serve.k16", "answer_altered"),
    ("i64x32.serve.k16", "half_batch"),
    ("flagship.train.b2", "state_unchanged"),
    ("flagship.train.b2", "half_batch"),
]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault, tiny_root):
    kind = "train" if ".train." in cell else "serve"
    with faults.FAULTS[kind][fault]():
        out = bench.run_cell(tiny_root, cell, 11, 0.3, False,
                             time.perf_counter(), device=torch.device("cpu"))
    assert out["correct"] is False
    failed = [n for n, c in out["checks"].items() if c["value"] > c["limit"]]
    assert failed, out["checks"]
