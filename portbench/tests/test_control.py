"""The control, the reference computed in fp8 in the program's place,
comes out as not correct.  On the CPU at a tiny size: the serve cells'
control fails the cell's own limits, and the train cell's reads its loss
at least three times as far from the fp32 reference as the program does
(the train limits were set at the cell's size).  On the card (``card``)
at the cell's own size: the control fails the cell's limits."""

import os

import pytest
import torch

from portbench.harness import bench
from portbench.reference.lowp import FP8
from tests_support import readings


@pytest.mark.parametrize("cell", ["flagship.serve.b1", "i64x32.serve.k16"])
def test_serve_control_fails_the_limits(cell, tiny_root):
    driver = readings(tiny_root, cell, 3, torch.device("cpu"))
    limits = bench.load_json(os.path.join(tiny_root, "portbench", "limits",
                                          cell + ".json"))
    control = driver.check(pr=FP8)
    assert any(control[k] > limits[k] for k in limits), control


def test_train_control_reads_further_than_the_program(tiny_root):
    driver = readings(tiny_root, "flagship.train.b2", 3, torch.device("cpu"))
    program = driver.check()
    control = driver.check(program=driver.reference(FP8))
    assert control["loss_gap"] >= 3 * program["loss_gap"], (control, program)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["flagship.serve.b1", "i64x32.serve.k16",
                                  "flagship.train.b2"])
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from conftest import REPO
    driver = readings(REPO, cell, 2 ** 31 + 3, torch.device("cuda"))
    limits = bench.load_json(os.path.join(REPO, "portbench", "limits",
                                          cell + ".json"))
    control = driver.check(pr=FP8) if ".serve." in cell else \
        driver.check(program=driver.reference(FP8))
    assert any(control[k] > limits[k] for k in limits), control
