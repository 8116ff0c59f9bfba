"""The yardstick's counts against numbers worked out by hand."""

import json
import os

from conftest import REPO
from portbench.costs import flops, peaks, segment_sum


def _cfg(name):
    with open(os.path.join(REPO, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


def test_flagship_forward_flops():
    # N 131,072 grid + M 40,962 mesh = 172,034 rows; E 261,120 mesh edges;
    # h 256; encoder input 19 x 2 + 6 = 44; 12 steps; 19 outputs.
    rows = 172034
    enc_mlp = 2 * rows * (44 * 512 + 512 * 256)
    enc_gcn = 2 * rows * (256 * 256 + 256 * 256)
    edge_enc = 2 * 261120 * 4 * 256
    step = 2 * 261120 * (768 * 256 + 256 * 256) \
        + 2 * 40962 * (512 * 256 + 256 * 256)
    dec_mlp = 2 * rows * (256 * 512 + 512 * 256)
    dec_gcn = 2 * rows * (256 * 256 + 256 * 19)
    want = enc_mlp + enc_gcn + edge_enc + 12 * step + dec_mlp + dec_gcn
    assert want == 2_049_007_004_672
    assert flops.forward_flops(_cfg("flagship")) == want
    assert flops.graph_sizes(_cfg("flagship")) == (131072, 40962, 261120)
    # The processor, 1.84e12 a forward.
    assert 12 * step == 1_836_107_956_224


def test_i64x32_forward_flops():
    # N 2,048 + M 10,242 = 12,290 rows; E 65,280; input 33 x 2 + 6 = 72.
    rows = 12290
    want = (2 * rows * (72 * 512 + 512 * 256)
            + 2 * rows * (2 * 256 * 256)
            + 2 * 65280 * 4 * 256
            + 12 * (2 * 65280 * 4 * 256 * 256 + 2 * 10242 * 3 * 256 * 256)
            + 2 * rows * (2 * 256 * 512)
            + 2 * rows * (256 * 256 + 256 * 33))
    assert want == 474_779_403_264
    assert flops.forward_flops(_cfg("i64x32")) == want
    assert flops.graph_sizes(_cfg("i64x32")) == (2048, 10242, 65280)


def test_unit_flops():
    cfg = _cfg("flagship")
    f = flops.forward_flops(cfg)
    assert flops.serve_flops(cfg, 1, 4) == 4 * f
    assert flops.train_flops(cfg, 2, 4) == 3 * 2 * 4 * f


def test_segment_sum_bytes():
    # The flagship encoder's launch in bf16: messages [203,648, 256],
    # offsets [172,035] int32, sums [172,034, 256].
    assert segment_sum.launch_bytes((203648, 256), 2, 172034) == \
        203648 * 256 * 2 + 172035 * 4 + 172034 * 256 * 2 == 193_037_324
    # A batch of 16 at the 64x32 multimesh in bf16.
    assert segment_sum.launch_bytes((16, 65280, 256), 2, 10242) == \
        16 * 65280 * 256 * 2 + 10243 * 4 + 16 * 10242 * 256 * 2


def test_peaks():
    assert peaks.lookup("NVIDIA H100 80GB HBM3") == {
        "bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
    assert peaks.lookup("some other card") is None
