"""Every cell end to end at a tiny size on the CPU: one run through
``bench.main`` prints a last line of the contract's shape, and the
program's plain versions pass the comparison."""

import json
import time

import pytest
import torch

from portbench.harness import bench

CELLS = ["flagship.serve.b1", "flagship.train.b2", "i64x32.serve.k16"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_prints_a_result(cell, tiny_root, spec, capsys):
    rc = bench.main(tiny_root, cell, 2 ** 31 + 17, 0.5, False,
                    time.perf_counter(), device=torch.device("cpu"))
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(out)[-1] == "checks" and out["window"]["units"] >= 1
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    e2e, _ = bench.cell_metrics(spec, cell)
    # peak_mem_gib is a card's reading: a CPU run has none.
    want = {m["name"] for m in e2e} - {"peak_mem_gib"}
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    dev = out["device"]
    assert dev["count"] == 1 and dev["platform"] == "cpu"
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def test_traced_run_reports_the_trace(tiny_root, capsys):
    rc = bench.main(tiny_root, "flagship.serve.b1", 5, 0.3, True,
                    time.perf_counter(), device=torch.device("cpu"))
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10


def test_same_seed_same_inputs(tiny_root):
    from portbench.harness import system
    cfg = bench.load_json(f"{tiny_root}/tiny/flagship.json")
    a = system.make_weights(cfg, 2 ** 33 + 5, "cpu")
    b = system.make_weights(cfg, 2 ** 33 + 5, "cpu")
    c = system.make_weights(cfg, 2 ** 33 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_no_card_no_result(tiny_root, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main(tiny_root, "flagship.serve.b1", 1, 0.5, False,
                   time.perf_counter())
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""
