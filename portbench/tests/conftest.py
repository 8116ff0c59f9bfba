"""Fixtures of the benchmark's tests: a checkout-like root whose cells run
the benchmark's own configurations cut to a tiny size, on the CPU with
the program's plain versions.  ``card`` marks the tests that need the
card; they decide inside the test whether it is there."""

import json
import os
import sys

import pytest
import torch

# Several test workers share the machine: a few threads each.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


def tiny_config(cfg: dict) -> dict:
    """The configuration at a tiny size: an 8 x 16 grid, mesh levels
    [1, 2], hidden 16, 3 processor steps; everything else as it is."""
    cfg = json.loads(json.dumps(cfg))
    cfg["grid"].update(num_lat=8, num_lon=16, lat_first=-78.75,
                       lat_last=78.75, lon_step=22.5)
    cfg["graph"]["mesh_levels"] = [1, 2]
    h = 16
    p = cfg["pipeline"]
    for block in ("encoder", "decoder"):
        p[block]["mlp"]["mlp_hidden_dims"] = [2 * h]
        p[block]["mlp"]["output_dim"] = h
        p[block]["gcn"]["hidden_dims"] = [h]
    p["encoder"]["gcn"]["output_dim"] = h
    p["processor"]["gcn"]["output_dim"] = h
    p["processor"]["gcn"]["num_message_passing_steps"] = 3
    return cfg


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A root with BENCHMARK.json, the tiny configurations and the real
    ``portbench`` folder (linked)."""
    root = tmp_path_factory.mktemp("tiny_root")
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    os.makedirs(root / "tiny")
    for c in spec["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = tiny_config(json.load(f))
        c["file"] = f"tiny/{c['name']}.json"
        with open(root / c["file"], "w") as f:
            json.dump(cfg, f)
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(spec, f)
    os.symlink(os.path.join(REPO, "portbench"), root / "portbench")
    return str(root)


@pytest.fixture(scope="session")
def spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)
