"""Nothing the benchmark runs loads JAX or the JAX package: its sources
import none of them, and a dry run on the CPU leaves none in
``sys.modules`` (top-level names compared whole)."""

import ast
import json
import os
import subprocess
import sys

from conftest import REPO
from portbench.harness.bench import BANNED_MODULES

PKG = os.path.join(REPO, "portbench")


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_sources_import_no_jax():
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in BANNED_MODULES, (path, name)


DRY_RUN = """
import json, sys, time, torch
sys.path.insert(0, {repo!r})
from portbench.harness import bench
from portbench import calibrate
from portbench.reference import lowp
bench.run_cell({root!r}, "flagship.train.b2", 3, 0.2, False,
               time.perf_counter(), device=torch.device("cpu"))
bench.run_cell({root!r}, "i64x32.serve.k16", 3, 0.2, True,
               time.perf_counter(), device=torch.device("cpu"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_dry_run_loads_no_jax(tiny_root):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", DRY_RUN.format(repo=REPO, root=tiny_root)],
        capture_output=True, text=True, env=env, timeout=600, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "graphcast_lite_torch" in tops and "portbench" in tops
    assert not tops & set(BANNED_MODULES), tops & set(BANNED_MODULES)
