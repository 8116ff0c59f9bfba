"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration and traffic
files and its metrics are read from ``BENCHMARK.json``; the last line of
standard output is the run's result as one JSON object, and the numbers
that decided ``correct`` are the last lines of standard error.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only the
    first run of a cell in a checkout builds."""
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _cache_dirs()
    sys.path.insert(0, ROOT)
    from portbench.harness import bench

    return bench.main(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), t0=_T0)


if __name__ == "__main__":
    sys.exit(main())
