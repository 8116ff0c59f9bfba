"""Readings that the limits of ``correct`` are set from, for one cell, in
one process: the program on many seeds, the control (the reference in
the program's place at the next precision down, fp8) and the planted
faults on a few.  Each reading comes from the cell's own path at its own
size: a serve cell's ``check_sample`` requests, a train cell's first
``checked_steps`` steps.  The benchmark's own runs never run this.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--control-seeds 1 2 3] [--faults half_batch] [--fault-seeds 4 5 6]

One JSON line a reading on standard output.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _readings(root, cell, seed, device, control=False, fault=None):
    import contextlib

    import torch

    from portbench.harness import bench, faults
    from portbench.reference.lowp import FP8

    spec = bench.load_benchmark(root)
    c = {w["name"]: w for w in spec["workloads"]}[cell]
    cfg = bench.load_json(os.path.join(root, {
        x["name"]: x for x in spec["configs"]}[c["config"]]["file"]))
    traffic = bench.load_json(os.path.join(root, "portbench", "traffic",
                                           c["traffic"] + ".json"))
    kind = traffic["driver"]
    plant = faults.FAULTS[kind][fault]() if fault else \
        contextlib.nullcontext()
    t0 = time.perf_counter()
    with plant:
        run = bench.Run(root, cell, cfg, traffic, seed, 0.0, False, device)
        driver = bench.load_module(os.path.join(
            root, "portbench", "drivers", kind + ".py")).Driver(run)
        run.system = driver
        driver.setup()
        if kind == "serve":
            for _ in range(int(traffic["check_sample"])):
                d, res, _ = driver.unit()
                driver.kept[d] = res
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = [("fault:" + fault if fault else "program", driver.check(),
            driver.details)]
    if control:
        out.append(("control", driver.check(pr=FP8) if kind == "serve"
                    else driver.check(program=driver.reference(FP8)),
                    driver.details))
    for label, r, details in out:
        print(json.dumps({"cell": cell, "seed": seed, "reading": label,
                          "values": r, "details": details,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    device = torch.device(args.device)
    for seed in args.seeds:
        _readings(ROOT, args.workload, seed, device,
                  control=seed in args.control_seeds)
    for fault in args.faults:
        for seed in args.fault_seeds:
            _readings(ROOT, args.workload, seed, device, fault=fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
