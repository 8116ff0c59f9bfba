"""A cell's driver taken through set-up and its checked work, with its
program state freed, ready for ``check``."""

import os

from portbench.harness import bench


def readings(root, cell, seed, device):
    spec = bench.load_benchmark(root)
    c = {w["name"]: w for w in spec["workloads"]}[cell]
    cfg = bench.load_json(os.path.join(root, {
        x["name"]: x for x in spec["configs"]}[c["config"]]["file"]))
    traffic = bench.load_json(os.path.join(root, "portbench", "traffic",
                                           c["traffic"] + ".json"))
    run = bench.Run(root, cell, cfg, traffic, seed, 0.0, False, device)
    driver = bench.load_module(os.path.join(
        root, "portbench", "drivers", traffic["driver"] + ".py")).Driver(run)
    run.system = driver
    driver.setup()
    if traffic["driver"] == "serve":
        for _ in range(int(traffic["check_sample"])):
            d, res, _ = driver.unit()
            driver.kept[d] = res
    driver.release()
    return driver
