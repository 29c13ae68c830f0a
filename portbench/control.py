#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the chip, in one
process: for each seed, the program's numbers (as a run of the cell
computes them, after a short window of `--iterations` iterations), and for
the seeds of `--control-seeds` also the control's: the reference in the
next precision below the configuration's (its `control` entry: bfloat16
for elementwise float32) put in the
program's place, on the same rows and iterations.

    python3 portbench/control.py --workload cheetah.bptt --seeds 11 12 13 \\
        --control-seeds 11 12 13 [--iterations 3]

One JSON line per seed: {"seed", "program": {...}, "control": {...}}.
The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, iterations: int, control: bool, device="cuda") -> dict:
    """The program's numbers for one seed, and the control's if asked."""
    driver = cell.driver().Driver(cell, seed, device)
    first = cell.traffic["warmup_iterations"]
    for i in range(first):
        driver.iterate(i, keep=False)
    driver.plan_check(iterations, first)
    for i in range(first, first + iterations):
        driver.iterate(i)
    driver.release()
    out = {"seed": seed, "program": driver.check()}
    if control:
        out["control"] = driver.check(control=cell.config["control"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--iterations", type=int, default=3)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.harness import spec

    cell = spec.load_cell(args.workload, ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(cell, seed, args.iterations, seed in args.control_seeds)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
