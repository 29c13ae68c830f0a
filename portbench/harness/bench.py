"""One run of one cell: set-up, the measured (or traced) window, the
metrics, the check against the reference, and the result line.

    run(cell, seed, seconds, trace)  -> (exit code, result dict or None)

Order: the program is imported and its model and inputs are made from the
seed; `warmup_iterations` iterations warm every shape the cell uses (set-up
ends when the first timed iteration starts); the window; the peak memory;
no JAX module may be loaded by then; the metrics; the program's state is
freed; the reference runs on the rows drawn for the check.
"""
from __future__ import annotations

import math
import subprocess
import sys
import time
import types

import torch

from portbench.harness import check, spec
from portbench.harness.trace import ITERATION, device_trace, summarize
from portbench.harness.window import run_window

FOREIGN = ("jax", "jaxlib", "flax", "diffdart_tpu")  # top-level names, compared whole


def foreign_modules() -> list:
    """The top-level names in sys.modules that the benchmark may not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FOREIGN))


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.split("\n")[0]
        return out.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def _log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def run(cell_name: str, seed: int, seconds: float, trace: bool, started: float,
        root=spec.ROOT, device: str = "cuda", traffic: dict | None = None, chip_check=True):
    """(exit code, result or None). `started` is the process's start on the
    perf_counter clock. `device`, `traffic` (overrides of the traffic's keys)
    and chip_check=False serve the CPU tests' dry path."""
    cell = spec.load_cell(cell_name, root)
    if traffic:
        cell.traffic.update(traffic)
    if chip_check:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < cell.chips:
            _log(f"portbench: {cell_name} needs {cell.chips} CUDA device(s), this machine has {n}")
            return 3, None
    driver = cell.driver().Driver(cell, seed, device)
    tr = cell.traffic
    for i in range(tr["warmup_iterations"]):
        t0 = time.perf_counter()
        driver.iterate(i, keep=False)
        last = time.perf_counter() - t0
    first = tr["warmup_iterations"]
    expected = tr["trace_iterations"] if trace else max(1, math.floor(seconds / last))
    driver.plan_check(expected, first)

    def iterate(i):
        with torch.profiler.record_function(ITERATION):
            driver.iterate(i)

    setup_seconds = time.perf_counter() - started
    summary = None
    if trace:
        with device_trace() as traced:
            window = run_window(iterate, seconds, first=first,
                                until=lambda i: i >= first + tr["trace_iterations"])
        summary = summarize(traced["events"])
    else:
        window = run_window(iterate, seconds, first=first)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    loaded = foreign_modules()
    if loaded:
        _log(f"portbench: the run loaded {loaded}; the benchmark measures diffdart_tpu_torch alone")
        return 4, None
    ctx = types.SimpleNamespace(cell=cell, traffic=tr, config=cell.config, window=window,
                                setup_seconds=setup_seconds, env_steps=driver.env_steps, trace=summary,
                                memory_peak_bytes=peak, grad=driver.grad)
    metrics = {}
    for entry in cell.per_layer if trace else cell.end_to_end:
        value = cell.metric(entry["name"]).read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": peak}
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
    if device == "cuda":
        dev["power_limit"] = _power_limit()
    driver.release()
    numbers = driver.check()
    loaded = foreign_modules()
    if loaded:
        _log(f"portbench: the check loaded {loaded}")
        return 4, None
    ok, shown = check.judge(numbers, cell.limits)
    result = {"correct": ok, "attempted": window.attempted,
              "failed": window.attempted - window.completed, "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    result["checks"] = shown
    _log(f"portbench: {cell_name} seed {seed}: {window.completed} iterations in "
         f"{window.seconds:.3f} s, set-up {setup_seconds:.3f} s, correct {ok}")
    for name, c in shown.items():
        _log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return 0, result
