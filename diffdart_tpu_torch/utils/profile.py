"""Tracing and profiling utilities.

Counterpart of diffdart_tpu/utils/profile.py (dart/common/Stopwatch.hpp and
performance::PerformanceLog parity): wall-clock stopwatches and a nested
phase log for host-side work, a JSONL metrics logger, and torch-native
hooks for device work: `named_scope` marks a region in torch.profiler's
trace and, on the card, as an NVTX range; `device_trace` records the CPU
and (where present) CUDA activity of a block into a Chrome trace.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import sys
import time

import torch


@contextlib.contextmanager
def named_scope(name: str):
    """Annotate a region for the profiler: a torch.profiler.record_function
    span and, where CUDA is present, an NVTX range of the same name."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class Stopwatch:
    """Start/stop wall timer (dart::common::Stopwatch parity)."""

    def __init__(self, start: bool = True):
        self._elapsed = 0.0
        self._t0 = time.perf_counter() if start else None

    def start(self):
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self._elapsed += time.perf_counter() - self._t0
            self._t0 = None

    def reset(self):
        self._elapsed, self._t0 = 0.0, None

    def elapsed_s(self) -> float:
        extra = (time.perf_counter() - self._t0) if self._t0 is not None else 0.0
        return self._elapsed + extra


class PerformanceLog:
    """Nested phase timings (performance::PerformanceLog::startRun parity)."""

    def __init__(self, name: str = "root"):
        self.name = name
        self.total = 0.0
        self.count = 0
        self.children: dict[str, PerformanceLog] = {}

    @contextlib.contextmanager
    def run(self, name: str):
        child = self.children.setdefault(name, PerformanceLog(name))
        t0 = time.perf_counter()
        try:
            yield child
        finally:
            child.total += time.perf_counter() - t0
            child.count += 1

    def report(self, indent: int = 0) -> str:
        lines = []
        if indent:
            lines.append("  " * indent + f"{self.name}: {self.total*1e3:.2f} ms x{self.count}")
        for c in self.children.values():
            lines.append(c.report(indent + 1))
        return "\n".join(lines)


_LAUNCH_NAMES = ("LaunchKernel", "LaunchCooperativeKernel")


def lost_kernel_events(events) -> tuple[int, list]:
    """(the kernel launches a Chrome trace records, the launch events among
    them whose kernel event is missing).

    A launch is a runtime or driver API event of a kernel launch; its
    kernel event carries the same correlation id. A driver launch inside a
    runtime launch on the same thread is the runtime call's own and is not
    counted again."""
    kernels = {e["args"]["correlation"] for e in events
               if e.get("cat") == "kernel" and "correlation" in e.get("args", {})}
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("ph") == "X" and any(n in e.get("name", "") for n in _LAUNCH_NAMES)
                and "correlation" in e.get("args", {})]
    spans = {}
    for e in launches:
        if e["cat"] == "cuda_runtime":
            spans.setdefault(e.get("tid"), []).append((e["ts"], e["ts"] + e.get("dur", 0)))
    for v in spans.values():
        v.sort()
    starts = {tid: [a for a, _ in v] for tid, v in spans.items()}

    def nested(e):
        v = spans.get(e.get("tid"))
        if e["cat"] != "cuda_driver" or not v:
            return False
        i = bisect.bisect_right(starts[e.get("tid")], e["ts"]) - 1
        return i >= 0 and e["ts"] + e.get("dur", 0) <= v[i][1]

    counted = [e for e in launches if not nested(e)]
    return len(counted), [e for e in counted if e["args"]["correlation"] not in kernels]


def _touch_card():
    """One small kernel, then a synchronize."""
    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block with torch.profiler (CPU activity, plus CUDA
    activity where a card is present) and write its Chrome trace to
    `logdir/trace_<pid>_<ns>.json`. Yields the profiler; once the block has
    ended, its `trace_path` attribute names the file and `kernel_launches`
    counts the kernel launches the trace records.

    On the card the trace is checked: every kernel launch it records must
    have its kernel event, and it must record at least its own closing
    kernel (the block's work is synchronized by a small kernel before the
    profiler stops). RuntimeError otherwise, so that a trace read for
    per-kernel metrics is never silently short.

    CUPTI maps the card's clock onto the host's when it starts. Left
    running across traces (Kineto's default), the two drift apart as the
    process ages, and Kineto drops the kernel events it then places outside
    the trace's window: on an H100 with torch 2.11, about one more of 53
    events every 15 s of process age (scripts/torch_trace_drift.py). With
    TEARDOWN_CUPTI=1 Kineto stops CUPTI after each trace, and the next one
    starts it afresh; device_trace sets it unless the caller did. A program
    that profiles before its first device_trace sets it itself, before its
    first trace (chip_smoke.py does): a CUPTI already running is not
    restarted here, and its trace raises if it lost events. A small kernel
    runs before each trace too: the traces that recorded no CUDA activity
    after a teardown had no CUDA call between the teardown and their start.
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.environ.setdefault("TEARDOWN_CUPTI", "1")
        _touch_card()
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if cuda:
                _touch_card()
    prof.trace_path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
    with open(prof.trace_path) as f:
        prof.kernel_launches, lost = lost_kernel_events(json.load(f)["traceEvents"])
    if cuda and not prof.kernel_launches:
        raise RuntimeError(f"device_trace: {prof.trace_path} records no kernel launch, not even "
                           f"its own closing kernel: the profiler recorded no CUDA activity")
    if lost:
        names = sorted({e["name"] for e in lost})
        raise RuntimeError(f"device_trace: {len(lost)} of {prof.kernel_launches} kernel launches "
                           f"in {prof.trace_path} have no kernel event ({names}); TEARDOWN_CUPTI="
                           f"{os.environ.get('TEARDOWN_CUPTI')}: a CUPTI left running across traces "
                           f"drifts from the host clock and Kineto drops the events it misplaces; "
                           f"set TEARDOWN_CUPTI=1 before the process's first profiler trace")


class MetricsLogger:
    """Structured per-iteration metrics -> JSONL stream (stdout or file)."""

    def __init__(self, path: str | None = None):
        self._fh = open(path, "a") if path else sys.stdout
        self._owns = path is not None

    def log(self, step: int, **metrics):
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self):
        if self._owns:
            self._fh.close()
