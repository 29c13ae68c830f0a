"""The traced run's device trace, and the numbers read from it.

`device_trace` and `lost_kernel_events` are frozen copies of the program's
diffdart_tpu_torch/utils/profile.py (as of the benchmark's first version):
Kineto's clock map drifts as a process ages and it then drops kernel
events, so TEARDOWN_CUPTI=1 is set before the first trace, a small kernel
runs before and after the block, and a trace in which a kernel launch has
no kernel event, or that records no launch at all, raises rather than read
short.

`summarize` reads a Chrome trace: the window is the span from the first
`portbench.iteration` annotation's start to the last one's end; device
time is the union of kernel, memcpy and memset intervals inside it; each
idle gap is put down to the innermost host event that covers its middle.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import json
import os
import shutil
import tempfile

import torch

ITERATION = "portbench.iteration"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
_LAUNCH_NAMES = ("LaunchKernel", "LaunchCooperativeKernel")


def lost_kernel_events(events) -> tuple[int, list]:
    """(the kernel launches a Chrome trace records, the launch events among
    them whose kernel event is missing). A driver launch inside a runtime
    launch on the same thread is the runtime call's own and is not counted
    again."""
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
    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace():
    """Profile the block (CPU and CUDA activity) and yield a dict that holds,
    once the block has ended, the trace's events (`events`) and its kernel
    launches (`kernel_launches`). The trace file is written under TMPDIR
    and removed once read."""
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    _touch_card()
    out = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield out
        finally:
            _touch_card()
    folder = tempfile.mkdtemp(prefix="portbench_trace_")
    try:
        path = os.path.join(folder, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["events"] = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    out["kernel_launches"], lost = lost_kernel_events(out["events"])
    if not out["kernel_launches"]:
        raise RuntimeError("device_trace: the trace records no kernel launch, not even its own "
                           "closing kernel: the profiler recorded no CUDA activity")
    if lost:
        names = sorted({e["name"] for e in lost})
        raise RuntimeError(f"device_trace: {len(lost)} of {out['kernel_launches']} kernel launches "
                           f"have no kernel event ({names[:5]}); TEARDOWN_CUPTI="
                           f"{os.environ.get('TEARDOWN_CUPTI')}")


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: dict  # kernel name -> device seconds inside the window
    kernel_n: dict  # kernel name -> launches inside the window
    device_ops: list  # [[name, seconds]], the 10 that took most device time
    idle_gaps: list  # [[host activity, seconds]], the 10 largest sums of idle time

    @property
    def kernels(self) -> int:
        return sum(self.kernel_n.values())

    def kernel_seconds(self, pattern) -> tuple[float, int]:
        """(device seconds, launches) of the kernels whose name matches the
        compiled regex `pattern`."""
        hits = [k for k in self.kernel_s if pattern.search(k)]
        return sum(self.kernel_s[k] for k in hits), sum(self.kernel_n[k] for k in hits)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events, top: int = 10) -> TraceSummary:
    """Window, device busy time, kernels by name, the top device operations
    and the idle time by host activity, from a Chrome trace's events (times
    in microseconds)."""
    marks = [e for e in events if e.get("name") == ITERATION and e.get("ph") == "X"
             and e.get("cat") in ("user_annotation", "cpu_op")]
    if not marks:
        raise ValueError(f"the trace has no {ITERATION!r} annotation")
    lo = min(e["ts"] for e in marks)
    hi = max(e["ts"] + e["dur"] for e in marks)
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS and e.get("ph") == "X"]
    inside = [(max(e["ts"], lo), min(e["ts"] + e.get("dur", 0), hi), e) for e in dev]
    inside = [(a, b, e) for a, b, e in inside if b > a]
    busy = _union([(a, b) for a, b, _ in inside])
    kernel_s, kernel_n = collections.Counter(), collections.Counter()
    for a, b, e in inside:
        kernel_s[e["name"]] += (b - a) * 1e-6
        if e["cat"] == "kernel":
            kernel_n[e["name"]] += 1
    gaps, prev = [], lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0), e.get("name", "")) for e in events
                  if e.get("cat") in _HOST_CATS and e.get("ph") == "X")
    idle, active, k = collections.Counter(), [], 0
    for a, b in gaps:  # in time order: a sweep over the host events
        mid = 0.5 * (a + b)
        while k < len(host) and host[k][0] <= mid:
            active.append(host[k])
            k += 1
        active = [h for h in active if h[1] >= mid]
        name = min(active, key=lambda h: h[1] - h[0])[2] if active else "(no host activity)"
        idle[name] += (b - a) * 1e-6
    busy_s = sum(b - a for a, b in busy) * 1e-6
    return TraceSummary(window_s=(hi - lo) * 1e-6, busy_s=busy_s, kernel_s=dict(kernel_s),
                        kernel_n=dict(kernel_n),
                        device_ops=[[k, v] for k, v in kernel_s.most_common(top)],
                        idle_gaps=[[k, v] for k, v in idle.most_common(top)])
