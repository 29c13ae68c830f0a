"""The harness on the CPU, with no card: discovery by name, a cell added as
new files, the window's arithmetic, the trace's readings, the result line,
and the refusal to run without a card.

    python -m pytest portbench/tests -p no:randomly -n 0
"""
import json
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from portbench.harness import bench, spec
from portbench.harness.trace import ITERATION, summarize
from portbench.harness.window import run_window

ROOT = Path(__file__).resolve().parents[2]
TINY = dict(batch=4, steps=3, check_rows=3, tape_pool=2, warmup_iterations=1, check_iterations=1,
            trace_iterations=2)
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _bench():
    return spec.load_benchmark(ROOT)


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_cells_found_by_name(cell):
    c = spec.load_cell(cell, ROOT)
    assert c.config["name"] == next(w["config"] for w in _bench()["workloads"] if w["name"] == cell)
    assert hasattr(c.driver(), "Driver")
    assert c.limits and c.end_to_end and c.per_layer
    assert "setup_s" in {m["name"] for m in c.end_to_end}


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_each_metric_has_its_reader(kind):
    for entry in _bench()[kind]:
        mod = spec.load_module(ROOT / "portbench" / "metrics" / f"{entry['name']}.py", "m")
        assert mod.UNIT == entry["unit"] and callable(mod.read)
        if kind == "per_layer":
            assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])


def test_run_py_names_no_cell_config_or_metric():
    text = (ROOT / "portbench" / "run.py").read_text() + (ROOT / "portbench" / "harness" / "bench.py").read_text()
    b = _bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert not [n for n in names if re.search(rf"(?<![\w.]){re.escape(n)}(?![\w.])", text)]


def _dry(cell, root=ROOT, seconds=0.3, trace=False, **traffic):
    return bench.run(cell, 2**31 + 77, seconds, trace, time.perf_counter(), root, device="cpu",
                     traffic={**TINY, **traffic}, chip_check=False)


def test_a_cell_added_as_new_files_runs(tmp_path):
    """A copy of the checkout's benchmark gains a traffic mix, a cell, a
    metric and their entries in BENCHMARK.json, all new files or new
    entries, and the harness runs the cell through its dry path."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    b = _bench()
    (tmp_path / "portbench" / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"driver": "rollout", "grad": False, "batch": 4, "steps": 2, "tau_scale": 0.2,
         "tape_pool": 1, "warmup_iterations": 1, "check_iterations": 1, "check_rows": 2,
         "trace_iterations": 1}))
    (tmp_path / "portbench" / "workloads" / "dummy.cell.json").write_text(json.dumps(
        {"config": "half_cheetah", "traffic": "dummy_mix", "chips": 1,
         "limits": {"state_err_median": 0.0}}))
    (tmp_path / "portbench" / "metrics" / "dummy_count.py").write_text(
        'UNIT = "iterations"\n\n\ndef read(ctx):\n    return ctx.window.completed\n')
    b["workloads"].append({"name": "dummy.cell", "config": "half_cheetah", "traffic": "dummy_mix",
                           "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "dummy_count", "unit": "iterations", "better": "higher",
                            "bound": 0.1, "source": "host_clock", "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code, result = bench.run("dummy.cell", 3, 0.2, False, time.perf_counter(), tmp_path,
                             device="cpu", chip_check=False)
    assert code == 0 and result["correct"]
    assert result["metrics"]["dummy_count"]["value"] == result["attempted"] >= 1
    assert set(result["metrics"]) == {"dummy_count", "setup_s"}


def test_window_rate_and_tail_count_a_stall():
    """Nine iterations of 0.1 s and one stall of 1.0 s: the rate is all the
    work over all of the window's 1.9 s, and the 90th percentile sees the
    stall."""
    t = [0.0]
    durations = [0.1] * 5 + [1.0] + [0.1] * 4

    def iterate(i):
        t[0] += durations[i]

    w = run_window(iterate, seconds=1.85, clock=lambda: t[0])
    assert w.completed == w.attempted == 10
    assert w.seconds == pytest.approx(1.9)
    assert w.rate(100) == pytest.approx(1000 / 1.9)
    assert w.percentile_ms(90) == pytest.approx(190.0)  # inclusive: 0.1 + 0.9 (1.0 - 0.1)
    assert w.percentile_ms(50) == pytest.approx(100.0)


def test_window_runs_its_last_iteration_to_its_end():
    t = [0.0]

    def iterate(i):
        t[0] += 0.4

    w = run_window(iterate, seconds=1.0, clock=lambda: t[0])
    assert w.completed == 3 and w.seconds == pytest.approx(1.2)


def _synthetic_trace():
    """Two iterations of 10 ms (from 0 and 10,000 us): kernel 1 busy 3 ms and
    1 ms in the first, a copy of 2 ms in the second, a host op covering the
    gaps."""
    ev = [{"name": ITERATION, "cat": "user_annotation", "ph": "X", "ts": 0, "dur": 10_000},
          {"name": ITERATION, "cat": "user_annotation", "ph": "X", "ts": 10_000, "dur": 10_000},
          {"name": "void fused_step_kernel<float>(int)", "cat": "kernel", "ph": "X", "ts": 1_000,
           "dur": 3_000},
          {"name": "void fused_step_kernel<float>(int)", "cat": "kernel", "ph": "X", "ts": 6_000,
           "dur": 1_000},
          {"name": "Memcpy DtoD", "cat": "gpu_memcpy", "ph": "X", "ts": 12_000, "dur": 2_000},
          {"name": "aten::add", "cat": "cpu_op", "ph": "X", "ts": 14_000, "dur": 6_000},
          {"name": "outside", "cat": "kernel", "ph": "X", "ts": 30_000, "dur": 5_000}]
    return ev


def test_idle_share_and_roofline_from_a_trace():
    s = summarize(_synthetic_trace())
    assert s.window_s == pytest.approx(0.02)
    assert s.busy_s == pytest.approx(0.006)
    assert s.kernel_n == {"void fused_step_kernel<float>(int)": 2}
    assert s.device_ops[0] == ["void fused_step_kernel<float>(int)", pytest.approx(0.004)]
    assert dict(s.idle_gaps)["aten::add"] == pytest.approx(0.006)
    assert dict(s.idle_gaps)[ITERATION] == pytest.approx(0.008)
    ctx = types.SimpleNamespace(
        trace=s, grad=False, env_steps=1000, traffic={"steps": 2},
        window=types.SimpleNamespace(completed=2),
        config={"work": {"fused_step_kernel": {"ops": 670, "bytes": 67}},
                "peaks": {"ops_per_s": 67e12, "bytes_per_s": 3.35e12}})
    metric = lambda name: spec.load_module(ROOT / "portbench" / "metrics" / f"{name}.py", "m")  # noqa: E731
    assert metric("device_idle_pct.rollout").read(ctx) == pytest.approx(70.0)
    assert metric("device_idle_pct.bptt").read(ctx) is None
    # 2000 env-steps x max(67 B / 3.35 TB/s, 670 / 67 TFLOP/s) = 4e-8 s over 4e-3 s of kernel 1
    assert metric("step_kernel_roofline_pct").read(ctx) == pytest.approx(1e-3)
    assert metric("vjp_kernel_roofline_pct").read(ctx) is None  # no such kernel, no count


@pytest.mark.parametrize("cell", ["cheetah.bptt", "cheetah.rollout"])
def test_the_last_line_has_exactly_its_keys(cell):
    code, result = _dry(cell)
    assert code == 0 and result["correct"]
    assert list(result) == LINE_KEYS + ["checks"]
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"] for m in _bench()["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == want


def test_the_traced_line_has_its_breakdown(monkeypatch):
    """The traced path with a CPU-only profiler standing in for the card's
    trace: the line gains `breakdown`, busy_s and window_s."""
    import contextlib

    @contextlib.contextmanager
    def cpu_trace():
        out = {}
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            yield out
        out["events"] = json.loads(json.dumps(_events(prof)))

    def _events(prof):
        return [{"name": e.name, "cat": "user_annotation" if e.name == ITERATION else "cpu_op",
                 "ph": "X", "ts": e.time_range.start, "dur": e.time_range.elapsed_us()}
                for e in prof.events()]

    monkeypatch.setattr(bench, "device_trace", cpu_trace)
    code, result = _dry("cheetah.rollout", trace=True)
    assert code == 0
    assert list(result) == LINE_KEYS + ["breakdown", "checks"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0 and result["device"]["busy_s"] == 0
    assert set(result["metrics"]) <= {"device_idle_pct.rollout", "step_kernel_roofline_pct"}


def test_no_card_no_result():
    """Without a CUDA device the run exits non-zero and prints no result
    line; it never falls back to the CPU."""
    assert not torch.cuda.is_available()
    assert bench.run("cheetah.rollout", 1, 1.0, False, time.perf_counter(), ROOT) == (3, None)
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          "cheetah.rollout", "--seed", str(2**31 + 5), "--seconds", "1", "--trace",
                          "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert not re.search(r"^\{", out.stdout, re.M)
    assert "CUDA device" in out.stderr
