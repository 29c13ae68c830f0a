"""The port's utils (diffdart_tpu_torch/utils/) on the CPU.

* Stopwatch, PerformanceLog.report and MetricsLogger against the JAX
  package's classes driven the same way, on one fake clock (time.perf_counter
  and time.time patched for both), so their numbers and lines are equal.
* device_trace around a named_scope of one plain step: the Chrome trace
  file exists and holds the scope by name; the check device_trace runs on
  the card (every kernel launch in the trace has its kernel event), on a
  hand-made trace.
* Checkpoints: a tree of tensors, a State, an Adam state_dict() and a
  generator state round-trips bit for bit (weights_only loading); and a
  resume, 3 Adam steps, save, restore, 2 steps, equals 5 straight steps
  bit for bit on a small CPU BPTT (the cartpole drive of the verify notes).
"""
import itertools
import json
import os
import time

import numpy as np
import pytest
import torch

from diffdart_tpu.utils import profile as jax_profile
from diffdart_tpu_torch.dynamics.model import State
from diffdart_tpu_torch.models import cartpole
from diffdart_tpu_torch.sim import step as S
from diffdart_tpu_torch.utils import (
    MetricsLogger, PerformanceLog, Stopwatch, restore_checkpoint, save_checkpoint)
from diffdart_tpu_torch.utils.profile import device_trace, lost_kernel_events, named_scope

F64 = torch.float64


@pytest.fixture
def fake_clock(monkeypatch):
    """time.perf_counter and time.time as one counter that advances 0.25 s
    per read, restarted by calling the fixture's value."""
    state = {}

    def restart():
        state["it"] = itertools.count()

    def tick():
        return 0.25 * next(state["it"])

    restart()
    monkeypatch.setattr(time, "perf_counter", tick)
    monkeypatch.setattr(time, "time", tick)
    return restart


def _drive_stopwatch(cls):
    sw = cls()
    out = [sw.elapsed_s()]
    sw.stop()
    out.append(sw.elapsed_s())
    out.append(sw.elapsed_s())  # stopped: frozen
    sw.start()
    sw.start()  # running: no-op
    out.append(sw.elapsed_s())
    sw.reset()
    out.append(sw.elapsed_s())
    out.append(cls(start=False).elapsed_s())
    return out


def test_stopwatch_matches_jax(fake_clock):
    got = _drive_stopwatch(Stopwatch)
    fake_clock()
    want = _drive_stopwatch(jax_profile.Stopwatch)
    assert got == want and got[2] == got[1] and got[-2:] == [0.0, 0.0]


def _drive_perflog(cls):
    log = cls()
    for _ in range(2):
        with log.run("rollout") as r:
            with r.run("step"):
                pass
            with r.run("collide"):
                pass
    with log.run("loss"):
        pass
    return log.report()


def test_performance_log_report_matches_jax(fake_clock):
    got = _drive_perflog(PerformanceLog)
    fake_clock()
    want = _drive_perflog(jax_profile.PerformanceLog)
    assert got == want
    assert "rollout: " in got and "x2" in got and "    step: 500.00 ms x2" in got


def test_metrics_logger_lines_match_jax(fake_clock, tmp_path):
    paths = []
    for cls, name in ((MetricsLogger, "port"), (jax_profile.MetricsLogger, "jax")):
        fake_clock()
        paths.append(tmp_path / f"{name}.jsonl")
        log = cls(str(paths[-1]))
        log.log(0, loss=torch.tensor(1.5, dtype=F64), lr=np.float32(0.25), tag="warm")
        log.log(1, loss=0.75)
        log.close()
    got, want = (p.read_text().splitlines() for p in paths)
    assert got == want and len(got) == 2
    assert json.loads(got[0]) == {"step": 0, "time": 0.0, "loss": 1.5, "lr": 0.25, "tag": "warm"}


def test_device_trace_names_the_scope(tmp_path):
    m = cartpole(dt=0.01, dtype=F64, device="cpu")
    s = State(q=torch.tensor([[0.1, 3.0]], dtype=F64), v=torch.zeros(1, 2, dtype=F64))
    with device_trace(str(tmp_path)) as prof:
        with named_scope("cartpole_step"):
            S.step(m, s, torch.zeros(1, 2, dtype=F64))
    assert os.path.dirname(prof.trace_path) == str(tmp_path)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "cartpole_step" for e in events)


def test_lost_kernel_events_finds_launches_without_kernels():
    """The check device_trace runs on the card, on a hand-made trace: three
    runtime launches (one lost its kernel event), a driver launch of its own
    (a Triton-style launch, kept), and a driver launch inside a runtime
    launch on the same thread (the runtime call's own, not counted again)."""
    def api(cat, name, corr, ts, dur, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
                "args": {"correlation": corr}}

    def kernel(corr):
        return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": 100 + corr, "dur": 1,
                "args": {"correlation": corr}}

    events = [api("cuda_runtime", "cudaLaunchKernel", 1, 0, 10),
              api("cuda_driver", "cuLaunchKernel", 9, 2, 5),
              api("cuda_runtime", "cudaLaunchKernel", 2, 20, 10),
              api("cuda_runtime", "cudaLaunchKernelExC", 3, 40, 10),
              api("cuda_driver", "cuLaunchKernel", 4, 60, 5, tid=2),
              api("cuda_runtime", "cudaDeviceSynchronize", 5, 70, 5),
              {"ph": "i", "cat": "cpu_instant_event", "name": "x", "ts": 0},
              kernel(1), kernel(3), kernel(4)]
    n, lost = lost_kernel_events(events)
    assert n == 4 and [e["args"]["correlation"] for e in lost] == [2]
    assert lost_kernel_events(events + [kernel(2)]) == (4, [])


def _tree():
    g = torch.Generator().manual_seed(5)
    torch.rand(3, generator=g)
    p = torch.nn.Parameter(torch.randn(4, 2, dtype=F64, generator=g))
    opt = torch.optim.Adam([p], lr=0.1)
    p.sum().backward()
    opt.step()
    return g, {
        "params": {"w": p.detach().clone(), "b": torch.arange(3, dtype=torch.int64)},
        "state": State(q=torch.randn(2, 3, dtype=F64, generator=g), v=torch.zeros(2, 3), t=None),
        "opt": opt.state_dict(),
        "rng": g.get_state(),
        "step": 7,
        "tags": ["a", 1.5, (torch.ones(2, dtype=torch.float32),)],
    }


def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    elif isinstance(a, State):
        assert isinstance(b, State)
        for k in ("q", "v", "t"):
            _assert_same(getattr(a, k), getattr(b, k))
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


def test_checkpoint_round_trip(tmp_path):
    g, tree = _tree()
    fname = save_checkpoint(str(tmp_path / "ckpt"), tree, step=3)
    assert fname == str(tmp_path / "ckpt" / "step_3.pt") and os.path.isfile(fname)
    _assert_same(tree, restore_checkpoint(fname, like=tree))
    plain = restore_checkpoint(fname)
    assert isinstance(plain["state"], dict) and torch.equal(plain["state"]["q"], tree["state"].q)
    g2 = torch.Generator()
    g2.set_state(plain["rng"])
    assert torch.equal(torch.rand(5, generator=g2), torch.rand(5, generator=g))


def test_checkpoint_file_holds_no_code(tmp_path):
    """restore loads with weights_only: a pickled object that is not a
    tensor or container is refused."""
    fname = str(tmp_path / "evil.pt")
    torch.save({"x": _Opaque()}, fname)
    with pytest.raises(Exception, match="[Ww]eights only"):
        restore_checkpoint(fname)


class _Opaque:
    pass


def _bptt_steps(taus, opt, n):
    m = cartpole(dt=0.01, dtype=F64, device="cpu")
    s0 = State(q=torch.tensor([[0.0, 3.14159]], dtype=F64), v=torch.zeros(1, 2, dtype=F64))
    for _ in range(n):
        opt.zero_grad()
        final = S.rollout_final(m, s0, taus)
        ((final.q**2).sum() + 0.1 * (final.v**2).sum()).backward()
        opt.step()


def test_checkpoint_resume_equals_straight_run(tmp_path):
    def fresh():
        taus = torch.nn.Parameter(torch.zeros(20, 1, 2, dtype=F64))
        return taus, torch.optim.Adam([taus], lr=0.05)

    taus, opt = fresh()
    _bptt_steps(taus, opt, 5)

    taus_a, opt_a = fresh()
    _bptt_steps(taus_a, opt_a, 3)
    fname = save_checkpoint(str(tmp_path / "run.pt"), {"taus": taus_a, "opt": opt_a.state_dict()})
    del taus_a, opt_a
    taus_b, opt_b = fresh()
    ck = restore_checkpoint(fname, like={"taus": taus_b, "opt": opt_b.state_dict()})
    with torch.no_grad():
        taus_b.copy_(ck["taus"])
    opt_b.load_state_dict(ck["opt"])
    _bptt_steps(taus_b, opt_b, 2)
    assert torch.equal(taus_b, taus) and taus.abs().max() > 0
