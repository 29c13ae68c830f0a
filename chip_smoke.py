#!/usr/bin/env python3
"""Drive the torch port (diffdart_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits nonzero, and nothing
falls back to the CPU or to the plain version:
  1. device   -- the card's name and power limit (nvidia-smi), torch/CUDA.
  2. build    -- nvcc builds ops/csrc/fused_step.cu from this checkout.
  3. f64      -- half-cheetah, B = 4096: 20 steps of kernel vs plain
                 version, re-synced to the plain version after each step;
                 q atol 1e-8, v atol 1e-7.
  4. f32      -- one step from the same inputs in float32: no non-finite
                 output, and >= 99% of envs within q 1e-4, v 5e-2 (the
                 Woodbury polish amplifies rounding by ~eps/cfm, ~1e-1 at
                 cfm = 1e-6 in float32, so rare active-set flips are allowed).
  5. main     -- rollout_fast on the half-cheetah, B = 4096, T = 50,
                 tau = 0.1 N(0,1), float32 (the benchmark config of the JAX
                 package's bench.py): the launch count over that run must be
                 T; the final state finite with a plausible torso height.
                 Then the kernel, the plain version and the rollout are
                 timed with CUDA events.
  6. reference -- the same rollout in float64 at B = 256 through the kernel
                 and through the plain version: >= 99% of envs within
                 q 1e-6, v 1e-4 at the end of the 50 steps.
Then one JSON line with the kernel's numbers, the card line, and the
result line {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
B, T = 4096, 50


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps):
    """Mean device time of fn() in ms over `reps` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


_COUNTED = {
    "add", "radd", "sub", "rsub", "mul", "rmul", "truediv", "rtruediv", "div", "neg",
    "maximum", "minimum", "abs", "sqrt", "rsqrt", "sin", "cos", "where", "gt", "ge", "lt",
    "le", "eq", "ne", "logical_and", "logical_or", "logical_not", "invert", "isfinite",
}


def ops_per_env_step(model_cpu, q, v, tau):
    """Elementwise operations the plain version performs per env in one
    forward step (structural zeros folded away, as the work the step needs),
    counted on the CPU at B = 1."""
    from torch.overrides import TorchFunctionMode

    from diffdart_tpu_torch.sim.tilestep import build_tile_step

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "").strip("_") in _COUNTED:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    step = build_tile_step(model_cpu)
    with torch.no_grad(), Count():
        step(q, v, tau)
    return Count.n


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from diffdart_tpu_torch.dynamics.model import State
    from diffdart_tpu_torch.models import cheetah_init_q, half_cheetah
    from diffdart_tpu_torch.ops import fused_step as fs
    from diffdart_tpu_torch.sim.fast import rollout_fast

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device ----
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} | CUDA {torch.version.cuda} | {kind}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib = fs._load("cuda")
    ptx = [ln.strip() for ln in lib.build_log.splitlines()
           if "registers" in ln or "spill" in ln or "stack frame" in ln]
    print(f"[build] fused_step.cu: nvcc {lib.build_seconds:.1f} s, load {time.perf_counter() - t0:.1f} s"
          f" | ptxas: {' / '.join(ptx)}")

    rng = np.random.RandomState(0)
    m64 = half_cheetah(dt=2e-3, dtype=torch.float64, device="cuda")
    q0 = cheetah_init_q(m64).cpu().numpy()
    q_np = np.tile(q0, (B, 1)) + 0.02 * rng.randn(B, m64.nq)
    v_np = 0.2 * rng.randn(B, m64.nv)
    tau_np = 0.5 * rng.randn(B, m64.nv)

    def soa(x, dtype):
        return torch.tensor(np.ascontiguousarray(x.T), dtype=dtype, device="cuda")

    # ---- 3. float64 parity, 20 re-synced steps ----
    step64 = fs.build_fused_step(m64)
    q, v, tau = soa(q_np, torch.float64), soa(v_np, torch.float64), soa(tau_np, torch.float64)
    eq = ev = 0.0
    with torch.no_grad():
        for _ in range(20):
            qk, vk = step64(q, v, tau)
            qp, vp = step64.plain(q, v, tau)
            torch.cuda.synchronize()
            eq = max(eq, (qk - qp).abs().max().item())
            ev = max(ev, (vk - vp).abs().max().item())
            q, v = qp, vp
    print(f"[f64] 20 re-synced steps at B={B}: max |dq| {eq:.3e} (tol 1e-8), max |dv| {ev:.3e} (tol 1e-7)")
    check(eq <= 1e-8 and ev <= 1e-7, "float64 kernel disagrees with the plain version")

    # ---- 4. float32 parity, one step ----
    m32 = half_cheetah(dt=2e-3, dtype=torch.float32, device="cuda")
    step32 = fs.build_fused_step(m32)
    q, v, tau = soa(q_np, torch.float32), soa(v_np, torch.float32), soa(tau_np, torch.float32)
    with torch.no_grad():
        qk, vk = step32(q, v, tau)
        qp, vp = step32.plain(q, v, tau)
    torch.cuda.synchronize()
    dq, dv = (qk - qp).abs().amax(0), (vk - vp).abs().amax(0)
    within = ((dq <= 1e-4) & (dv <= 5e-2)).float().mean().item()
    f32_err = max(dq.max().item(), dv.max().item())
    print(f"[f32] one step at B={B}: |dq| max {dq.max().item():.3e} p99 {dq.quantile(0.99).item():.3e}, "
          f"|dv| max {dv.max().item():.3e} p99 {dv.quantile(0.99).item():.3e}; "
          f"{100 * within:.2f}% of envs within q 1e-4, v 5e-2")
    check(bool(torch.isfinite(qk).all() and torch.isfinite(vk).all()), "non-finite float32 output")
    check(within >= 0.99, "float32 kernel disagrees with the plain version on > 1% of envs")

    # ---- 5. main path: rollout_fast, B = 4096, T = 50, float32 ----
    q_main = cheetah_init_q(m32).repeat(B, 1)
    taus = torch.tensor(0.1 * np.random.RandomState(1).randn(T, B, m32.nv), dtype=torch.float32,
                        device="cuda")
    state = State(q=q_main, v=torch.zeros(B, m32.nv, device="cuda"), t=torch.zeros(B, device="cuda"))
    with torch.no_grad():
        fs.KERNEL.launches = 0
        final = rollout_fast(m32, state, taus)
        torch.cuda.synchronize()
        launches = fs.KERNEL.launches
    z = final.q[:, 0]
    print(f"[main] rollout_fast B={B} T={T} f32: {launches} kernel launches; final torso z "
          f"min {z.min().item():.4f} max {z.max().item():.4f}; finite "
          f"{bool(torch.isfinite(final.q).all() and torch.isfinite(final.v).all())}")
    check(launches == T, f"expected {T} kernel launches on the main path, got {launches}")
    check(tuple(final.q.shape) == (B, m32.nq) and tuple(final.v.shape) == (B, m32.nv), "bad shapes")
    check(bool(torch.isfinite(final.q).all() and torch.isfinite(final.v).all()), "non-finite final state")
    check(bool(((z > 0.0) & (z < 1.0)).all()), "implausible torso height")

    with torch.no_grad():
        qs, vs, ts = fs.to_soa(q_main), torch.zeros(m32.nv, B, device="cuda"), taus[0].T.contiguous()
        kernel_ms = cuda_ms(lambda: step32(qs, vs, ts), reps=50)
        plain_ms = cuda_ms(lambda: step32.plain(qs, vs, ts), reps=3)
        roll_ms = cuda_ms(lambda: rollout_fast(m32, state, taus), reps=3)
    sps = B * T / (roll_ms * 1e-3)
    print(f"[main] timing on {card}: kernel {kernel_ms:.4f} ms/step, rollout {roll_ms:.3f} ms "
          f"= {roll_ms / T:.4f} ms/step = {sps:.6g} env-steps/s forward; "
          f"plain version {plain_ms:.2f} ms/step (context only)")

    # ---- 6. reference check: float64 rollout, kernel vs plain version ----
    Br = 256
    st64 = State(q=cheetah_init_q(m64).repeat(Br, 1), v=torch.zeros(Br, m64.nv, dtype=torch.float64, device="cuda"))
    taus64 = taus[:, :Br].double()
    with torch.no_grad():
        ker = rollout_fast(m64, st64, taus64)
        qp, vp = fs.to_soa(st64.q), fs.to_soa(st64.v)
        for t in range(T):
            qp, vp = step64.plain(qp, vp, taus64[t].T.contiguous())
    eq_r = (ker.q - qp.T).abs().amax(1)
    ev_r = (ker.v - vp.T).abs().amax(1)
    frac = ((eq_r <= 1e-6) & (ev_r <= 1e-4)).double().mean().item()
    print(f"[reference] f64 rollout B={Br} T={T}: max |dq| {eq_r.max().item():.3e}, "
          f"max |dv| {ev_r.max().item():.3e}; {100 * frac:.2f}% of envs within q 1e-6, v 1e-4")
    check(frac >= 0.99, "float64 rollout through the kernel disagrees with the plain version")

    # ---- kernel line ----
    m_cpu = half_cheetah(dt=2e-3, dtype=torch.float32, device="cpu")
    one = [x[:, :1].cpu() for x in (qs, vs, ts)]
    ops = ops_per_env_step(m_cpu, *one)
    di, df = fs.pack_descriptor(m32)
    nbytes = (2 * m32.nq + 3 * m32.nv) * 4 * B + di.nbytes + df.size * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops * B / F32_OPS_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    print(f"[bound] {ops} ops/env-step x {B} envs, {nbytes} bytes: bytes {1e3 * t_bytes:.3e} ms, "
          f"ops {1e3 * t_ops:.3e} ms")
    print(json.dumps({"kernels": [{
        "name": "fused_step",
        "route": "cuda",
        "source": "diffdart_tpu_torch/ops/csrc/fused_step.cu",
        "replaces": "diffdart_tpu/ops/pallas_step.py:55",
        "launches": launches,
        "max_abs_err": f32_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
