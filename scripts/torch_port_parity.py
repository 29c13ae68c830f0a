"""How closely the torch port (diffdart_tpu_torch) follows the JAX package on
the CPU, and how far float32 lies from float64 in either. Prints one line per
comparison; takes a few minutes.

    JAX_PLATFORMS=cpu python scripts/torch_port_parity.py

1. jump_worm(n_links=2), B = 16, 20 steps re-synced to JAX after each: the
   port's plain fused step against the eager and the jitted JAX tile step.
2. jump_worm(n_links=2), B = 1024, one step: the port's fused step against
   the Pallas `_fwd_kernel` in interpret mode.
3. half_cheetah, B = 64, one step from chip_smoke.py's inputs (seed 0): float32
   against float64, in the port and in the eager JAX tile step.
4. half_cheetah, B = 16, one step: the VJP of the eager JAX tile step
   (jax.vjp) against the port's plain version under autograd and against
   the host build of the port's VJP kernel (ops/_build.py kind 'host').
5. jump_worm(n_links=2), B = 1024, one step: the VJP kernel's host build
   against the Pallas `_bwd_kernel` in interpret mode; at the envs where
   they differ, the eager JAX tile step's VJP and the port's plain autograd.
6. every model of tests/test_torch_cuda.py::KERNEL_MODELS, B = 64, float64:
   the plain version's reverse-mode VJP (autograd), its forward-mode VJP
   (ops/vjp_check.py::forward_mode_vjp) and the VJP kernel's host build,
   pairwise, and the share of envs within rtol VJP_RTOL plus atol 1e-10 or
   VJP_ATOL times each array's largest magnitude.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
jax.config.update("jax_enable_x64", True)

from diffdart_tpu.models import half_cheetah as jax_half_cheetah  # noqa: E402
from diffdart_tpu.models import jump_worm as jax_jump_worm  # noqa: E402
from diffdart_tpu.ops.pallas_step import build_pallas_step, from_tiles, to_tiles  # noqa: E402
from diffdart_tpu.sim.tilestep import build_tile_step as jax_build_tile_step  # noqa: E402
from diffdart_tpu_torch.models import cheetah_init_q, half_cheetah, jump_worm  # noqa: E402
from diffdart_tpu_torch.ops import fused_step as fs  # noqa: E402
from diffdart_tpu_torch.ops import vjp_check as vc  # noqa: E402
from diffdart_tpu_torch.ops.fused_step import host_kernel_vjp  # noqa: E402
from diffdart_tpu_torch.sim.tilestep import build_tile_step  # noqa: E402
from test_torch_cuda import KERNEL_MODELS, WORM_Q0, inputs  # noqa: E402


def tiles(x, dtype=jnp.float64):
    """(B, k) numpy -> k jnp tiles of shape (8, B // 8)."""
    t = jnp.asarray(x.T.reshape(x.shape[1], 8, -1), dtype)
    return tuple(t[i] for i in range(x.shape[1]))


def untiles(xs):
    return np.stack([np.asarray(x, np.float64).reshape(-1) for x in xs], axis=1)


def soa(x, dtype=torch.float64):
    return torch.tensor(np.ascontiguousarray(x.T), dtype=dtype)


def worm_resynced():
    jm = jax_jump_worm(dt=2e-3, n_links=2).replace(lcp_pivot_iters=0)
    tm = jump_worm(dt=2e-3, n_links=2, dtype=torch.float64, device="cpu")
    rng = np.random.RandomState(0)
    B = 16
    q = np.tile(WORM_Q0, (B, 1)) + 0.05 * rng.randn(B, tm.nq)
    v, tau = 0.3 * rng.randn(B, tm.nv), 0.5 * rng.randn(B, tm.nv)
    eager = jax_build_tile_step(jm, output="tiles")
    steps = {"eager": eager, "jitted": jax.jit(eager)}
    port = fs.build_fused_step(tm)
    err = {k: [0.0, 0.0] for k in steps}
    for _ in range(20):
        with torch.no_grad():
            qt, vt = (x.T.numpy() for x in port(soa(q), soa(v), soa(tau)))
        outs = {k: [untiles(x) for x in f(tiles(q), tiles(v), tiles(tau))] for k, f in steps.items()}
        for k, (qj, vj) in outs.items():
            err[k][0] = max(err[k][0], np.abs(qt - qj).max())
            err[k][1] = max(err[k][1], np.abs(vt - vj).max())
        q, v = outs["eager"]
    for k, (eq, ev) in err.items():
        print(f"[worm B={B}, 20 re-synced steps] port vs {k} JAX tile step: "
              f"max |dq| {eq:.3e}, max |dv| {ev:.3e}")


def worm_pallas():
    jm = jax_jump_worm(dt=2e-3, n_links=2).replace(lcp_pivot_iters=0)
    tm = jump_worm(dt=2e-3, n_links=2, dtype=torch.float64, device="cpu")
    rng = np.random.RandomState(1)
    B = 1024
    q = np.tile(WORM_Q0, (B, 1)) + 0.02 * rng.randn(B, tm.nq)
    v, tau = 0.2 * rng.randn(B, tm.nv), 0.5 * rng.randn(B, tm.nv)
    qj, vj = build_pallas_step(jm, interpret=True)(*(to_tiles(jnp.asarray(x)) for x in (q, v, tau)))
    qj, vj = np.asarray(from_tiles(qj)), np.asarray(from_tiles(vj))
    with torch.no_grad():
        qt, vt = (x.T.numpy() for x in fs.build_fused_step(tm)(soa(q), soa(v), soa(tau)))
    dv = np.abs(vt - vj)
    at = np.unravel_index(dv.argmax(), dv.shape)
    print(f"[worm B={B}, one step] port vs Pallas _fwd_kernel (interpret): max |dq| "
          f"{np.abs(qt - qj).max():.3e}, max |dv| {dv.max():.3e} at |v| = {abs(vj[at]):.3f}; "
          f"{int((dv > 1e-7).sum())} of {dv.size} v values beyond 1e-7")


def cheetah_f32_floor():
    B = 64
    m64 = half_cheetah(dt=2e-3, dtype=torch.float64, device="cpu")
    m32 = half_cheetah(dt=2e-3, dtype=torch.float32, device="cpu")
    rng = np.random.RandomState(0)
    q = np.tile(cheetah_init_q(m64).numpy(), (B, 1)) + 0.02 * rng.randn(B, m64.nq)
    v, tau = 0.2 * rng.randn(B, m64.nv), 0.5 * rng.randn(B, m64.nv)
    with torch.no_grad():
        pq64, pv64 = (x.T.numpy() for x in build_tile_step(m64)(soa(q), soa(v), soa(tau)))
        pq32, pv32 = (x.T.double().numpy() for x in build_tile_step(m32)(
            *(soa(x, torch.float32) for x in (q, v, tau))))
    jstep = jax_build_tile_step(jax_half_cheetah(dt=2e-3).replace(lcp_pivot_iters=0), output="tiles")
    jq64, jv64 = (untiles(x) for x in jstep(tiles(q), tiles(v), tiles(tau)))
    jq32, jv32 = (untiles(x) for x in jstep(*(tiles(x, jnp.float32) for x in (q, v, tau))))

    def line(name, qa, va, qb, vb):
        dq, dv = np.abs(qa - qb).max(1), np.abs(va - vb).max(1)
        within = np.mean((dq <= 1e-4) & (dv <= 5e-2))
        print(f"[half_cheetah B={B}, one step] {name}: max |dq| {dq.max():.3e}, max |dv| "
              f"{dv.max():.3e}, median env |dv| {np.median(dv):.3e}; "
              f"{100 * within:.2f}% of envs within q 1e-4, v 5e-2")

    line("port f64 vs JAX f64", pq64, pv64, jq64, jv64)
    line("port f32 vs port f64", pq32, pv32, pq64, pv64)
    line("JAX f32 vs JAX f64", jq32, jv32, jq64, jv64)
    line("port f32 vs JAX f32", pq32, pv32, jq32, jv32)


def cheetah_vjp():
    B = 16
    m = half_cheetah(dt=2e-3, dtype=torch.float64, device="cpu")
    rng = np.random.RandomState(0)
    q = np.tile(cheetah_init_q(m).numpy(), (B, 1)) + 0.02 * rng.randn(B, m.nq)
    v, tau = 0.2 * rng.randn(B, m.nv), 0.5 * rng.randn(B, m.nv)
    gq, gv = rng.randn(B, m.nq), rng.randn(B, m.nv)
    jstep = jax_build_tile_step(jax_half_cheetah(dt=2e-3).replace(lcp_pivot_iters=0), output="tiles")
    _, vjp = jax.vjp(jstep, tiles(q), tiles(v), tiles(tau))
    want = [untiles(x) for x in vjp((tiles(gq), tiles(gv)))]
    xs = [soa(x).requires_grad_(True) for x in (q, v, tau)]
    plain = [x.T.numpy() for x in torch.autograd.grad(build_tile_step(m)(*xs), xs, (soa(gq), soa(gv)))]
    kernel = host_kernel_vjp(m, *(soa(x) for x in (q, v, tau, gq, gv)))[0]
    kernel = [x.T.numpy() for x in kernel]
    for name, got in (("port plain autograd", plain), ("port VJP kernel (host build)", kernel)):
        errs = ", ".join(f"d{k} {np.abs(a - b).max():.3e} of {np.abs(b).max():.3e}"
                         for k, a, b in zip(("q", "v", "tau"), got, want))
        print(f"[half_cheetah B={B}, one step] VJP, {name} vs eager JAX: max |error| {errs}")


def worm_pallas_vjp():
    jm = jax_jump_worm(dt=2e-3, n_links=2).replace(lcp_pivot_iters=0)
    tm = jump_worm(dt=2e-3, n_links=2, dtype=torch.float64, device="cpu")
    B = 1024
    q, v, tau = inputs(WORM_Q0, tm.nq, tm.nv, B=B, seed=1)
    rng = np.random.RandomState(11)
    gq, gv = rng.randn(B, tm.nq), rng.randn(B, tm.nv)
    _, vjp = jax.vjp(build_pallas_step(jm, interpret=True), *(to_tiles(jnp.asarray(x)) for x in (q, v, tau)))
    pallas = [np.asarray(from_tiles(x)) for x in vjp((to_tiles(jnp.asarray(gq)), to_tiles(jnp.asarray(gv))))]
    _, vjp = jax.vjp(jax_build_tile_step(jm, output="tiles"), tiles(q), tiles(v), tiles(tau))
    eager = [untiles(x) for x in vjp((tiles(gq), tiles(gv)))]
    xs = [soa(x).requires_grad_(True) for x in (q, v, tau)]
    plain = [x.T.numpy() for x in torch.autograd.grad(build_tile_step(tm)(*xs), xs, (soa(gq), soa(gv)))]
    kernel = [x.T.numpy() for x in host_kernel_vjp(tm, *(soa(x) for x in (q, v, tau, gq, gv)))[0]]
    bad = np.zeros(B, bool)
    for a, b in zip(kernel, pallas):
        bad |= (np.abs(a - b) > vc.VJP_RTOL * np.abs(b) + vc.VJP_ATOL * np.abs(b).max()).any(1)
    print(f"[worm B={B}, one step] VJP kernel (host build) vs Pallas _bwd_kernel (interpret): "
          f"{B - bad.sum()} of {B} envs within rtol {vc.VJP_RTOL:g} + atol {vc.VJP_ATOL:g} max|g|")

    def rel(x, e):
        return max(np.abs(a[e] - k[e]).max() / np.abs(k[e]).max() for a, k in zip(x, kernel))

    for e in np.nonzero(bad)[0]:
        print(f"    env {e}: relative difference to the kernel: Pallas interpret {rel(pallas, e):.3e}, "
              f"eager JAX tile step {rel(eager, e):.3e}, port plain autograd {rel(plain, e):.3e}")


def vjp_modes():
    B = 64
    for name in sorted(KERNEL_MODELS):
        m, q0 = KERNEL_MODELS[name](torch.float64, "cpu")
        q, v, tau = (soa(x) for x in inputs(q0, m.nq, m.nv, B=B, seed=2))
        rng = np.random.RandomState(102)
        gq, gv = torch.tensor(rng.randn(m.nq, B)), torch.tensor(rng.randn(m.nv, B))
        step = build_tile_step(m)
        xs = [x.clone().requires_grad_(True) for x in (q, v, tau)]
        rev = torch.autograd.grad(step(*xs), xs, (gq, gv))
        fwd = vc.forward_mode_vjp(step, q, v, tau, gq, gv)
        ker = host_kernel_vjp(m, q, v, tau, gq, gv)[0]

        def diff(a, b):
            return max(((x - y).abs().max() / y.abs().max()).item() for x, y in zip(a, b))

        def within(atol):
            return 100 * vc.envs_within(ker, rev, atol=atol)

        print(f"[{name} B={B}, one step] VJP max |difference| / max|g|: torch forward vs reverse mode "
              f"{diff(fwd, rev):.3e}, kernel vs torch forward {diff(ker, fwd):.3e}, kernel vs reverse "
              f"{diff(ker, rev):.3e}; kernel vs reverse, envs within atol 1e-10 max|g| {within(1e-10):.2f}%, "
              f"{vc.VJP_ATOL:g} max|g| {within(vc.VJP_ATOL):.2f}%")


if __name__ == "__main__":
    worm_resynced()
    worm_pallas()
    cheetah_f32_floor()
    cheetah_vjp()
    worm_pallas_vjp()
    vjp_modes()
