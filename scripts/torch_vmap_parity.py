"""How closely the torch port's vmap stack follows the JAX package's, on the
CPU in float64. Prints one line per comparison; takes about two minutes.

    JAX_PLATFORMS=cpu python scripts/torch_vmap_parity.py

1. The vmap step (sim/step.py::step) of every model of
   tests/test_torch_vmap_step.py::STEP_MODELS, B = 8, 4 steps re-synced to
   JAX after each: largest |dq| and |dv| against jit(vmap(step)).
2. The sweeps on tests/test_pallas_lcp.py's generator (B = 16, float64
   values of its float32 problems): the port's _jacobi against the JAX
   _jacobi and against both Pallas kernels in interpret mode; kernel 4
   accumulates its matvec in float32 even for float64 inputs.
3. The low-rank LCP (lambda and its VJP) on the LCPs of
   tests/test_torch_lcp_lowrank.py: largest difference on converged envs,
   relative to the largest magnitude.
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from diffdart_tpu.ops.lcp import _jacobi as jax_jacobi  # noqa: E402
from diffdart_tpu.ops.pallas_lcp import jacobi_sweeps_pallas, jacobi_sweeps_pallas_single  # noqa: E402
from diffdart_tpu_torch.dynamics.model import State  # noqa: E402
from diffdart_tpu_torch.ops.lcp import _jacobi  # noqa: E402
from diffdart_tpu_torch.sim import step as S  # noqa: E402

import test_torch_lcp_lowrank as TL  # noqa: E402
import test_torch_pallas_lcp as TP  # noqa: E402
import test_torch_vmap_step as TS  # noqa: E402
from test_torch_vmap_dynamics import T  # noqa: E402


def step_parity():
    get = TS.step_references()
    for name in TS.STEP_MODELS:
        m, tau, traj = get(name)
        eq = ev = 0.0
        for k in range(TS.STEPS):
            with torch.no_grad():
                s = S.step(m, State(q=T(traj[k][0]), v=T(traj[k][1])), T(tau))
            eq = max(eq, np.abs(s.q.numpy() - traj[k + 1][0]).max())
            ev = max(ev, np.abs(s.v.numpy() - traj[k + 1][1]).max())
        print(f"[step] {name}: {TS.STEPS} re-synced steps, max |dq| {eq:.3e}, max |dv| {ev:.3e} "
              f"(max |v| {np.abs(traj[-1][1]).max():.3e})")


def sweeps():
    A, b, lo, hi, mu, fidx = TP._problems(B=16, seed=0)
    xs = [x.astype(np.float64) for x in (A, b, lo, hi, mu)]
    jx = [jnp.asarray(x) for x in xs]
    fj = jnp.asarray(np.array(fidx), jnp.int32)
    ref = jax.vmap(lambda *a: jax_jacobi(*a, fj, 6))(*jx)
    k3 = jacobi_sweeps_pallas(*jx, fidx, 6, interpret=True)
    k4 = jax.vmap(functools.partial(jacobi_sweeps_pallas_single, fidx=fidx, iters=6, interpret=True))(*jx)
    got = _jacobi(*(T(x) for x in xs), torch.tensor(fidx), 6).numpy()
    for name, want in (("JAX _jacobi", ref), ("kernel 3 interpret", k3), ("kernel 4 interpret", k4)):
        print(f"[sweeps] float64, B = 16, D = 9: port _jacobi vs {name}: max |dlam| "
              f"{np.abs(got - np.asarray(want)).max():.3e} (max |lam| {np.abs(got).max():.3e})")


def lcp():
    get = TL.lcp_references()
    for name in TL.CASES:
        m, x, fidx, lam_j, res_j, g, vjp_j = get(name)
        lam, _ = TL._solve(m, x, fidx, m.lcp_pivot_iters)
        conv = res_j < 1e-8
        xs = TL._port_inputs(x, requires_grad=True)
        cfm = torch.tensor(m.contact_cfm, dtype=torch.float64)
        lam_g = TL.boxed_lcp_lowrank(xs[0], xs[1], cfm, *xs[2:], torch.tensor(fidx), m.contact_iters, 2,
                                     _jacobi, m.lcp_pivot_iters)
        grads = torch.autograd.grad(lam_g, xs, T(g))
        dl = np.abs(lam.numpy() - lam_j)[conv].max()
        rel = max(np.abs(a.numpy() - np.asarray(w))[conv].max() / np.abs(np.asarray(w))[conv].max()
                  for a, w in zip(grads, vjp_j) if np.abs(np.asarray(w))[conv].max() > 0)
        print(f"[lcp] {name}: {conv.sum()} of {len(conv)} envs converged; max |dlam| {dl:.3e} (max "
              f"|lam| {np.abs(lam_j).max():.3e}); VJP max |difference| / max |gradient| {rel:.3e}")


if __name__ == "__main__":
    step_parity()
    sweeps()
    lcp()
