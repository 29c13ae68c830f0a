"""How sensitive hierarchical IK is to its start, in the torch port and in
the JAX package alike, on the CPU in float64. Takes about a minute.

    JAX_PLATFORMS=cpu python scripts/torch_ik_chaos.py

The case is chip_smoke.py's (phase 30): a 6-link chain, B = 64 targets
from seeded random poses, the tip on the first level and link 2 on the
second, solved from q = 0. Each package solves again from a start moved by
1e-15 (a seeded random direction) and prints, after 1, 5, 10, 20 and 80
iterations, the largest |dq| between the two solves, how many envs end
more than 1e-10 apart, and the largest |dq| over the envs where both
levels converged (error < 1e-6) in both solves; then the largest |dq|
between the two packages from the same start.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from diffdart_tpu.models import chain as jax_chain  # noqa: E402
from diffdart_tpu.neural import HierarchicalIK as JHierarchicalIK  # noqa: E402
from diffdart_tpu_torch.dynamics.kinematics import fk  # noqa: E402
from diffdart_tpu_torch.models import chain  # noqa: E402
from diffdart_tpu_torch.neural import HierarchicalIK  # noqa: E402

B = 64
LEVELS = [[(5, (0, 0, 0))], [(2, (0, 0, 0))]]


def spread(qa, ea, qb, eb):
    d = np.abs(qa - qb).max(1)
    both = (ea < 1e-6).all(1) & (eb < 1e-6).all(1)
    worst_conv = d[both].max() if both.any() else float("nan")
    return f"max |dq| {d.max():.3e}, {int((d > 1e-10).sum())} envs > 1e-10; both levels converged in " \
           f"{int(both.sum())} envs, max |dq| there {worst_conv:.3e}"


def main():
    m = chain(n=6, length=0.3, dtype=torch.float64, device="cpu")
    jm = jax_chain(n=6, length=0.3)
    p = fk(m, torch.tensor(0.4 * np.random.RandomState(16).randn(B, 6)))[1]
    targets = [p[:, 5][:, None], p[:, 2][:, None]]
    jt = [jnp.asarray(t.numpy()) for t in targets]
    q0 = torch.zeros(B, 6, dtype=torch.float64)
    q0p = q0 + 1e-15 * torch.tensor(np.random.RandomState(17).randn(B, 6))
    for iters in (1, 5, 10, 20, 80):
        hik = HierarchicalIK(m, LEVELS, iters=iters)
        qa, ea = (x.numpy() for x in hik.solve(targets, q0))
        qb, eb = (x.numpy() for x in hik.solve(targets, q0p))
        jh = JHierarchicalIK(jm, LEVELS, iters=iters)
        js = jax.jit(jax.vmap(lambda t0, t1, q: jh.solve([t0, t1], q)))
        ja, jea = (np.asarray(x) for x in js(*jt, jnp.asarray(q0.numpy())))
        jb, jeb = (np.asarray(x) for x in js(*jt, jnp.asarray(q0p.numpy())))
        print(f"{iters:2d} iterations, start moved by 1e-15: port {spread(qa, ea, qb, eb)} | JAX package "
              f"{spread(ja, jea, jb, jeb)} | port vs JAX from q = 0: max |dq| {np.abs(qa - ja).max():.3e}")


if __name__ == "__main__":
    main()
