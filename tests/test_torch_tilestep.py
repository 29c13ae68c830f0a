"""Plain PyTorch fused step (diffdart_tpu_torch/sim/tilestep.py) against the
JAX tile step (diffdart_tpu/sim/tilestep.py): per-step parity on the worm
and the half-cheetah, and BPTT gradient parity on the worm.

Same inputs from a numpy seed go to both packages; the comparison is in
float64. Per-step runs are re-synced to the JAX state after every step
(contact dynamics are chaotic, so free-running trajectories would amplify
summation-order rounding). Tolerances are those of the JAX package's own
Pallas-vs-tile-step check (tests/test_tilestep.py:386-387, 410): both sides
run the same algebra, so they agree to rounding amplified by about eps/cfm
in the Woodbury polish.

The JAX steps run eagerly (un-jitted): the plain PyTorch version then
agrees with them to 1e-15. XLA:CPU's jitted program rounds differently: on
the worm below it differs from its own eager evaluation by up to 1.2e-7 in
v after one step (on velocities of up to 22; the eps/cfm amplification of
its reassociated sums). The check against the jitted worm step therefore
allows v atol 2e-7. Jitting the half-cheetah's unrolled
trace, or the worm's 5-step gradient, takes minutes on the CPU, so those
run eagerly only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.models import half_cheetah as jax_half_cheetah
from diffdart_tpu.models import jump_worm as jax_jump_worm
from diffdart_tpu.sim.tilestep import build_tile_step as jax_build_tile_step
from diffdart_tpu_torch.models import half_cheetah, jump_worm
from diffdart_tpu_torch.sim.tilestep import TileStepUnsupported, build_tile_step

B = 16
S, L = 2, 8  # JAX tile shape: B = S * L


def _tiles(x):
    """(B, k) numpy -> tuple of k (S, L) jnp tiles."""
    t = jnp.asarray(x.T.reshape(x.shape[1], S, L))
    return tuple(t[i] for i in range(x.shape[1]))


def _untiles(xs):
    return np.stack([np.asarray(x).reshape(B) for x in xs], axis=1)


def _soa(x):
    """(B, k) numpy -> tuple of k (B,) float64 tensors."""
    return tuple(torch.tensor(np.ascontiguousarray(x[:, i])) for i in range(x.shape[1]))


def _unsoa(xs):
    return np.stack([x.detach().numpy() for x in xs], axis=1)


def _worm_pair():
    jm = jax_jump_worm(dt=2e-3, n_links=2).replace(lcp_pivot_iters=0)
    tm = jump_worm(dt=2e-3, n_links=2, dtype=torch.float64, device="cpu")
    return jm, tm


def _worm_batch(nq, nv, seed):
    rng = np.random.RandomState(seed)
    q0 = np.array([0.06, 0.0, 0.25, -0.5])[:nq]
    q = np.tile(q0, (B, 1)) + 0.05 * rng.randn(B, nq)
    return q, 0.3 * rng.randn(B, nv), 0.5 * rng.randn(B, nv)


def _check_resynced(jstep, tstep, q, v, tau, steps, v_atol=1e-7):
    taut, taus = _tiles(tau), _soa(tau)
    for it in range(steps):
        qj, vj = jstep(_tiles(q), _tiles(v), taut)
        qj, vj = _untiles(qj), _untiles(vj)
        with torch.no_grad():
            qt, vt = tstep(_soa(q), _soa(v), taus)
        np.testing.assert_allclose(_unsoa(qt), qj, atol=1e-8, rtol=0, err_msg=f"q at step {it}")
        np.testing.assert_allclose(_unsoa(vt), vj, atol=v_atol, rtol=0, err_msg=f"v at step {it}")
        q, v = qj, vj


def test_worm_matches_jax_tile_step():
    jm, tm = _worm_pair()
    q, v, tau = _worm_batch(tm.nq, tm.nv, seed=0)
    _check_resynced(jax_build_tile_step(jm, output="tiles"), build_tile_step(tm, output="tiles"), q, v, tau, steps=20)


def test_worm_matches_jitted_jax_tile_step():
    jm, tm = _worm_pair()
    q, v, tau = _worm_batch(tm.nq, tm.nv, seed=0)
    _check_resynced(jax.jit(jax_build_tile_step(jm, output="tiles")),
                    build_tile_step(tm, output="tiles"), q, v, tau, steps=20, v_atol=2e-7)


def test_half_cheetah_matches_eager_jax_tile_step():
    jm = jax_half_cheetah(dt=2e-3).replace(lcp_pivot_iters=0)
    tm = half_cheetah(dt=2e-3, dtype=torch.float64, device="cpu")
    rng = np.random.RandomState(1)
    q0 = np.array([0.6, 0.0, 0.0, -0.1, 0.2, -0.1, 0.1, -0.2, 0.1])
    q = np.tile(q0, (B, 1)) + 0.04 * rng.randn(B, tm.nq)
    q[:, 0] -= 0.25  # drop the root so feet and shins touch the floor
    v = 0.4 * rng.randn(B, tm.nv)
    tau = 1.0 * rng.randn(B, tm.nv)
    _check_resynced(jax_build_tile_step(jm, output="tiles"),
                    build_tile_step(tm, output="tiles"), q, v, tau, steps=3)


def test_worm_bptt_gradient_matches_jax():
    """T = 5 BPTT loss; gradient wrt the control tape."""
    jm, tm = _worm_pair()
    q, v, tau = _worm_batch(tm.nq, tm.nv, seed=3)
    T_h = 5
    taus = np.tile(tau[None], (T_h, 1, 1)) * 0.3

    jstep = jax_build_tile_step(jm, output="tiles")

    def loss_jax(taus):
        qc, vc = _tiles(q), _tiles(v)
        for t in range(T_h):
            tt = taus[t].T.reshape(tm.nv, S, L)
            qc, vc = jstep(qc, vc, tuple(tt[i] for i in range(tm.nv)))
        return (sum(jnp.sum(x**2) for x in qc) / (tm.nq * B)
                + sum(jnp.sum(x**2) for x in vc) / (tm.nv * B))

    l_j, g_j = jax.value_and_grad(loss_jax)(jnp.asarray(taus))

    tstep = build_tile_step(tm, output="tiles")
    taus_t = torch.tensor(taus, requires_grad=True)
    qc, vc = _soa(q), _soa(v)
    for t in range(T_h):
        qc, vc = tstep(qc, vc, tuple(taus_t[t, :, i] for i in range(tm.nv)))
    l_t = (sum((x**2).sum() for x in qc) / (tm.nq * B)
           + sum((x**2).sum() for x in vc) / (tm.nv * B))
    l_t.backward()
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-9)
    np.testing.assert_allclose(taus_t.grad.numpy(), np.asarray(g_j), rtol=1e-6, atol=1e-10)


def test_unsupported_models_raise():
    from diffdart_tpu_torch.dynamics.model import GeomType, JointType, ModelBuilder

    b = ModelBuilder(dt=1e-3)
    body = b.add_body(parent=-1, jtype=JointType.UNIVERSAL, axis=(1, 0, 0), axis2=(0, 1, 0))
    b.add_geom(body, GeomType.SPHERE, size=(0.1, 0, 0))
    with pytest.raises(TileStepUnsupported):
        build_tile_step(b.finalize(dtype=torch.float64, device="cpu"))
    jm, tm = _worm_pair()
    with pytest.raises(TileStepUnsupported, match="pair-budget"):
        build_tile_step(tm.replace(pair_budget=3))  # the JAX tile step raises too
    # contact_budget=2 and lcp="xla" raised here until the hybrid LCP was
    # ported; they now run, and match the JAX package's hybrid step (eager,
    # pivot off on both sides; the two solve the LCP in other orders)
    q, v, tau = _worm_batch(tm.nq, tm.nv, seed=0)
    tm0 = tm.replace(lcp_pivot_iters=0)
    for kw, lcp in ((dict(contact_budget=2), "auto"), (dict(), "xla")):
        _check_resynced(jax_build_tile_step(jm.replace(**kw), output="tiles", lcp=lcp),
                        build_tile_step(tm0.replace(**kw), output="tiles", lcp=lcp),
                        q, v, tau, steps=2, v_atol=1e-6)
