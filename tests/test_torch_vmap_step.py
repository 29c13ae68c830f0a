"""The torch port's vmap step (sim/step.py, sim/constrained.py,
sim/batched.py, sim/fast.py's fallback) against the JAX package, float64 on
the CPU, the same numpy inputs on both sides.

* Per-step parity, re-synced to the JAX state after every step (contact
  dynamics are chaotic, so free-running trajectories would amplify
  summation-order rounding), on half_cheetah, worm, cube_drop,
  servo_cheetah and free_cube at each model's default solver settings
  (pivot refinement on): q atol 1e-8, v atol 1e-7. The JAX package's own
  tile-vs-vmap check allows q 1e-7, v 1e-5 (tests/test_tilestep.py:82-88);
  here both sides run the same algebra, so they agree to rounding amplified
  by about eps/cfm in the Woodbury polish (measured: v 1.3e-8 on the
  half-cheetah).
* step_batched against the JAX step_batched (the same tolerances).
* The BPTT gradient of rollout_checkpointed (T = 5) against jax.grad of the
  JAX rollout_checkpointed, on envs whose LCP converged at every step
  (natural-map residual below 1e-8, tests/test_tilestep.py:103-126): rtol
  1e-6 plus atol 1e-8 of the largest magnitude (ops/vjp_check.py's limits).
* The cartpole drive of .claude/skills/verify/SKILL.md for three gradient
  steps: loss and gradient against JAX at rtol 1e-9 (no contact, so
  rounding is not amplified).
* rollout_fast's fallback: it warns and its gradient wrt the body masses
  matches jax.grad through the JAX package's fallback (the counterpart of
  tests/test_fast_dispatch.py:36), with the BPTT test's limits and envs.

The pivot refinement is off (lcp_pivot_iters=0) where a test says so: its
while_loop costs XLA:CPU seconds of compile time per program, and
tests/test_torch_lcp_lowrank.py and cube_drop's step parity cover it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.dynamics.model import State as JState
from diffdart_tpu.sim import rollout as jax_rollout
from diffdart_tpu.sim import step as jax_step
from diffdart_tpu.sim.batched import step_batched as jax_step_batched
from diffdart_tpu.sim.step import rollout_checkpointed as jax_rollout_checkpointed
from diffdart_tpu_torch.dynamics.model import State
from diffdart_tpu_torch.ops import pallas_lcp as P
from diffdart_tpu_torch.ops.vjp_check import VJP_ATOL, VJP_RTOL
from diffdart_tpu_torch.sim import step as S
from diffdart_tpu_torch.sim.batched import step_batched
from diffdart_tpu_torch.sim.constrained import solver_diagnostics
from diffdart_tpu_torch.sim.fast import rollout_fast

from test_torch_vmap_dynamics import T, batch, close

STEP_MODELS = ["half_cheetah", "worm", "cube_drop", "servo_cheetah", "free_cube"]
STEPS = 4
# models whose step parity runs without the pivot refinement: its
# while_loop takes XLA:CPU ~5 s more to compile per model, and cube_drop's
# redundant corners (and tests/test_torch_lcp_lowrank.py) exercise it
NO_PIVOT = {"half_cheetah", "servo_cheetah", "free_cube"}


def _jstate(q, v):
    return JState(q=q, v=v, t=jnp.zeros(()))


def step_references():
    """name -> (port model, taus, JAX states along a re-synced trajectory),
    each computed once (scripts/torch_vmap_parity.py uses it too)."""
    cache = {}

    def get(name):
        if name not in cache:
            m, jm, q, v, tau = batch(name, seed=5)
            if name in NO_PIVOT:
                m, jm = m.replace(lcp_pivot_iters=0), jm.replace(lcp_pivot_iters=0)
            f = jax.jit(jax.vmap(lambda q, v, t: jax_step(jm, _jstate(q, v), t)))
            traj = [(q, v)]
            for _ in range(STEPS):
                s = f(*(jnp.asarray(x) for x in (*traj[-1], tau)))
                traj.append((np.asarray(s.q), np.asarray(s.v)))
            cache[name] = (m, tau, traj)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def step_ref():
    return step_references()


@pytest.mark.parametrize("name", STEP_MODELS)
def test_step_matches_jax_resynced(name, step_ref):
    m, tau, traj = step_ref(name)
    for k in range(STEPS):
        with torch.no_grad():
            s = S.step(m, State(q=T(traj[k][0]), v=T(traj[k][1])), T(tau))
        close(s.q, traj[k + 1][0], atol=1e-8, msg=f"q at step {k}")
        close(s.v, traj[k + 1][1], atol=1e-7, msg=f"v at step {k}")


@pytest.mark.parametrize("name", ["half_cheetah"])
def test_step_batched_matches_jax(name):
    m, jm, q, v, tau = batch(name, seed=6)
    want = jax.jit(lambda q, v, t: jax_step_batched(jm, JState(q=q, v=v, t=jnp.zeros(q.shape[0])), t))(
        *(jnp.asarray(x) for x in (q, v, tau)))
    n0 = P.KERNEL.launches
    got = step_batched(m, State(q=T(q), v=T(v), t=torch.zeros(q.shape[0], dtype=torch.float64)), T(tau))
    assert P.KERNEL.launches == n0, "a CPU call launched the kernel"
    close(got.q, want.q, atol=1e-8)
    close(got.v, want.v, atol=1e-7)
    close(got.t, want.t)


def test_step_batched_is_forward_only():
    m, _, q, v, tau = batch("worm", seed=7)
    taus = T(tau).requires_grad_(True)
    out = step_batched(m, State(q=T(q), v=T(v)), taus)
    with pytest.raises(RuntimeError, match="forward only"):
        out.v.sum().backward()
    with torch.no_grad():
        ref = step_batched(m, State(q=T(q), v=T(v)), T(tau))
    close(out.v, ref.v.numpy(), atol=0)


@pytest.fixture(scope="module")
def bptt_ref():
    """Worm, B = 8, T = 5, pivot off: the envs whose LCPs converged at every
    step (port residuals, which match JAX's: test_solver_diagnostics below),
    and one jitted JAX program giving the loss over those envs and its
    gradient wrt the control tape and the body masses, through the vmapped
    rollout_checkpointed that the JAX rollout_fast falls back to."""
    Th = 5
    m, jm, q, v, tau = batch("worm", seed=8)
    m, jm = m.replace(lcp_pivot_iters=0), jm.replace(lcp_pivot_iters=0)
    taus = np.tile(tau[None], (Th, 1, 1)) * 0.3
    conv = np.ones(q.shape[0], bool)
    with torch.no_grad():
        s = State(q=T(q), v=T(v))
        for t in range(Th):
            conv &= solver_diagnostics(m, s, T(taus[t])).numpy() < 1e-8
            s = S.step(m, s, T(taus[t]))
    assert conv.sum() >= 4, f"too few converged envs: {conv.sum()}"
    w = conv.astype(np.float64)

    def loss_jax(taus, mass):
        final = jax.vmap(lambda q_, v_, t_: jax_rollout_checkpointed(jm.replace(mass=mass), _jstate(q_, v_), t_),
                         in_axes=(0, 0, 1))(jnp.asarray(q), jnp.asarray(v), taus)
        return jnp.mean(w * final.q[:, 0] ** 2) + jnp.mean(w[:, None] * final.v**2)

    l_j, (g_taus, g_mass) = jax.jit(jax.value_and_grad(loss_jax, argnums=(0, 1)))(
        jnp.asarray(taus), jm.mass)
    return m, q, v, taus, T(w), float(l_j), np.asarray(g_taus), np.asarray(g_mass)


def _loss(final, w):
    return (w * final.q[:, 0] ** 2).mean() + (w[:, None] * final.v**2).mean()


def test_bptt_gradient_matches_jax(bptt_ref):
    """The gradient wrt the control tape of rollout_checkpointed."""
    m, q, v, taus, w, l_j, g_j, _ = bptt_ref
    taus_t = T(taus).requires_grad_(True)
    l_t = _loss(S.rollout_checkpointed(m, State(q=T(q), v=T(v)), taus_t), w)
    (g_t,) = torch.autograd.grad(l_t, taus_t)
    np.testing.assert_allclose(l_t.item(), l_j, rtol=1e-9)
    assert np.abs(g_j).max() > 0
    close(g_t, g_j, atol=VJP_ATOL * np.abs(g_j).max(), rtol=VJP_RTOL)


def test_rollout_fast_fallback_mass_gradient_matches_jax(bptt_ref):
    """grad wrt the body masses through rollout_fast (the counterpart of
    tests/test_fast_dispatch.py:36): the port warns, takes the vmap stack
    and gives the JAX package's gradient."""
    m, q, v, taus, w, l_j, _, g_j = bptt_ref
    mass = m.mass.clone().requires_grad_(True)
    with pytest.warns(UserWarning, match="require grad"):
        final = rollout_fast(m.replace(mass=mass), State(q=T(q), v=T(v)), T(taus))
    (g_t,) = torch.autograd.grad(_loss(final, w), mass)
    assert np.isfinite(g_j).all() and np.abs(g_j).max() > 0
    close(g_t, g_j, atol=VJP_ATOL * np.abs(g_j).max(), rtol=VJP_RTOL)


def test_cartpole_drive_matches_jax():
    """.claude/skills/verify/SKILL.md's BPTT drive (cartpole, dt 0.01, pole
    near the top, zero controls, lr 0.05) for three iterations at T = 100,
    one env."""
    from diffdart_tpu.models import cartpole as jax_cartpole
    from diffdart_tpu_torch.models import cartpole

    Th, iters, lr = 100, 3, 0.05
    jm = jax_cartpole(dt=0.01)
    m = cartpole(dt=0.01, dtype=torch.float64, device="cpu")
    s0 = JState(q=jnp.array([0.0, 3.14159]), v=jnp.zeros(2), t=jnp.zeros(()))

    def loss_jax(taus):
        final, _ = jax_rollout(jm, s0, taus)
        return jnp.sum(final.q**2) + 0.1 * jnp.sum(final.v**2)

    lg = jax.jit(jax.value_and_grad(loss_jax))
    taus_j = jnp.zeros((Th, 2))
    taus_t = torch.zeros(Th, 1, 2, dtype=torch.float64)
    st0 = State(q=torch.tensor([[0.0, 3.14159]], dtype=torch.float64),
                v=torch.zeros(1, 2, dtype=torch.float64))
    for _ in range(iters):
        l_j, g_j = lg(taus_j)
        x = taus_t.clone().requires_grad_(True)
        final, traj = S.rollout(m, st0, x)
        l_t = (final.q**2).sum() + 0.1 * (final.v**2).sum()
        (g_t,) = torch.autograd.grad(l_t, x)
        np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-9)
        close(g_t[:, 0], g_j, atol=1e-12, rtol=1e-9)
        assert traj.q.shape == (Th, 1, 2)
        taus_j = taus_j - lr * g_j
        taus_t = taus_t - lr * g_t
    assert l_t.item() < 9.87


def test_rollouts_agree():
    """rollout, rollout_final, rollout_checkpointed and rollout_segmented
    give the same final state and the same gradient (worm, T = 4)."""
    m, _, q, v, tau = batch("worm", seed=9)
    taus = np.tile(tau[None], (4, 1, 1)) * 0.3
    outs = []
    for fn in (lambda s, x: S.rollout(m, s, x)[0], lambda s, x: S.rollout_final(m, s, x),
               lambda s, x: S.rollout_checkpointed(m, s, x),
               lambda s, x: S.rollout_segmented(m, s, x, segment=2)):
        x = T(taus).requires_grad_(True)
        final = fn(State(q=T(q), v=T(v)), x)
        (g,) = torch.autograd.grad((final.q**2).sum() + (final.v**2).sum(), x)
        outs.append((final.q.detach(), final.v.detach(), g))
    for q_, v_, g_ in outs[1:]:
        close(q_, outs[0][0].numpy(), atol=0)
        close(v_, outs[0][1].numpy(), atol=0)
        close(g_, outs[0][2].numpy(), atol=1e-12, rtol=1e-12)
    with pytest.raises(ValueError, match="multiple"):
        S.rollout_segmented(m, State(q=T(q), v=T(v)), T(taus), segment=3)


def test_lowrank_pallas_on_cpu_runs_the_plain_sweeps():
    """contact_solver='lowrank_pallas' on CPU tensors: the wrapper runs
    _jacobi, so the step equals 'lowrank' bit for bit and nothing
    launches."""
    m, _, q, v, tau = batch("half_cheetah", seed=10)
    n1 = P.KERNEL_SINGLE.launches
    with torch.no_grad():
        a = S.step(m, State(q=T(q), v=T(v)), T(tau))
        b = S.step(m.replace(contact_solver="lowrank_pallas"), State(q=T(q), v=T(v)), T(tau))
    assert P.KERNEL_SINGLE.launches == n1
    assert torch.equal(a.q, b.q) and torch.equal(a.v, b.v)
    # the dense solvers (tests/test_torch_lcp_dense.py) never take the kernel
    with torch.no_grad():
        c = S.step(m.replace(contact_solver="jacobi"), State(q=T(q), v=T(v)), T(tau))
    assert P.KERNEL_SINGLE.launches == n1 and torch.isfinite(c.v).all()


def test_solver_diagnostics_matches_jax():
    from diffdart_tpu.sim.constrained import solver_diagnostics as jax_diag

    m, jm, q, v, tau = batch("worm", seed=11)
    want = jax.jit(jax.vmap(lambda q, v, t: jax_diag(jm, _jstate(q, v), t)))(
        *(jnp.asarray(x) for x in (q, v, tau)))
    got = solver_diagnostics(m, State(q=T(q), v=T(v)), T(tau))
    conv = np.asarray(want) < 1e-8
    assert conv.any()
    assert ((got.numpy() < 1e-8) == conv).all()
    close(got[~conv], np.asarray(want)[~conv], atol=1e-8, rtol=1e-6)


def test_lcp_dtype_f64_island():
    """A float32 model with lcp_dtype='f64' solves its LCP in float64 (and
    runs the pivot refinement there): float32 output, closer to the float64
    step than the plain float32 step is."""
    m64, _, q, v, tau = batch("cube_drop", seed=12)
    from test_torch_vmap_dynamics import MODELS

    m32 = MODELS["cube_drop"](torch.float32, "cpu")[0]
    s32 = State(q=T(q).float(), v=T(v).float())
    with torch.no_grad():
        ref = S.step(m64, State(q=T(q), v=T(v)), T(tau)).v
        plain = S.step(m32, s32, T(tau).float()).v
        island = S.step(m32.replace(lcp_dtype="f64"), s32, T(tau).float()).v
    assert island.dtype == torch.float32 and torch.isfinite(island).all()
    assert (island.double() - ref).abs().max() <= (plain.double() - ref).abs().max()


def test_unconstrained_step_matches_jax():
    """The contact-free path (step_unconstrained) on the cartpole."""
    m, jm, q, v, tau = batch("cartpole", seed=13)
    want = jax.jit(jax.vmap(lambda q, v, t: jax_step(jm, _jstate(q, v), t)))(
        *(jnp.asarray(x) for x in (q, v, tau)))
    got = S.step(m, State(q=T(q), v=T(v), t=torch.zeros(q.shape[0], dtype=torch.float64)), T(tau))
    close(got.q, want.q)
    close(got.v, want.v)
    close(got.t, np.full(q.shape[0], 0.01))


def test_rollout_checkpointed_solves_once_per_step(monkeypatch):
    """rollout_checkpointed keeps each step's LCP impulse: the sweeps run T
    times in forward plus backward (a per-step torch.utils.checkpoint
    rollout, the version before, runs them 2T times), and the gradient wrt
    the control tape and the body masses is that rollout's, to 1e-12
    relative (worm, T = 4)."""
    from torch.utils.checkpoint import checkpoint

    from diffdart_tpu_torch.ops.lcp import _jacobi
    from diffdart_tpu_torch.sim import constrained

    m, _, q, v, tau = batch("worm", seed=14)
    m = m.replace(lcp_pivot_iters=0)
    taus = np.tile(tau[None], (4, 1, 1)) * 0.3
    calls = []

    def counted(*args):
        calls.append(1)
        return _jacobi(*args)

    monkeypatch.setattr(constrained, "_jacobi", counted)

    def grads(roll):
        mass = m.mass.clone().requires_grad_(True)
        x = T(taus).requires_grad_(True)
        final = roll(m.replace(mass=mass), State(q=T(q), v=T(v)), x)
        return torch.autograd.grad((final.q**2).sum() + (final.v**2).sum(), (x, mass))

    def per_step_checkpoint(model, s, x):
        qq, vv, tt = s.q, s.v, s.t
        for k in range(x.shape[0]):
            qq, vv, tt = checkpoint(S._step_tensors, model, qq, vv, tt, x[k], use_reentrant=False,
                                    preserve_rng_state=False)
        return State(q=qq, v=vv, t=tt)

    got = grads(S.rollout_checkpointed)
    n_new = len(calls)
    want = grads(per_step_checkpoint)
    assert n_new == 4 and len(calls) - n_new == 8
    for g, w in zip(got, want):
        assert w.abs().max() > 0
        close(g, w.numpy(), atol=1e-12 * w.abs().max().item(), rtol=1e-12)
