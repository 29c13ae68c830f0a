"""Trajectory optimization in the torch port (diffdart_tpu_torch/trajectory/)
against the JAX package (diffdart_tpu/trajectory/), float64 on the CPU, and
the catapult's contact step that its trajectory problem runs on.

Every JAX reference is one jit in a module-scoped fixture (or in the test
that alone uses it); the port runs eagerly. Each optimizer runs for a few
iterations only, from the same inputs: iLQR 2 iterations on the pendulum
(T = 20) and on the free body's reorientation with the tangent charts
(T = 10); single shooting 3 Adam steps; multiple shooting 2 outer
iterations of 3 inner steps; one MPC solve. Results agree to about 1e-11
(the two packages sum the step in other orders); the stated tolerance is
1e-8 on controls and states and rtol 1e-9 on costs. The Adam of
torch.optim makes optax.adam's update to within 5e-16 in float64 (measured
on random gradient sequences), so the shooting results are held at the
same tolerances.
"""
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffdart_tpu.dynamics.model import JointType as JJointType
from diffdart_tpu.dynamics.model import ModelBuilder as JModelBuilder
from diffdart_tpu.dynamics.model import State as JState
from diffdart_tpu.models import cartpole as jax_cartpole
from diffdart_tpu.models import pendulum as jax_pendulum
from diffdart_tpu.models.scenes import catapult as jax_catapult
from diffdart_tpu.sim.step import step as jax_step
from diffdart_tpu.trajectory import MultipleShooting as JMultipleShooting
from diffdart_tpu.trajectory import ilqr as jax_ilqr
from diffdart_tpu.trajectory import single_shooting as jax_single_shooting
from diffdart_tpu.trajectory import tangent_ops as jax_tangent_ops
from diffdart_tpu.trajectory.ilqr import make_dynamics as jax_make_dynamics
from diffdart_tpu.trajectory.nlp import _defect_jacobian_fns as jax_defect_jacobian_fns
from diffdart_tpu_torch.dynamics.model import JointType, ModelBuilder, State
from diffdart_tpu_torch.math.lie import quat_exp, quat_mul
from diffdart_tpu_torch.models import cartpole, catapult, catapult_init_q, cube_drop, pendulum
from diffdart_tpu_torch.sim.step import step
from diffdart_tpu_torch.trajectory import (
    MultipleShooting,
    ilqr,
    make_dynamics,
    single_shooting,
    solve_slsqp,
    tangent_ops,
)
from diffdart_tpu_torch.trajectory.ilqr import _linearize
from diffdart_tpu_torch.trajectory.mpc import MPC, ObservationLog, RealTimeControlBuffer, Ticker
from diffdart_tpu_torch.trajectory.nlp import _defect_jacobian_fns
from diffdart_tpu_torch.trajectory.stall import (
    SolverStallWarning,
    check_trajectory_stall,
    rollout_solver_residuals,
    stall_threshold,
)

from test_torch_vmap_dynamics import T, close, jax_model_of

F64 = dict(dtype=torch.float64, device="cpu")


def _pendulum_problem():
    """The swing-up of tests/test_trajectory.py in both packages."""
    tgt = np.array([np.pi / 2, 0.0])
    jt, tt = jnp.asarray(tgt), T(tgt)

    def jrc(x, u, t):
        return 0.001 * jnp.sum(u**2) + 0.05 * jnp.sum((x - jt) ** 2)

    def jtc(x):
        return 200.0 * jnp.sum((x - jt) ** 2)

    def rc(x, u, t):
        return 0.001 * torch.sum(u**2) + 0.05 * torch.sum((x - tt) ** 2)

    def tc(x):
        return 200.0 * torch.sum((x - tt) ** 2)

    jm = jax_pendulum(dt=0.02, damping=0.05)
    m = pendulum(dt=0.02, damping=0.05, **F64)
    x0 = np.array([-np.pi / 2, 0.0])
    return (jax_make_dynamics(jm), jrc, jtc), (make_dynamics(m), rc, tc), x0


def _same(res, jres, fields=("us", "xs"), atol=1e-8):
    for f in fields:
        close(getattr(res, f), getattr(jres, f), atol=atol, msg=f)
    close(res.cost_trace, jres.cost_trace, rtol=1e-9, atol=0, msg="cost_trace")


def test_ilqr_pendulum_matches_jax():
    (jf, jrc, jtc), (f, rc, tc), x0 = _pendulum_problem()
    us0 = np.zeros((20, 1))
    jres = jax.jit(lambda u: jax_ilqr(jf, jrc, jtc, jnp.asarray(x0), u, iters=2))(jnp.asarray(us0))
    res = ilqr(f, rc, tc, T(x0), T(us0), iters=2)
    _same(res, jres)
    close(res.cost, jres.cost, rtol=1e-9, atol=0)


def _free_body(builder, **kw):
    b = builder(gravity=(0.0, 0.0, 0.0), dt=0.02)
    b.add_body(parent=-1, jtype=(JointType if builder is ModelBuilder else JJointType).FREE,
               mass=1.0, inertia=0.05 * np.eye(3))
    return b.finalize(**kw)


def test_ilqr_free_body_tangent_charts_match_jax():
    """The FREE-body reorientation of tests/test_trajectory.py:81-126 with
    tangent_ops: T = 10, 2 iterations, the Riccati sweep in R^12."""
    jm, m = _free_body(JModelBuilder), _free_body(ModelBuilder, **F64)
    jsel = jnp.zeros((m.nv, 3)).at[:3, :].set(jnp.eye(3))
    jf = jax_make_dynamics(jm, control_map=lambda u: jsel @ u)
    f = make_dynamics(m, control_map=lambda u: torch.cat([u, torch.zeros_like(u)], dim=-1))
    qt = np.array([np.cos(np.pi / 4), np.sin(np.pi / 4), 0.0, 0.0])
    jq, tq = jnp.asarray(qt), T(qt)

    def jrc(x, u, t):
        d = jnp.sum(x[:4] * jq)
        return 0.05 * jnp.sum(u**2) + 20.0 * (1.0 - d * d)

    def jtc(x):
        d = jnp.sum(x[:4] * jq)
        return 200.0 * (1.0 - d * d) + jnp.sum(x[m.nq:] ** 2)

    def rc(x, u, t):
        d = torch.sum(x[:4] * tq)
        return 0.05 * torch.sum(u**2) + 20.0 * (1.0 - d * d)

    def tc(x):
        d = torch.sum(x[:4] * tq)
        return 200.0 * (1.0 - d * d) + torch.sum(x[m.nq:] ** 2)

    assert tangent_ops(m)[2] == 12
    x0 = np.concatenate([m.neutral_q().numpy(), np.zeros(m.nv)])
    us0 = 0.1 * np.random.RandomState(0).randn(10, 3)
    jres = jax.jit(lambda u: jax_ilqr(jf, jrc, jtc, jnp.asarray(x0), u, iters=2,
                                      charts=jax_tangent_ops(jm)))(jnp.asarray(us0))
    res = ilqr(f, rc, tc, T(x0), T(us0), iters=2, charts=tangent_ops(m))
    _same(res, jres)
    assert float(res.cost) < float(res.cost_trace[0]) or float(res.cost_trace[0]) < 1e3


def test_batched_linearization_matches_jax_jacobian():
    """fx, fu of every step of a worm trajectory in contact (one batched
    step of T = 4 envs, nx backward passes) against jax.jacobian of the
    JAX step at each point, float64."""
    from diffdart_tpu_torch.models import jump_worm

    m = jump_worm(dt=2e-3, n_links=2, **F64)
    jm = jax_model_of(m)
    rng = np.random.RandomState(4)
    nx = m.nq + m.nv
    xs = np.tile(np.r_[0.045, 0.0, 0.25, -0.5, np.zeros(m.nv)], (5, 1))
    xs[:, :m.nq] += 0.03 * rng.randn(5, m.nq)
    xs[:, m.nq:] += 0.3 * rng.randn(5, m.nv)
    us = 0.5 * rng.randn(4, m.nv)
    jf = jax_make_dynamics(jm)
    jx, ju = jax.jit(jax.vmap(jax.jacobian(jf, argnums=(0, 1))))(jnp.asarray(xs[:-1]), jnp.asarray(us))
    fx, fu = _linearize(make_dynamics(m), lambda x, e: x + e, lambda a, b: b - a, T(xs), T(us), nx)
    scale = max(1.0, float(np.abs(np.asarray(jx)).max()))
    close(fx, jx, atol=1e-7 * scale, msg="fx")
    close(fu, ju, atol=1e-7 * max(1.0, float(np.abs(np.asarray(ju)).max())), msg="fu")


def test_single_shooting_matches_jax_with_optax_adam():
    (jf, jrc, jtc), (f, rc, tc), x0 = _pendulum_problem()
    us0 = np.zeros((20, 1))
    jres = jax_single_shooting(jf, jrc, jtc, jnp.asarray(x0), jnp.asarray(us0), iters=3)
    res = single_shooting(f, rc, tc, T(x0), T(us0), iters=3)
    _same(res, jres)


def test_multiple_shooting_matches_jax():
    (jf, jrc, jtc), (f, rc, tc), x0 = _pendulum_problem()
    us0 = 0.1 * np.ones((20, 1))
    jms = JMultipleShooting(jf, jrc, jtc, T=20, segment_len=5, nx=2, nu=1)
    ms = MultipleShooting(f, rc, tc, T=20, segment_len=5, nx=2, nu=1)
    jres = jms.solve(jnp.asarray(x0), jnp.asarray(us0), outer_iters=2, inner_iters=3,
                     optimizer=optax.adam(5e-2))
    res = ms.solve(T(x0), T(us0), outer_iters=2, inner_iters=3)
    _same(res, jres)
    close(res.defect_norm, jres.defect_norm, atol=1e-9)


def _cartpole_nlp(builder_m, lib):
    """The cart-pole swing-up NLP of tests/test_nlp.py in either package."""
    m = builder_m
    nx = m.nq + m.nv
    if lib is torch:
        def f(x, u):
            s = step(m, State(q=x[..., :m.nq], v=x[..., m.nq:]),
                     torch.cat([u, torch.zeros_like(u)], dim=-1))
            return torch.cat([s.q, s.v], dim=-1)

        rc = lambda x, u, t: 1e-3 * torch.sum(u**2)  # noqa: E731
        tc = lambda x: 10.0 * (x[1] - np.pi) ** 2 + 0.1 * torch.sum(x[2:] ** 2) + x[0] ** 2  # noqa: E731
        return MultipleShooting(f, rc, tc, T=40, segment_len=10, nx=nx, nu=1)

    def jf(x, u):
        s = jax_step(m, JState(q=x[: m.nq], v=x[m.nq:], t=jnp.zeros((), x.dtype)),
                     jnp.zeros(m.nv, x.dtype).at[0].set(u[0]))
        return jnp.concatenate([s.q, s.v])

    jrc = lambda x, u, t: 1e-3 * jnp.sum(u**2)  # noqa: E731
    jtc = lambda x: 10.0 * (x[1] - jnp.pi) ** 2 + 0.1 * jnp.sum(x[2:] ** 2) + x[0] ** 2  # noqa: E731
    return JMultipleShooting(jf, jrc, jtc, T=40, segment_len=10, nx=nx, nu=1)


def test_defect_jacobian_matches_jax_and_slsqp_runs():
    m = cartpole(dt=0.02, **F64)
    ms, jms = _cartpole_nlp(m, torch), _cartpole_nlp(jax_cartpole(dt=0.02), jnp)
    nx = m.nq + m.nv
    z = 0.1 * np.random.RandomState(3).randn(ms.T * ms.nu + (ms.K - 1) * nx)
    jval, jjac = jax_defect_jacobian_fns(jms, jnp.zeros(nx), jnp.float64)
    val, jac = _defect_jacobian_fns(ms, torch.zeros(nx, dtype=torch.float64), torch.float64)
    close(val(z), jval(jnp.asarray(z)), atol=1e-12, msg="defects")
    np.testing.assert_allclose(jac(z), jjac(z), atol=1e-10)
    # one short SLSQP run: hard control bounds hold, defects are constraints
    U = 8.0
    calls = []
    res, info = solve_slsqp(ms, torch.zeros(nx, dtype=torch.float64),
                            torch.zeros(ms.T, 1, dtype=torch.float64), u_lo=-U, u_hi=U,
                            max_iter=4, intermediate_callback=lambda it, xs, us, c: calls.append(c))
    assert float(res.us.abs().max()) <= U + 1e-9
    assert info.n_iter >= 1 and len(calls) == info.n_iter
    assert np.isfinite(info.constraint_violation)
    assert float(res.cost) < 10.0 * np.pi**2  # below the hanging pole's cost


def _cartpole_mpc(lib, horizon, iters):
    if lib is torch:
        m = cartpole(dt=0.02, **F64)
        f = make_dynamics(m, control_map=lambda u: torch.cat([u, torch.zeros_like(u)], dim=-1))
        rc = lambda x, u, t: 1e-3 * u[0] ** 2 + x[1] ** 2 + 0.1 * x[0] ** 2 + 0.01 * (x[2] ** 2 + x[3] ** 2)  # noqa: E731,E501
        tc = lambda x: 100.0 * torch.sum(x**2)  # noqa: E731
        return f, MPC(f, rc, tc, horizon=horizon, nu=1, dt=0.02, iters_per_solve=iters)
    from diffdart_tpu.trajectory.mpc import MPC as JMPC

    jf = jax_make_dynamics(jax_cartpole(dt=0.02), control_map=lambda u: jnp.array([u[0], 0.0]))
    jrc = lambda x, u, t: 1e-3 * u[0] ** 2 + x[1] ** 2 + 0.1 * x[0] ** 2 + 0.01 * (x[2] ** 2 + x[3] ** 2)  # noqa: E731,E501
    jtc = lambda x: 100.0 * jnp.sum(x**2)  # noqa: E731
    return jf, JMPC(jf, jrc, jtc, horizon=horizon, nu=1, dt=0.02, iters_per_solve=iters)


def test_mpc_solve_and_warm_start_match_jax():
    """One MPC solve on the cart-pole of examples/mpc_cartpole.py
    (horizon 10, 2 iLQR iterations) against the JAX package's, and the
    warm start after 3 control periods: the old plan shifted by 3, the
    tail padded with its last control."""
    _, mpc = _cartpole_mpc(torch, 10, 2)
    _, jmpc = _cartpole_mpc(jnp, 10, 2)
    x0 = np.array([0.0, 0.3, 0.0, 0.0])
    res, jres = mpc.solve(T(x0), 0.0), jmpc.solve(jnp.asarray(x0), 0.0)
    _same(res, jres)
    np.testing.assert_allclose(mpc.get_control(0.0), np.asarray(jres.us)[0], atol=1e-8)
    captured = {}
    orig = mpc._solve

    def spy(x, warm):
        captured["warm"] = warm.numpy()
        return orig(x, warm)

    mpc._solve = spy
    old = res.us.numpy()
    mpc.solve(T(x0), 3 * mpc.dt)
    np.testing.assert_allclose(captured["warm"][:7], old[3:], rtol=1e-7)
    np.testing.assert_allclose(captured["warm"][7:], np.tile(old[-1:], (3, 1)), rtol=1e-7)
    assert mpc.log.ts == [0.0, 3 * mpc.dt]


def test_control_buffer_log_and_ticker():
    """tests/test_mpc.py:84-107, on the port's classes."""
    buf = RealTimeControlBuffer(nu=2, dt=0.1, horizon=5)
    us = np.arange(10).reshape(5, 2).astype(float)
    buf.splice(1.0, us)
    np.testing.assert_array_equal(buf.get(1.0), us[0])
    np.testing.assert_array_equal(buf.get(1.25), us[2])
    np.testing.assert_array_equal(buf.get(0.0), us[0])
    np.testing.assert_array_equal(buf.get(99.0), us[4])
    log = ObservationLog.create()
    log.observe(0.1, np.array([1.0, 2.0]))
    log.observe(0.2, torch.tensor([3.0, 4.0]))
    assert log.ts == [0.1, 0.2]
    np.testing.assert_array_equal(log.xs[1], [3.0, 4.0])
    ticker = Ticker(period_s=0.005)
    hits = []
    ticker.registerTickListener(lambda now: hits.append(now))
    t0 = time.perf_counter()
    ticker.start(max_ticks=5)
    assert len(hits) == 5
    assert time.perf_counter() - t0 < 1.0


def _cube_population_xs(m, n=12, seed=0):
    """The near-coplanar cube states of tests/test_stall.py, made with the
    port's quaternion maps, in the flat layout xs (n+1, nx), us (n, nv)."""
    q0 = m.neutral_q().numpy()
    rng = np.random.default_rng(seed)
    xs = []
    for k in range(n + 1):
        q = q0.copy()
        dq = quat_exp(T(rng.normal(size=3) * 0.04))
        q[:4] = quat_mul(T(q[:4]), dq).numpy()
        q[6] = 0.094 + 0.01 * rng.random()
        v = rng.normal(size=m.nv) * (2.0 if k % 2 else 0.3)
        xs.append(np.concatenate([q, v]))
    return T(np.stack(xs)), torch.zeros(n, m.nv, dtype=torch.float64)


def test_stall_warning_fires_on_a_stalled_model_and_not_on_a_healthy_one():
    m = cube_drop(dt=2e-3, friction=0.8, **F64)
    xs, us = _cube_population_xs(m)
    stalled = m.replace(lcp_pivot_iters=0)
    res = rollout_solver_residuals(stalled, xs, us)
    assert float(res.max()) > stall_threshold(stalled, xs.dtype)
    with pytest.warns(SolverStallWarning, match="lcp_pivot_iters"):
        check_trajectory_stall(stalled, xs, us)
    with warnings.catch_warnings():
        warnings.simplefilter("error", SolverStallWarning)
        mx = check_trajectory_stall(m, xs, us)
    assert float(mx) < stall_threshold(m, xs.dtype)


def test_ilqr_diagnose_model_warns_only_where_the_solver_stalls():
    """ilqr(diagnose_model=...) checks the optimized trajectory (the
    wiring of tests/test_stall.py::TestOptimizerWiring): from a cube state
    that stalls without the pivot refinement, silent with it, a
    SolverStallWarning without it."""
    m = cube_drop(dt=2e-3, friction=0.8, **F64)
    m0 = m.replace(lcp_pivot_iters=0)
    xs, us = _cube_population_xs(m0)
    res = rollout_solver_residuals(m0, xs, us)
    x0 = xs[int(torch.nonzero(res > stall_threshold(m0, xs.dtype))[0, 0])]
    us0 = torch.zeros(3, m.nv, dtype=torch.float64)

    def rc(x, u, t):
        return 1e-3 * torch.sum(u**2)

    def tc(x):
        return torch.sum(x[4:7] ** 2)

    with warnings.catch_warnings():
        warnings.simplefilter("error", SolverStallWarning)
        out = ilqr(make_dynamics(m), rc, tc, x0, us0, iters=2, diagnose_model=m)
    assert torch.isfinite(out.us).all()
    with pytest.warns(SolverStallWarning):
        ilqr(make_dynamics(m0), rc, tc, x0, us0, iters=2, diagnose_model=m0)


def test_catapult_contact_step_matches_jax():
    """The catapult with the ball pressed 0.5 mm into its cradle (the
    ball-cradle slot valid at every step) and the arm swinging: 5 float64
    steps re-synced to the JAX state, q within 1e-9 and v within 1e-6
    (measured 2.1e-11 and 2.1e-8 at |v| up to 13): two moving bodies in
    contact, the step the catapult's trajectory problem runs on."""
    from diffdart_tpu_torch.collision.collide import collide_world_with_bodies
    from diffdart_tpu_torch.dynamics.dynamics import kinematics_cache

    m = catapult(dt=2e-3, **F64)
    jm = jax_catapult(dt=2e-3)
    B = 4
    rng = np.random.RandomState(5)
    q = np.tile(catapult_init_q(m).numpy(), (B, 1))
    q[:, 8] -= 0.0015  # the ball's z: from 1 mm above the cradle to 0.5 mm into it
    v = np.zeros((B, m.nv))
    tau = np.zeros((B, m.nv))
    tau[:, :2] = np.array([-20.0, -6.0]) + rng.randn(B, 2)
    jstep = jax.jit(jax.vmap(lambda q, v, t: jax_step(jm, JState(q=q, v=v, t=jnp.zeros(())), t)))
    for it in range(5):
        cache = kinematics_cache(m, T(q), T(v))
        c, ba, bb = collide_world_with_bodies(m, cache["R"], cache["p"])
        cradle = ((ba == 2) & (bb == 1)) | ((ba == 1) & (bb == 2))
        assert bool(c.valid[:, cradle].any(-1).all()), f"ball-cradle contact lost at step {it}"
        sj = jstep(jnp.asarray(q), jnp.asarray(v), jnp.asarray(tau))
        st = step(m, State(q=T(q), v=T(v)), T(tau))
        close(st.q, sj.q, atol=1e-9, msg=f"q at step {it}")
        close(st.v, sj.v, atol=1e-6, msg=f"v at step {it}")
        q, v = np.asarray(sj.q), np.asarray(sj.v)
