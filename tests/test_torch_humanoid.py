"""The Atlas-class humanoid and the catapult in the torch port
(diffdart_tpu_torch/models/humanoid.py, models/scenes.py) against the JAX
package, float64 on the CPU.

Both models are built by each package and compared field for field, the
hull buffers bit for bit. From a perturbed standing state (the root 5 mm
low, the joints +-0.05 rad, v ~ 0.1 N(0,1), B = 4), three steps with
`contact_budget=12` (D = 84 LCP rows), each re-synced to the JAX package's
state, are held to the JAX tile-vs-vmap tolerances, q 1e-7 and v 1e-5
(tests/test_tilestep.py:82-88); measured 2e-11 in q and 1e-8 in v. The
full-slot LCP (33 slots, D = 147) at that state equals JAX's
prepare_constrained within 1e-10 (A's entries sum in other orders). Each
JAX configuration compiles once, in a module-scoped fixture (about 25 s
for the step); the JAX humanoid's timestep Jacobians are not compiled here
(far dearer), so the port's Jacobians are held to its own backprop and to
central differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.collision.collide import collide_world_with_bodies as jax_collide
from diffdart_tpu.dynamics import dynamics as JD
from diffdart_tpu.dynamics.model import State as JState
from diffdart_tpu.models.humanoid import humanoid as jax_humanoid
from diffdart_tpu.models.humanoid import humanoid_init_q as jax_humanoid_init_q
from diffdart_tpu.models.scenes import catapult as jax_catapult
from diffdart_tpu.sim.constrained import prepare_constrained as jax_prepare
from diffdart_tpu.sim.step import step as jax_step
from diffdart_tpu_torch.collision import collide as C
from diffdart_tpu_torch.dynamics import dynamics as D
from diffdart_tpu_torch.dynamics import model as tm
from diffdart_tpu_torch.dynamics.model import State
from diffdart_tpu_torch.models import catapult, humanoid, humanoid_init_q
from diffdart_tpu_torch.neural import LossGradient, backprop, timestep_jacobians
from diffdart_tpu_torch.sim.constrained import prepare_constrained, solver_diagnostics
from diffdart_tpu_torch.sim.fast import rollout_fast
from diffdart_tpu_torch.sim.step import step

from test_torch_model import _assert_same, _jax_fields
from test_torch_vmap_dynamics import T, close, jax_model_of

F64 = dict(dtype=torch.float64, device="cpu")
B = 4


def _model(budget=0):
    return humanoid(**F64).replace(contact_budget=budget)


def perturbed_state(m, B=B, seed=0):
    """(q, v) numpy: the standing pose with the root 5 mm low, the joints
    +-0.05 rad, v ~ 0.1 N(0, 1)."""
    rng = np.random.RandomState(seed)
    q = np.tile(humanoid_init_q(m).numpy(), (B, 1))
    q[:, 6] -= 0.005
    q[:, 7:] += 0.05 * (2 * rng.rand(B, m.nq - 7) - 1)
    return q, 0.1 * rng.randn(B, m.nv)


@pytest.fixture(scope="module")
def ref():
    """name -> the JAX package's outputs at the perturbed state, one jit
    per humanoid configuration: 'step12' one vmapped step with the budget
    (a function of (q, v), called three times); 'lcp' the full-slot
    contacts and LCP."""
    cache = {}

    def get(name):
        if name not in cache:
            if name == "step12":
                jm = jax_model_of(_model(12))
                cache[name] = jax.jit(jax.vmap(
                    lambda q, v, t: jax_step(jm, JState(q=q, v=v, t=jnp.zeros(())), t)))
            else:
                jm = jax_model_of(_model())

                def one(q, v, tau):
                    c = JD.kinematics_cache(jm, q, v)
                    return (jax_collide(jm, c["R"], c["p"]),
                            jax_prepare(jm, JState(q=q, v=v, t=jnp.zeros(())), tau)[0])

                q, v = perturbed_state(_model())
                cache[name] = jax.jit(jax.vmap(one))(q, v, np.zeros((B, 30)))
        return cache[name]

    return get


@pytest.mark.parametrize("name", ["humanoid", "catapult"])
def test_model_matches_jax_field_for_field(name):
    got = humanoid(**F64) if name == "humanoid" else catapult(**F64)
    want = jax_humanoid() if name == "humanoid" else jax_catapult()
    _assert_same(tm.model_to_numpy(got), _jax_fields(want))
    if name == "humanoid":
        assert (got.nv, got.nq, got.ngeom, len(got.col_pairs)) == (30, 31, 14, 13)
        assert len(got.hull_vcounts) == 4 and C.max_contacts(got) == 33
        np.testing.assert_array_equal(humanoid_init_q(got).numpy(), np.asarray(jax_humanoid_init_q(want)))


@pytest.mark.parametrize("name", ["humanoid", "catapult"])
def test_model_from_numpy_of_jax_model(name):
    want = jax_humanoid() if name == "humanoid" else jax_catapult()
    carried = tm.model_from_numpy(_jax_fields(want), **F64)
    own = humanoid(**F64) if name == "humanoid" else catapult(**F64)
    _assert_same(tm.model_to_numpy(carried), tm.model_to_numpy(own))
    assert carried.hull_verts.dtype == torch.float64


def test_humanoid_float32_build_and_devices():
    m32 = humanoid(dtype=torch.float32, device="cpu")
    m64 = humanoid(**F64)
    assert m32.hull_verts.dtype == torch.float32 and m32.device.type == "cpu"
    assert torch.equal(m32.hull_verts, m64.hull_verts.float())
    assert humanoid_init_q(m32).dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            humanoid()


def test_three_resynced_budget_steps_match_jax(ref):
    m = _model(12)
    jstep = ref("step12")
    q, v = perturbed_state(m)
    tau = np.zeros((B, m.nv))
    errs = []
    for _ in range(3):
        with torch.no_grad():
            got = step(m, State(q=T(q), v=T(v)), T(tau))
        want = jstep(q, v, tau)
        errs.append((np.abs(got.q.numpy() - np.asarray(want.q)).max(),
                     np.abs(got.v.numpy() - np.asarray(want.v)).max()))
        q, v = np.asarray(want.q), np.asarray(want.v)
    assert max(e[0] for e in errs) <= 1e-7 and max(e[1] for e in errs) <= 1e-5, errs


def test_full_slot_lcp_matches_jax(ref):
    m = _model()
    (contacts, ba, bb), lcp = ref("lcp")
    q, v = perturbed_state(m)
    cache = D.kinematics_cache(m, T(q), T(v))
    got, ga, gb = C.collide_world_with_bodies(m, cache["R"], cache["p"])
    for field in ("pos", "normal", "depth"):
        close(getattr(got, field), getattr(contacts, field), atol=1e-12, msg=field)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(contacts.valid))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ba)[0])
    g = prepare_constrained(m, State(q=T(q), v=T(v)), torch.zeros(B, m.nv, dtype=torch.float64))[0]
    assert g.b.shape == (B, 147)
    for field in ("J", "A", "b", "lo", "hi", "mu"):
        close(getattr(g, field), getattr(lcp, field), atol=1e-10, msg=field)
    np.testing.assert_array_equal(g.valid.numpy(), np.asarray(lcp.valid))
    np.testing.assert_array_equal(g.fidx.numpy(), np.asarray(lcp.fidx)[0])


def test_budget_keeps_the_deepest_slots():
    """With contact_budget=12 the LCP has 84 rows, and the 12 slots kept in
    each env are its deepest valid ones, deepest first."""
    m = _model(12)
    q, v = perturbed_state(m)
    cache = D.kinematics_cache(m, T(q), T(v))
    full, ba, bb = C.collide_world_with_bodies(m, cache["R"], cache["p"])
    sel, sa, sb = C.select_contacts(m, full, ba, bb)
    score = torch.where(full.valid, full.depth, torch.full_like(full.depth, -np.inf))
    want = torch.sort(score, dim=-1, descending=True).values[:, :12]
    got = torch.where(sel.valid, sel.depth, torch.full_like(sel.depth, -np.inf))
    assert torch.equal(got, want)
    assert tuple(sa.shape) == (B, 12) and tuple(sel.friction.shape) == (B, 12)
    lcp = prepare_constrained(m, State(q=T(q), v=T(v)))[0]
    assert lcp.b.shape == (B, 84)


@pytest.fixture(scope="module")
def vmap_rollout():
    """3 steps of the vmap stack from the perturbed state (B = 2, budget
    12): (model, q, v, taus, final State)."""
    from diffdart_tpu_torch.sim.step import rollout_final

    m = _model(12)
    q, v = perturbed_state(m, B=2)
    taus = torch.zeros(3, 2, m.nv, dtype=torch.float64)
    with torch.no_grad():
        fin = rollout_final(m, State(q=T(q), v=T(v)), taus)
    return m, q, v, taus, fin


def test_rollout_fast_warns_and_runs_the_vmap_stack(vmap_rollout):
    """With the mass requiring grad, rollout_fast warns and runs the vmap
    stack, which gives the mass its gradient: 3 steps, the final state
    equal to the vmap stack's rollout. On the card the humanoid also
    warns without grad, naming the hybrid LCP (147 rows), which runs
    outside the kernel."""
    from diffdart_tpu_torch.sim import fast

    m, q, v, taus, ref = vmap_rollout
    assert "the hybrid LCP runs outside the kernel" in fast._fallback_reason(m, torch.device("cuda"))
    mass = m.mass.clone().requires_grad_(True)
    with pytest.warns(UserWarning, match="require grad"):
        fin = rollout_fast(m.replace(mass=mass), State(q=T(q), v=T(v)), taus)
    assert bool(torch.isfinite(fin.q).all() and torch.isfinite(fin.v).all())
    assert bool((fin.q[:, 6] > 0.9).all())
    close(fin.q.detach(), ref.q.numpy(), atol=1e-12)
    close(fin.v.detach(), ref.v.numpy(), atol=1e-12)
    (g,) = torch.autograd.grad(fin.q[:, 6].sum(), mass)
    assert bool(torch.isfinite(g).all())


def test_rollout_fast_routes_the_humanoid(vmap_rollout):
    """The plain fused step has convex slots and the hybrid LCP, so the
    humanoid is inside the fused subset: on the CPU rollout_fast takes
    rollout_tiled's hybrid branch without a warning, and its final state
    after 3 steps equals the vmap stack's (q 1e-7, v 1e-5)."""
    import warnings

    from diffdart_tpu_torch.sim import fast

    m, q, v, taus, ref = vmap_rollout
    assert fast._fallback_reason(m, torch.device("cpu")) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        fin = rollout_fast(m, State(q=T(q), v=T(v)), taus)
    assert bool(torch.isfinite(fin.q).all() and torch.isfinite(fin.v).all())
    assert bool((fin.q[:, 6] > 0.9).all())
    close(fin.q, ref.q.numpy(), atol=1e-7)
    close(fin.v, ref.v.numpy(), atol=1e-5)


def test_timestep_jacobians_backprop_and_central_differences():
    """The port's Jacobians at the perturbed state (B = 2, every slot):
    finite; backprop equal to J^T g within 1e-8 of its largest magnitude;
    two columns (one velocity, one force) against central differences at
    eps 1e-4 within 3e-4, on envs whose LCP converged (natural-map residual
    below 1e-8). At eps 1e-5 the solve's own rounding over 2 eps reaches
    4-7e-4 on this model (its residual is ~1e-8 at D = 147; measured on the
    velocity columns 0, 2, 5, 8: 2.0e-4 to 6.8e-4, against 1.8e-5 to 7.0e-5
    at eps 1e-4), so the gate is at 1e-4."""
    m = _model()
    q, v = perturbed_state(m, B=2)
    st = State(q=T(q), v=T(v))
    tau = torch.zeros(2, m.nv, dtype=torch.float64)
    with torch.no_grad():
        conv = solver_diagnostics(m, st, tau) < 1e-8
    assert bool(conv.any())
    J = timestep_jacobians(m, st, tau)
    assert all(bool(torch.isfinite(x).all()) for x in J)
    rng = np.random.RandomState(1)
    gq, gv = T(rng.randn(2, m.nv)), T(rng.randn(2, m.nv))
    bp = backprop(m, st, tau, LossGradient(gq, gv, torch.zeros_like(gq)))

    def jt(Jq, Jv):
        return (Jq.transpose(-1, -2) @ gq.unsqueeze(-1) + Jv.transpose(-1, -2) @ gv.unsqueeze(-1)).squeeze(-1)

    for got, want in zip(bp, (jt(J.pos_pos, J.pos_vel), jt(J.vel_pos, J.vel_vel),
                              jt(J.force_pos, J.force_vel))):
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-8

    eps = 1e-4
    with torch.no_grad():
        base = step(m, st, tau).q

        def out(v_, t_):
            s = step(m, State(q=st.q, v=v_), t_)
            return D.position_difference(m, base, s.q), s.v

        for j, (kp, kv), f in ((8, ("vel_pos", "vel_vel"), lambda h, e: out(st.v + h * e, tau)),
                               (20, ("force_pos", "force_vel"), lambda h, e: out(st.v, tau + h * e))):
            e = torch.zeros_like(st.v)
            e[:, j] = 1.0
            (pp, vp), (pm, vm) = f(eps, e), f(-eps, e)
            for key, fd in ((kp, (pp - pm) / (2 * eps)), (kv, (vp - vm) / (2 * eps))):
                err = (getattr(J, key)[..., j] - fd)[conv].abs().max().item()
                assert err <= 3e-4, (key, j, err)
