"""The hybrid lcp='xla' mode of the plain fused step (diffdart_tpu_torch/
sim/tilestep.py::_xla_lcp_vnew: element-wise dynamics and rows, the LCP
gathered into dense (B, D, nv) tensors and solved by boxed_lcp_lowrank)
and the hybrid branch of ops/fused_step.py::rollout_tiled, float64 on the
CPU.

The model is tests/test_tilestep_hybrid.py's 2-link jump-worm (4 contact
slots), with the LCP forced through the hybrid and with contact_budget=3
(each env's 3 deepest valid slots; lcp='auto' then picks the hybrid). At
that file's tolerances: against the port's vmap step, re-synced every
step, q 1e-7 and v 1e-5; the BPTT loss rtol 1e-8 and its gradient rtol
5e-4, atol 5e-7 against the vmap stack's. Against the JAX package's
hybrid step (one jit per model) q 1e-9 and v 1e-6: the two solve the LCP
in other orders, amplified by about eps/cfm in the polish.
"""
import jax
import numpy as np
import pytest
import torch

from diffdart_tpu.sim.tilestep import build_tile_step as jax_build_tile_step
from diffdart_tpu_torch.dynamics.model import State
from diffdart_tpu_torch.models import jump_worm
from diffdart_tpu_torch.ops import fused_step as fs
from diffdart_tpu_torch.sim import fast
from diffdart_tpu_torch.sim.step import step
from diffdart_tpu_torch.sim.tilestep import build_tile_step

from test_torch_tilestep import B, _soa, _tiles, _unsoa, _untiles
from test_torch_vmap_dynamics import jax_model_of

CASES = {"forced_xla": (dict(), "xla"), "budget3": (dict(contact_budget=3), "auto")}


def worm(case):
    kw, _ = CASES[case]
    return jump_worm(dt=2e-3, n_links=2, dtype=torch.float64, device="cpu").replace(**kw)


def worm_batch(m, seed):
    rng = np.random.RandomState(seed)
    q0 = m.neutral_q().numpy() + np.array([0.06, 0.0, 0.25, -0.5])[: m.nq]
    q = np.tile(q0, (B, 1)) + 0.05 * rng.randn(B, m.nq)
    return q, 0.3 * rng.randn(B, m.nv), 0.5 * rng.randn(B, m.nv)


@pytest.fixture(scope="module")
def jax_steps():
    """case -> the jitted JAX hybrid tile step (one jit per model)."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = jax.jit(jax_build_tile_step(jax_model_of(worm(case)), output="tiles",
                                                      lcp=CASES[case][1]))
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_hybrid_matches_the_vmap_step(case):
    m = worm(case)
    tstep = build_tile_step(m, output="tiles", lcp=CASES[case][1])
    q, v, tau = worm_batch(m, seed=7 if case == "budget3" else 0)
    Tq, Tv, Ttau = (torch.tensor(x) for x in (q, v, tau))
    with torch.no_grad():
        for it in range(10):
            ref = step(m, State(q=Tq, v=Tv), Ttau)
            qt, vt = tstep(_soa(Tq.numpy()), _soa(Tv.numpy()), _soa(tau))
            np.testing.assert_allclose(_unsoa(qt), ref.q.numpy(), atol=1e-7, err_msg=f"q at step {it}")
            np.testing.assert_allclose(_unsoa(vt), ref.v.numpy(), atol=1e-5, err_msg=f"v at step {it}")
            Tq, Tv = ref.q, ref.v


@pytest.mark.parametrize("case", list(CASES))
def test_hybrid_matches_jax_hybrid_step(case, jax_steps):
    m = worm(case)
    tstep = build_tile_step(m, output="tiles", lcp=CASES[case][1])
    q, v, tau = worm_batch(m, seed=1)
    for it in range(3):
        qj, vj = (_untiles(x) for x in jax_steps(case)(_tiles(q), _tiles(v), _tiles(tau)))
        with torch.no_grad():
            qt, vt = tstep(_soa(q), _soa(v), _soa(tau))
        np.testing.assert_allclose(_unsoa(qt), qj, atol=1e-9, rtol=0, err_msg=f"q at step {it}")
        np.testing.assert_allclose(_unsoa(vt), vj, atol=1e-6, rtol=0, err_msg=f"v at step {it}")
        q, v = qj, vj


@pytest.mark.parametrize("case", list(CASES))
def test_hybrid_bptt_matches_the_vmap_stack(case):
    """Loss mean(q_T[:, 0]^2) + mean(v_T^2) over T = 5 steps, and its
    gradient wrt the control tape, through the hybrid's IFT solve and
    through the vmap stack's."""
    m = worm(case)
    q, v, tau = worm_batch(m, seed=11 if case == "budget3" else 3)
    taus0 = np.tile(tau[None], (5, 1, 1)) * 0.3
    tstep = build_tile_step(m, output="tiles", lcp=CASES[case][1])

    def loss(qf, vf):
        return (qf[:, 0] ** 2).mean() + (vf**2).mean()

    taus_t = torch.tensor(taus0, requires_grad=True)
    qc, vc = _soa(q), _soa(v)
    for t in range(5):
        qc, vc = tstep(qc, vc, tuple(taus_t[t, :, i] for i in range(m.nv)))
    l_t = loss(torch.stack(qc, 1), torch.stack(vc, 1))
    (g_t,) = torch.autograd.grad(l_t, taus_t)

    taus_r = torch.tensor(taus0, requires_grad=True)
    s = State(q=torch.tensor(q), v=torch.tensor(v))
    for t in range(5):
        s = step(m, s, taus_r[t])
    l_r = loss(s.q, s.v)
    (g_r,) = torch.autograd.grad(l_r, taus_r)
    np.testing.assert_allclose(l_t.item(), l_r.item(), rtol=1e-8)
    np.testing.assert_allclose(g_t.numpy(), g_r.numpy(), rtol=5e-4, atol=5e-7)


def test_rollout_tiled_hybrid_branch_equals_stepping_the_plain_version():
    """rollout_tiled takes its hybrid branch (checkpointed steps) for the
    budgeted worm; its final state, and its gradient, equal a loop over the
    plain step. On the card rollout_fast names the hybrid reason and takes
    the vmap stack."""
    m = worm("budget3")
    q, v, tau = worm_batch(m, seed=5)
    taus0 = np.tile(tau[None], (4, 1, 1)) * 0.3
    assert "hybrid LCP runs outside the kernel" in fs.kernel_unsupported_reason(m)
    assert "hybrid LCP" in fast._fallback_reason(m, torch.device("cuda"))
    taus_a = torch.tensor(taus0, requires_grad=True)
    fin = fs.rollout_tiled(m, State(q=torch.tensor(q), v=torch.tensor(v)), taus_a)
    tstep = build_tile_step(m, output="tiles")
    taus_b = torch.tensor(taus0, requires_grad=True)
    qc, vc = _soa(q), _soa(v)
    for t in range(4):
        qc, vc = tstep(qc, vc, tuple(taus_b[t, :, i] for i in range(m.nv)))
    np.testing.assert_array_equal(fin.q.detach().numpy(), _unsoa(qc))
    np.testing.assert_array_equal(fin.v.detach().numpy(), _unsoa(vc))
    (ga,) = torch.autograd.grad((fin.q[:, 0] ** 2).sum(), taus_a)
    (gb,) = torch.autograd.grad((torch.stack(qc, 1)[:, 0] ** 2).sum(), taus_b)
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=1e-12, atol=1e-15)
