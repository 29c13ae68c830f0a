"""Convex-hull slots of the plain fused step (diffdart_tpu_torch/sim/
tilestep.py: every hull vertex a candidate, the 4 deepest become slots,
_topk_tile_slots) against the JAX tile step and the port's vmap step,
float64 on the CPU.

The model is tests/test_tilestep_hybrid.py's octahedron: a free body whose
hull has 6 vertices, on a plane, pivot refinement off (the tile LCP has
none). Tolerances: against the eager JAX tile step q 1e-8 and v 1e-7, as in
tests/test_torch_tilestep.py; against the vmap step, re-synced every step,
q 1e-7 and v 1e-5 (tests/test_tilestep_hybrid.py:200-203). The slot order
on exact ties is held to the JAX version's on constructed ties.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.sim.tilestep import _topk_tile_slots as jax_topk
from diffdart_tpu.sim.tilestep import build_tile_step as jax_build_tile_step
from diffdart_tpu_torch.dynamics.model import GeomType, JointType, ModelBuilder, State
from diffdart_tpu_torch.math.lie import quat_normalize
from diffdart_tpu_torch.ops import fused_step as fs
from diffdart_tpu_torch.sim import fast
from diffdart_tpu_torch.sim.step import step
from diffdart_tpu_torch.sim.tilestep import SLOTS, _topk_tile_slots, build_tile_step

from test_torch_tilestep import B, _soa, _tiles, _unsoa, _untiles
from test_torch_vmap_dynamics import jax_model_of

OCTA = 0.1 * np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1.0]])


def octa_model(verts=OCTA):
    b = ModelBuilder(dt=2e-3)
    body = b.add_body(parent=-1, jtype=JointType.FREE, mass=1.0, inertia=np.eye(3) * 0.004)
    b.add_geom(body, GeomType.CONVEX, verts=verts, friction=0.6)
    b.add_geom(-1, GeomType.PLANE, friction=0.6)
    return b.finalize(dtype=torch.float64, device="cpu").replace(lcp_pivot_iters=0)


def octa_batch(m, seed=1):
    """(q, v, tau) numpy (B, k): random attitudes, the centre 0.1 +- 0.04
    above the plane (some vertices below it), v ~ 0.5 N(0, 1)."""
    rng = np.random.RandomState(seed)
    quat = quat_normalize(torch.tensor(rng.randn(B, 4))).numpy()
    pos = np.stack([0.05 * rng.randn(B), 0.05 * rng.randn(B), 0.1 + 0.04 * rng.randn(B)], 1)
    return np.concatenate([quat, pos], 1), 0.5 * rng.randn(B, m.nv), 0.1 * rng.randn(B, m.nv)


def test_convex_slots_match_jax_tile_step():
    m = octa_model()
    jstep = jax_build_tile_step(jax_model_of(m), output="tiles")
    tstep = build_tile_step(m, output="tiles")
    q, v, tau = octa_batch(m)
    taut, taus = _tiles(tau), _soa(tau)
    for it in range(3):
        qj, vj = (_untiles(x) for x in jstep(_tiles(q), _tiles(v), taut))
        with torch.no_grad():
            qt, vt = tstep(_soa(q), _soa(v), taus)
        np.testing.assert_allclose(_unsoa(qt), qj, atol=1e-8, rtol=0, err_msg=f"q at step {it}")
        np.testing.assert_allclose(_unsoa(vt), vj, atol=1e-7, rtol=0, err_msg=f"v at step {it}")
        q, v = qj, vj


def test_convex_slots_match_the_vmap_step():
    m = octa_model()
    tstep = build_tile_step(m, output="tiles")
    q, v, tau = octa_batch(m, seed=2)
    Tq, Tv, Ttau = (torch.tensor(x) for x in (q, v, tau))
    touched = 0
    with torch.no_grad():
        for it in range(10):
            ref = step(m, State(q=Tq, v=Tv), Ttau)
            qt, vt = tstep(_soa(Tq.numpy()), _soa(Tv.numpy()), _soa(tau))
            np.testing.assert_allclose(_unsoa(qt), ref.q.numpy(), atol=1e-7, err_msg=f"q at step {it}")
            np.testing.assert_allclose(_unsoa(vt), ref.v.numpy(), atol=1e-5, err_msg=f"v at step {it}")
            touched += int((ref.q[:, 6] < 0.1).sum())
            Tq, Tv = ref.q, ref.v
    assert touched  # some vertices were below the plane


def test_topk_tie_order_matches_jax():
    """Candidates with exact ties (and a dead-slot hull of 3 vertices): the
    slots' depths and positions, slot by slot, equal the JAX version's:
    deepest first, the lower candidate index on a tie."""
    rng = np.random.RandomState(0)
    n, L = 7, 16
    levels = np.array([0.3, -0.1, 0.3, 0.05, 0.3, -0.1, 0.05])
    d = np.stack([levels[rng.permutation(n)] for _ in range(L)], 1)  # (n, L) ties in every env
    pos = rng.randn(n, 3, L)
    for k_verts in (n, 3):
        jd = [jnp.asarray(d[j])[None] for j in range(k_verts)]
        jp = [[jnp.asarray(pos[j, a])[None] for a in range(3)] for j in range(k_verts)]
        td = [torch.tensor(d[j]) for j in range(k_verts)]
        tp = [[torch.tensor(pos[j, a]) for a in range(3)] for j in range(k_verts)]
        want = jax_topk(jd, jp, 4, jd[0] * 0.0)
        got = _topk_tile_slots(td, tp, 4, td[0] * 0.0)
        assert len(got) == len(want) == 4
        for s, ((gd, gp), (wd, wp)) in enumerate(zip(got, want)):
            if wd is None:
                assert gd is None and all(x is None for x in gp), s
                continue
            np.testing.assert_array_equal(gd.numpy(), np.asarray(wd)[0], err_msg=f"slot {s}")
            for a in range(3):
                np.testing.assert_array_equal(gp[a].numpy(), np.asarray(wp[a])[0])


def test_kernel_names_the_convex_reason():
    """Kernel 1 has convex slots (4 per hull, as the plain version): the
    kernel names no reason for the octahedron, so on the card rollout_fast
    takes the fused path without a warning, and the packer lays out the
    hull's 6 vertices in the descriptor's pool. A model over a cap (a
    17-body chain) still gets its reason."""
    m = octa_model()
    assert SLOTS[GeomType.CONVEX] == 4
    assert fs.kernel_unsupported_reason(m) is None
    assert fast.supports_fused(m)
    assert fast._fallback_reason(m, torch.device("cuda")) is None
    assert fast._fallback_reason(m, torch.device("cpu")) is None
    di, df = fs.pack_descriptor(m)
    ints = dict(zip([n for n, _ in fs._I_LAYOUT], np.split(di, np.cumsum([k for _, k in fs._I_LAYOUT])[:-1])))
    floats = dict(zip([n for n, _ in fs._F_LAYOUT], np.split(df, np.cumsum([k for _, k in fs._F_LAYOUT])[:-1])))
    assert ints["pair_nvert"][0] == 6 and ints["pair_vert_off"][0] == 0
    np.testing.assert_array_equal(floats["hull_verts"][:18].reshape(6, 3), OCTA)
    b = ModelBuilder(dt=1e-3)
    prev = -1
    for _ in range(fs.MAX_NB + 1):
        prev = b.add_body(parent=prev, jtype=JointType.REVOLUTE, axis=(0, 1, 0), X_pos=(0, 0, -0.1))
    chain = b.finalize(dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError, match="bodies = 17 exceeds the kernel's cap of 16"):
        fs.pack_descriptor(chain)


def test_rollout_tiled_runs_the_plain_version_on_the_cpu():
    """The octahedron is not in the hybrid LCP mode, so rollout_tiled runs
    FusedStep, which on CPU tensors is the plain version: its final state
    equals a loop over the plain step, bit for bit. (On the card the same
    call launches the step kernel once per step.)"""
    m = octa_model()
    q, v, tau = octa_batch(m)
    taus = torch.tensor(np.stack([tau, -tau]))
    with torch.no_grad():
        fin = fs.rollout_tiled(m, State(q=torch.tensor(q), v=torch.tensor(v)), taus)
        tstep = build_tile_step(m, output="stacked")
        qs, vs = torch.tensor(q).T.contiguous(), torch.tensor(v).T.contiguous()
        for t in range(2):
            qs, vs = tstep(qs, vs, taus[t].T.contiguous())
    np.testing.assert_array_equal(fin.q.numpy(), qs.T.numpy())
    np.testing.assert_array_equal(fin.v.numpy(), vs.T.numpy())
