"""Convex-hull slots in the fused-step kernel and its VJP kernel
(diffdart_tpu_torch/ops/csrc/fused_step.cu: hull_slots, hull_vertex), float64
on the CPU through the kernels' host builds.

The model is the octahedron of tests/test_torch_tile_convex.py: a free body
whose hull has 6 vertices, on a plane; 4 slots, D = 12 LCP rows, B = 64.

* The host build of kernel 1 against the plain version (sim/tilestep.py),
  10 steps, each started from the plain version's last state (re-synced):
  q 1e-8, v 1e-7, the tolerances of tests/test_tilestep.py:386-387; and
  against the JAX package's tile step (one jit) at the same tolerances.
  JAX's Pallas kernel in interpret mode takes about 35 s on this model
  here, over this file's budget, so the JAX reference is its tile step,
  whose arithmetic that kernel runs.
* Exact ties: yaw-only attitudes keep the four equatorial vertices at one
  depth, bit for bit, below the plane; the kernel must take the same three
  of them as the plain version (the lower vertex index on a tie). Listing
  the hull's vertices in another order changes which three, and the step
  by far more than the tolerance, so the check is sharp.
* The VJP kernel's host build against torch.autograd.grad through the plain
  version at ops/vjp_check.py's limits, at random and at tie states; its
  recorded primal equals kernel 1's output bit for bit; every env records
  the same number of nodes.
* The kernel's vertex pool cap: a model over it is refused with a reason
  that names the cap.
* The kernel multiplies a hull vertex by the full rotation where the plain
  version skips zero coordinates: the two sums are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.sim.tilestep import build_tile_step as jax_build_tile_step
from diffdart_tpu_torch.dynamics.model import GeomType, JointType, ModelBuilder
from diffdart_tpu_torch.math.lie import quat_normalize
from diffdart_tpu_torch.ops import fused_step as fs
from diffdart_tpu_torch.ops import tile as T
from diffdart_tpu_torch.ops.fused_step import host_kernel_step, host_kernel_vjp
from diffdart_tpu_torch.ops.vjp_check import VJP_SHARE, envs_within
from diffdart_tpu_torch.sim import fast
from diffdart_tpu_torch.sim.tilestep import build_tile_step

from test_torch_fused_step import _needs_cxx
from test_torch_tile_convex import OCTA, octa_model
from test_torch_vmap_dynamics import jax_model_of

B = 64


def batch(seed, B=B):
    """(q, v, tau) as SoA float64 tensors (k, B): random attitudes, the
    centre 0.1 +- 0.04 above the plane (some vertices below it)."""
    rng = np.random.RandomState(seed)
    quat = quat_normalize(torch.tensor(rng.randn(B, 4))).numpy()
    pos = np.stack([0.05 * rng.randn(B), 0.05 * rng.randn(B), 0.1 + 0.04 * rng.randn(B)], 1)
    q = np.concatenate([quat, pos], 1)
    v, tau = 0.5 * rng.randn(B, 6), 0.1 * rng.randn(B, 6)
    return tuple(torch.tensor(np.ascontiguousarray(x.T)) for x in (q, v, tau))


def tie_batch(seed, B=B):
    """Yaw-only attitudes (the quaternion (cos, 0, 0, sin): the rotation's
    third row is exactly (0, 0, 1)), the centre 0.01 below the plane: the
    four equatorial vertices share one depth bit for bit, 0.01, under the
    bottom vertex's 0.11; spins about every axis make the choice among
    them matter."""
    rng = np.random.RandomState(seed)
    yaw = rng.uniform(-np.pi, np.pi, B)
    q = np.zeros((B, 7))
    q[:, 0], q[:, 3] = np.cos(yaw / 2), np.sin(yaw / 2)
    q[:, 4:6] = 0.05 * rng.randn(B, 2)
    q[:, 6] = -0.01
    v, tau = 0.5 * rng.randn(B, 6), 0.1 * rng.randn(B, 6)
    return tuple(torch.tensor(np.ascontiguousarray(x.T)) for x in (q, v, tau))


@pytest.fixture(scope="module")
def octa():
    return octa_model()


@pytest.fixture(scope="module")
def jax_step(octa):
    step = jax_build_tile_step(jax_model_of(octa), output="tiles")
    return jax.jit(lambda q, v, tau: step(q, v, tau))


def _plain(m, q, v, tau):
    with torch.no_grad():
        return build_tile_step(m)(q, v, tau)


def test_octahedron_runs_on_the_kernel(octa):
    assert fs.kernel_unsupported_reason(octa) is None
    assert fast._fallback_reason(octa, torch.device("cuda")) is None
    di, _ = fs.pack_descriptor(octa)
    assert fs.build_fused_step(octa).D == 12 and int(di[4]) == 4  # 4 slots


def test_host_kernel_matches_plain_over_resynced_steps(octa):
    _needs_cxx()
    q, v, tau = batch(1)
    touched = 0
    for it in range(10):
        qp, vp = _plain(octa, q, v, tau)
        qk, vk = host_kernel_step(octa, q, v, tau)
        np.testing.assert_allclose(qk.numpy(), qp.numpy(), atol=1e-8, rtol=0, err_msg=f"q at step {it}")
        np.testing.assert_allclose(vk.numpy(), vp.numpy(), atol=1e-7, rtol=0, err_msg=f"v at step {it}")
        touched += int((q[6] < 0.1).sum())
        q, v = qp, vp
    assert touched


def test_host_kernel_matches_jax_tile_step(octa, jax_step):
    _needs_cxx()
    q, v, tau = batch(2)

    def tiles(x):
        return tuple(jnp.asarray(x[i].numpy().reshape(8, B // 8)) for i in range(x.shape[0]))

    for it in range(3):
        qj, vj = (np.stack([np.asarray(a).reshape(B) for a in xs]) for xs in
                  jax_step(tiles(q), tiles(v), tiles(tau)))
        qk, vk = host_kernel_step(octa, q, v, tau)
        np.testing.assert_allclose(qk.numpy(), qj, atol=1e-8, rtol=0, err_msg=f"q at step {it}")
        np.testing.assert_allclose(vk.numpy(), vj, atol=1e-7, rtol=0, err_msg=f"v at step {it}")
        q, v = torch.tensor(qj), torch.tensor(vj)


def test_exact_ties_take_the_plain_versions_slots(octa):
    _needs_cxx()
    q, v, tau = tie_batch(3)
    qp, vp = _plain(octa, q, v, tau)
    qk, vk = host_kernel_step(octa, q, v, tau)
    np.testing.assert_allclose(qk.numpy(), qp.numpy(), atol=1e-8, rtol=0)
    np.testing.assert_allclose(vk.numpy(), vp.numpy(), atol=1e-7, rtol=0)
    # the same hull with its equatorial vertices listed in reverse: the tie
    # now goes to other vertices, and the step moves well past the tolerance
    other = octa_model(OCTA[[3, 2, 1, 0, 4, 5]])
    _, vo = host_kernel_step(other, q, v, tau)
    assert (vo - vk).abs().max() > 1e-3


@pytest.mark.parametrize("states", [batch, tie_batch])
def test_host_vjp_matches_plain_autograd(octa, states):
    _needs_cxx()
    q, v, tau = states(4)
    rng = np.random.RandomState(5)
    gq, gv = torch.tensor(rng.randn(7, B)), torch.tensor(rng.randn(6, B))
    xs = [x.clone().requires_grad_(True) for x in (q, v, tau)]
    want = torch.autograd.grad(build_tile_step(octa)(*xs), xs, (gq, gv))
    got, (qo, vo), _ = host_kernel_vjp(octa, q, v, tau, gq, gv)
    assert all(torch.isfinite(x).all() for x in got)
    assert envs_within(got, want) >= VJP_SHARE
    qk, vk = host_kernel_step(octa, q, v, tau)
    assert torch.equal(qo, qk) and torch.equal(vo, vk)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tape_node_count_is_the_same_in_every_env(octa, dtype):
    """A tape of exactly one env's count holds every env, at random states
    and at ties (a slot takes another vertex in each env)."""
    _needs_cxx()
    q, v, tau = batch(6, B=1)
    g = (torch.ones(7, 1), torch.ones(6, 1))
    n1 = host_kernel_vjp(octa, q, v, tau, *g, dtype=dtype)[2]
    for states in (batch, tie_batch):
        q, v, tau = states(7)
        g = (torch.ones(7, B), torch.ones(6, B))
        got, _, n2 = host_kernel_vjp(octa, q, v, tau, *g, cap=n1, dtype=dtype)
        assert n2 == n1 and all(torch.isfinite(x).all() for x in got)


def test_hulls_over_the_vertex_cap_name_it():
    """Three hulls of 32 vertices each on one body (96 in the pool, 36 LCP
    rows) are over the
    kernel's cap of 64: the reason names the cap, the packer refuses the
    model, and on the card rollout_fast would warn with the reason; the
    plain version on the CPU takes the model."""
    rng = np.random.RandomState(8)
    b = ModelBuilder(dt=2e-3)
    body = b.add_body(parent=-1, jtype=JointType.FREE, mass=1.0, inertia=np.eye(3) * 0.004)
    for k in range(3):
        pts = rng.randn(200, 3)
        b.add_geom(body, GeomType.CONVEX, verts=0.1 * pts / np.linalg.norm(pts, axis=1, keepdims=True),
                   pos=(0.1 * k, 0, 0))
    b.add_geom(-1, GeomType.PLANE)
    m = b.finalize(dtype=torch.float64, device="cpu")
    want = f"hull vertices = 96 exceeds the kernel's cap of {fs.MAX_HULL_VERTS}"
    assert fs.kernel_unsupported_reason(m) == want
    with pytest.raises(NotImplementedError, match=want):
        fs.pack_descriptor(m)
    assert want in fast._fallback_reason(m, torch.device("cuda"))
    assert fast._fallback_reason(m, torch.device("cpu")) is None


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_full_vertex_product_equals_the_plain_sum(dtype):
    """The plain version forms a hull vertex's world position with the zero
    coordinates skipped (T.matvec3 over structural zeros); the kernel
    multiplies by every coordinate. On the octahedron (two zeros per
    vertex) the two positions and depths are equal."""
    rng = np.random.RandomState(9)
    R = torch.tensor(quat_normalize(torch.tensor(rng.randn(256, 4))).numpy(), dtype=dtype)
    w_, x, y, z = R.unbind(1)
    rows = [[1 - 2 * (y * y + z * z), 2 * (x * y - w_ * z), 2 * (x * z + w_ * y)],
            [2 * (x * y + w_ * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w_ * x)],
            [2 * (x * z - w_ * y), 2 * (y * z + w_ * x), 1 - 2 * (x * x + y * y)]]
    pg = [torch.tensor(0.1 * rng.randn(256), dtype=dtype) for _ in range(3)]
    n, off = [0.0, 0.0, 1.0], 0.0
    for vl in OCTA:
        skipped = T.vadd(T.matvec3(rows, [float(a) or None for a in vl]), pg)
        full = [((rows[i][0] * float(vl[0]) + rows[i][1] * float(vl[1])) + rows[i][2] * float(vl[2]))
                + pg[i] for i in range(3)]
        for a, b in zip(skipped, full):
            assert torch.equal(a, b)
        d_skip = T.sub(off, T.dot(skipped, n))
        d_full = off - ((full[0] * n[0] + full[1] * n[1]) + full[2] * n[2])
        assert torch.equal(d_skip, d_full)
