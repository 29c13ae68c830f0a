"""Element algebra of the torch port (diffdart_tpu_torch/ops/tile.py) against
diffdart_tpu/ops/tile.py on random (B,) inputs: each op over every mix of
structural zero (None), constant (float) and live operands, and the small
linear algebra and quaternion helpers. A live element is a (B,) float64
tensor in the port and a (S, L) tile in JAX; constant and None results must
fold identically. Live results agree to 1e-14 relative (the same IEEE ops;
JAX's rsqrt and transcendental kernels may differ by an ulp)."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.ops import tile as JT
from diffdart_tpu_torch.ops import tile as TT

B = 16
S, L = 2, 8
RTOL = 1e-14


def _pair(x):
    """numpy (B,) -> (torch element, jax element); constants pass through."""
    if x is None or isinstance(x, float):
        return x, x
    return torch.tensor(x), jnp.asarray(x.reshape(S, L))


def _same(t, j, rtol=RTOL, atol=0.0):
    if t is None or isinstance(t, (int, float)):
        assert type(t) is type(j) or (isinstance(j, float) and isinstance(t, float)), (t, j)
        if t is not None:
            assert t == pytest.approx(j, rel=rtol, abs=0)
        return
    jt = np.asarray(j)
    tt = t.detach().numpy()
    if jt.shape == (S, L):
        jt = jt.reshape(B)
    np.testing.assert_allclose(np.broadcast_to(tt, (B,)), np.broadcast_to(jt.reshape(-1), (B,)),
                               rtol=rtol, atol=atol)


def _live(seed, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, B)


KINDS = {"none": None, "zero": 0.0, "one": 1.0, "const": -0.75, "live": "live"}
BINARY = ["add", "sub", "mul", "fma", "maximum", "minimum"]


def _operand(kind, seed):
    return _live(seed) if kind == "live" else KINDS[kind]


@pytest.mark.parametrize("op", BINARY)
@pytest.mark.parametrize("ka,kb", list(itertools.product(KINDS, repeat=2)))
def test_binary_op_folding_matches_jax(op, ka, kb):
    a_t, a_j = _pair(_operand(ka, 1))
    b_t, b_j = _pair(_operand(kb, 2))
    if op == "fma":
        c_t, c_j = _pair(_live(3))
        _same(TT.fma(c_t, a_t, b_t), JT.fma(c_j, a_j, b_j))
    else:
        _same(getattr(TT, op)(a_t, b_t), getattr(JT, op)(a_j, b_j))


@pytest.mark.parametrize("ka", ["none", "zero", "const", "live"])
@pytest.mark.parametrize("kb", ["const", "live"])
def test_div_matches_jax(ka, kb):
    a_t, a_j = _pair(_operand(ka, 4))
    b_t, b_j = _pair(_operand(kb, 5))
    _same(TT.div(a_t, b_t), JT.div(a_j, b_j))


@pytest.mark.parametrize("op", ["neg", "abs_", "sqrt", "rsqrt"])
@pytest.mark.parametrize("kind", ["none", "const", "live"])
def test_unary_op_matches_jax(op, kind):
    if op in ("sqrt", "rsqrt") and kind == "none":
        pytest.skip("sqrt/rsqrt of a structural zero is not defined in either package")
    x = _live(6, 0.1, 3.0) if kind == "live" else (2.25 if kind == "const" else None)
    t, j = _pair(x)
    _same(getattr(TT, op)(t), getattr(JT, op)(j), rtol=1e-15 if op != "rsqrt" else 1e-14)


def test_clip_where_materialize_gt0_match_jax():
    x_t, x_j = _pair(_live(7))
    _same(TT.clip(x_t, -0.5, 0.7), JT.clip(x_j, -0.5, 0.7))
    _same(TT.clip(x_t, TT.neg(x_t), 0.3), JT.clip(x_j, JT.neg(x_j), 0.3))
    c_t, c_j = x_t > 0, x_j > 0
    like_t, like_j = torch.zeros(B, dtype=torch.float64), jnp.zeros((S, L))
    for a, b in [(x_t, None), (None, x_t), (1.0, None), (x_t, 2.0)]:
        aj = x_j if a is x_t else a
        bj = x_j if b is x_t else b
        _same(TT.where(c_t, a, b, like=like_t), JT.where(c_j, aj, bj, like=like_j))
    for v in (None, 1.5, x_t):
        _same(TT.materialize(v, like_t), JT.materialize(x_j if v is x_t else v, like_j))
    assert torch.equal(TT.gt0(x_t, like_t), torch.tensor(np.asarray(JT.gt0(x_j, like_j)).reshape(B)))
    assert TT.where(c_t, 1.0, None, like=like_t.float()).dtype == torch.float32
    with pytest.raises(ValueError):
        TT.where(c_t, 1.0, None)


def test_where_constant_branches_keep_dtype():
    """Two constant branches take `like`'s dtype, never a default dtype."""
    c = torch.tensor([True, False])
    for dt in (torch.float32, torch.float64):
        assert TT.where(c, 1.0, 0.0, like=torch.zeros(2, dtype=dt)).dtype == dt


def _spd(seed, n, live=True):
    rng = np.random.RandomState(seed)
    A = rng.randn(B, n, n)
    M = np.einsum("bij,bkj->bik", A, A) + n * np.eye(n)
    Mt = [[torch.tensor(M[:, i, j]) for j in range(n)] for i in range(n)]
    Mj = [[jnp.asarray(M[:, i, j].reshape(S, L)) for j in range(n)] for i in range(n)]
    return M, Mt, Mj


@pytest.mark.parametrize("n", [1, 3, 6])
def test_chol_solve_matches_jax(n):
    M, Mt, Mj = _spd(8, n)
    rhs = np.random.RandomState(9).randn(B, n)
    b_t = [torch.tensor(rhs[:, i]) if i % 2 == 0 else (None if i % 3 else 0.5) for i in range(n)]
    b_j = [jnp.asarray(rhs[:, i].reshape(S, L)) if i % 2 == 0 else (None if i % 3 else 0.5)
           for i in range(n)]
    Lt, Lj = TT.chol_factor(Mt), JT.chol_factor(Mj)
    for i in range(n):
        for j in range(i + 1):
            _same(Lt[i][j], Lj[i][j])
    for xt, xj in zip(TT.chol_solve(Lt, b_t), JT.chol_solve(Lj, b_j)):
        _same(xt, xj)


@pytest.mark.parametrize("n", [2, 5])
def test_solve_ge_matches_jax(n):
    rng = np.random.RandomState(10 + n)
    A = rng.randn(B, n, n) + 4 * np.eye(n)
    A[:, 0, n - 1] = 0.0
    At = [[torch.tensor(A[:, i, j]) for j in range(n)] for i in range(n)]
    Aj = [[jnp.asarray(A[:, i, j].reshape(S, L)) for j in range(n)] for i in range(n)]
    At[n - 1][0] = Aj[n - 1][0] = None  # structural zero below the diagonal
    rhs = rng.randn(B, n)
    xt = TT.solve_ge(At, [torch.tensor(rhs[:, i]) for i in range(n)])
    xj = JT.solve_ge(Aj, [jnp.asarray(rhs[:, i].reshape(S, L)) for i in range(n)])
    for a, b in zip(xt, xj):
        _same(a, b, rtol=1e-13)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_safe_div_matches_jax(dtype):
    num = _live(11)
    den = _live(12)
    den[::4] = 1e-25  # dead denominators: 0 in f32, plain division in f64
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    t = TT.safe_div(torch.tensor(num, dtype=dtype), torch.tensor(den, dtype=dtype))
    j = JT.safe_div(jnp.asarray(num.reshape(S, L), jdt), jnp.asarray(den.reshape(S, L), jdt))
    np.testing.assert_allclose(t.numpy(), np.asarray(j).reshape(B), rtol=1e-6 if dtype == torch.float32 else 1e-15)
    if dtype == torch.float32:
        assert (t[::4] == 0).all()
    assert TT.safe_div(None, torch.tensor(den)) is None
    assert TT.safe_div(1.0, 1e-30) is None and TT.safe_div(1.0, 4.0) == 0.25


@pytest.mark.parametrize("axis", [(0, 1, 0), (0, 0, 1), (0.6, 0.0, 0.8)])
def test_exp_so3_const_axis_matches_jax(axis):
    th_t, th_j = _pair(_live(13, -3, 3))
    for rt, rj in zip(sum(TT.exp_so3_const_axis(axis, th_t), []), sum(JT.exp_so3_const_axis(axis, th_j), [])):
        _same(rt, rj)
    const_t = sum(TT.exp_so3_const_axis(axis, 0.3), [])
    const_j = sum(JT.exp_so3_const_axis(axis, 0.3), [])
    for rt, rj in zip(const_t, const_j):
        _same(rt, rj)


@pytest.mark.parametrize("scale", [1.0, 1e-5])
def test_quaternion_helpers_match_jax(scale):
    """scale 1e-5 takes the small-angle Taylor branch of quat_exp. Products
    of unit quaternions cancel, so those compare with an absolute 1e-15."""
    rng = np.random.RandomState(14)
    q = rng.randn(4, B)
    w = scale * rng.randn(3, B)
    qt, qj = [torch.tensor(x) for x in q], [jnp.asarray(x.reshape(S, L)) for x in q]
    wt, wj = [torch.tensor(x) for x in w], [jnp.asarray(x.reshape(S, L)) for x in w]
    nt, nj = TT.quat_normalize_t(qt), JT.quat_normalize_t(qj)
    for a, b in zip(nt, nj):
        _same(a, b)
    for a, b in zip(sum(TT.quat_to_mat_t(nt), []), sum(JT.quat_to_mat_t(nj), [])):
        _same(a, b, atol=1e-15)
    et, ej = TT.quat_exp_t(wt), JT.quat_exp_t(wj)
    for a, b in zip(et, ej):
        _same(a, b)
    for a, b in zip(TT.quat_mul_t(nt, et), JT.quat_mul_t(nj, ej)):
        _same(a, b, atol=1e-15)
    assert TT.quat_exp_t([None, None, None]) == [1.0, None, None, None]


def test_spatial_helpers_match_jax():
    R = [[_pair(_live(20 + 3 * i + j)) for j in range(3)] for i in range(3)]
    Rt = [[x[0] for x in row] for row in R]
    Rj = [[x[1] for x in row] for row in R]
    p = [_pair(_live(30 + i)) for i in range(3)]
    pt, pj = [x[0] for x in p], [x[1] for x in p]
    w = [1.0, None, 0.5]
    ta, ja = TT.spatial_transform_motion(Rt, pt, w, [None, 2.0, None]), \
        JT.spatial_transform_motion(Rj, pj, w, [None, 2.0, None])
    for a, b in zip(ta[0] + ta[1], ja[0] + ja[1]):
        _same(a, b)
    for a, b in zip(sum(TT.matmul3(Rt, TT.transpose3(Rt)), []), sum(JT.matmul3(Rj, JT.transpose3(Rj)), [])):
        _same(a, b)
    for a, b in zip(TT.matTvec3(Rt, pt) + TT.cross3(pt, w), JT.matTvec3(Rj, pj) + JT.cross3(pj, w)):
        _same(a, b)


def test_gradients_split_at_ties_like_jax():
    """maximum/minimum give half the gradient to each side at a tie, as
    jax.lax does; abs has zero gradient at 0."""
    x = torch.tensor([0.0, 1.0, -1.0], dtype=torch.float64, requires_grad=True)
    (TT.maximum(x, 0.0).sum() + TT.minimum(x, 1.0).sum() + TT.abs_(x).sum()).backward()
    np.testing.assert_array_equal(x.grad.numpy(), [0.5 + 1.0 + 0.0, 1.0 + 0.5 + 1.0, 0.0 + 1.0 - 1.0])
