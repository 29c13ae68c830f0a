"""Model data of the torch port (diffdart_tpu_torch/dynamics/model.py and
models/) against the JAX package: every field of the port-built Model equals
the JAX-built one, fields carry across with model_from_numpy /
model_to_numpy, and device selection never falls back silently."""
import dataclasses

import numpy as np
import pytest
import torch

from diffdart_tpu.dynamics import model as jax_model_mod
from diffdart_tpu.models import half_cheetah as jax_half_cheetah
from diffdart_tpu.models import jump_worm as jax_jump_worm
from diffdart_tpu_torch.dynamics import model as tm
from diffdart_tpu_torch.models import cheetah_init_q, half_cheetah, jump_worm

F64 = dict(dtype=torch.float64, device="cpu")

BUILDERS = {
    "half_cheetah": (lambda: jax_half_cheetah(dt=2e-3), lambda: half_cheetah(dt=2e-3, **F64)),
    "worm2": (lambda: jax_jump_worm(n_links=2), lambda: jump_worm(n_links=2, **F64)),
    "worm3": (lambda: jax_jump_worm(n_links=3), lambda: jump_worm(n_links=3, **F64)),
}


def _jax_fields(m) -> dict:
    """A JAX-package Model as numpy arrays and static values."""
    out = {}
    for f in dataclasses.fields(m):
        x = getattr(m, f.name)
        out[f.name] = np.asarray(x, np.float64) if hasattr(x, "dtype") and hasattr(x, "shape") else x
    return out


def _assert_same(fields_a: dict, fields_b: dict):
    assert set(fields_a) == set(fields_b)
    for name in fields_a:
        a, b = fields_a[name], fields_b[name]
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
            assert np.shape(a) == np.shape(b), name
        else:
            assert a == b, (name, a, b)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_matches_jax(name):
    jb, tb = BUILDERS[name]
    _assert_same(tm.model_to_numpy(tb()), _jax_fields(jb()))


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_model_from_numpy_of_jax_model(name):
    jb, tb = BUILDERS[name]
    carried = tm.model_from_numpy(_jax_fields(jb()), device="cpu", dtype=torch.float64)
    _assert_same(tm.model_to_numpy(carried), tm.model_to_numpy(tb()))
    assert carried.mass.dtype == torch.float64 and carried.device.type == "cpu"


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_numpy_round_trip_is_identity(name):
    m = BUILDERS[name][1]()
    back = tm.model_from_numpy(tm.model_to_numpy(m), device="cpu", dtype=torch.float64)
    _assert_same(tm.model_to_numpy(back), tm.model_to_numpy(m))


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_derived_topology_matches_jax(name):
    jb, tb = BUILDERS[name]
    j, t = jb(), tb()
    np.testing.assert_array_equal(t.ancestor_mask, j.ancestor_mask)
    assert t.dof_body == j.dof_body and t.nbody == j.nbody and t.ngeom == j.ngeom
    np.testing.assert_array_equal(t.neutral_q().numpy(), np.asarray(j.neutral_q()))


def test_servo_and_joint_friction_match_jax():
    jm = jax_half_cheetah(dt=2e-3)
    m = half_cheetah(dt=2e-3, **F64)
    leg = tuple(range(3, m.nv))
    tgt = np.zeros(m.nv)
    tgt[3:] = [1.5, -1.0, 0.8, -1.2, 1.0, -0.6]
    jm = jax_model_mod.enable_joint_friction(
        jax_model_mod.enable_servo(jm, leg, force_limit=8.0, target=tgt), leg, friction=0.4)
    m = tm.enable_joint_friction(tm.enable_servo(m, leg, force_limit=8.0, target=tgt), leg, friction=0.4)
    _assert_same(tm.model_to_numpy(m), _jax_fields(jm))


def test_cheetah_init_q_and_state():
    m = half_cheetah(**F64)
    q = cheetah_init_q(m)
    assert q.dtype == torch.float64 and q.shape == (m.nq,) and float(q[0]) == 0.6
    s = tm.make_state(m, q=q)
    assert s.v.shape == (m.nv,) and float(s.t) == 0.0


def test_replace_and_frozen():
    m = jump_worm(n_links=2, **F64)
    assert m.replace(lcp_pivot_iters=0).lcp_pivot_iters == 0 and m.lcp_pivot_iters == 16
    with pytest.raises(dataclasses.FrozenInstanceError):
        m.nq = 3


def test_model_from_numpy_rejects_unknown_fields():
    fields = tm.model_to_numpy(jump_worm(n_links=2, **F64))
    fields["bogus"] = 1
    with pytest.raises(ValueError, match="bogus"):
        tm.model_from_numpy(fields, device="cpu")


def test_convex_geom_raises():
    """A CONVEX geom, which raised here until hulls were ported, is built:
    its hull (a box's 8 corners, 12 triangular faces) and every field equal
    the JAX-built model's; one without verts raises."""
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-2, 2) for z in (-0.5, 0.5)], float)
    models = []
    for mod, kw in ((tm, F64), (jax_model_mod, {})):
        b = mod.ModelBuilder()
        body = b.add_body(parent=-1, jtype=mod.JointType.FREE)
        b.add_geom(body, mod.GeomType.CONVEX, verts=corners + 0.1)
        models.append(b.finalize(**kw))
    m, jm = models
    assert m.geom_hull == (0,) and m.hull_vcounts == (8,) and m.hull_fcounts == (12,)
    _assert_same(tm.model_to_numpy(m), _jax_fields(jm))
    with pytest.raises(ValueError, match="requires verts"):
        tm.ModelBuilder().add_geom(-1, tm.GeomType.CONVEX)


def test_cuda_default_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        jump_worm(n_links=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.model_from_numpy(tm.model_to_numpy(jump_worm(n_links=2, **F64)))
