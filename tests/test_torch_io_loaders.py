"""The port's scene loaders (diffdart_tpu_torch/io: skel.py, sdf.py, vsk.py,
mjcf.py and load_into_builder) against the JAX package's, float64 on the
CPU.

Each scene (the SKEL, SDF and VSK strings of tests/test_io.py and
tests/test_vsk.py, and tests/test_io.py's anchored MJCF, which needs the
`mujoco` package) is loaded into both packages' builders: every field of
the two Models agrees to 1e-12 (array fields) or exactly (static fields).
Then 5 steps of 4 envs from seeded velocities and torques agree within q
1e-9 and v 1e-6 (the JAX step is one jit per scene). load_into_builder
picks the loader by extension and by root tag as the JAX package's does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffdart_tpu.io as jio
from diffdart_tpu.dynamics.model import ModelBuilder as JBuilder
from diffdart_tpu.dynamics.model import State as JState
from diffdart_tpu.sim.step import step as jax_step
import diffdart_tpu_torch.io as tio
from diffdart_tpu_torch.dynamics.model import ModelBuilder, State, model_to_numpy
from diffdart_tpu_torch.sim.step import step

from test_io import MJCF_ANCHORED, SDF_PENDULUM, SKEL_PENDULUM, URDF_2LINK
from test_vsk import VSK

SDF_STATIC = """
<sdf version="1.9"><world name="w">
  <model name="ground"><static>true</static>
    <link name="g">
      <collision name="c">
        <geometry><plane><normal>0 0 1</normal></plane></geometry>
        <surface>
          <friction><ode><mu>1.25</mu></ode></friction>
          <bounce><restitution_coefficient>0.5</restitution_coefficient></bounce>
        </surface>
      </collision>
    </link>
  </model>
  <model name="egg">
    <link name="body">
      <pose>0 0 0.5 0 0 0</pose>
      <inertial><mass>1.0</mass>
        <inertia><ixx>0.01</ixx><iyy>0.01</iyy><izz>0.01</izz></inertia>
      </inertial>
      <collision name="e">
        <geometry><ellipsoid><radii>0.1 0.15 0.2</radii></ellipsoid></geometry>
      </collision>
    </link>
  </model>
</world></sdf>"""  # tests/test_io.py:239

# name -> (scene text, JAX loader, port loader)
SCENES = {
    "skel": (SKEL_PENDULUM, jio.load_skel_into_builder, tio.load_skel_into_builder),
    "sdf": (SDF_PENDULUM, jio.load_sdf_into_builder, tio.load_sdf_into_builder),
    "sdf_static": (SDF_STATIC, jio.load_sdf_into_builder, tio.load_sdf_into_builder),
    "vsk": (VSK, jio.load_vsk_into_builder, tio.load_vsk_into_builder),
    "mjcf": (MJCF_ANCHORED, jio.load_mjcf_into_builder, tio.load_mjcf_into_builder),
}


def load_pair(name):
    """(port Model float64 on the CPU, JAX Model float64) of one scene."""
    text, jload, tload = SCENES[name]
    if name == "mjcf":
        pytest.importorskip("mujoco")
    jb, tb = JBuilder(), ModelBuilder()
    jload(jb, text)
    tload(tb, text)
    return tb.finalize(dtype=torch.float64, device="cpu"), jb.finalize(dtype=jnp.float64)


def assert_models_equal(m, jm):
    for name, x in model_to_numpy(m).items():
        y = getattr(jm, name)
        if isinstance(x, np.ndarray):
            np.testing.assert_allclose(x, np.asarray(y, np.float64), atol=1e-12, rtol=0, err_msg=name)
        else:
            assert x == y or np.array_equal(np.asarray(x), np.asarray(y)), name


@pytest.mark.parametrize("name", sorted(SCENES))
def test_models_agree(name):
    m, jm = load_pair(name)
    assert_models_equal(m, jm)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_five_steps_agree(name):
    m, jm = load_pair(name)
    B = 4
    rng = np.random.RandomState(0)
    q = np.tile(m.neutral_q().numpy(), (B, 1))
    v, tau = 0.3 * rng.randn(B, m.nv), 0.5 * rng.randn(B, m.nv)
    jf = jax.jit(jax.vmap(lambda q_, v_, t_: jax_step(jm, JState(q=q_, v=v_, t=jnp.zeros(())), t_)))
    jq, jv = jnp.asarray(q), jnp.asarray(v)
    s = State(q=torch.tensor(q), v=torch.tensor(v))
    with torch.no_grad():
        for it in range(5):
            js = jf(jq, jv, jnp.asarray(tau))
            jq, jv = js.q, js.v
            s = step(m, s, torch.tensor(tau))
            np.testing.assert_allclose(s.q.numpy(), np.asarray(jq), atol=1e-9, rtol=0, err_msg=f"q {it}")
            np.testing.assert_allclose(s.v.numpy(), np.asarray(jv), atol=1e-6, rtol=0, err_msg=f"v {it}")
    assert np.abs(s.q.numpy() - q).max() > 1e-4  # the scene moved


def test_load_into_builder_dispatch(tmp_path):
    """By extension (.urdf, .skel, .sdf, .world, .vsk) and, for .xml files
    and strings, by root tag (<robot>, <world>, <mujoco> when mujoco is
    present): the port's Model equals the JAX package's from its own
    load_into_builder; an unknown format raises ValueError in both."""
    files = {"a.urdf": URDF_2LINK, "b.skel": SKEL_PENDULUM, "c.sdf": SDF_PENDULUM,
             "d.world": SDF_STATIC, "e.vsk": VSK, "f.xml": URDF_2LINK, "g.xml": SKEL_PENDULUM}
    cases = []
    for fname, text in files.items():
        (tmp_path / fname).write_text(text)
        cases.append(str(tmp_path / fname))
    cases += [URDF_2LINK, SKEL_PENDULUM]
    try:
        import mujoco  # noqa: F401

        (tmp_path / "h.xml").write_text(MJCF_ANCHORED)
        cases += [str(tmp_path / "h.xml"), MJCF_ANCHORED]
    except ImportError:
        pass
    for case in cases:
        jb, tb = JBuilder(), ModelBuilder()
        jio.load_into_builder(jb, case)
        tio.load_into_builder(tb, case)
        assert_models_equal(tb.finalize(dtype=torch.float64, device="cpu"), jb.finalize(dtype=jnp.float64))
    (tmp_path / "x.obj").write_text("v 0 0 0\n")
    for load, builder in ((jio.load_into_builder, JBuilder()), (tio.load_into_builder, ModelBuilder())):
        with pytest.raises(ValueError, match="unsupported scene format"):
            load(builder, str(tmp_path / "x.obj"))


def test_mjcf_without_mujoco_names_it(monkeypatch):
    """Where `mujoco` is missing (the card's machine), loading an MJCF scene
    raises ImportError naming it; importing the loader does not need it."""
    import builtins

    real = builtins.__import__

    def no_mujoco(name, *a, **kw):
        if name == "mujoco":
            raise ImportError("No module named 'mujoco'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mujoco)
    with pytest.raises(ImportError, match="mujoco"):
        tio.load_into_builder(ModelBuilder(), MJCF_ANCHORED)
