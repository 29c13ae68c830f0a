"""ops/fused_step.py and sim/fast.py of the torch port.

* One step of the port's fused step on the worm at B = 1024 against the
  TPU kernel itself, build_pallas_step(interpret=True) of the JAX package.
* The CUDA kernel's per-env code, compiled for the host CPU, against the
  plain PyTorch version (float64, worm and half-cheetah): the kernel's
  arithmetic is checked here although the kernel itself runs only on a card.
* rollout_fast on the CPU against a loop over the plain version.
* What must raise: models outside the fused subset or the kernel's subset,
  GPU inputs that require grad (the backward kernel is the next slice).
* The port imports neither jax nor the JAX package.
"""
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.models import jump_worm as jax_jump_worm
from diffdart_tpu.ops.pallas_step import build_pallas_step, from_tiles, to_tiles
from diffdart_tpu_torch.dynamics.model import GeomType, JointType, ModelBuilder, State
from diffdart_tpu_torch.models import half_cheetah, jump_worm
from diffdart_tpu_torch.ops import fused_step as fs
from diffdart_tpu_torch.sim.fast import rollout_fast, supports_fused
from diffdart_tpu_torch.sim.tilestep import TileStepUnsupported, build_tile_step

from test_torch_cuda import KERNEL_MODELS, WORM_Q0
from test_torch_cuda import inputs as _inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _soa(x, **kw):
    return torch.tensor(np.ascontiguousarray(x.T), **kw)


def _worm(**kw):
    return jump_worm(dt=2e-3, n_links=2, dtype=torch.float64, device="cpu", **kw)


def test_fused_step_matches_pallas_kernel_interpret():
    """Port vs the TPU kernel (interpret mode) on one (8, 128) block. The
    interpret-mode kernel is an XLA:CPU program, whose rounding differs from
    op-by-op evaluation by up to ~1e-7 relative after the eps/cfm
    amplification of the Woodbury polish (2.7e-7 absolute at |v| = 13 on 4
    of these 4096 values), hence the relative term on v."""
    jm = jax_jump_worm(dt=2e-3, n_links=2).replace(lcp_pivot_iters=0)
    m = _worm()
    q, v, tau = _inputs(WORM_Q0, m.nq, m.nv, B=1024, seed=1)
    qj, vj = build_pallas_step(jm, interpret=True)(
        *(to_tiles(jnp.asarray(x)) for x in (q, v, tau)))
    with torch.no_grad():
        qt, vt = fs.build_fused_step(m)(_soa(q), _soa(v), _soa(tau))
    np.testing.assert_allclose(qt.T.numpy(), np.asarray(from_tiles(qj)), atol=1e-8, rtol=0)
    np.testing.assert_allclose(vt.T.numpy(), np.asarray(from_tiles(vj)), atol=1e-7, rtol=1e-7)


@pytest.mark.parametrize("model", sorted(KERNEL_MODELS))
def test_host_build_of_kernel_matches_plain_version(model):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    m, q0 = KERNEL_MODELS[model](torch.float64, "cpu")
    q, v, tau = (_soa(x) for x in _inputs(q0, m.nq, m.nv, B=64, seed=2))
    with torch.no_grad():
        qp, vp = build_tile_step(m)(q, v, tau)
    qk, vk = fs.host_kernel_step(m, q, v, tau)
    np.testing.assert_allclose(qk.numpy(), qp.numpy(), atol=1e-8, rtol=0)
    np.testing.assert_allclose(vk.numpy(), vp.numpy(), atol=1e-7, rtol=0)


def test_rollout_fast_cpu_matches_plain_loop():
    m = _worm()
    B, T = 8, 6
    q, v, _ = _inputs(WORM_Q0, m.nq, m.nv, B=B, seed=3)
    taus = 0.1 * np.random.RandomState(4).randn(T, B, m.nv)
    state = State(q=torch.tensor(q), v=torch.tensor(v), t=torch.zeros(B, dtype=torch.float64))
    with torch.no_grad():
        out = rollout_fast(m, state, torch.tensor(taus))
        step = build_tile_step(m)
        qs, vs = _soa(q), _soa(v)
        for t in range(T):
            qs, vs = step(qs, vs, _soa(taus[t]))
    np.testing.assert_array_equal(out.q.numpy(), qs.T.numpy())
    np.testing.assert_array_equal(out.v.numpy(), vs.T.numpy())
    np.testing.assert_allclose(out.t.numpy(), T * 2e-3)


def test_rollout_fast_cpu_gradient_flows():
    m = _worm()
    q, v, tau = _inputs(WORM_Q0, m.nq, m.nv, B=4, seed=5)
    taus = torch.tensor(np.tile(tau[None], (3, 1, 1)) * 0.3, requires_grad=True)
    out = rollout_fast(m, State(q=torch.tensor(q), v=torch.tensor(v)), taus)
    (out.q**2).sum().backward()
    assert torch.isfinite(taus.grad).all() and taus.grad.abs().sum() > 0


def test_soa_round_trip():
    x = torch.arange(12.0).reshape(4, 3)
    assert fs.to_soa(x).shape == (3, 4) and fs.to_soa(x).is_contiguous()
    assert torch.equal(fs.from_soa(fs.to_soa(x)), x)


def test_unsupported_models_raise():
    b = ModelBuilder(dt=1e-3)
    b.add_body(parent=-1, jtype=JointType.UNIVERSAL)
    universal = b.finalize(dtype=torch.float64, device="cpu")
    with pytest.raises(TileStepUnsupported):
        fs.build_fused_step(universal)
    assert not supports_fused(universal)
    with pytest.raises(NotImplementedError, match="vmap"):
        rollout_fast(universal, State(q=torch.zeros(2, 2), v=torch.zeros(2, 2)),
                     torch.zeros(1, 2, 2))
    # in the plain version's subset, over a kernel cap: 17 contact pairs
    b = ModelBuilder(dt=1e-3)
    b.add_geom(-1, GeomType.PLANE)
    body = b.add_body(parent=-1, jtype=JointType.FREE)
    for k in range(fs.MAX_PAIRS + 1):
        b.add_geom(body, GeomType.SPHERE, size=(0.1, 0, 0), pos=(0.1 * k, 0, 0))
    many = b.finalize(dtype=torch.float64, device="cpu")
    assert supports_fused(many)
    with pytest.raises(NotImplementedError, match="cap"):
        fs.pack_descriptor(many)
    # model parameters that require grad would be baked as constants
    worm = _worm()
    traced = worm.replace(mass=worm.mass.clone().requires_grad_(True))
    with pytest.raises(NotImplementedError, match="require grad"):
        rollout_fast(traced, State(q=torch.zeros(2, 4), v=torch.zeros(2, 4)), torch.zeros(1, 2, 4))


def test_gpu_inputs_that_require_grad_raise():
    """Inputs off the CPU never reach the plain version: with grad required
    they raise before any launch (meta tensors stand in for CUDA ones)."""
    step = fs.build_fused_step(_worm())
    q = torch.zeros(4, 8, device="meta", dtype=torch.float64, requires_grad=True)
    v = torch.zeros(4, 8, device="meta", dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="backward kernel"):
        step(q, v, v)
    with torch.no_grad(), pytest.raises(ValueError, match="unsupported device"):
        step(q, v, v)


def test_descriptor_layout_and_caps():
    di, df = fs.pack_descriptor(half_cheetah(dtype=torch.float64, device="cpu"))
    assert di.dtype == np.int32 and df.dtype == np.float64
    # nb nq nv pairs nc nlim nservo nfric D iters passes
    assert di[:11].tolist() == [7, 9, 9, 5, 10, 6, 0, 0, 42, 4, 2]
    assert fs.kernel_unsupported_reason(_worm().replace(contact_iters=4)) is None
    b = ModelBuilder(dt=1e-3)
    prev = -1
    for _ in range(fs.MAX_NB + 1):
        prev = b.add_body(parent=prev, jtype=JointType.REVOLUTE)
    assert "cap" in fs.kernel_unsupported_reason(b.finalize(dtype=torch.float64, device="cpu"))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import diffdart_tpu_torch as p\n"
        "for mod in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(mod.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'diffdart_tpu' or n.startswith('diffdart_tpu.')]\n"
        "print(len([n for n in sys.modules if n.startswith('diffdart_tpu_torch')]), bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: val for k, val in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 12, proc.stdout
