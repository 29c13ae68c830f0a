"""The port's data-parallel layer (diffdart_tpu_torch/parallel/) on the CPU,
float64: the counterpart of tests/test_parallel.py:66-134 and
tests/test_distributed.py:34-46, then held to the JAX package.

* make_mesh on 8 explicit CPU devices, and its raises (too few devices; two
  cards in one process).
* Sharded per-env losses equal the unsharded ones bit for bit: every env's
  arithmetic in the vmap stack is row-wise, so a shard of 2 envs computes
  each env as the batch of 16 does.
* data_parallel_grad against the unsharded mean loss and its gradient at
  tests/test_parallel.py:108's rtol 1e-9, atol 1e-12 (the shard sums run
  in another order than autograd's sum over the batch), and the replicated
  gradient as the mean of the per-shard gradients at rtol 1e-7 (:134).
* Against the JAX package: cube_drop, B = 16, T = 3, a shared control tape
  (T, nv), per-env loss q_T[6]^2 (tests/test_distributed.py:84-97), the
  port's data_parallel_grad on the 8-device CPU mesh against
  jax.value_and_grad of the JAX package's meshless mean loss (one jit): the
  loss at rtol 1e-9, the gradient at rtol 1e-9 plus atol 1e-12, the limits
  at which tests/test_torch_vmap_step.py holds the port's rollout gradient
  to JAX's where no contact amplifies rounding (its cartpole drive); the
  cube falls freely for these 3 steps.
* A two-process gloo cluster on localhost: each process imports only the
  port, feeds its half of B = 16 (local_env_slice, one numpy seed) and
  gets the meshless full-batch loss and gradient within rtol 1e-12; the
  two processes agree exactly (the all-reduce leaves every rank the same
  sum).
"""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.dynamics.model import State as JState
from diffdart_tpu.models import cube_drop as jax_cube_drop
from diffdart_tpu.sim import rollout as jax_rollout
from diffdart_tpu_torch.dynamics.model import State
from diffdart_tpu_torch.models import cheetah_init_q, cube_drop, half_cheetah
from diffdart_tpu_torch.parallel import (
    data_parallel_grad, init_distributed, local_env_slice, make_global_batch, make_mesh,
    shard_batch)
from diffdart_tpu_torch.parallel.comm import Mesh, ShardedBatch
from diffdart_tpu_torch.parallel.distributed import global_mesh, process_count, process_index
from diffdart_tpu_torch.sim import step as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DEV = 8
CPUS = [torch.device("cpu")] * N_DEV
F64 = torch.float64


@pytest.fixture(scope="module")
def cheetah_batch():
    B, T = 2 * N_DEV, 3
    m = half_cheetah(dt=2e-3, dtype=F64, device="cpu")
    rng = np.random.RandomState(3)
    batch = State(q=cheetah_init_q(m).repeat(B, 1) + 0.01 * torch.tensor(rng.randn(B, m.nq)),
                  v=0.05 * torch.tensor(rng.randn(B, m.nv)))
    taus = 0.1 * torch.tensor(rng.randn(T, m.nv))
    return m, batch, taus


def _per_env_loss(m):
    def fn(taus, sb):
        b = sb.q.shape[0]
        final = S.rollout_final(m, sb, taus[:, None].expand(-1, b, -1))
        return final.q[:, 1] ** 2 + 0.1 * (final.v**2).sum(1)

    return fn


def test_mesh_has_8_devices():
    mesh = make_mesh(N_DEV, devices=CPUS)
    assert mesh.size == N_DEV and mesh.devices == tuple(CPUS)
    assert make_mesh(2, devices=CPUS).size == 2


def test_make_mesh_raises_on_too_few_devices():
    with pytest.raises(ValueError, match="requested"):
        make_mesh(N_DEV + 1, devices=CPUS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_one_process_drives_one_card():
    """A mesh over two cards in one process would run its shards one after
    another: make_mesh and shard_batch refuse it and name torchrun. A card
    repeated, or CPU devices, are one device's shards and stay allowed."""
    two = [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(devices=two)
    with pytest.raises(ValueError, match="one process drives one card"):
        shard_batch(Mesh(tuple(two)), {"q": torch.zeros(4, 1)})
    assert make_mesh(devices=[torch.device("cuda", 0)] * 2).size == 2


def test_shard_batch_splits_every_tensor_of_a_tree():
    mesh = make_mesh(4, devices=CPUS)
    tree = {"s": State(q=torch.arange(8.0)[:, None], v=torch.zeros(8, 2)),
            "x": [np.arange(16).reshape(8, 2)], "k": 3}
    sb = shard_batch(mesh, tree)
    assert isinstance(sb, ShardedBatch) and len(sb.shards) == 4 and sb.devices == mesh.devices
    assert [x["s"].q.shape[0] for x in sb.shards] == [2, 2, 2, 2]
    assert torch.equal(sb.shards[2]["s"].q[:, 0], torch.tensor([4.0, 5.0]))
    assert torch.equal(sb.shards[3]["x"][0], torch.tensor([[12, 13], [14, 15]]))
    assert sb.shards[1]["k"] == 3
    with pytest.raises(ValueError, match="evenly"):
        shard_batch(make_mesh(3, devices=CPUS), tree)


def test_sharded_loss_matches_unsharded(cheetah_batch):
    m, batch, taus = cheetah_batch
    loss_fn = _per_env_loss(m)
    ref = loss_fn(taus, batch)
    sharded = shard_batch(make_mesh(N_DEV, devices=CPUS), batch)
    got = torch.cat([loss_fn(taus, s) for s in sharded.shards])
    assert torch.equal(got, ref)


def test_data_parallel_grad_matches_unsharded(cheetah_batch):
    m, batch, taus = cheetah_batch
    loss_fn = _per_env_loss(m)
    x = taus.clone().requires_grad_(True)
    ref_loss = loss_fn(x, batch).mean()
    (ref_grad,) = torch.autograd.grad(ref_loss, x)

    mesh = make_mesh(N_DEV, devices=CPUS)
    loss, grad = data_parallel_grad(loss_fn, mesh)(taus, shard_batch(mesh, batch))
    assert torch.isfinite(loss) and ref_grad.abs().max() > 0
    np.testing.assert_allclose(loss.item(), ref_loss.item(), rtol=1e-12)
    np.testing.assert_allclose(grad.numpy(), ref_grad.numpy(), rtol=1e-9, atol=1e-12)


def test_replicated_grad_is_mean_of_per_shard_grads(cheetah_batch):
    m, batch, taus = cheetah_batch
    loss_fn = _per_env_loss(m)
    mesh = make_mesh(N_DEV, devices=CPUS)
    sharded = shard_batch(mesh, batch)
    _, grad = data_parallel_grad(loss_fn, mesh)(taus, sharded)
    g_shards = []
    for s in sharded.shards:
        x = taus.clone().requires_grad_(True)
        g_shards.append(torch.autograd.grad(loss_fn(x, s).mean(), x)[0])
    manual = torch.stack(g_shards).mean(0)
    np.testing.assert_allclose(grad.numpy(), manual.numpy(), rtol=1e-7, atol=1e-10)


def test_dict_params_and_unsharded_batch(cheetah_batch):
    """params as a dict of tensors; a batch given unsharded is sharded over
    the mesh first."""
    m, batch, taus = cheetah_batch
    base = _per_env_loss(m)

    def loss_fn(p, sb):
        return p["scale"] * base(p["taus"], sb)

    mesh = make_mesh(4, devices=CPUS)
    params = {"taus": taus, "scale": torch.tensor(2.0, dtype=F64)}
    loss, grad = data_parallel_grad(loss_fn, mesh)(params, batch)
    loss1, grad1 = data_parallel_grad(base, mesh)(taus, batch)
    np.testing.assert_allclose(loss.item(), 2 * loss1.item(), rtol=1e-14)
    np.testing.assert_allclose(grad["taus"].numpy(), 2 * grad1.numpy(), rtol=1e-14)
    np.testing.assert_allclose(grad["scale"].item(), loss1.item(), rtol=1e-14)


class TestSingleProcessDegenerate:
    def test_local_env_slice(self):
        assert process_count() == 1 and process_index() == 0
        assert local_env_slice(16) == slice(0, 16)

    def test_make_global_batch_matches_shard_batch(self):
        mesh = make_mesh(N_DEV, devices=CPUS)
        local = {"q": np.arange(32.0).reshape(16, 2)}
        g = make_global_batch(mesh, local)
        s = shard_batch(mesh, {"q": torch.tensor(local["q"])})
        assert len(g.shards) == N_DEV and g.devices == mesh.devices
        for a, b in zip(g.shards, s.shards):
            assert torch.equal(a["q"], b["q"])

    def test_init_distributed_without_configuration(self, monkeypatch):
        for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
            monkeypatch.delenv(k, raising=False)
        assert init_distributed() is False
        assert process_count() == 1
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="NCCL backend needs a CUDA device"):
                init_distributed("127.0.0.1:1", 1, 0)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                global_mesh()


def test_data_parallel_grad_matches_jax():
    B, T = 16, 3
    # the pivot refinement off on both sides: its while_loop costs XLA:CPU
    # seconds of compile time, and no contact is active here
    jm = jax_cube_drop(dt=2e-3).replace(lcp_pivot_iters=0)
    m = cube_drop(dt=2e-3, dtype=F64, device="cpu").replace(lcp_pivot_iters=0)
    rng = np.random.RandomState(11)
    q0 = np.tile(m.neutral_q().numpy(), (B, 1))
    q0[:, 6] = 0.12 + 0.005 * rng.rand(B)
    v0 = 0.05 * rng.randn(B, m.nv)
    taus = 0.5 * rng.randn(T, m.nv)

    def mean_loss(taus_j):
        def one(q, v):
            final, _ = jax_rollout(jm, JState(q=q, v=v, t=jnp.zeros(())), taus_j)
            return final.q[6] ** 2

        return jnp.mean(jax.vmap(one)(jnp.asarray(q0), jnp.asarray(v0)))

    l_j, g_j = jax.jit(jax.value_and_grad(mean_loss))(jnp.asarray(taus))

    def per_env(taus_t, sb):
        final = S.rollout_final(m, sb, taus_t[:, None].expand(-1, sb.q.shape[0], -1))
        return final.q[:, 6] ** 2

    mesh = make_mesh(N_DEV, devices=CPUS)
    batch = shard_batch(mesh, State(q=torch.tensor(q0), v=torch.tensor(v0)))
    loss, grad = data_parallel_grad(per_env, mesh)(torch.tensor(taus), batch)
    assert np.abs(np.asarray(g_j)).max() > 0
    np.testing.assert_allclose(loss.item(), float(l_j), rtol=1e-9)
    np.testing.assert_allclose(grad.numpy(), np.asarray(g_j), rtol=1e-9, atol=1e-12)


_CLUSTER_CHILD = r"""
import json, os, sys
import numpy as np
import torch
from diffdart_tpu_torch.dynamics.model import State
from diffdart_tpu_torch.models import cube_drop
from diffdart_tpu_torch.parallel import (
    data_parallel_grad, global_mesh, init_distributed, local_env_slice, make_global_batch,
    shutdown_distributed)
from diffdart_tpu_torch.parallel.distributed import process_count, process_index
from diffdart_tpu_torch.sim import step as S

pid = int(os.environ["DD_PID"])
assert init_distributed(os.environ["DD_COORD"], 2, pid, backend="gloo")
assert init_distributed(os.environ["DD_COORD"], 2, pid, backend="gloo")  # idempotent
assert process_count() == 2 and process_index() == pid
mesh = global_mesh()
assert mesh.devices == (torch.device("cpu"),) * 2, mesh

m = cube_drop(dt=2e-3, dtype=torch.float64, device="cpu")
B, T = 16, 2
rng = np.random.RandomState(7)          # the same seed in both processes
q0 = np.tile(m.neutral_q().numpy(), (B, 1))
q0[:, 6] = 0.12 + 0.02 * rng.randn(B)
v0 = 0.1 * rng.randn(B, m.nv)
taus = torch.tensor(0.3 * rng.randn(T, m.nv))
sl = local_env_slice(B)
batch = make_global_batch(mesh, State(q=torch.tensor(q0[sl]), v=torch.tensor(v0[sl])))
assert len(batch.shards) == 1 and batch.shards[0].q.shape == (B // 2, m.nq)

def per_env(taus_t, sb):
    final = S.rollout_final(m, sb, taus_t[:, None].expand(-1, sb.q.shape[0], -1))
    return final.q[:, 6] ** 2

loss, grad = data_parallel_grad(per_env, mesh)(taus, batch)
shutdown_distributed()

# the meshless full-batch computation, process-local
x = taus.clone().requires_grad_(True)
ref = per_env(x, State(q=torch.tensor(q0), v=torch.tensor(v0))).mean()
(ref_g,) = torch.autograd.grad(ref, x)
np.testing.assert_allclose(loss.item(), ref.item(), rtol=1e-12)
np.testing.assert_allclose(grad.numpy(), ref_g.numpy(), rtol=1e-12, atol=1e-12 * ref_g.abs().max().item())
assert "jax" not in sys.modules and "diffdart_tpu" not in sys.modules
print("CLUSTER2-OK " + json.dumps({"pid": pid, "loss": loss.item(), "grad": grad.flatten().tolist()}))
"""


def test_two_process_gloo_cluster():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, DD_COORD=f"127.0.0.1:{port}")
    procs = [subprocess.Popen([sys.executable, "-c", _CLUSTER_CHILD], env=dict(env, DD_PID=str(i)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    res = []
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"process {pid} failed (rc={rc}):\n{out[-2000:]}\n{err[-3000:]}"
        res.append(json.loads(out.split("CLUSTER2-OK ")[1]))
    assert [r["pid"] for r in res] == [0, 1]
    assert res[0]["loss"] == res[1]["loss"] and res[0]["grad"] == res[1]["grad"]
