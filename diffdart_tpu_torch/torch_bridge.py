"""The reference's dart_torch.timestep (python/diffdart/dart_torch.py) on the
port's own step.

Counterpart of diffdart_tpu/torch_bridge.py. There the bridge wraps the JAX
step in a torch.autograd.Function with host copies each way; here the step
is already torch, so `timestep` is an alias of sim/step.py::step on torch
tensors: autograd flows through it natively (the low-rank LCP's IFT
backward included), on the tensors' own device, with no copy and no cache.
"""
from __future__ import annotations

from diffdart_tpu_torch.dynamics.model import Model, State
from diffdart_tpu_torch.sim.step import step


def timestep(model: Model, q, v, tau):
    """One differentiable physics step:
        q_next, v_next = timestep(model, q, v, tau)
    q (nq,) or (B, nq), v and tau (nv,) or (B, nv), on the model's device;
    the outputs have the inputs' shapes."""
    one = q.dim() == 1
    if one:
        q, v, tau = q[None], v[None], tau[None]
    s = step(model, State(q=q, v=v), tau)
    return (s.q[0], s.v[0]) if one else (s.q, s.v)
