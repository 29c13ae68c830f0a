"""The benchmark's plain reference: rollouts of a configuration's model,
built by the frozen copies in this folder from the configuration's own
numbers, on the inputs the harness hands to the program as well.

The step is sim/tilestep.py's, the element-wise fused step on (k, B)
tensors: the plain version of the fused kernels, op for op.
Nothing here imports the program (diffdart_tpu_torch) or JAX.

`compute_dtype` runs the same step in another dtype than the model's (the
tile step's constants are folded from the model's build): the bfloat16
control of `portbench/control.py` for a float32 configuration.
"""
from __future__ import annotations

import importlib

import torch


def resolve(spec: str):
    """'package.module:attr' -> the attribute."""
    module, _, attr = spec.partition(":")
    return getattr(importlib.import_module(module), attr)


def build_model(config: dict, device, dtype=torch.float32):
    """The configuration's model, built by the reference's own builder."""
    spec = config["model"]
    return resolve(spec["reference"])(device=device, dtype=dtype, **spec.get("kwargs", {}))


def _one_step(model):
    """(q, v, tau) -> (q', v') in the batch-first layout."""
    from portbench.reference.sim.tilestep import build_tile_step

    tstep = build_tile_step(model, output="stacked")

    def one(q, v, tau):
        qn, vn = tstep(q.T.contiguous(), v.T.contiguous(), tau.T.contiguous())
        return qn.T, vn.T

    return one


def final_state(model, q, v, taus, compute_dtype=None):
    """The final (q, v) of a rollout: q (B, nq), v (B, nv), taus (T, B, nv),
    batch-first, in compute_dtype (default: q's)."""
    dtype = compute_dtype or q.dtype
    q, v, taus = q.to(dtype), v.to(dtype), taus.to(dtype)
    one = _one_step(model)
    for t in range(taus.shape[0]):
        q, v = one(q, v, taus[t])
    return q, v


def bptt(model, q, v, taus, loss: dict, batch: int, compute_dtype=None):
    """(q_T, v_T, d loss / d taus) for the rows given, where the loss is the
    traffic's, mean(q_T[:, i]^2) + w mean(taus^2) over a batch of `batch`
    envs: the rows' share of it, so each row's gradient is the one it has
    in the whole batch."""
    taus = taus.detach().to(compute_dtype or taus.dtype).requires_grad_(True)
    with torch.enable_grad():
        qf, vf = final_state(model, q, v, taus, compute_dtype)
        T, _, nv = taus.shape
        value = ((qf[:, loss["q_index"]] ** 2).sum() / batch
                 + loss["tau_weight"] * (taus ** 2).sum() / (T * batch * nv))
        (g,) = torch.autograd.grad(value, taus)
    return qf.detach(), vf.detach(), g
