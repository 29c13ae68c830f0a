"""How the VJP kernel (ops/csrc/fused_step.cu, `fused_step_vjp`) is held to
its plain version. chip_smoke.py, tests/test_torch_*.py and
scripts/torch_port_parity.py all use these limits and comparisons.

float64, against torch.autograd.grad through the plain version (reverse
mode): each of dq, dv, dtau within rtol VJP_RTOL plus atol VJP_ATOL times its
largest magnitude, on >= VJP_SHARE of envs (`envs_within`). The Woodbury
pass amplifies rounding by about eps/cfm, so a code that rounds differently
(another mode, another order of a sum, another ulp in sin/cos) differs by
that much; torch's own forward and reverse modes of the plain version
differ by up to 3.4e-9 times the largest magnitude (free_cube, B = 64,
scripts/torch_port_parity.py). An env may also differ where the other
code's rounding moves a row across an active-set tolerance, hence the share.

float32, against reverse-mode autograd of the plain float32 step
(`reverse_mode_vjp`): the kernel's own mode on the same primal (kernel 1 and
the plain version agree bit for bit in float32 on the card). The kernel
records the plain version's operations in its order with torch's backward
formulas as partials, and sweeps them in the order torch's engine runs the
backward (highest sequence number first), so its adjoint sums round as
torch's do up to where the two codes create operations in another order.
Two float32 VJPs in different modes cannot be held to each other, nor to the
float64 VJP: the Woodbury pass amplifies float32 rounding by about eps/cfm =
0.12 at cfm = 1e-6, so both sit at a median env error of about 1 against
float64. In the same mode the kernel is held to a median env error
(`env_rel_err`) of at most F32_MEDIAN and a share of envs within F32_REL of
at least F32_SHARE. An all-zero or env-permuted VJP has a median error of
about 1. Forward-mode AD (`forward_mode_vjp`) is printed beside it, not held.
"""
from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

VJP_RTOL, VJP_ATOL, VJP_SHARE = 1e-6, 1e-8, 0.99
F32_MEDIAN, F32_REL, F32_SHARE = 1e-4, 1e-2, 0.9


def env_rel_err(got, want):
    """Per env (column): the largest |got - want| over (dq, dv, dtau), each
    array's error divided by that array's largest magnitude in the env."""
    err = None
    for a, b in zip(got, want):
        e = (a - b).abs().amax(0) / b.abs().amax(0).clamp_min(1e-30)
        err = e if err is None else torch.maximum(err, e)
    return err


def envs_within(got, want, rtol=VJP_RTOL, atol=VJP_ATOL):
    """Share of envs whose (dq, dv, dtau) all lie within rtol |want| plus
    atol times the array's largest magnitude."""
    ok = None
    for a, b in zip(got, want):
        good = ((a - b).abs() <= rtol * b.abs() + atol * b.abs().max()).all(0)
        ok = good if ok is None else ok & good
    return ok.double().mean().item()


def f32_stats(got, want):
    """(median env error, share of envs within F32_REL, per-env errors) of a
    float32 VJP against a reference (reverse_mode_vjp's)."""
    rel = env_rel_err(got, want)
    return rel.median().item(), (rel <= F32_REL).double().mean().item(), rel


def f32_ok(median, share):
    return median <= F32_MEDIAN and share >= F32_SHARE


def reverse_mode_vjp(step, q, v, tau, gq, gv):
    """(dq, dv, dtau) = (gq, gv) . d step(q, v, tau) / d(q, v, tau) by
    torch.autograd.grad through `step`."""
    xs = [x.detach().clone().requires_grad_(True) for x in (q, v, tau)]
    with torch.enable_grad():
        return torch.autograd.grad(step(*xs), xs, (gq, gv))


def forward_mode_vjp(step, q, v, tau, gq, gv):
    """(dq, dv, dtau) = (gq, gv) . d step(q, v, tau) / d(q, v, tau) by
    forward-mode AD (torch.autograd.forward_ad), one tangent direction per
    column: each env's column is repeated
    K = nq + 2 nv times, copy k carries a unit tangent on input k, and one
    dual run of `step` gives all K directions. Memory grows with B K."""
    (nq, B), nv = q.shape, v.shape[0]
    K = nq + 2 * nv
    seed = torch.eye(K, dtype=q.dtype, device=q.device).repeat_interleave(B, dim=1)
    with fwAD.dual_level():
        xs = [fwAD.make_dual(x.detach().repeat(1, K), t)
              for x, t in zip((q, v, tau), seed.split((nq, nv, nv)))]
        jq, jv = (fwAD.unpack_dual(o).tangent for o in step(*xs))
    d = ((gq.repeat(1, K) * jq).sum(0) + (gv.repeat(1, K) * jv).sum(0)).view(K, B)
    return d[:nq], d[nq:nq + nv], d[nq + nv:]
