"""How the sweep kernel (ops/csrc/jacobi_sweeps.cu) is held to its plain
version (ops/lcp.py::_jacobi) on the card. chip_smoke.py and
tests/test_torch_cuda.py use these limits.

The two compute the same sweeps in the same dtype, but the plain version's
A @ lam runs in cuBLAS's summation order and the kernel's dot products sum
row by row in order, so they agree to rounding, not bit for bit. The
difference is measured per entry relative to max(1, |lam|) (impulses of the
half-cheetah reach ~10): the sweeps contract (row steps of at most 0.9 of a
diagonal step), so a rounding difference stays of the order of a few ulps
of the dot product's terms. Float64: REL_F64 = 1e-12; float32:
REL_F32 = 1e-4, with no non-finite output. The sweep output is compared
directly, not only through the step: the Woodbury polish downstream
amplifies any difference by about eps/cfm.
"""
from __future__ import annotations

import torch

REL_F64, REL_F32 = 1e-12, 1e-4


def sweep_error(got, want):
    """(max |got - want|, max |got - want| / max(1, |want|))."""
    err = (got - want).abs()
    return err.max().item(), (err / want.abs().clamp_min(1.0)).max().item()


def sweep_ok(got, want):
    limit = REL_F64 if want.dtype == torch.float64 else REL_F32
    return bool(torch.isfinite(got).all()) and sweep_error(got, want)[1] <= limit
