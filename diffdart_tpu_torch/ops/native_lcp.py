"""ctypes binding of the native Dantzig boxed-LCP pivot solver
(native/lcp_dantzig.cpp). Counterpart of diffdart_tpu/ops/native_lcp.py.

An exact host-side oracle for checking the batched solvers (the sweep
kernel, ops/lcp.py, ops/lcp_lowrank.py), and a CPU solver where
pivot-grade accuracy is needed. The C++ source is read from the
repository's native/ directory and built with the host compiler by
ops/_build.py (kind 'host') into the package's build directory,
diffdart_tpu_torch/_build/, at first use; nothing is written into native/.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from diffdart_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parents[2] / "native" / "lcp_dantzig.cpp"


class NativeBuildError(RuntimeError):
    pass


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    if not SOURCE.exists():
        raise NativeBuildError(f"source not found: {SOURCE}")
    try:
        lib = _build.build("lcp_dantzig", "host", path=SOURCE)
    except RuntimeError as e:
        raise NativeBuildError(f"native build failed: {e}") from e
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.boxed_lcp_dantzig.restype = ctypes.c_int
    lib.boxed_lcp_dantzig.argtypes = [
        ctypes.c_int, f64, f64, f64, f64, f64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"), f64, f64]
    return lib


def available() -> bool:
    """Whether the library builds (or is built) and loads here."""
    try:
        _load()
        return True
    except NativeBuildError:
        return False


def boxed_lcp_dantzig(A, b, lo, hi, mu, fidx):
    """Exact pivot solve of one boxed LCP (host, float64): A (n, n), b, lo,
    hi, mu (n,), fidx (n,) int (the normal row of a friction row, -1 for
    none); bounds beyond +-1e30 are clipped to it. Returns (lam, w, status),
    status 0 for an exact solve."""
    lib = _load()
    A = np.ascontiguousarray(np.asarray(A, np.float64))
    b = np.ascontiguousarray(np.asarray(b, np.float64))
    n = len(b)
    if A.shape != (n, n):
        raise ValueError(f"boxed_lcp_dantzig: A must be ({n}, {n}), got {A.shape}")
    lo = np.ascontiguousarray(np.clip(np.asarray(lo, np.float64), -1e30, 1e30))
    hi = np.ascontiguousarray(np.clip(np.asarray(hi, np.float64), -1e30, 1e30))
    mu = np.ascontiguousarray(np.asarray(mu, np.float64))
    fidx = np.ascontiguousarray(np.asarray(fidx, np.int32))
    for name, x in (("lo", lo), ("hi", hi), ("mu", mu), ("fidx", fidx)):
        if x.shape != (n,):
            raise ValueError(f"boxed_lcp_dantzig: {name} must be ({n},), got {x.shape}")
    x = np.zeros(n)
    w = np.zeros(n)
    status = lib.boxed_lcp_dantzig(n, A, b, lo, hi, mu, fidx, x, w)
    return x, w, int(status)
