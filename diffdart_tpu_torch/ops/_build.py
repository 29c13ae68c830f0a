"""Builds ops/csrc/fused_step.cu (the fused step and its VJP) into a shared
library with a plain C interface and loads it with ctypes.

kind='cuda': nvcc for sm_90a (Hopper), at first use, into
diffdart_tpu_torch/_build/ (listed in .gitignore), keyed by a hash of the
source and flags. kind='host': the same per-env code compiled by the host
C++ compiler, which lets the kernel's arithmetic be checked on a machine
without a GPU.

Precision flags: no fast math. -fmad=false keeps every multiply and add
separately rounded, as the plain PyTorch version computes them, so kernel
and plain version agree to rounding; the Woodbury polish amplifies rounding
by about eps/cfm, which is why sin/cos/sqrt/division stay IEEE.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "csrc" / "fused_step.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_HOST_FLAGS = ["-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC"]


def _compiler(kind: str) -> tuple[str, list]:
    if kind == "cuda":
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
        return nvcc, _NVCC_FLAGS
    if kind == "host":
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no host C++ compiler (g++/c++) found")
        return cxx, _HOST_FLAGS
    raise ValueError(f"unknown build kind {kind!r}")


@functools.lru_cache(maxsize=None)
def build(kind: str = "cuda") -> ctypes.CDLL:
    """Compile (if not already built for this source) and load the library.
    The compiler's report (nvcc: ptxas registers/spills) is kept as
    `lib.build_log`, the compile time in seconds as `lib.build_seconds`
    (0.0 when the library was already built)."""
    cc, flags = _compiler(kind)
    src = SRC.read_bytes()
    key = hashlib.sha256(src + " ".join([kind, *flags]).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libfused_step_{kind}_{key}.so"
    log, seconds = "", 0.0
    if not out.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([cc, *flags, "-o", tmp, str(SRC)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {SRC.name} ({kind}) failed:\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)  # atomic: concurrent builders never see a torn file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(out))
    lib.fused_step_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.fused_step_layout.restype = None
    for name in ("fused_step_f32", "fused_step_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("fused_step_vjp_f32", "fused_step_vjp_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.build_log = log
    lib.build_seconds = seconds
    return lib


def layout(lib: ctypes.CDLL) -> list:
    """[DescI ints, DescF<float> floats, DescF<double> doubles, MAX_NB,
    MAX_NQ, MAX_NV, MAX_PAIRS, MAX_NC, MAX_LIM, MAX_D] as compiled."""
    buf = (ctypes.c_int * 10)()
    lib.fused_step_layout(buf)
    return list(buf)
