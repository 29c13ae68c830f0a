"""Builds a kernel source of ops/csrc/ into a shared library with a plain C
interface and loads it with ctypes. Each wrapper module declares the
argtypes of its library's functions next to its own code (pointers and the
stream as c_void_p).

kind='cuda': nvcc for sm_90a (Hopper), at first use, into
diffdart_tpu_torch/_build/ (listed in .gitignore), keyed by the source name
and a hash of the source and flags. kind='host': the same per-env code
compiled by the host C++ compiler, which lets a kernel's arithmetic be
checked on a machine without a GPU.

Precision flags: no fast math. -fmad=false keeps every multiply and add
separately rounded, as the plain PyTorch versions compute them, so kernels
and plain versions agree to rounding; the Woodbury polish of the LCP
amplifies rounding by about eps/cfm, which is why sin/cos/sqrt/division
stay IEEE.

Sources: "fused_step" (the fused step and its VJP), "jacobi_sweeps" (the
boxed-LCP sweeps); and, host only, a C++ source elsewhere in the repository
passed by its path (ops/native_lcp.py: native/lcp_dantzig.cpp, the pivot
oracle), whose library is built here too and never beside its source. Each
is compiled to objects and linked into one library. A source whose kernels
take long to compile states a line `#define KERNEL_PARTS n`: the CUDA build
then compiles it n times at once, each nvcc with -DKERNEL_PART=i (the
source instantiates part i's kernels and their C launchers only). The host
build is one part: it serves the tests, whose workers may build at the
same time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_HOST_FLAGS = ["-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC"]


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


def _run_all(cmds):
    """Run the commands at once; (returncode, output) of each."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, out) for p, out in zip(procs, outs)]


@functools.lru_cache(maxsize=None)
def build(source: str, kind: str = "cuda", path: Path | None = None) -> ctypes.CDLL:
    """Compile ops/csrc/<source>.cu, or the file at `path` under the name
    `source` (if not already built for this source text), and load it; with
    kind='cuda', in the parts the source states, all at once (see the
    module docstring). The compiler's report (nvcc: ptxas
    registers and spills), kept beside the library, is `lib.build_log`; the
    compile time in seconds is `lib.build_seconds` (0.0 when the library
    was already built)."""
    cc, flags = _compiler(kind)
    src_path = CSRC / f"{source}.cu" if path is None else Path(path)
    src = src_path.read_bytes()
    stated = re.search(rb"^#define KERNEL_PARTS (\d+)", src, re.M)
    parts = int(stated.group(1)) if stated and kind == "cuda" else 1
    key = hashlib.sha256(src + " ".join([kind, *flags]).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{source}_{kind}_{key}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.exists():
        tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
        tmp = os.path.join(tmpdir, out.name)
        t0 = time.perf_counter()
        try:
            objs = [os.path.join(tmpdir, f"part{i}.o") for i in range(parts)]
            part = (lambda i: [f"-DKERNEL_PART={i}"]) if parts > 1 else (lambda i: [])
            results = _run_all([[cc, *flags, *part(i), "-c", "-o", o, str(src_path)]
                                for i, o in enumerate(objs)])
            if all(rc == 0 for rc, _ in results):
                results += _run_all([[cc, "-shared", "-o", tmp, *objs]])
            log = "".join(text for _, text in results)
            if any(rc != 0 for rc, _ in results):
                raise RuntimeError(f"building {src_path.name} ({kind}) failed:\n{log}")
            Path(tmp + ".log").write_text(log)
            os.replace(tmp + ".log", log_path)
            os.replace(tmp, out)  # atomic: concurrent builders never see a torn file
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    lib.build_log = log_path.read_text() if log_path.exists() else ""
    lib.build_seconds = seconds
    return lib


def declare(fn, n_ptr: int, n_int: int, stream: bool = True):
    """argtypes of a C launcher taking n_ptr pointers, then n_int ints, then
    (optionally) the stream; returns an int error code."""
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + ([ctypes.c_void_p] if stream else []))
    fn.restype = ctypes.c_int
    return fn
