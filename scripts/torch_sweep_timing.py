"""The sweep kernel's timings of chip_smoke.py (phases 11, 14 and 15) alone,
on one NVIDIA GPU, for the port in this checkout or in another one.
Imports no JAX.

    python scripts/torch_sweep_timing.py [--repo DIR] [--label NAME]

--repo imports diffdart_tpu_torch from DIR (default: this checkout), so two
trees can be compared in one call on one card: run parent, change, change,
parent. Inputs: a boxed LCP of the half-cheetah's shape (B = 4096, D = 42:
10 normal rows, 20 friction rows, 12 limit rows; A = J J^T + 1e-3 I with J
of rank 9; 4 iterations), made from numpy seed 0. Prints one JSON line:
ptxas's line of the kernel per dtype; the device ms per launch from the
bare C launcher (chip_smoke.sweep_readings): float32 warm (one set of
inputs, which stays in the 50 MB L2) and cold (launches rotating over 4
copies, 129 MB), the same with iters = 0 (the copy of A and the row scales
alone), float64 warm and cold, and the host ms to issue one launch; the
launch configuration where the tree's wrapper reports it; and a SHA-256 of
lam's bytes per dtype, so that equal hashes show two trees' kernels equal
bit for bit.

    python scripts/torch_sweep_timing.py --trace

adds, for this checkout's kernel, where an env's time goes on the float32
register path: it builds a copy of ops/csrc/jacobi_sweeps.cu with clock64
stamps written by lane 0 of each warp (TRACE_POINTS), runs it once at
B = 132 (one env per SM: a warp's chain alone) and at B = 4096, and prints
the median cycles per env of each stage (the wait for its copy, loading its
rows and row scales, starting the next env's copy, the sweeps, writing lam
out) and of the first iteration's two half-sweeps and copy-back, with the
SM clock (cycles per ns of %globaltimer). The stamps cost time of their
own: the stages' sum is not the uninstrumented kernel's time.
"""
import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, D, NC, ITERS = 4096, 42, 10, 4


def problem(dtype):
    """The seeded LCP (A, b, lo, hi, mu, fidx) on the card."""
    rng = np.random.default_rng(0)
    J = rng.normal(size=(B, D, 9))
    A = np.einsum("bik,bjk->bij", J, J) + 1e-3 * np.eye(D)
    fr = np.zeros(D, bool)
    fr[NC:3 * NC] = True
    fidx = np.where(fr, np.r_[np.zeros(NC), np.tile(np.arange(NC), 2), np.zeros(D - 3 * NC)], -1)
    hi = np.where(fr, 0.0, np.inf) * np.ones((B, 1))
    mu = np.where(fr, 0.5, 0.0) * np.ones((B, 1))
    xs = [torch.tensor(x, dtype=dtype, device="cuda")
          for x in (A, rng.normal(size=(B, D)), np.zeros((B, D)), hi, mu)]
    return SimpleNamespace(A=xs[0], b=xs[1], lo=xs[2], hi=xs[3], mu=xs[4],
                           fidx=torch.tensor(fidx.astype(np.int64), device="cuda"))


# (a piece of the kernel source, the same with stamps): STAMP(k, on) has
# lane 0 of the warp write stamp k of env e where `on` holds
_NEXT = "    const int next = e + stride < p.B ? (int)(e + stride) : p.B;\n"
_OUT = "      for (int i = l; i < D; i += WARP) out[i] = lam[i];\n    });\n"
_HALF = "      lanes([&](int l) {{ regs_half<{0}>(LANE_ROWS(l), lam); }});\n"
TRACE_POINTS = [
    ("    stage_wait(mbar, n & 1, bulk);\n" + _NEXT,
     "    STAMP(0, 1);\n    stage_wait(mbar, n & 1, bulk);\n    STAMP(1, 1);\n" + _NEXT),
    ("    if (next < p.B) stage_env(p, stage, mbar, next, bulk);\n",
     "    STAMP(2, 1);\n    if (next < p.B) stage_env(p, stage, mbar, next, bulk);\n    STAMP(3, 1);\n"),
    (_HALF.format(0), "      STAMP(8, it == 0);\n" + _HALF.format(0) + "      STAMP(9, it == 0);\n"),
    (_HALF.format(1), "      STAMP(10, it == 0);\n" + _HALF.format(1) + "      STAMP(11, it == 0);\n"),
    ("#undef LANE_ROWS\n", "#undef LANE_ROWS\n    STAMP(4, 1);\n"),
    (_OUT + "  }\n}", _OUT + "    STAMP(5, 1);\n  }\n}"),
]
STAGES = {"wait for the copy": (0, 1), "rows and row scales": (1, 2), "start the next copy": (2, 3),
          "sweeps": (3, 4), "lam out": (4, 5), "first half-sweep": (8, 9),
          "first copy-back": (9, 10), "second half-sweep": (10, 11)}
STAMP = """
#ifdef __CUDACC__
__device__ unsigned long long g_stamps[1 << 20];
__device__ __forceinline__ void stamp(long long e, int k, bool on) {
  if ((threadIdx.x & 31) == 0 && e < 16384 && on) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[(e * 16 + k) * 2] = t;
    g_stamps[(e * 16 + k) * 2 + 1] = clock64();
  }
}
extern "C" int stamps_get(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));
}
#endif
#ifdef __CUDA_ARCH__
#define STAMP(k, on) stamp(e, k, on)
#else
#define STAMP(k, on)
#endif
"""


def trace(x, fidx):
    """Median cycles per env of each stage (STAGES) on the register path,
    from a copy of this checkout's kernel with stamps at TRACE_POINTS."""
    from diffdart_tpu_torch.ops import _build
    src = (_build.CSRC / "jacobi_sweeps.cu").read_text()
    for piece, stamped in TRACE_POINTS:
        if src.count(piece) != 1:
            raise RuntimeError(f"trace: the kernel source no longer has one {piece!r}")
        src = src.replace(piece, stamped)
    src = src.replace("namespace sweeps {", STAMP + "namespace sweeps {", 1)
    d = tempfile.mkdtemp()
    cu, so = os.path.join(d, "traced.cu"), os.path.join(d, "traced.so")
    with open(cu, "w") as f:
        f.write(src)
    nvcc, flags = _build._compiler("cuda")
    built = subprocess.run([nvcc, *flags, "-shared", "-o", so, cu], capture_output=True, text=True)
    if built.returncode:
        raise RuntimeError(f"trace: nvcc failed on the stamped source:\n{built.stdout}{built.stderr}")
    lib = ctypes.CDLL(so)
    run = lib.jacobi_sweeps_f32
    _build.declare(run, 7, 3)
    out = {}
    for B_ in (132, B):
        lam = torch.empty(B_, D, device="cuda")
        xs = [t[:B_].contiguous() for t in (x.A, x.b, x.lo, x.hi, x.mu)]
        args = (*(t.data_ptr() for t in xs), fidx.data_ptr(), lam.data_ptr(), B_, D, ITERS, None)
        for _ in range(3):  # the last launch's stamps are read
            if run(*args):
                raise RuntimeError("trace: launch failed")
        torch.cuda.synchronize()
        st = np.zeros(1 << 20, np.uint64)
        lib.stamps_get.argtypes = [ctypes.c_void_p]
        if lib.stamps_get(st.ctypes.data):
            raise RuntimeError("trace: reading the stamps failed")
        st = st.reshape(-1, 16, 2)[:B_].astype(np.int64)
        row = {name: float(np.median(st[:, b, 1] - st[:, a, 1])) for name, (a, b) in STAGES.items()}
        row["clock_GHz"] = float(np.median((st[:, 5, 1] - st[:, 0, 1]) /
                                           np.maximum(st[:, 5, 0] - st[:, 0, 0], 1)))
        out[f"B={B_}"] = row
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--trace", action="store_true", help="also time the stages of an env (this checkout)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sweep_timing: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import ptxas_lines, sweep_bound, sweep_readings

    sys.path.insert(0, os.path.abspath(args.repo))
    from diffdart_tpu_torch.ops import pallas_lcp as P

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = P._load("cuda")
    ptx = ptxas_lines(lib)
    lcp = {dt: problem(dt) for dt in (torch.float32, torch.float64)}
    out = {"label": args.label, "repo": os.path.abspath(args.repo), "card": card,
           "ptxas_f32": ptx.get("jacobi_sweeps<float>"), "ptxas_f64": ptx.get("jacobi_sweeps<double>"),
           "bound_f32_ms": sweep_bound(B, D, ITERS, torch.float32)[0],
           "bound_f64_ms": sweep_bound(B, D, ITERS, torch.float64)[0]}
    if hasattr(P, "launch_config"):
        out["config"] = {str(dt)[6:]: P.launch_config(dt, D) for dt in lcp}
    with torch.no_grad():
        for dt, x in lcp.items():
            lam = P.jacobi_sweeps_pallas(x.A, x.b, x.lo, x.hi, x.mu, x.fidx, ITERS)
            out[f"lam_sha256_{str(dt)[6:]}"] = hashlib.sha256(lam.cpu().numpy().tobytes()).hexdigest()
            out[f"max_abs_lam_{str(dt)[6:]}"] = lam.abs().max().item()
        out["ms"] = sweep_readings(lib, lcp[torch.float32], lcp[torch.float64], ITERS)
        if args.trace:
            out["trace_cycles"] = trace(lcp[torch.float32], lcp[torch.float32].fidx)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
