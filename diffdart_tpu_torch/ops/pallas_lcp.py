"""The boxed-LCP sweep kernel (ops/csrc/jacobi_sweeps.cu) on CUDA tensors,
its plain PyTorch version (ops/lcp.py::_jacobi) on CPU tensors.

Counterpart of diffdart_tpu/ops/pallas_lcp.py, with the same two entry
points: `jacobi_sweeps_pallas` (the batched block kernel's call site,
sim/batched.py::step_batched) and `jacobi_sweeps_pallas_single` (the
single-env kernel's call site, ops/lcp_lowrank.py::_solve_impl with
contact_solver='lowrank_pallas'). The JAX package vmaps the second one; the
port's vmap stack is batch-first, so both take the whole batch and launch
the same kernel once. Each has its own launch counter (`KERNEL.launches`,
`KERNEL_SINGLE.launches`), raised by one per launch and nowhere else.

Shapes: A (B, D, D); b, lo, hi, mu (B, D); fidx (D,) int64 on A's device
(-1 on non-friction rows, the normal row's index on friction rows), the
`fidx` of constraints/assembly.py::LCPData.
Returns lam (B, D). The kernel is forward only: a CUDA call with grad
enabled and an input that requires grad raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from diffdart_tpu_torch.ops import _build
from diffdart_tpu_torch.ops.lcp import _jacobi


@functools.lru_cache(maxsize=None)
def _load(kind: str) -> ctypes.CDLL:
    """The built jacobi_sweeps library with its argtypes declared."""
    lib = _build.build("jacobi_sweeps", kind)
    lib.jacobi_sweeps_max_d.argtypes = [ctypes.c_int]
    lib.jacobi_sweeps_max_d.restype = ctypes.c_int
    lib.jacobi_sweeps_max_rows_for.argtypes = [ctypes.c_int, ctypes.c_longlong]
    lib.jacobi_sweeps_max_rows_for.restype = ctypes.c_int
    lib.jacobi_sweeps_config.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.jacobi_sweeps_config.restype = ctypes.c_int
    lib.jacobi_sweeps_lists.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.jacobi_sweeps_lists.restype = ctypes.c_int
    for name in ("jacobi_sweeps_f32", "jacobi_sweeps_f64"):
        _build.declare(getattr(lib, name), 7, 3)
    return lib


@functools.lru_cache(maxsize=None)
def max_rows(dtype, device_index: int = 0) -> int:
    """The largest D the CUDA kernel takes in `dtype` on the card: one
    warp's shared memory with one buffer (A, lam, the new values and the
    row scales) and the block's phase lists must fit the card's opt-in
    shared memory per block (227 KB on the H100: 167 rows in float64, 238
    in float32)."""
    with torch.cuda.device(device_index):
        return _load("cuda").jacobi_sweeps_max_d(torch.finfo(dtype).bits // 8)


def launch_config(dtype, D: int, kind: str = "cuda") -> dict:
    """How the kernel runs at D in `dtype` on the current card (kind='cuda'),
    or the shared memory the host build sizes for it (kind='host'): whether
    the register path can run (float32, 15 <= D <= 48; the kernel also needs
    at most 32 rows per phase, else it takes the direct path), warps per
    block, warps per SM (from the occupancy the kernel gets; 0 in the host
    build), shared bytes per block and per warp."""
    out = (ctypes.c_int * 5)()
    err = _load(kind).jacobi_sweeps_config(torch.finfo(dtype).bits // 8, int(D), out)
    if err:
        raise RuntimeError(f"jacobi_sweeps_config failed: CUDA error {err}")
    keys = ("register_path", "warps_per_block", "warps_per_sm", "block_bytes", "warp_bytes")
    return {k: bool(v) if k == "register_path" else v for k, v in zip(keys, out)}


def _check(A, b, lo, hi, mu, fidx, what):
    if A.ndim != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"{what}: A must be (B, D, D), got {tuple(A.shape)}")
    B, D = A.shape[0], A.shape[-1]
    if tuple(fidx.shape) != (D,) or fidx.dtype != torch.int64:
        raise ValueError(f"{what}: fidx must be ({D},) int64, got {tuple(fidx.shape)} {fidx.dtype}")
    for x, name in ((b, "b"), (lo, "lo"), (hi, "hi"), (mu, "mu")):
        if tuple(x.shape) != (B, D):
            raise ValueError(f"{what}: {name} must be ({B}, {D}), got {tuple(x.shape)}")
    for x, name in ((A, "A"), (b, "b"), (lo, "lo"), (hi, "hi"), (mu, "mu")):
        if x.dtype not in (torch.float32, torch.float64) or x.dtype != A.dtype:
            raise TypeError(f"{what}: {name} must be float32 or float64 like A, got {x.dtype}")
    for x, name in ((b, "b"), (lo, "lo"), (hi, "hi"), (mu, "mu"), (fidx, "fidx")):
        if x.device != A.device:
            raise ValueError(f"{what}: {name} is on {x.device}, A on {A.device}")


class _SweepKernel:
    """Wrapper of the CUDA sweep kernel for one call site. `launches`
    counts kernel launches, and nothing else."""

    def __init__(self, name):
        self.name = name
        self.launches = 0

    def __call__(self, A, b, lo, hi, mu, fidx, iters: int):
        _check(A, b, lo, hi, mu, fidx, self.name)
        if A.device.type == "cpu":
            return _jacobi(A, b, lo, hi, mu, fidx, iters)
        if A.device.type != "cuda":
            raise ValueError(f"{self.name}: unsupported device {A.device}")
        if torch.is_grad_enabled() and any(x.requires_grad for x in (A, b, lo, hi, mu)):
            raise RuntimeError(f"{self.name}: the sweep kernel is forward only; inputs that "
                               "require grad are not supported on CUDA")
        B, D = b.shape
        cap = max_rows(A.dtype, A.device.index if A.device.index is not None else torch.cuda.current_device())
        if D > cap:
            raise NotImplementedError(f"{self.name}: D = {D} exceeds the kernel's cap of {cap} rows in "
                                      f"{A.dtype} (the card's shared memory per block)")
        lib = _load("cuda")
        fn = lib.jacobi_sweeps_f32 if A.dtype == torch.float32 else lib.jacobi_sweeps_f64
        A, b, lo, hi, mu, fidx = (x.contiguous() for x in (A, b, lo, hi, mu, fidx))
        lam = torch.empty_like(b)
        with torch.cuda.device(A.device):
            stream = torch.cuda.current_stream(A.device).cuda_stream
            err = fn(A.data_ptr(), b.data_ptr(), lo.data_ptr(), hi.data_ptr(), mu.data_ptr(),
                     fidx.data_ptr(), lam.data_ptr(), B, D, int(iters), stream)
        if err:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {err}")
        self.launches += 1
        return lam


KERNEL = _SweepKernel("jacobi_sweeps")
KERNEL_SINGLE = _SweepKernel("jacobi_sweeps_single")


def jacobi_sweeps_pallas(A, b, lo, hi, mu, fidx, iters: int = 6):
    """Batched sweeps, the call site of sim/batched.py::step_batched
    (TPU kernel 3, `_sweep_kernel`)."""
    return KERNEL(A, b, lo, hi, mu, fidx, iters)


def jacobi_sweeps_pallas_single(A, b, lo, hi, mu, fidx, iters: int = 6):
    """The sweeps of ops/lcp_lowrank.py::_solve_impl (TPU kernel 4,
    `_sweep_kernel1`, which the JAX package vmaps over envs); batch-first
    like the rest of the port's vmap stack."""
    return KERNEL_SINGLE(A, b, lo, hi, mu, fidx, iters)


def host_sweeps(A, b, lo, hi, mu, fidx, iters: int, dtype=torch.float64):
    """The kernel's per-warp code compiled for the host CPU (ops/_build.py,
    kind='host'), on CPU copies of the inputs in `dtype`: checks the
    kernel's arithmetic where there is no GPU, and is the card's λ bit for
    bit. Not on any execution path."""
    _check(A, b, lo, hi, mu, fidx, "host_sweeps")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"host_sweeps: dtype must be float32 or float64, got {dtype}")
    lib = _load("host")
    fn = lib.jacobi_sweeps_f32 if dtype == torch.float32 else lib.jacobi_sweeps_f64
    xs = [x.detach().cpu().to(dtype).contiguous() for x in (A, b, lo, hi, mu)]
    f = fidx.cpu().contiguous()
    lam = torch.empty_like(xs[1])
    B, D = xs[1].shape
    err = fn(*(x.data_ptr() for x in xs), f.data_ptr(), lam.data_ptr(), B, D, int(iters), None)
    if err:
        raise RuntimeError(f"host jacobi_sweeps failed: {err}")
    return lam
