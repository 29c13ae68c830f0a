#!/usr/bin/env python3
"""The work per env-step that the roofline shares count, from the frozen
reference (portbench/reference/), for each configuration:

    python3 portbench/count_work.py            # prints {config: {kernel: work}}

- fused_step_kernel (one step): the elementwise operations of the plain
  step per env, structural zeros folded away, seen as torch functions
  (TorchFunctionMode) at B = 1 on the CPU; bytes: q, v, tau read and q', v'
  written once.
- fused_step_vjp_kernel (one step's VJP): the operations of the plain
  step with grad enabled plus its autograd backward, seen at the aten level
  (TorchDispatchMode); bytes: q, v, tau, gq, gv read and dq, dv, dtau
  written once.
Counts are of the configuration's dtype (bytes of its element size).

The configurations' files hold these numbers under `work`; a test holds
them to this script. They depend on the model's sizes alone.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent

_COUNTED = {
    "add", "radd", "sub", "rsub", "mul", "rmul", "truediv", "rtruediv", "div", "neg",
    "maximum", "minimum", "abs", "sqrt", "rsqrt", "sin", "cos", "where", "gt", "ge", "lt",
    "le", "eq", "ne", "logical_and", "logical_or", "logical_not", "invert", "isfinite",
}
_COUNTED_VJP = _COUNTED | {"bitwise_not", "masked_fill", "sgn", "pow", "reciprocal"}


def _one_env(model, cfg):
    q = torch.tensor(cfg["init_q"], dtype=model.dtype).reshape(-1, 1)
    v = torch.zeros(model.nv, 1, dtype=model.dtype)
    tau = 0.1 * torch.randn(model.nv, 1, generator=torch.Generator().manual_seed(0),
                            dtype=model.dtype)
    return q, v, tau


def step_ops(model, q, v, tau) -> int:
    from torch.overrides import TorchFunctionMode

    from portbench.reference.sim.tilestep import build_tile_step

    n = 0

    class Count(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            nonlocal n
            if getattr(func, "__name__", "").strip("_") in _COUNTED:
                n += 1
            return func(*args, **(kwargs or {}))

    step = build_tile_step(model)
    with torch.no_grad(), Count():
        step(q, v, tau)
    return n


def vjp_ops(model, q, v, tau) -> int:
    from torch.utils._python_dispatch import TorchDispatchMode

    from portbench.reference.sim.tilestep import build_tile_step

    n = 0

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            nonlocal n
            if func.overloadpacket.__name__.strip("_") in _COUNTED_VJP:
                n += 1
            return func(*args, **(kwargs or {}))

    step = build_tile_step(model)
    xs = [x.clone().requires_grad_(True) for x in (q, v, tau)]
    with Count():
        out = step(*xs)
        torch.autograd.grad(out, xs, [torch.ones_like(o) for o in out])
    return n


def count(cfg: dict) -> dict:
    from portbench.reference import runner

    dtype = getattr(torch, cfg["dtype"])
    model = runner.build_model(cfg, "cpu", dtype)
    elem = torch.finfo(dtype).bits // 8
    q, v, tau = _one_env(model, cfg)
    nq, nv = model.nq, model.nv
    return {"fused_step_kernel": {"ops": step_ops(model, q, v, tau),
                                  "bytes": (nq + 2 * nv + nq + nv) * elem},
            "fused_step_vjp_kernel": {"ops": vjp_ops(model, q, v, tau),
                                      "bytes": (2 * nq + 3 * nv + nq + 2 * nv) * elem}}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from portbench.harness import spec

    bench = spec.load_benchmark(ROOT)
    out = {c["name"]: count(spec.read_data(ROOT / c["file"])) for c in bench["configs"]}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
