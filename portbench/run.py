#!/usr/bin/env python3
"""The benchmark of diffdart_tpu_torch on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json from the root of a checkout and prints, as
the last line of standard output, one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), device, with --trace 1 breakdown, and last `checks`,
each number compared beside its limit (also the last lines of standard
error). Exits non-zero with no result line without the CUDA devices the
cell asks for, or when the run has loaded JAX or the JAX package.

Every part of a cell is found by name (portbench/harness/spec.py). Caches
go inside the checkout: the program builds its kernels into
diffdart_tpu_torch/_build/, and CUDA's, torch's and Triton's caches are
pointed at .portbench_cache/.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache = ROOT / ".portbench_cache"
    for var, sub in (("CUDA_CACHE_PATH", "cuda"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    sys.path.insert(0, str(ROOT))
    from portbench.harness.bench import run

    code, result = run(args.workload, args.seed, args.seconds, bool(args.trace), STARTED, ROOT)
    if result is not None:
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
