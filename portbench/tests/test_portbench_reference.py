"""The benchmark's frozen reference against the program's plain versions at
a tiny size in float64, and what the benchmark may import.

    python -m pytest portbench/tests -p no:randomly -n 0
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FOREIGN = {"jax", "jaxlib", "flax", "diffdart_tpu"}
F64 = torch.float64


def _top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _benchmark_files():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


@pytest.mark.parametrize("path", _benchmark_files(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    """No module the benchmark runs imports JAX or the JAX package; the
    name before the first dot is compared whole, so diffdart_tpu_torch is
    not taken for diffdart_tpu."""
    assert not (_top_level_imports(path) & FOREIGN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    assert not (_top_level_imports(path) & (FOREIGN | {"diffdart_tpu_torch"}))


def test_foreign_name_match_is_whole():
    from portbench.harness.bench import FOREIGN as names

    assert "diffdart_tpu_torch".split(".")[0] not in names
    assert "diffdart_tpu" in names


def test_a_run_loads_no_jax_module():
    """A whole run (the CPU dry path of cheetah.rollout) in a fresh
    interpreter: once it has ended, sys.modules holds no JAX module and no
    module of the JAX package."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from portbench.harness.bench import run, foreign_modules\n"
        "c, r = run('cheetah.rollout', 5, 0.2, False, time.perf_counter(), device='cpu', "
        "traffic=dict(batch=4, steps=3, check_rows=2, warmup_iterations=1), chip_check=False)\n"
        "import json; print(json.dumps([c, r['correct'], foreign_modules()]))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [0, True, []]


def _cheetah_inputs(B, T, seed):
    g = torch.Generator().manual_seed(seed)
    q0 = torch.tensor([0.6, 0.0, 0.0, -0.1, 0.2, -0.1, 0.1, -0.2, 0.1], dtype=F64)
    q = q0 + 0.02 * torch.randn(B, 9, generator=g, dtype=F64)
    v = 0.1 * torch.randn(B, 9, generator=g, dtype=F64)
    taus = 0.1 * torch.randn(T, B, 9, generator=g, dtype=F64)
    return q, v, taus


def test_reference_tile_step_matches_the_program_plain_version():
    """Half-cheetah, B = 3, 4 steps, float64: the frozen tile step against
    the program's (sim/tilestep.py, the plain version of the fused
    kernels), final state and the gradient of the traffic's loss."""
    from diffdart_tpu_torch.models import half_cheetah
    from diffdart_tpu_torch.sim.tilestep import build_tile_step

    from portbench.reference import runner
    from portbench.reference.models.half_cheetah import half_cheetah as ref_half_cheetah

    q, v, taus = _cheetah_inputs(3, 4, 0)
    loss = {"q_index": 1, "tau_weight": 1e-4}
    ref = runner.bptt(ref_half_cheetah(dtype=F64, device="cpu"), q, v, taus, loss, 3)
    step = build_tile_step(half_cheetah(dtype=F64, device="cpu"))
    t = taus.clone().requires_grad_(True)
    qs, vs = q.T.contiguous(), v.T.contiguous()
    for k in range(4):
        qs, vs = step(qs, vs, t[k].T.contiguous())
    value = (qs[1] ** 2).mean() + 1e-4 * (t ** 2).mean()
    (g,) = torch.autograd.grad(value, t)
    torch.testing.assert_close(ref[0], qs.T.detach(), rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(ref[1], vs.T.detach(), rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(ref[2], g, rtol=1e-8, atol=1e-14)


def test_stored_work_counts_match_count_work():
    """The work per env-step in each configuration's file is what
    portbench/count_work.py computes from the frozen reference."""
    from portbench import count_work
    from portbench.harness import spec

    bench = spec.load_benchmark(ROOT)
    for entry in bench["configs"]:
        cfg = spec.read_data(ROOT / entry["file"])
        assert cfg["work"] == count_work.count(cfg), entry["name"]
