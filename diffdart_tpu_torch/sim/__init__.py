"""Simulation entry points. Counterpart of diffdart_tpu/sim/: the fused path
(fast.py, tilestep.py), the vmap stack (step.py, constrained.py,
batched.py), the World facade (world.py) and recordings (recording.py).

Exports the names the JAX package's sim/__init__ does, but `step`: here
`sim.step` stays the submodule (sim/step.py::step is the function). They
load on first use (a module __getattr__): ops/fused_step.py imports
sim/tilestep.py, and sim/fast.py imports ops/fused_step.py, so importing
them here eagerly would make a cycle."""
import importlib

_EXPORTS = {
    "solver_diagnostics": "constrained",
    "rollout_fast": "fast",
    "supports_fused": "fast",
    "rollout": "step",
    "rollout_checkpointed": "step",
    "rollout_final": "step",
    "rollout_segmented": "step",
    "step_unconstrained": "step",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
