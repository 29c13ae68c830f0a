"""Simulation entry points. Counterpart of diffdart_tpu/sim/; so far the
fused path only (fast.py, tilestep.py). The vmap stack (step.py,
constrained.py, batched.py), world.py and recording.py are not ported yet.
Import the submodules directly; this package re-exports nothing."""
