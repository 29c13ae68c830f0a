"""Simulation entry points. Counterpart of diffdart_tpu/sim/: the fused path
(fast.py, tilestep.py) and the vmap stack (step.py, constrained.py,
batched.py). world.py and recording.py are not ported yet. Import the
submodules directly; this package re-exports nothing."""
