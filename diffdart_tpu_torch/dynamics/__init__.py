"""Model data. Counterpart of diffdart_tpu/dynamics/; so far model.py only.
joints.py, kinematics.py and dynamics.py (the vmap stack) are not ported
yet."""
