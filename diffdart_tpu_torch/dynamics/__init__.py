"""Model data and the vmap stack's dynamics. Counterpart of
diffdart_tpu/dynamics/: model.py, joints.py (every joint
type), kinematics.py, dynamics.py and shapes.py."""
