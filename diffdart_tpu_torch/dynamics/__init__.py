"""Model data and the vmap stack's dynamics. Counterpart of
diffdart_tpu/dynamics/: model.py, joints.py (every joint
type), kinematics.py, dynamics.py and shapes.py."""
from diffdart_tpu_torch.dynamics.dynamics import forward_dynamics, inverse_dynamics  # noqa: F401
