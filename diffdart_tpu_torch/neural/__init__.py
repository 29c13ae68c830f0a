"""Timestep Jacobians, one-step backprop and coordinate mappings (IK).
Counterpart of diffdart_tpu/neural/ (jacobians.py, mappings.py)."""
from diffdart_tpu_torch.neural.jacobians import (  # noqa: F401
    LossGradient, TimestepJacobians, backprop, jacobian_wrt, timestep_jacobians)
from diffdart_tpu_torch.neural.mappings import (  # noqa: F401
    HierarchicalIK, IKMapping, IdentityMapping, solve_ik)
