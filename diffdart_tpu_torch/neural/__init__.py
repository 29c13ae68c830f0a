"""Timestep Jacobians and one-step backprop. Counterpart of
diffdart_tpu/neural/ (jacobians.py); mappings.py is not ported yet."""
from diffdart_tpu_torch.neural.jacobians import (  # noqa: F401
    LossGradient, TimestepJacobians, backprop, jacobian_wrt, timestep_jacobians)
