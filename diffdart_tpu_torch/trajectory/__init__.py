"""Trajectory optimization over the vmap stack's step. Counterpart of
diffdart_tpu/trajectory/: iLQR (ilqr.py), single and multiple shooting
(shooting.py), the SLSQP driver (nlp.py), MPC (mpc.py) and the stall
checks (stall.py)."""
from diffdart_tpu_torch.trajectory.ilqr import ilqr, ILQRResult, make_dynamics, tangent_ops  # noqa: F401
from diffdart_tpu_torch.trajectory.shooting import (  # noqa: F401
    MultipleShooting,
    single_shooting,
    ShootingResult,
)
from diffdart_tpu_torch.trajectory.nlp import solve_slsqp, NLPInfo  # noqa: F401
