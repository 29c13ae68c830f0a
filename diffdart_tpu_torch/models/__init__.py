"""Model builders. Counterpart of diffdart_tpu/models/: basic.py, the
half-cheetah and the jump-worm. humanoid.py and the catapult scene are not
ported yet."""
from diffdart_tpu_torch.models.basic import (  # noqa: F401
    capsule_lying, cartpole, chain, cube_drop, double_pendulum, pendulum, projectile)
from diffdart_tpu_torch.models.half_cheetah import cheetah_init_q, half_cheetah  # noqa: F401
from diffdart_tpu_torch.models.scenes import jump_worm  # noqa: F401
