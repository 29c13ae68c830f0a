"""Model builders. Counterpart of diffdart_tpu/models/: basic.py, the
half-cheetah, the Atlas-class humanoid and the scenes (catapult, jump-worm)."""
from diffdart_tpu_torch.models.basic import (  # noqa: F401
    capsule_lying, cartpole, chain, cube_drop, double_pendulum, pendulum, projectile)
from diffdart_tpu_torch.models.half_cheetah import cheetah_init_q, half_cheetah  # noqa: F401
from diffdart_tpu_torch.models.humanoid import humanoid, humanoid_init_q  # noqa: F401
from diffdart_tpu_torch.models.scenes import catapult, catapult_init_q, jump_worm  # noqa: F401
