"""Model builders. Counterpart of diffdart_tpu/models/; so far the
half-cheetah, the jump-worm, cartpole and cube_drop. The rest of basic.py,
humanoid.py and the catapult scene are not ported yet."""
from diffdart_tpu_torch.models.basic import cartpole, cube_drop  # noqa: F401
from diffdart_tpu_torch.models.half_cheetah import cheetah_init_q, half_cheetah  # noqa: F401
from diffdart_tpu_torch.models.scenes import jump_worm  # noqa: F401
