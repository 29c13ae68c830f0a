"""Collision of the vmap stack. Counterpart of diffdart_tpu/collision/:
narrowphase.py (every primitive pair), convex.py (hull and ellipsoid
pairs) and collide.py (the pair plan and the contact budget)."""
from diffdart_tpu_torch.collision.collide import Contacts, collide_world, max_contacts  # noqa: F401
