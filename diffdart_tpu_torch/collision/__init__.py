"""Collision of the vmap stack. Counterpart of diffdart_tpu/collision/; the
plane pairs of narrowphase.py and collide.py (convex.py is not ported)."""
from diffdart_tpu_torch.collision.collide import Contacts, max_contacts  # noqa: F401
