"""Constraint assembly of the vmap stack. Counterpart of
diffdart_tpu/constraints/."""
