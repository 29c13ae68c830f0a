"""Lie-group and spatial algebra. Counterpart of diffdart_tpu/math/."""
