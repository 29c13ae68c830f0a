"""Model loaders. Counterpart of diffdart_tpu/io/: mesh.py and urdf.py
(the SKEL, SDF, MJCF and VSK loaders are ROADMAP Queue 1 item 11)."""
from diffdart_tpu_torch.io.urdf import load_urdf_into_builder, parse_urdf  # noqa: F401
