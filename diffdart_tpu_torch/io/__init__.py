"""Model loaders, numpy at build time, each emitting onto the port's
ModelBuilder. Counterpart of diffdart_tpu/io/: URDF, SKEL, MJCF (through
the `mujoco` package, imported when a scene is loaded), SDF and VSK, and
load_into_builder, which picks one by the file's extension or root tag."""
from diffdart_tpu_torch.io.urdf import load_urdf_into_builder, parse_urdf  # noqa: F401
from diffdart_tpu_torch.io.skel import load_skel_into_builder  # noqa: F401
from diffdart_tpu_torch.io.mjcf import load_mjcf_into_builder  # noqa: F401
from diffdart_tpu_torch.io.sdf import load_sdf_into_builder  # noqa: F401
from diffdart_tpu_torch.io.vsk import load_vsk_into_builder, parse_vsk  # noqa: F401


def load_into_builder(builder, path: str, **kw):
    """Load a scene file (or an XML string) into `builder`, dispatching by
    extension (.urdf, .skel, .vsk, .sdf / .world), else, for .xml or a
    string, by the root tag: <robot> URDF, <mujoco> MJCF, <world> or <skel>
    SKEL. Raises ValueError for anything else."""
    import os

    p = str(path)
    if p.endswith(".urdf"):
        return load_urdf_into_builder(builder, p, **kw)
    if p.endswith(".skel"):
        return load_skel_into_builder(builder, p, **kw)
    if p.endswith(".vsk"):
        return load_vsk_into_builder(builder, p, **kw)
    if p.endswith(".sdf") or p.endswith(".world"):
        return load_sdf_into_builder(builder, p, **kw)
    if p.endswith(".xml") or p.strip().startswith("<"):
        text = open(p).read() if os.path.exists(p) else p
        head = text.lstrip()[:200]
        if "<robot" in head:
            return load_urdf_into_builder(builder, p, **kw)
        if "<mujoco" in head:
            return load_mjcf_into_builder(builder, p, **kw)
        if "<world" in head or "<skel" in head:
            return load_skel_into_builder(builder, p, **kw)
    raise ValueError(f"unsupported scene format: {path}")
