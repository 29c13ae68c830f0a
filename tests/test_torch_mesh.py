"""Mesh and URDF loading of the torch port (diffdart_tpu_torch/io/mesh.py,
io/urdf.py, dynamics/shapes.py) against the JAX package, on the CPU.

The loaders, the convex hull (scipy, with farthest-point decimation) and
the mesh integrals run the same numpy and scipy calls in the same order in
both packages, so they are held equal bit for bit; the closed-form mass
properties of dynamics/shapes.py within tests/test_convex.py's rtol 1e-9 /
atol 1e-12. The Atlas asset is the JAX package's, read as files.
"""
import os

import numpy as np
import pytest

from diffdart_tpu.dynamics import shapes as jax_shapes
from diffdart_tpu.io import mesh as jax_mesh
from diffdart_tpu.io import urdf as jax_urdf
from diffdart_tpu_torch.dynamics import shapes
from diffdart_tpu_torch.dynamics.model import GeomType, ModelBuilder
from diffdart_tpu_torch.io import mesh, urdf
from diffdart_tpu_torch.models.humanoid import ATLAS_URDF

MESHES = os.path.join(os.path.dirname(ATLAS_URDF), "meshes")


def _equal(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (msg, a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _cloud(seed, n=200):
    return np.random.RandomState(seed).randn(n, 3) * np.r_[0.3, 0.2, 0.1]


def test_atlas_asset_is_the_jax_packages():
    import diffdart_tpu.models.humanoid as jh

    assert os.path.samefile(ATLAS_URDF, jh.ATLAS_URDF)


@pytest.mark.parametrize("name", ["foot.obj", "pelvis.obj", "torso.obj"])
def test_load_obj_matches_jax(name):
    path = os.path.join(MESHES, name)
    for a, b in zip(mesh.load_mesh(path, scale=(1.0, 2.0, 0.5)),
                    jax_mesh.load_mesh(path, scale=(1.0, 2.0, 0.5))):
        _equal(a, b, name)


@pytest.mark.parametrize("fmt", ["obj", "stl", "stl_ascii"])
def test_mesh_round_trip(fmt, tmp_path):
    """save_obj / save_stl then load_mesh give back the mesh: OBJ as written
    (9 significant digits), binary STL deduplicated in float32, an ASCII STL
    deduplicated; each equal to the JAX package's loader on the same file."""
    v, f = mesh.cylinder_mesh(0.1, 0.25, n=10)
    path = str(tmp_path / f"m.{fmt[:3]}")
    if fmt == "obj":
        mesh.save_obj(path, v, f)
    elif fmt == "stl":
        mesh.save_stl(path, v, f)
    else:
        with open(path, "w") as fh:
            fh.write("solid m\n")
            for tri in v[f]:
                fh.write("facet normal 0 0 0\n outer loop\n")
                fh.write("".join(f"  vertex {float(x)!r} {float(y)!r} {float(z)!r}\n" for x, y, z in tri))
                fh.write(" endloop\nendfacet\n")
            fh.write("endsolid m\n")
    got = mesh.load_mesh(path)
    for a, b in zip(got, jax_mesh.load_mesh(path)):
        _equal(a, b, fmt)
    gv, gf = got
    assert gf.shape == f.shape
    tol = 1e-7 if fmt == "stl" else 1e-8
    # the same triangles (as vertex coordinates), up to the format's rounding
    np.testing.assert_allclose(np.sort(gv[gf].reshape(-1, 3), axis=0),
                               np.sort(v[f].reshape(-1, 3), axis=0), atol=tol)
    vol = mesh.mesh_volume_com_inertia(gv, gf)[0]
    assert vol == pytest.approx(mesh.mesh_volume_com_inertia(v, f)[0], rel=1e-5)


def test_dedup_triangles_matches_jax():
    tri = np.random.RandomState(1).randint(0, 3, size=(40, 3, 3)).astype(np.float64)
    for a, b in zip(mesh._dedup_triangles(tri), jax_mesh._dedup_triangles(tri)):
        _equal(a, b)


@pytest.mark.parametrize("max_verts", [None, 32, 12, 6])
@pytest.mark.parametrize("seed", [0, 1])
def test_convex_hull_matches_jax_bit_for_bit(seed, max_verts):
    pts = _cloud(seed)
    got = mesh.convex_hull(pts, max_verts=max_verts)
    want = jax_mesh.convex_hull(pts, max_verts=max_verts)
    for a, b, name in zip(got, want, ("verts", "normals", "offsets")):
        _equal(a, b, name)
    hv, hn, hb = got
    if max_verts is not None:
        assert hv.shape[0] <= max_verts
    assert np.all(hv @ hn.T <= hb + 1e-12)  # every vertex inside every plane


@pytest.mark.parametrize("name", ["foot.obj", "pelvis.obj", "torso.obj", "box", "cylinder"])
def test_mesh_volume_com_inertia_matches_jax(name):
    if name == "box":
        v, f = mesh.box_mesh((0.1, 0.2, 0.3))
    elif name == "cylinder":
        v, f = mesh.cylinder_mesh(0.1, 0.3, n=16)
    else:
        v, f = mesh.load_mesh(os.path.join(MESHES, name))
    got = mesh.mesh_volume_com_inertia(v, f, density=700.0)
    want = jax_mesh.mesh_volume_com_inertia(v, f, density=700.0)
    for a, b in zip(got, want):
        _equal(np.float64(a) if np.ndim(a) == 0 else a, np.float64(b) if np.ndim(b) == 0 else b, name)
    for a, b in zip(mesh.convex_hull(v, max_verts=8), jax_mesh.convex_hull(v, max_verts=8)):
        _equal(a, b, name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_primitive_and_procedural_meshes_match_jax(seed):
    pts = _cloud(seed) * np.r_[1.0, 0.3 * seed + 0.2, 1.0]
    got, want = mesh.fit_primitive(pts), jax_mesh.fit_primitive(pts)
    assert got["type"] == want["type"]
    for k in ("size", "rot", "pos"):
        _equal(got[k], want[k], k)
    for a, b in zip(mesh.box_mesh((0.1, 0.2, 0.3)), jax_mesh.box_mesh((0.1, 0.2, 0.3))):
        _equal(a, b)
    for a, b in zip(mesh.cylinder_mesh(0.1, 0.2, 8), jax_mesh.cylinder_mesh(0.1, 0.2, 8)):
        _equal(a, b)
    _equal(mesh.mesh_bounds(pts)[1], jax_mesh.mesh_bounds(pts)[1])


SHAPES = {
    "sphere": (GeomType.SPHERE, (0.1, 0, 0), None, None),
    "box": (GeomType.BOX, (0.1, 0.2, 0.3), None, None),
    "cylinder": (GeomType.CYLINDER, (0.1, 0.3, 0), None, None),
    "capsule": (GeomType.CAPSULE, (0.1, 0.3, 0), None, None),
    "ellipsoid": (GeomType.ELLIPSOID, (0.1, 0.2, 0.3), None, None),
    "convex_mesh": (GeomType.CONVEX, (0, 0, 0), *mesh.cylinder_mesh(0.1, 0.2, 12)),
    "convex_cloud": (GeomType.CONVEX, (0, 0, 0), _cloud(3), None),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_shape_mass_properties_match_jax(name):
    gtype, size, verts, faces = SHAPES[name]
    got = shapes.shape_mass_properties(gtype, size, verts=verts, faces=faces, density=900.0)
    want = jax_shapes.shape_mass_properties(gtype, size, verts=verts, faces=faces, density=900.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12, err_msg=name)


def test_body_mass_properties_and_plane_match_jax():
    geoms = [dict(type=GeomType.BOX, size=(0.1, 0.2, 0.05), p=(0.1, 0, 0)),
             dict(type=GeomType.CAPSULE, size=(0.05, 0.2, 0), R=np.array(
                 [[0.0, 0, 1], [0, 1, 0], [-1, 0, 0]]), p=(0, 0.1, 0.2)),
             dict(type=GeomType.CONVEX, size=(0, 0, 0), verts=_cloud(4) + 0.3)]
    for a, b in zip(shapes.body_mass_properties(geoms), jax_shapes.body_mass_properties(geoms)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
    for mod in (shapes, jax_shapes):
        with pytest.raises(ValueError, match="plane"):
            mod.shape_mass_properties(GeomType.PLANE, (0, 0, 0))


def _same_tree(a, b, where=""):
    """Equal nested dicts / lists / arrays / scalars, arrays bit for bit."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        _equal(a, b, where)
    else:
        assert a == b, (where, a, b)


def test_parse_urdf_of_atlas_matches_jax_link_by_link():
    got, want = urdf.parse_urdf(ATLAS_URDF), jax_urdf.parse_urdf(ATLAS_URDF)
    assert got["name"] == want["name"] and list(got["links"]) == list(want["links"])
    for name in want["links"]:
        _same_tree(got["links"][name], want["links"][name], name)
    _same_tree(got["joints"], want["joints"], "joints")
    assert sum(len(link["geoms"]) for link in got["links"].values()) == 13
    assert sum(g["type"] == GeomType.CONVEX for link in got["links"].values()
               for g in link["geoms"]) == 4


URDF_NO_INERTIAL = """<robot name="r">
  <link name="base"><collision><geometry><box size="0.2 0.4 0.1"/></geometry></collision></link>
  <link name="arm">
    <collision><origin xyz="0 0 0.1" rpy="0.1 0.2 0.3"/>
      <geometry><mesh filename="package://pkg/meshes/foot.obj" scale="1 1 2"/></geometry></collision>
    <collision><geometry><cylinder radius="0.05" length="0.3"/></geometry></collision>
  </link>
  <link name="tip"><inertial><mass value="0.5"/><inertia ixx="1e-3" iyy="2e-3" izz="3e-3"/></inertial></link>
  <joint name="j1" type="revolute"><parent link="base"/><child link="arm"/>
    <origin xyz="0 0 0.2"/><axis xyz="0 1 0"/><limit lower="-1" upper="1"/>
    <dynamics damping="0.3"/></joint>
  <joint name="j2" type="revolute"><parent link="arm"/><child link="tip"/><axis xyz="1 0 0"/>
    <mimic joint="j1" multiplier="-0.5" offset="0.1"/></joint>
</robot>"""


@pytest.mark.parametrize("skip_meshes", [False, True])
def test_urdf_string_with_shape_inertia_mesh_and_mimic_matches_jax(skip_meshes):
    """A URDF given as a string: mass properties from shapes (no
    <inertial>), a package:// mesh resolved under mesh_dir, a cylinder as a
    capsule, a mimic joint; the builders' models equal field for field."""
    import torch

    from diffdart_tpu.dynamics import model as jm

    from test_torch_model import _assert_same, _jax_fields

    got = urdf.parse_urdf(URDF_NO_INERTIAL, mesh_dir=os.path.dirname(MESHES))
    want = jax_urdf.parse_urdf(URDF_NO_INERTIAL, mesh_dir=os.path.dirname(MESHES))
    _same_tree(got["links"], want["links"], "links")
    _same_tree(got["joints"], want["joints"], "joints")
    models = []
    for mod, load, kw in ((None, urdf.load_urdf_into_builder, dict(dtype=torch.float64, device="cpu")),
                          (jm, jax_urdf.load_urdf_into_builder, {})):
        b = ModelBuilder() if mod is None else mod.ModelBuilder()
        load(b, URDF_NO_INERTIAL, skip_meshes=skip_meshes, mesh_dir=os.path.dirname(MESHES))
        models.append(b.finalize(**kw))
    from diffdart_tpu_torch.dynamics.model import model_to_numpy

    _assert_same(model_to_numpy(models[0]), _jax_fields(models[1]))
    assert len(models[0].hull_vcounts) == (0 if skip_meshes else 1)
    assert models[0].mimic_pairs == ((7, 6),)  # the dofs after the FREE root's 6


def test_resolve_mesh_path_forms_and_miss():
    base = os.path.dirname(MESHES)
    want = os.path.join(MESHES, "foot.obj")
    for ref in ("meshes/foot.obj", "package://atlas/meshes/foot.obj", "file://" + want, want):
        got = urdf.resolve_mesh_path(ref, base)
        assert os.path.samefile(got, want) and got == jax_urdf.resolve_mesh_path(ref, base)
    with pytest.raises(FileNotFoundError, match="nowhere.obj"):
        urdf.resolve_mesh_path("nowhere.obj", base)
    with pytest.raises(ValueError, match="unsupported mesh format"):
        mesh.load_mesh("x.ply")
