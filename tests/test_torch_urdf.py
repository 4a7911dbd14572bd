"""rapier_tpu_torch.loaders.urdf against rapier_tpu.loaders.urdf.

The reference's own scenarios (tests/test_urdf.py): the double pendulum in
its impulse-joint and multibody forms, a binary STL and a Collada file
written to `tmp_path`, and a robot with every geometry the loader reads (a
mesh file through ``package://``, a cylinder, a sphere, a link with only an
inertial mass, a floating joint).  Loading is host-side numpy in both
packages, so the handle dicts and every leaf of the built states must be
equal exactly; the port steps the pendulum briefly to show the joints hold.
No reference step runs here.
"""

import dataclasses
import struct

import numpy as np
import pytest

PENDULUM = """
<robot name="pendulum">
  <link name="base">
    <collision>
      <geometry><box size="0.2 0.2 0.2"/></geometry>
    </collision>
  </link>
  <link name="arm1">
    <collision>
      <origin xyz="0 -0.25 0"/>
      <geometry><box size="0.05 0.5 0.05"/></geometry>
    </collision>
  </link>
  <link name="arm2">
    <collision>
      <origin xyz="0 -0.25 0"/>
      <geometry><capsule radius="0.04" length="0.4"/></geometry>
    </collision>
  </link>
  <joint name="shoulder" type="revolute">
    <parent link="base"/>
    <child link="arm1"/>
    <origin xyz="0.0 -0.1 0"/>
    <axis xyz="0 0 1"/>
    <limit lower="-2.0" upper="2.0"/>
  </joint>
  <joint name="elbow" type="continuous">
    <parent link="arm1"/>
    <child link="arm2"/>
    <origin xyz="0 -0.5 0"/>
    <axis xyz="0 0 1"/>
  </joint>
</robot>
"""

COLLADA = """<?xml version="1.0"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
  <asset><unit name="millimeter" meter="0.001"/></asset>
  <library_geometries>
    <geometry id="g1"><mesh>
      <source id="pos"><float_array id="pa" count="12">
        0 0 0  1000 0 0  0 1000 0  1000 1000 0
      </float_array></source>
      <vertices id="verts"><input semantic="POSITION" source="#pos"/></vertices>
      <triangles count="1">
        <input semantic="VERTEX" source="#verts" offset="0"/>
        <p>0 1 2</p>
      </triangles>
      <polylist count="1">
        <input semantic="VERTEX" source="#verts" offset="0"/>
        <vcount>4</vcount>
        <p>0 1 3 2</p>
      </polylist>
    </mesh></geometry>
  </library_geometries>
</COLLADA>
"""


def _binary_stl(tris):
    buf = b"\x00" * 80 + struct.pack("<I", len(tris))
    for tri in tris:
        buf += struct.pack("<3f", 0, 0, 1)
        for v in tri:
            buf += struct.pack("<3f", *v)
        buf += struct.pack("<H", 0)
    return buf


def _tetra():
    p = [(0.0, 0.0, 0.0), (0.2, 0.0, 0.0), (0.0, 0.2, 0.0), (0.0, 0.0, 0.2)]
    return [(p[0], p[2], p[1]), (p[0], p[1], p[3]), (p[0], p[3], p[2]), (p[1], p[2], p[3])]


def _load(xml, use_multibody=False, **kw):
    """The model through both loaders: (ref world, ref handles, ref state,
    port world, port handles, port state)."""
    from rapier_tpu.loaders.urdf import load_urdf as ref_load
    from rapier_tpu.world import PhysicsWorld as RefWorld
    from rapier_tpu_torch.loaders.urdf import load_urdf
    from rapier_tpu_torch.world import PhysicsWorld

    rw = RefWorld(gravity=(-3.0, -9.81, 0.0))
    pw = PhysicsWorld(gravity=(-3.0, -9.81, 0.0), device="cpu")
    rh = ref_load(xml, rw, use_multibody=use_multibody, **kw)
    ph = load_urdf(xml, pw, use_multibody=use_multibody, **kw)
    return rw, rh, rw.build(), pw, ph, pw.build()


def assert_loaded_equal(rw, rh, rs, pw, ph, ps):
    assert dataclasses.asdict(ph) == dataclasses.asdict(rh)
    for part in ("bodies", "colliders", "contacts", "joints", "multibodies", "meshes", "hulls"):
        r, p = getattr(rs, part), getattr(ps, part)
        assert (r is None) == (p is None), part
        if p is None:
            continue
        for f in dataclasses.fields(p):
            a, d = np.asarray(getattr(p, f.name)), np.asarray(getattr(r, f.name))
            assert a.shape == d.shape and np.array_equal(a, d, equal_nan=True), \
                f"{part}.{f.name}"
    assert pw.params.shape_types_present == rw.params.shape_types_present
    assert pw._mb_trees == getattr(rw, "_mb_trees", [])


@pytest.mark.parametrize("use_multibody", [False, True])
def test_pendulum_matches_reference(use_multibody):
    """Both forms: the handles, the built state, and the chain's poses
    (arm1 at base - 0.1, arm2 at arm1 - 0.5)."""
    loaded = _load(PENDULUM, use_multibody, root_translation=(0, 2, 0), fixed_base=True)
    assert_loaded_equal(*loaded)
    _rw, _rh, _rs, pw, ph, _ps = loaded
    assert set(ph.bodies) == {"base", "arm1", "arm2"} and set(ph.joints) == {"shoulder", "elbow"}
    assert ph.use_multibody == use_multibody
    np.testing.assert_allclose(pw.body_translation(ph.bodies["arm1"]), [0, 1.9, 0], atol=1e-6)
    np.testing.assert_allclose(pw.body_translation(ph.bodies["arm2"]), [0, 1.4, 0], atol=1e-6)
    if use_multibody:
        assert pw.state.multibodies is not None and pw.state.joints is None
        assert pw.multibody_link_of(ph.bodies["arm2"]) == (0, 2)
    else:
        assert pw.state.joints is not None and pw.state.multibodies is None


@pytest.mark.parametrize("use_multibody", [False, True])
def test_pendulum_swings_and_holds_together(use_multibody):
    """The port steps the pendulum 30 steps under a sideways pull: the base
    stays put, the anchors hold (exactly in the multibody form), the chain
    swings in its plane."""
    _rw, _rh, _rs, pw, ph, _ps = _load(PENDULUM, use_multibody, root_translation=(0, 2, 0),
                                        fixed_base=True)
    pw.step(30)
    base, arm1, arm2 = (pw.body_translation(ph.bodies[n]) for n in ("base", "arm1", "arm2"))
    assert np.isfinite(arm2).all()
    np.testing.assert_allclose(base, [0, 2, 0], atol=1e-6)
    tol = 1e-4 if use_multibody else 0.05
    assert abs(np.linalg.norm(arm1 - base) - 0.1) < tol
    assert arm2[0] < -0.005
    assert abs(arm1[2]) < 1e-2 and abs(arm2[2]) < 1e-2


def test_binary_stl_matches_reference(tmp_path):
    from rapier_tpu.loaders.urdf import _load_mesh_file as ref_read
    from rapier_tpu_torch.loaders.meshfiles import load_mesh_file

    path = tmp_path / "tri.stl"
    path.write_bytes(_binary_stl([((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0))] + _tetra()))
    verts, faces = load_mesh_file(str(path))
    rv, rf = ref_read(str(path))
    assert verts.dtype == rv.dtype and faces.dtype == rf.dtype
    np.testing.assert_array_equal(verts, rv)
    np.testing.assert_array_equal(faces, rf)
    assert faces.shape == (5, 3) and verts.shape[0] == 6     # shared vertices merged


def test_collada_matches_reference(tmp_path):
    from rapier_tpu.loaders.urdf import _load_mesh_file as ref_read
    from rapier_tpu_torch.loaders.meshfiles import load_mesh_file

    path = tmp_path / "part.dae"
    path.write_text(COLLADA)
    verts, faces = load_mesh_file(str(path))
    rv, rf = ref_read(str(path))
    np.testing.assert_array_equal(verts, rv)
    np.testing.assert_array_equal(faces, rf)
    assert verts.shape == (4, 3) and faces.shape == (3, 3)
    np.testing.assert_allclose(verts.max(), 1.0)              # mm -> m


def test_ascii_stl_and_obj_match_reference(tmp_path):
    from rapier_tpu.loaders.urdf import _load_mesh_file as ref_read
    from rapier_tpu_torch.loaders.meshfiles import load_mesh_file

    lines = ["solid t"]
    for tri in _tetra():
        lines += ["facet normal 0 0 1", "outer loop"]
        lines += [f"vertex {v[0]} {v[1]} {v[2]}" for v in tri]
        lines += ["endloop", "endfacet"]
    (tmp_path / "t.stl").write_text("\n".join(lines + ["endsolid t"]))
    (tmp_path / "q.obj").write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1/1 2/2 3/3 4/4\n")
    for name in ("t.stl", "q.obj"):
        got, want = load_mesh_file(str(tmp_path / name)), ref_read(str(tmp_path / name))
        for a, d in zip(got, want):
            assert a.dtype == d.dtype
            np.testing.assert_array_equal(a, d)
    assert load_mesh_file(str(tmp_path / "none.stl")) is None
    assert load_mesh_file(str(tmp_path / "q.ply")) is None


def test_every_geometry_matches_reference(tmp_path):
    """A robot file with a mesh link (package:// path, scaled), a cylinder
    link turned by its collision origin, a sphere, a link with only an
    inertial mass, a prismatic limit, a fixed joint and a floating one."""
    (tmp_path / "meshes").mkdir()
    (tmp_path / "meshes" / "tet.stl").write_bytes(_binary_stl(_tetra()))
    urdf = """
<robot name="zoo">
  <link name="base"><collision><geometry><box size="0.4 0.2 0.4"/></geometry></collision></link>
  <link name="shell"><collision><origin xyz="0 0 0.1" rpy="0.1 0.2 0.3"/>
    <geometry><mesh filename="package://meshes/tet.stl" scale="2 1 1"/></geometry>
  </collision></link>
  <link name="drum"><collision><origin rpy="1.5707963 0 0"/>
    <geometry><cylinder radius="0.1" length="0.3"/></geometry></collision></link>
  <link name="ball"><collision><geometry><sphere radius="0.05"/></geometry></collision></link>
  <link name="weight"><inertial><mass value="2.5"/></inertial></link>
  <link name="free"><collision><geometry><box size="0.1 0.1 0.1"/></geometry></collision></link>
  <joint name="lift" type="prismatic"><parent link="base"/><child link="shell"/>
    <origin xyz="0 0.2 0"/><axis xyz="0 1 0"/><limit lower="-0.1" upper="0.3"/></joint>
  <joint name="spin" type="continuous"><parent link="shell"/><child link="drum"/>
    <origin xyz="0.2 0 0" rpy="0 0 0.5"/><axis xyz="1 0 0"/></joint>
  <joint name="glue" type="fixed"><parent link="drum"/><child link="ball"/>
    <origin xyz="0 0.15 0"/></joint>
  <joint name="hang" type="revolute"><parent link="drum"/><child link="weight"/>
    <origin xyz="0 -0.2 0"/><axis xyz="0 0 1"/><limit lower="1" upper="-1"/></joint>
  <joint name="loose" type="floating"><parent link="base"/><child link="free"/>
    <origin xyz="1 0 0"/></joint>
</robot>
"""
    path = tmp_path / "zoo.urdf"
    path.write_text(urdf)
    for use_multibody in (False, True):
        loaded = _load(str(path), use_multibody, root_translation=(0.5, 1.0, -0.5))
        assert_loaded_equal(*loaded)
        ph = loaded[4]
        assert "loose" not in ph.joints and ph.joint_names == ["lift", "spin", "glue", "hang"]
    ps = loaded[5]
    assert ps.meshes is not None and ps.bodies.inv_mass[ph.bodies["weight"]] == np.float32(1 / 2.5)
