"""The halfspace kernels, the cuboid support point and the halfspace's AABB
and mass of rapier_tpu_torch against rapier_tpu's, on seeded lanes: 1e-5 on
points, normals and distances (1e-6 on support points), feature ids and
validity equal.  The quadruped path that uses them is in
tests/test_torch_quadruped.py.
"""

import functools

import jax
import numpy as np
import pytest
import torch


def _close(actual, desired, atol, what):
    a, d = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
    assert a.shape == d.shape, (what, a.shape, d.shape)
    err = float(np.max(np.abs(a - d)))
    assert err <= atol, f"{what}: max |diff| {err:.3e} > {atol}"


P = 64


def _lanes(seed, shape_type):
    """Seeded lanes of one shape type above a tilted halfspace, lane-last."""
    rng = np.random.default_rng(seed)
    pA = rng.uniform(-0.3, 0.3, (3, P)).astype(np.float32)
    qA = rng.normal(0, 1, (4, P)).astype(np.float32)
    qA /= np.linalg.norm(qA, axis=0)
    prmA = np.zeros((12, P), np.float32)
    if shape_type == "ball":
        prmA[0] = rng.uniform(0.05, 0.3, P)
    elif shape_type == "capsule":
        prmA[0:3] = rng.uniform(-0.2, 0.2, (3, P))
        prmA[3:6] = rng.uniform(-0.2, 0.2, (3, P))
        prmA[6] = rng.uniform(0.02, 0.1, P)
    else:
        prmA[0:3] = rng.uniform(0.05, 0.3, (3, P))
    pB = rng.uniform(-0.1, 0.1, (3, P)).astype(np.float32)
    qB = np.zeros((4, P), np.float32)
    qB[3] = 1.0
    qB[0] = rng.uniform(-0.2, 0.2, P)
    qB /= np.linalg.norm(qB, axis=0)
    prmB = np.zeros((12, P), np.float32)
    prmB[2] = 1.0
    return pA, qA, prmA, pB, qB, prmB


def _check_manifold(port, ref, what):
    for name in ("normal", "point", "dist"):
        _close(getattr(port, name)[0].numpy(), getattr(ref, name), 1e-5, f"{what} {name}")
    for name in ("fid", "valid"):
        assert np.array_equal(getattr(port, name)[0].numpy(),
                              np.asarray(getattr(ref, name))), (what, name)


@pytest.mark.parametrize("kind", ["ball", "capsule", "cuboid"])
def test_halfspace_kernels_match_reference(kind):
    from rapier_tpu.geometry import narrowphase as ref_np
    from rapier_tpu.types import ShapeType
    from rapier_tpu_torch.geometry import narrowphase as port_np

    args = _lanes({"ball": 1, "capsule": 2, "cuboid": 3}[kind], kind)
    targs = [torch.from_numpy(a)[None] for a in args]
    vl = functools.partial(jax.vmap, in_axes=-1, out_axes=-1)
    if kind == "cuboid":
        st = np.full((P,), int(ShapeType.CUBOID), np.int32)
        ref = vl(ref_np.convex_halfspace)(args[0], args[1], st, *args[2:])
        port = port_np.convex_halfspace(targs[0], targs[1], torch.from_numpy(st)[None],
                                        *targs[2:])
    else:
        name = f"{kind}_halfspace"
        ref = vl(getattr(ref_np, name))(*args)
        port = getattr(port_np, name)(*targs)
    _check_manifold(port, jax.tree.map(np.asarray, ref), f"{kind}-halfspace")


def test_support_point_matches_reference():
    from rapier_tpu.geometry import shapes as ref_shapes
    from rapier_tpu_torch.geometry import shapes as port_shapes

    rng = np.random.default_rng(4)
    st = np.repeat(np.array([0, 1, 2], np.int32), 20)
    prm = rng.uniform(0.05, 0.5, (60, 12)).astype(np.float32)
    d = rng.normal(0, 1, (60, 3)).astype(np.float32)
    ref = np.asarray(ref_shapes.support_point(st, prm, d))
    port = port_shapes.support_point(torch.from_numpy(st), torch.from_numpy(prm),
                                     torch.from_numpy(d)).numpy()
    _close(port, ref, 1e-6, "support_point")


def test_halfspace_aabb_and_mass():
    from rapier_tpu.geometry import mass_properties as ref_mp
    from rapier_tpu.geometry import shapes as ref_shapes
    from rapier_tpu_torch.geometry import mass_properties as port_mp
    from rapier_tpu_torch.geometry import shapes as port_shapes

    st = np.array([3], np.int32)
    prm = np.zeros((1, 12), np.float32)
    prm[0, 2] = 1.0
    pos = np.array([[0.1, 0.2, 0.3]], np.float32)
    rot = np.array([[0.0, 0.0, 0.0, 1.0]], np.float32)
    ref = ref_shapes.compute_aabbs(st, prm, pos, rot)
    port = port_shapes.compute_aabbs(*[torch.from_numpy(x) for x in (st, prm, pos, rot)])
    for a, r in zip(port, ref):
        assert np.array_equal(a.numpy(), np.asarray(r))
    assert port_mp.shape_mass_properties(3, prm[0], 1.0).mass == \
        ref_mp.shape_mass_properties(3, prm[0], 1.0).mass == 0.0
