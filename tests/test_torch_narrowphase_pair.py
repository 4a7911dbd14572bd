"""`narrowphase_boxbox.cuboid_cuboid`, the one-pair box-box manifold, on the
reference's tests/test_narrowphase.py box-box cases (:55-90): each case's
own checks on the port's result, and the port's result against the
reference's `cuboid_cuboid_cl` on the same lane (the function the port's
`cuboid_cuboid` runs on one lane): normal, points and depths within TOL,
feature ids and validity equal.
"""

import numpy as np
import pytest
import torch

TOL = 1e-6
IDQ = (0.0, 0.0, 0.0, 1.0)


def _prm(*v):
    return list(v) + [0.0] * (12 - len(v))


def _edge_rot():
    import jax.numpy as jnp
    from rapier_tpu.math import quat

    r = quat.from_axis_angle(jnp.array([1.0, 0.0, 0.0]), jnp.pi / 4)
    return tuple(np.asarray(quat.mul(
        quat.from_axis_angle(jnp.array([0.0, 0.0, 1.0]), jnp.pi / 4), r)).tolist())


CASES = {
    "stack_four_points": ((0.0, 0.99, 0.0), IDQ),
    "offset_clip": ((0.5, 0.98, 0.0), IDQ),
    "edge_contact": ((0.0, 1.3, 0.0), None),
}


def _both(case):
    import jax.numpy as jnp
    from rapier_tpu.geometry.narrowphase_boxbox import cuboid_cuboid_cl
    from rapier_tpu_torch.geometry.narrowphase_boxbox import cuboid_cuboid

    pos, rot = CASES[case]
    rot = rot or _edge_rot()
    args = [(0.0, 0.0, 0.0), IDQ, _prm(0.5, 0.5, 0.5), pos, rot, _prm(0.5, 0.5, 0.5)]
    mine = cuboid_cuboid(*(torch.tensor(a, dtype=torch.float32) for a in args))
    ref = cuboid_cuboid_cl(*(jnp.asarray(np.asarray(a, np.float32))[:, None] for a in args))
    ref = type(mine)(normal=np.asarray(ref.normal)[:, 0], point=np.asarray(ref.point)[..., 0],
                     dist=np.asarray(ref.dist)[:, 0], fid=np.asarray(ref.fid)[:, 0],
                     valid=np.asarray(ref.valid)[:, 0])
    mine = type(mine)(*(x.numpy() for x in mine))
    assert mine.normal.shape == (3,) and mine.point.shape == (4, 3)
    for f in ("normal", "point", "dist"):
        np.testing.assert_allclose(getattr(mine, f), getattr(ref, f), atol=TOL, rtol=0,
                                   err_msg=f"{case} {f}")
    for f in ("fid", "valid"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f), err_msg=f"{case} {f}")
    return mine


@pytest.mark.parametrize("case", list(CASES))
def test_cuboid_cuboid_pair(case):
    m = _both(case)
    if case == "stack_four_points":
        assert np.all(m.valid)
        np.testing.assert_allclose(m.dist, -0.01, atol=1e-4)
        np.testing.assert_allclose(m.normal, [0, 1, 0], atol=1e-5)
        assert np.ptp(m.point[:, 0]) > 0.9 and np.ptp(m.point[:, 2]) > 0.9
    elif case == "offset_clip":
        pts = m.point[m.valid]
        assert pts[:, 0].min() > -0.01 and pts[:, 0].max() < 0.51
    else:
        assert np.any(m.valid)
        assert float(m.dist[np.argmax(m.valid)]) < 0.5
