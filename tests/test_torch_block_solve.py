"""The 2x2 block solve (`contact_constraints.solve_color(block_2x2=True)`, the
2D block solver) against the reference's, pass by pass, without a step.

Seeded contact lanes (`test_torch_common.seeded_lanes`: B = 2 scenes, 8
bodies, 64 lanes in 4 colors that share bodies, one to four active points)
are generated and updated by the port; both packages then run the same
constraints through colors 0-3 biased, then bias-free, and after each pass
the body velocities and the normal, tangent and twist impulses are compared.
Lanes 0, 7, 14, ... repeat point 0 as point 1 and have their rows 0 and 1
softened (r x 1.5), so that the pair's 2x2 matrix is singular (det < 0) and
the solve falls back to point 0 alone.

- float64 (the reference under `jax.enable_x64`): every value within 1e-9
  of the largest magnitude (at least 1); and over the passes the paired
  lanes reach each of the four MLCP cases and the singular fallback,
  classified from each pass's input velocities by a numpy
  transcription of the case rules (reference contact_constraints.py
  :676-760), every decision at least 1e-4 of the size of its terms away
  from its >= 0 tie.
- float32: each value's error against the float64 run, in units of 1e-5 of
  the largest magnitude, at most 1 or twice the reference's own.  The
  margin above keeps XLA's FMA contraction (R1b) from taking another case.
"""

import numpy as np
import pytest
import torch

import test_torch_common as tp

N = tp.SEED_N
SOFT = 1.5
RATES = dict(cfm_factor=0.8, inv_dt=240.0, allowed_lin_err=0.001, erp_inv_dt=60.0,
             max_corrective_velocity=10.0, warmstart_coeff=1.0)
IMPULSES = ("impulse", "tan_impulse", "twist_impulse")


def _constraints(dtype):
    """The port's updated constraints and solver bodies in `dtype`, and
    the singular lanes."""
    from rapier_tpu_torch.dynamics.solver import contact_constraints as pcc
    from rapier_tpu_torch.dynamics.solver.contact_constraints import SolverBodies

    man, sbn, prev, color, twin = tp.seeded_lanes(5)
    cast = tp.cast_float(dtype)
    sb = SolverBodies(**{k: torch.from_numpy(cast(v)) for k, v in sbn.items()})
    c = pcc.generate(tp.port_manifolds(man, cast), sb, torch.from_numpy(cast(prev)),
                     torch.from_numpy(color), N)
    rng = np.random.default_rng(6)
    k = c.b1.shape[-1]
    c = c._replace(
        impulse=torch.from_numpy(cast(rng.uniform(0, 0.3, (tp.B, 4, k)))) * c.point_mask,
        tan_impulse=torch.from_numpy(cast(rng.normal(0, 0.05, (tp.B, 2, k)))),
        twist_impulse=torch.from_numpy(cast(rng.normal(0, 0.02, (tp.B, k)))))
    c = pcc.update(c, sb, **RATES)
    soft = np.ones((tp.B, 4, k))
    soft[:, :2, twin] = SOFT
    return c._replace(r=c.r * torch.from_numpy(cast(soft))), sb, twin


def _to_reference(c, s):
    import jax.numpy as jnp

    def leaf(v):
        if not isinstance(v, torch.Tensor):
            return v
        v = v[s].numpy()
        return jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)

    return {name: leaf(v) for name, v in c._asdict().items()}


def _passes():
    return [(ci, use_bias) for use_bias in (True, False) for ci in range(4)]


def _run_both(dtype):
    """[(port constraints, port bodies)] and [(reference ...)] after each
    pass (the reference's stacked over the scenes), and the port's inputs."""
    import jax
    import jax.numpy as jnp
    import rapier_tpu.dynamics.solver.contact_constraints as jcc
    from rapier_tpu_torch.dynamics.solver import contact_constraints as pcc

    c, sb, _ = _constraints(dtype)
    port, pc, psb = [], c, sb
    for ci, use_bias in _passes():
        pc, psb = pcc.solve_color(pc, psb, ci, use_bias=use_bias, block_2x2=True)
        port.append((pc, psb))
    with jax.enable_x64(dtype == np.float64):
        per_scene = []
        for s in range(tp.B):
            rc = jcc.ContactConstraints(**_to_reference(c, s))
            rc = rc._replace(cfm_factor=jnp.asarray(rc.cfm_factor, dtype))
            rsb = jcc.SolverBodies(*(jnp.asarray(x[s].numpy()) for x in sb))
            oh1, oh2 = jcc.pair_onehots(rc, N + 1)
            out = []
            for ci, use_bias in _passes():
                rc, rsb = jcc.solve_color(rc, rsb, ci, oh1, oh2, use_bias=use_bias,
                                          block_2x2=True)
                out.append(({f: np.asarray(getattr(rc, f)) for f in IMPULSES},
                            {f: np.asarray(getattr(rsb, f)) for f in ("v_lin", "v_ang")}))
            per_scene.append(out)
    ref = [({f: np.stack([sc[i][0][f] for sc in per_scene]) for f in IMPULSES},
            {f: np.stack([sc[i][1][f] for sc in per_scene]) for f in ("v_lin", "v_ang")})
           for i in range(len(_passes()))]
    return (c, sb), port, ref


@pytest.fixture(scope="module")
def runs():
    return {name: _run_both(dt) for name, dt in (("f64", np.float64), ("f32", np.float32))}


def _values(port, ref):
    """[(what, port value, reference value)] of every pass."""
    out = []
    for i, ((pc, psb), (rimp, rsb)) in enumerate(zip(port, ref)):
        for f in ("v_lin", "v_ang"):
            out.append((f"pass {i} {f}", getattr(psb, f).numpy(), rsb[f]))
        for f in IMPULSES:
            out.append((f"pass {i} {f}", getattr(pc, f).numpy(), rimp[f]))
    return out


def _cases(c, sb, ci, use_bias):
    """The MLCP case of each paired lane of color `ci` (0: both impulses
    positive, 1: point 0's alone, 2: point 1's alone, 3: both zero, 4: the
    old impulses kept), whether its matrix is singular, and the smallest
    distance of a case decision from its tie, in float64 numpy."""
    f = {k: (v.numpy().astype(np.float64) if isinstance(v, torch.Tensor) else v)
         for k, v in c._asdict().items()}
    b1, b2 = c.b1.numpy(), c.b2.numpy()

    def lanes(table, idx):
        t = table.numpy().astype(np.float64)
        return np.take_along_axis(t, np.broadcast_to(idx[:, None], t.shape[:2] + idx.shape[-1:]),
                                  axis=-1)

    v1, w1, v2, w2 = lanes(sb.v_lin, b1), lanes(sb.v_ang, b1), lanes(sb.v_lin, b2), lanes(sb.v_ang, b2)

    def dot(a, b):
        return np.sum(a * b, axis=1)

    rhs = f["rhs"] if use_bias else f["rhs_wo_bias"]
    d, td1, td2, iitd1, iitd2 = (f["dir1"], f["torque_dir1"], f["torque_dir2"],
                                 f["ii_torque_dir1"], f["ii_torque_dir2"])
    lin = dot(d, v1) - dot(d, v2)
    dva = lin + dot(td1[:, 0], w1) + dot(td2[:, 0], w2) + rhs[:, 0]
    dvb = lin + dot(td1[:, 1], w1) + dot(td2[:, 1], w2) + rhs[:, 1]
    r0, r1 = f["r"][:, 0], f["r"][:, 1]
    m11, m22 = 1.0 / np.maximum(r0, 1e-12), 1.0 / np.maximum(r1, 1e-12)
    m12 = dot(d * (f["im1"] + f["im2"]), d) + dot(iitd1[:, 0], td1[:, 1]) \
        + dot(iitd2[:, 0], td2[:, 1])
    det = m11 * m22 - m12 * m12
    ok = det > 0
    sdet = np.where(ok, det, 1.0)
    inv11, inv22 = np.where(ok, m22 / sdet, r0), np.where(ok, m11 / sdet, 0.0)
    inv12, k12 = np.where(ok, -m12 / sdet, 0.0), np.where(ok, m12, 0.0)
    p0, p1 = f["impulse"][:, 0], f["impulse"][:, 1]
    n0x, n0y = p0 - (inv11 * dva + inv12 * dvb), p1 - (inv12 * dva + inv22 * dvb)
    n1x, n2y = p0 - r0 * dva, p1 - r1 * dvb
    q1, q2 = dvb + k12 * n1x, dva + k12 * n2y
    case = np.where((n0x >= 0) & (n0y >= 0), 0, np.where(
        (n1x >= 0) & (q1 >= 0), 1, np.where((n2y >= 0) & (q2 >= 0), 2, np.where(
            (dva >= 0) & (dvb >= 0), 3, 4))))
    pm = c.point_mask.numpy()
    paired = c.valid.numpy() & (c.color.numpy() == ci) & pm[:, 0] & pm[:, 1]
    a = np.abs
    terms = [(n0x, a(p0) + a(inv11 * dva) + a(inv12 * dvb)),
             (n0y, a(p1) + a(inv12 * dva) + a(inv22 * dvb)),
             (n1x, a(p0) + a(r0 * dva)), (q1, a(dvb) + a(k12 * n1x)),
             (n2y, a(p1) + a(r1 * dvb)), (q2, a(dva) + a(k12 * n2y)),
             (dva, a(lin) + a(dva - lin - rhs[:, 0]) + a(rhs[:, 0])),
             (dvb, a(lin) + a(dvb - lin - rhs[:, 1]) + a(rhs[:, 1])),
             (det, m11 * m22 + m12 * m12)]
    # Each decision's distance from 0 relative to the size of its terms; one
    # that is exactly 0 in float64 (a zero impulse, a singular row) is
    # exactly 0 in float32 too.
    margin = np.stack([np.where(x == 0.0, np.inf, a(x) / np.maximum(t, 1e-300))
                       for x, t in terms])[:, paired]
    return case[paired], ~ok[paired], float(margin.min()) if margin.size else np.inf


def test_every_case_and_the_fallback_are_reached(runs):
    (c, sb), port, _ = runs["f64"]
    inputs = [(c, sb)] + port[:-1]
    cases, singular, margin = [], [], np.inf
    for (ci, use_bias), (pc, psb) in zip(_passes(), inputs):
        k, sing, m = _cases(pc, psb, ci, use_bias)
        cases.append(k)
        singular.append(sing)
        margin = min(margin, m)
    cases, singular = np.concatenate(cases), np.concatenate(singular)
    assert set(cases[~singular].tolist()) >= {0, 1, 2, 3}, np.bincount(cases[~singular])
    assert singular.sum() >= 4 and len(set(cases[singular].tolist())) >= 2
    assert margin > 1e-4, margin
    # Lanes without both points active take the sequential candidates.
    pm = c.point_mask.numpy()
    assert (c.valid.numpy() & (pm[:, 0] ^ pm[:, 1])).sum() >= 8


def test_float64_matches_reference(runs):
    _, port, ref = runs["f64"]
    for what, p, r in _values(port, ref):
        tp.assert_scaled(p, r, what, 1e-9)
    assert float(np.abs(port[-1][0].impulse.numpy()).max()) > 0.1


def test_float32_rounding_as_close_as_the_reference(runs):
    exact = [r for _, _, r in _values(*runs["f64"][1:])]
    for (what, p32, r32), r64 in zip(_values(*runs["f32"][1:]), exact):
        p32, r32, r64 = (np.asarray(x, np.float64) for x in (p32, r32, r64))
        tol = 1e-5 * max(1.0, float(np.abs(r64).max()))
        port, ref = np.max(np.abs(p32 - r64)) / tol, np.max(np.abs(r32 - r64)) / tol
        assert port <= max(1.0, 2.0 * ref), f"{what}: port {port:.3f}, reference {ref:.3f}"


def test_points_beyond_the_pair_follow_the_block(runs):
    """Lanes with four active points solve points 2 and 3 after the block:
    their impulses change in the passes, as the reference's do."""
    (c, _), port, _ = runs["f64"]
    four = c.valid.numpy() & c.point_mask.numpy().all(axis=1)
    assert four.sum() >= 4
    diff = np.abs(port[-1][0].impulse.numpy() - c.impulse.numpy())[:, 2:]
    assert diff.transpose(0, 2, 1)[four].max() > 1e-3
