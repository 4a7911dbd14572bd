"""Scene queries over a batch of scenes: ray casts, point projection, point
and shape intersection, shape casts (counterpart of
rapier_tpu.geometry.queries, the reference's QueryPipeline,
query_pipeline.rs:44-780).

Every query evaluates all colliders and reduces, as the reference does
(no BVH).  The reference vmaps a per-collider function; here the lanes are a
grid ``[B, Q, C]``: B scenes, Q queries a scene (rays, points or shape
casts), C colliders, vectors ``[B, Q, C, 3]``.  Query inputs are ``[B, Q,
3]`` (quaternions ``[B, Q, 4]``), results ``[B, Q]`` (vectors ``[B, Q,
3]``).  The analytic shapes are computed for the shape types present in the
scene, on every lane; hull lanes run GJK (`geometry/gjk.py`, lane-first)
on those lanes only, mesh colliders reduce per-triangle lanes per collider
with `utils/routing.segment_max`.  Large grids are evaluated in chunks of
scenes (QUERY_LANES lanes each); a lane's result never depends on another's.

Shape casts (`cast_shape`, `cast_shape_nonlinear`) run the reference's
search on each (query, collider) lane whose swept bounds meet the
collider's bounds: 9 coarse samples along the motion, then `iters`
bisection steps inside the first penetrating interval, the answer the last
separated-side evaluation.  A lane outside the bounds cannot reach a gap
<= 0 and answers "no hit", as the reference's search does there; the
bisection runs only on the lanes whose coarse scan found a penetrating
sample and that do not start touching, the only lanes whose answer it sets.

The ray kernels are the reference's, but for one change of numerics: the
ball's, the capsule's and the cylinder's quadratics take their
discriminant as dd (r^2 - |l|^2), l the line's closest point to the axis,
instead of b^2 - dd c, which cancels on a grazing ray from far away (the
reference's form puts lidar hit points up to 1e-4 off a ball 12 m away;
this one 4e-6).  The two agree to the reference's rounding.

Query filter flags mirror QueryFilterFlags (query_pipeline.rs:575).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from rapier_tpu_torch.geometry import gjk as _gjk
from rapier_tpu_torch.geometry import shapes
from rapier_tpu_torch.geometry.dispatch import collider_world_poses
from rapier_tpu_torch.geometry.narrowphase_mesh import _triangle_sat, closest_point_triangle
from rapier_tpu_torch.math import quat
from rapier_tpu_torch.types import BodyType, ShapeType
from rapier_tpu_torch.utils.routing import make_segment_plan, segment_max

# QueryFilterFlags
EXCLUDE_FIXED = 1 << 0
EXCLUDE_KINEMATIC = 1 << 1
EXCLUDE_DYNAMIC = 1 << 2
EXCLUDE_SENSORS = 1 << 3
EXCLUDE_SOLIDS = 1 << 4

_INF = 1e30
# Lane elements (scenes x queries x colliders) evaluated at once.
QUERY_LANES = 1 << 22
# GJK lanes evaluated at once in a shape cast.
GJK_LANES = 1 << 20
# Distance beyond which a collider's bounds and a shape's swept bounds are
# apart for certain (GJK's own error is ~1e-6).
_BOUNDS_MARGIN = 1e-2
_N_COARSE = 8

_CUBOIDS = (ShapeType.CUBOID, ShapeType.ROUND_CUBOID)
_CYLINDERS = (ShapeType.CYLINDER, ShapeType.ROUND_CYLINDER)
_CONES = (ShapeType.CONE, ShapeType.ROUND_CONE)
_MESHES = (ShapeType.TRIMESH, ShapeType.HEIGHTFIELD)


class RayHit(NamedTuple):
    hit: torch.Tensor       # [B, R] bool
    toi: torch.Tensor       # [B, R] distance along the (unit or not) direction
    collider: torch.Tensor  # [B, R] int64 collider index (-1 when no hit)
    point: torch.Tensor     # [B, R, 3]
    normal: torch.Tensor    # [B, R, 3] outward surface normal at the hit


class PointProjection(NamedTuple):
    collider: torch.Tensor  # [B, P] int64 (-1 if none)
    point: torch.Tensor     # [B, P, 3] closest point on the collider
    distance: torch.Tensor  # [B, P] signed (negative inside a solid shape)
    is_inside: torch.Tensor  # [B, P]


class ShapeCastHit(NamedTuple):
    hit: torch.Tensor       # [B, Q] bool
    toi: torch.Tensor       # [B, Q] fraction [0, max_toi] along the direction
    collider: torch.Tensor  # [B, Q] int64 (-1 when none)
    normal: torch.Tensor    # [B, Q, 3] contact normal (obstacle towards the shape)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _col(x):
    return x.unsqueeze(-1)


def _vec(values, like):
    """A constant 3-vector on `like`'s device and dtype."""
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def _pick(k, *vals):
    """``vals[k]`` lane by lane (``k [...]``, each val ``[...]`` or ``[..., 3]``)."""
    out = vals[-1]
    for i in range(len(vals) - 2, -1, -1):
        sel = k == i
        out = torch.where(_col(sel) if out.dim() > k.dim() else sel, vals[i], out)
    return out


def _present(colliders):
    """The shape types the colliders hold (one host read)."""
    return {int(t) for t in torch.unique(colliders.shape_type).tolist()}


def _is(st, types):
    sel = torch.zeros_like(st, dtype=torch.bool)
    for t in types:
        sel = sel | (st == int(t))
    return sel


def _rows(x, idx):
    """Rows ``x [B, N, ...]`` at ``idx [B, M]`` -> ``[B, M, ...]``."""
    idx = idx.long()
    view = idx.view(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, view)


def _filter_mask(colliders, body_type, flags: int, exclude_collider=-1, exclude_body=-1,
                 groups: int = 0xFFFF_FFFF):
    """``[B, C]``: the colliders a query sees.  The excludes are ints or
    per-scene ``[B]`` tensors."""
    c = colliders
    n = c.parent.shape[-1]
    parent = c.parent
    bt = torch.where(parent >= 0, _rows(body_type, parent.clamp(min=0)), int(BodyType.FIXED))
    ok = c.enabled.clone()
    if flags & EXCLUDE_FIXED:
        ok = ok & ~((bt == BodyType.FIXED) | (parent < 0))
    if flags & EXCLUDE_KINEMATIC:
        ok = ok & ~((bt == BodyType.KINEMATIC_POSITION_BASED)
                    | (bt == BodyType.KINEMATIC_VELOCITY_BASED))
    if flags & EXCLUDE_DYNAMIC:
        ok = ok & ~(bt == BodyType.DYNAMIC)
    if flags & EXCLUDE_SENSORS:
        ok = ok & ~c.sensor
    ex_c = torch.as_tensor(exclude_collider, device=parent.device).reshape(-1, 1)
    ex_b = torch.as_tensor(exclude_body, device=parent.device).reshape(-1, 1)
    ok = ok & (torch.arange(n, device=parent.device) != ex_c)
    ok = ok & ~((parent == ex_b) & (parent >= 0))
    gm, gf = (int(groups) >> 16) & 0xFFFF, int(groups) & 0xFFFF
    cg = c.collision_groups.long()
    cm, cf = (cg >> 16) & 0xFFFF, cg & 0xFFFF
    return ok & ((gm & cf) != 0) & ((cm & gf) != 0)


# ---------------------------------------------------------------------------
# Scene chunks


def _slice(x, sl):
    """Scenes `sl` of a tensor, a dataclass of tensors, or None."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x[sl]
    return dataclasses.replace(x, **{f.name: getattr(x, f.name)[sl]
                                     for f in dataclasses.fields(x)})


def _by_scenes(fn, per_scene: int, bsz: int, *args):
    """`fn(*args)` over chunks of scenes of at most QUERY_LANES lanes; every
    tensor (or dataclass of tensors) argument has the scene axis first.
    Results (NamedTuples, tuples or tensors) are joined along it."""
    step = max(1, QUERY_LANES // max(1, per_scene))
    if step >= bsz:
        return fn(*args)
    parts = [fn(*[a if not (isinstance(a, torch.Tensor) or dataclasses.is_dataclass(a))
                  else _slice(a, slice(i, i + step)) for a in args])
             for i in range(0, bsz, step)]
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts)
    joined = [torch.cat([p[j] for p in parts]) for j in range(len(first))]
    return type(first)(*joined) if hasattr(first, "_fields") else tuple(joined)


def _as_real(x, like):
    """A float query input at the dtype and device of `like` (the state's
    positions)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=like.dtype, device=like.device)
    return torch.as_tensor(np.asarray(x, np.float64), dtype=like.dtype, device=like.device)


def _scene_rows(x, bsz: int, q: int, width: int, like):
    """A query input as ``[B, Q, width]`` at the state's dtype (from
    ``[width]``, ``[B, width]`` or ``[B, Q, width]``)."""
    x = _as_real(x, like)
    if x.dim() == 1:
        x = x.expand(bsz, q, width)
    elif x.dim() == 2:
        x = x.unsqueeze(1).expand(bsz, q, width)
    return x.expand(bsz, q, width)


def _per_query(x, bsz: int, q: int, like):
    """A scalar or ``[B]`` or ``[B, Q]`` value as ``[B, Q]`` at the state's
    dtype."""
    x = _as_real(x, like)
    if x.dim() == 1:
        x = x.unsqueeze(1)
    return x.expand(bsz, q)


def _per_scene(x, bsz: int, device):
    """An int or ``[B]`` tensor as a ``[B]`` int64 tensor."""
    return torch.as_tensor(x, dtype=torch.int64, device=device).reshape(-1).expand(bsz)


# ---------------------------------------------------------------------------
# Per-shape local ray kernels: o, d [..., 3] in the shape's frame


def _quadratic_disc(o, d, dd, b, r):
    """The discriminant b^2 - dd (o.o - r^2) of a ray against a sphere (or
    a cylinder's projected circle), as dd (r^2 - |l|^2) with l the line's
    closest point to the centre: the same value without the cancellation of
    b^2 against o.o at a grazing ray from far away (float32 left hit points
    1e-4 off a ball 12 m away)."""
    ell = o - d * _col(b / torch.clamp(dd, min=1e-12))
    return dd * (r * r - _dot(ell, ell))


def _ray_ball(o, d, r):
    b = _dot(o, d)
    c = _dot(o, o) - r * r
    dd_ = _dot(d, d)
    disc = _quadratic_disc(o, d, dd_, b, r)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    dd = torch.clamp(dd_, min=1e-12)
    t0 = (-b - sq) / dd
    t1 = (-b + sq) / dd
    inside = c <= 0.0
    t = torch.where(inside, torch.clamp(t1, min=0.0), t0)
    hit = (disc >= 0.0) & (t >= 0.0) & (inside | (t0 >= 0.0))
    p = o + d * _col(t)
    nrm = p / _col(torch.clamp(_norm(p), min=1e-12))
    return hit, t, nrm


def _ray_cuboid(o, d, h):
    small = torch.abs(d) < 1e-12
    inv = 1.0 / torch.where(small, torch.where(d >= 0, 1e-12, -1e-12), d)
    t1 = (-h - o) * inv
    t2 = (h - o) * inv
    tmin_ax = torch.minimum(t1, t2)
    tmax_ax = torch.maximum(t1, t2)
    par_out = small & (torch.abs(o) > h)
    tmin = torch.amax(tmin_ax, dim=-1)
    tmax = torch.amin(torch.where(par_out, -_INF, tmax_ax), dim=-1)
    inside = torch.all(torch.abs(o) <= h, dim=-1)
    t = torch.where(inside, torch.clamp(tmax, min=0.0), tmin)
    hit = (tmax >= torch.clamp(tmin, min=0.0)) & ~torch.any(par_out, dim=-1) & (t >= 0.0)
    p = o + d * _col(t)
    oh_out = torch.nn.functional.one_hot(torch.argmax(tmin_ax, dim=-1), 3).to(p.dtype)
    n_out = oh_out * _col(torch.sign(torch.sum(oh_out * p, dim=-1)))
    oh_in = torch.nn.functional.one_hot(
        torch.argmin(torch.where(par_out, _INF, tmax_ax), dim=-1), 3).to(p.dtype)
    nrm = torch.where(_col(inside), oh_in * torch.sign(p), n_out)
    return hit, t, nrm


def _ray_halfspace(o, d, n):
    denom = _dot(d, n)
    dist = _dot(o, n)
    t = -dist / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    hit = (dist >= 0.0) & (denom < 0.0) & (t >= 0.0)
    # A ray starting inside the halfspace hits at once (solid).
    hit = hit | (dist < 0.0)
    t = torch.where(dist < 0.0, 0.0, t)
    return hit, t, n.expand(o.shape)


def _closest_point_segment(a, b, p):
    ab = b - a
    t = torch.clamp(_dot(p - a, ab) / torch.clamp(_dot(ab, ab), min=1e-12), 0.0, 1.0)
    return a + ab * _col(t), t


def _ray_capsule(o, d, a, b, r):
    """The cylinder part as a quadratic in the axis frame, the caps as
    balls."""
    axis = b - a
    len_sq = torch.clamp(_dot(axis, axis), min=1e-12)
    u = axis / _col(torch.sqrt(len_sq))
    oo = o - a
    d_p = d - u * _col(_dot(d, u))
    o_p = oo - u * _col(_dot(oo, u))
    A = _dot(d_p, d_p)
    B = _dot(o_p, d_p)
    disc = _quadratic_disc(o_p, d_p, A, B, r)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    tc = (-B - sq) / torch.clamp(A, min=1e-12)
    s = _dot(oo + d * _col(tc), u)
    cyl_ok = ((disc >= 0.0) & (A > 1e-12) & (tc >= 0.0) & (s >= 0.0)
              & (s <= torch.sqrt(len_sq)))
    p_cyl = o + d * _col(tc)
    foot = a + u * _col(s)
    n_cyl = (p_cyl - foot) / _col(torch.clamp(r, min=1e-12))
    ha, ta, na = _ray_ball(o - a, d, r)
    hb, tb, nb = _ray_ball(o - b, d, r)
    ts = torch.stack([torch.where(cyl_ok, tc, _INF), torch.where(ha, ta, _INF),
                      torch.where(hb, tb, _INF)], dim=-1)
    t = torch.amin(ts, dim=-1)
    k = torch.argmin(ts, dim=-1)
    nrm = _pick(k, n_cyl, na, nb)
    hit = t < _INF
    q, _ = _closest_point_segment(a, b, o)
    inside = _norm(o - q) <= r
    return hit | inside, torch.where(inside, 0.0, t), nrm


def _ray_cylinder(o, d, hh, r):
    """Y-axis cylinder (half-height hh, radius r): the side quadratic and
    the cap discs (parry Cylinder::cast_local_ray)."""
    ox, oy, oz = o.unbind(-1)
    dx, dy_, dz = d.unbind(-1)
    a = dx * dx + dz * dz
    b = ox * dx + oz * dz
    c = ox * ox + oz * oz - r * r
    xz = _vec([1.0, 0.0, 1.0], o)
    disc = _quadratic_disc(o * xz, d * xz, a, b, r)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_side = (-b - sq) / torch.clamp(a, min=1e-12)
    y_s = oy + dy_ * t_side
    side_ok = (disc >= 0.0) & (a > 1e-12) & (t_side >= 0.0) & (torch.abs(y_s) <= hh)
    p_s = o + d * _col(t_side)
    n_side = _vec([1.0, 0.0, 1.0], o) * p_s / _col(torch.clamp(r, min=1e-12))
    dy = torch.where(torch.abs(dy_) < 1e-12, 1e-12, dy_)
    ts, ns = [torch.where(side_ok, t_side, _INF)], [n_side]
    for sgn in (1.0, -1.0):
        t_cap = (sgn * hh - oy) / dy
        p_c = o + d * _col(t_cap)
        cap_ok = ((t_cap >= 0.0) & (p_c[..., 0] * p_c[..., 0] + p_c[..., 2] * p_c[..., 2]
                                    <= r * r) & (torch.abs(dy_) >= 1e-12))
        ts.append(torch.where(cap_ok, t_cap, _INF))
        ns.append(_vec([0.0, sgn, 0.0], o).expand(o.shape))
    tstack = torch.stack(ts, dim=-1)
    k = torch.argmin(tstack, dim=-1)
    t = torch.gather(tstack, -1, k.unsqueeze(-1)).squeeze(-1)
    nrm = _pick(k, *ns)
    inside = (torch.abs(oy) <= hh) & (c <= 0.0)
    t = torch.where(inside, 0.0, t)
    return (t < _INF) | inside, t, nrm


def _ray_cone(o, d, hh, r):
    """Y-axis cone (apex +hh, base disc at -hh of radius r): the clamped
    infinite-cone quadric and the base disc."""
    ox, oy, oz = o.unbind(-1)
    dx, dy_, dz = d.unbind(-1)
    kk_ = r / torch.clamp(2.0 * hh, min=1e-12)
    k2 = kk_ * kk_
    uo = hh - oy
    A = dx * dx + dz * dz - k2 * dy_ * dy_
    B = ox * dx + oz * dz + k2 * uo * dy_
    C = ox * ox + oz * oz - k2 * uo * uo
    disc = B * B - A * C
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    An = torch.where(torch.abs(A) < 1e-12, 1e-12, A)
    t_sl = []
    for t in ((-B - sq) / An, (-B + sq) / An):
        y = oy + dy_ * t
        t_sl.append(torch.where((disc >= 0.0) & (t >= 0.0) & (y >= -hh) & (y <= hh), t, _INF))
    t_slant = torch.minimum(t_sl[0], t_sl[1])
    p_sl = o + d * _col(t_slant)
    n_sl = torch.stack([p_sl[..., 0], k2 * (hh - p_sl[..., 1]), p_sl[..., 2]], dim=-1)
    n_sl = n_sl / _col(torch.clamp(_norm(n_sl), min=1e-12))
    dy = torch.where(torch.abs(dy_) < 1e-12, 1e-12, dy_)
    t_base = (-hh - oy) / dy
    p_b = o + d * _col(t_base)
    base_ok = ((t_base >= 0.0) & (p_b[..., 0] * p_b[..., 0] + p_b[..., 2] * p_b[..., 2]
                                  <= r * r) & (torch.abs(dy_) >= 1e-12))
    t_b = torch.where(base_ok, t_base, _INF)
    first = t_slant <= t_b            # argmin of the pair: the first of equal
    t = torch.where(first, t_slant, t_b)
    nrm = torch.where(_col(first), n_sl, _vec([0.0, -1.0, 0.0], o))
    inside = (oy >= -hh) & (oy <= hh) & (C <= 0.0) & (uo >= 0.0)
    t = torch.where(inside, 0.0, t)
    return (t < _INF) | inside, t, nrm


def _hull_support(hv, d):
    """Support point of padded hull vertices ``hv [L, V, 3]`` along ``d
    [L, 3]`` (the first vertex of the largest dot product)."""
    dots = hv[..., 0] * d[:, None, 0] + hv[..., 1] * d[:, None, 1] + hv[..., 2] * d[:, None, 2]
    k = torch.argmax(dots, dim=1)
    return torch.gather(hv, 1, k.view(-1, 1, 1).expand(-1, 1, 3)).squeeze(1)


def _ray_convex(o, d, hv, max_toi=_INF, iters: int = 16):
    """Rays ``[L, 3]`` against hulls ``[L, V, 3]`` by GJK conservative
    advancement: at parameter t the point o + d_unit t advances by its GJK
    distance to the hull, which cannot overshoot (parry's RayCast for
    ConvexPolyhedron; the hull table holds vertices only)."""
    dlen = torch.clamp(_norm(d), min=1e-12)
    du = d / _col(dlen)
    m = torch.tensor(max_toi, dtype=o.dtype, device=o.device) * dlen

    def dist_at(t):
        p = o + du * _col(t)

        def supp(dd):
            sa = _hull_support(hv, dd)
            return sa - p, sa, p

        return _gjk.gjk(supp, p - hv[:, 0])

    t = torch.zeros_like(dlen)
    done = torch.zeros_like(dlen, dtype=torch.bool)
    hit = torch.zeros_like(done)
    for _ in range(iters):
        g = dist_at(t)
        hit_now = g["intersect"] | (g["dist"] < 1e-5)
        t_next = torch.where(done | hit_now, t, t + g["dist"])
        done = done | hit_now | (t_next > m)
        hit = hit | hit_now
        t = t_next
    g = dist_at(torch.clamp(t - 1e-4, min=0.0))
    return hit & (t <= m), t / dlen, -g["normal"]      # hull -> point: the outward normal


def _hull_table(colliders, hulls):
    """Per-collider padded hull vertices ``[B, C, V, 3]`` (hull 0's for a
    collider that is not CONVEX), or None."""
    if hulls is None:
        return None
    h = hulls.vertices
    h_idx = torch.where(colliders.shape_type == ShapeType.CONVEX,
                        colliders.shape_params[..., 0].long(), 0).clamp(0, h.shape[1] - 1)
    return _rows(h, h_idx)


def _grid_lanes(mask):
    """The (b, q, c) indices of the True lanes of a ``[B, Q, C]`` mask."""
    return torch.nonzero(mask, as_tuple=True)


def _ray_shape_local(o, d, st, prm, types):
    """Local ray dispatch over the analytic shape types present.  Round
    shapes cast against their inner shape (their borders are small by
    construction, as in the reference)."""
    hit = torch.zeros(o.shape[:-1], dtype=torch.bool, device=o.device)
    t = torch.full(o.shape[:-1], _INF, dtype=o.dtype, device=o.device)
    nrm = torch.zeros_like(o)
    branches = (
        ((ShapeType.BALL,), lambda: _ray_ball(o, d, prm[..., 0])),
        (_CUBOIDS, lambda: _ray_cuboid(o, d, prm[..., 0:3])),
        ((ShapeType.HALFSPACE,), lambda: _ray_halfspace(o, d, prm[..., 0:3])),
        ((ShapeType.CAPSULE,), lambda: _ray_capsule(o, d, prm[..., 0:3], prm[..., 3:6],
                                                    prm[..., 6])),
        (_CYLINDERS, lambda: _ray_cylinder(o, d, prm[..., 0], prm[..., 1])),
        (_CONES, lambda: _ray_cone(o, d, prm[..., 0], prm[..., 1])),
    )
    for ts_, fn in branches:
        if not any(int(x) in types for x in ts_):
            continue
        h_, t_, n_ = fn()
        sel = _is(st, ts_)
        hit = torch.where(sel, h_, hit)
        t = torch.where(sel, t_, t)
        nrm = torch.where(_col(sel), n_, nrm)
    return hit, t, nrm


def _mesh_tri_tables(colliders, meshes):
    """Per-triangle owner collider ``[B, T]``, whether it has one, and the
    owner-local vertices ``[B, T, 3]`` of every mesh collider's triangles
    (shape_params[0:2] hold a mesh collider's (tri_start, tri_count))."""
    tri = meshes.triangles                                   # [B, T, 3]
    t_ids = torch.arange(tri.shape[1], device=tri.device).view(1, -1, 1)
    start = colliders.shape_params[..., 0].long().unsqueeze(1)
    count = colliders.shape_params[..., 1].long().unsqueeze(1)
    is_mesh = _is(colliders.shape_type, _MESHES).unsqueeze(1)
    in_range = is_mesh & (t_ids >= start) & (t_ids < start + count)     # [B, T, C]
    has_owner = torch.any(in_range, dim=2) & torch.all(tri >= 0, dim=2)
    owner = torch.argmax(in_range.int(), dim=2)
    v = [_rows(meshes.vertices, tri[..., k].clamp(min=0)) for k in range(3)]
    return owner, has_owner, v[0], v[1], v[2]


def _reduce_mesh_lanes(value, lane_ok, owner, n_c):
    """Per collider, the least `value` of its triangles' lanes and the
    highest-indexed triangle reaching it (tie-safe).  value, lane_ok ``[M,
    T]``, owner ``[B, T]`` broadcast to M = B x Q rows -> (best ``[M, C]``,
    winning triangle ``[M, C]``, -1 where none)."""
    m, t = value.shape
    own = owner.repeat_interleave(m // owner.shape[0], dim=0)
    plan = make_segment_plan(torch.where(lane_ok, own, n_c), n_c + 1)
    best = -segment_max(torch.where(lane_ok, -value, -_INF), plan, -_INF)[:, :n_c]
    t_ids = torch.arange(t, device=value.device).expand(m, t)
    is_best = lane_ok & (value <= torch.gather(best, 1, own))
    idx = segment_max(torch.where(is_best, t_ids, -1), plan, -1)[:, :n_c]
    return best, idx


def _ray_mesh_all(origin, direction, colliders, meshes, w_pos, w_rot, ok, max_toi):
    """Rays ``[B, R, 3]`` against every mesh triangle (Moeller-Trumbore,
    double-sided), reduced per collider: (t ``[B, R, C]``, INF where none;
    world normal ``[B, R, C, 3]``)."""
    owner, has_owner, v0, v1, v2 = _mesh_tri_tables(colliders, meshes)
    bsz, r = origin.shape[:2]
    n_c = colliders.shape_type.shape[1]
    cp = _rows(w_pos, owner).unsqueeze(1)                    # [B, 1, T, 3]
    cr = _rows(w_rot, owner).unsqueeze(1)
    o = quat.inv_rotate(cr, origin.unsqueeze(2) - cp)        # [B, R, T, 3]
    d = quat.inv_rotate(cr, direction.unsqueeze(2).expand(o.shape))
    v0, v1, v2 = v0.unsqueeze(1), v1.unsqueeze(1), v2.unsqueeze(1)
    e1, e2 = v1 - v0, v2 - v0
    h = quat.cross(d, e2)
    a = _dot(e1, h)
    f = 1.0 / torch.where(torch.abs(a) < 1e-12, 1e-12, a)
    s = o - v0
    u = f * _dot(s, h)
    q = quat.cross(s, e1)
    v = f * _dot(d, q)
    t = f * _dot(e2, q)
    hit = ((torch.abs(a) >= 1e-12) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= 0.0) & (t <= max_toi.unsqueeze(-1))
           & (has_owner & torch.gather(ok, 1, owner)).unsqueeze(1))
    n_l = quat.cross(e1, e2)
    n_l = n_l / _col(torch.clamp(_norm(n_l), min=1e-12))
    n_w = quat.rotate(cr, n_l)
    n_w = n_w * -_col(torch.sign(_dot(n_w, direction.unsqueeze(2))))
    mt = torch.where(hit, t, _INF)
    best, idx = _reduce_mesh_lanes(mt.reshape(bsz * r, -1), hit.reshape(bsz * r, -1),
                                   owner, n_c)
    mesh_t = best.view(bsz, r, n_c)
    idx = idx.view(bsz, r, n_c)
    mesh_n = torch.gather(n_w, 2, idx.clamp(min=0).unsqueeze(-1).expand(bsz, r, n_c, 3))
    return torch.where((mesh_t < _INF) & (idx >= 0), mesh_t, _INF), mesh_n


def _cast_ray_lanes(bodies, colliders, meshes, hulls, origin, direction, max_toi, flags,
                    exclude_collider, exclude_body, groups):
    """Per-lane (t ``[B, R, C]``, INF where no hit; world normal ``[B, R, C,
    3]``) shared by cast_ray and intersect_ray."""
    w_pos, w_rot = collider_world_poses(bodies, colliders)
    ok = _filter_mask(colliders, bodies.body_type, flags, exclude_collider, exclude_body,
                      groups)
    types = _present(colliders)
    cp, cr = w_pos.unsqueeze(1), w_rot.unsqueeze(1)          # [B, 1, C, ...]
    st = colliders.shape_type.unsqueeze(1)
    prm = colliders.shape_params.unsqueeze(1)
    o = quat.inv_rotate(cr, origin.unsqueeze(2) - cp)        # [B, R, C, 3]
    d = quat.inv_rotate(cr, direction.unsqueeze(2).expand(o.shape))
    hit, t, nrm = _ray_shape_local(o, d, st, prm, types)
    if hulls is not None and int(ShapeType.CONVEX) in types:
        lanes = _grid_lanes((st == ShapeType.CONVEX).expand(hit.shape))
        hv = _hull_table(colliders, hulls)
        h_x, t_x, n_x = _ray_convex(o[lanes], d[lanes], hv[lanes[0], lanes[2]])
        hit, t, nrm = hit.index_put(lanes, h_x), t.index_put(lanes, t_x), \
            nrm.index_put(lanes, n_x)
    hit = hit & ok.unsqueeze(1) & (t <= max_toi.unsqueeze(-1)) & (t >= 0.0)
    ts = torch.where(hit, t, _INF)
    normals = quat.rotate(cr, nrm)
    if meshes is not None:
        mesh_t, mesh_n = _ray_mesh_all(origin, direction, colliders, meshes, w_pos, w_rot,
                                       ok, max_toi)
        better = mesh_t < ts
        normals = torch.where(_col(better), mesh_n, normals)
        ts = torch.where(better, mesh_t, ts)
    return ts, normals


def _ray_args(bodies, colliders, origin, direction, max_toi, exclude_collider,
              exclude_body):
    dev = bodies.pos.device
    bsz = bodies.pos.shape[0]
    origin = _as_real(origin, bodies.pos)
    r = origin.shape[1]
    return (bsz, r, _scene_rows(origin, bsz, r, 3, bodies.pos),
            _scene_rows(direction, bsz, r, 3, bodies.pos), _per_query(max_toi, bsz, r, bodies.pos),
            _per_scene(exclude_collider, bsz, dev), _per_scene(exclude_body, bsz, dev))


def cast_ray(bodies, colliders, origin, direction, max_toi=_INF, flags: int = 0,
             exclude_collider=-1, exclude_body=-1, groups: int = 0xFFFF_FFFF,
             meshes=None, hulls=None) -> RayHit:
    """Closest hit of each ray (QueryPipeline::cast_ray): origin and
    direction ``[B, R, 3]``, max_toi a float or ``[B, R]``.  Every shape
    type: the analytic kernels, GJK conservative advancement on hulls,
    Moeller-Trumbore over mesh triangles.  On an exact tie in t the first
    collider wins."""
    bsz, r, origin, direction, max_toi, ex_c, ex_b = _ray_args(
        bodies, colliders, origin, direction, max_toi, exclude_collider, exclude_body)
    c = colliders.shape_type.shape[1]

    def run(bodies, colliders, meshes, hulls, origin, direction, max_toi, ex_c, ex_b):
        ts, normals = _cast_ray_lanes(bodies, colliders, meshes, hulls, origin, direction,
                                      max_toi, flags, ex_c, ex_b, groups)
        t = torch.amin(ts, dim=-1)
        k = torch.argmin(ts, dim=-1)
        hit = t < _INF
        n = torch.gather(normals, 2, k.view(k.shape + (1, 1)).expand(k.shape + (1, 3)))
        return RayHit(hit=hit, toi=torch.where(hit, t, max_toi),
                      collider=torch.where(hit, k, -1),
                      point=origin + direction * _col(t),
                      normal=torch.where(_col(hit), n.squeeze(2), 0.0))

    return _by_scenes(run, r * c, bsz, bodies, colliders, meshes, hulls, origin, direction,
                      max_toi, ex_c, ex_b)


def intersect_ray(bodies, colliders, origin, direction, max_toi=_INF, flags: int = 0,
                  exclude_collider=-1, exclude_body=-1, groups: int = 0xFFFF_FFFF,
                  meshes=None, hulls=None):
    """Every hit of each ray (QueryPipeline::intersect_ray): (hit ``[B, R,
    C]``, toi ``[B, R, C]``, normal ``[B, R, C, 3]``)."""
    bsz, r, origin, direction, max_toi, ex_c, ex_b = _ray_args(
        bodies, colliders, origin, direction, max_toi, exclude_collider, exclude_body)
    c = colliders.shape_type.shape[1]

    def run(bodies, colliders, meshes, hulls, origin, direction, max_toi, ex_c, ex_b):
        ts, normals = _cast_ray_lanes(bodies, colliders, meshes, hulls, origin, direction,
                                      max_toi, flags, ex_c, ex_b, groups)
        return ts < _INF, ts, normals

    return _by_scenes(run, r * c, bsz, bodies, colliders, meshes, hulls, origin, direction,
                      max_toi, ex_c, ex_b)


# ---------------------------------------------------------------------------
# Points


def _axis_y(like):
    return _vec([0.0, 1.0, 0.0], like)


def _project_cylinder(p, hh, r):
    """Closest surface point and signed distance, y-axis cylinder."""
    rho = torch.sqrt(p[..., 0] * p[..., 0] + p[..., 2] * p[..., 2])
    u = torch.where(_col(rho > 1e-9),
                    _vec([1.0, 0.0, 1.0], p) * p / _col(torch.clamp(rho, min=1e-9)),
                    _vec([1.0, 0.0, 0.0], p))
    ey = _axis_y(p)
    inside = (rho <= r) & (torch.abs(p[..., 1]) <= hh)
    rho_c = torch.minimum(rho, r)
    y_c = torch.minimum(torch.maximum(p[..., 1], -hh), hh)
    proj_out = u * _col(rho_c) + ey * _col(y_c)
    d_out = _norm(p - proj_out)
    d_side = r - rho
    d_cap = hh - torch.abs(p[..., 1])
    proj_side = u * _col(r) + ey * _col(p[..., 1])
    proj_cap = u * _col(rho) + ey * _col(torch.sign(p[..., 1]) * hh)
    proj_in = torch.where(_col(d_side < d_cap), proj_side, proj_cap)
    d_in = -torch.minimum(d_side, d_cap)
    return torch.where(_col(inside), proj_in, proj_out), torch.where(inside, d_in, d_out)


def _project_cone(p, hh, r):
    """Closest surface point and signed distance, y-axis cone (apex +hh)."""
    rho = torch.sqrt(p[..., 0] * p[..., 0] + p[..., 2] * p[..., 2])
    u = torch.where(_col(rho > 1e-9),
                    _vec([1.0, 0.0, 1.0], p) * p / _col(torch.clamp(rho, min=1e-9)),
                    _vec([1.0, 0.0, 0.0], p))
    ey = _axis_y(p)
    # The (rho, y) cross-section: slant segment apex (0, hh) -> rim (r, -hh).
    ab0, ab1 = r - 0.0, -hh - hh
    q0, q1 = rho - 0.0, p[..., 1] - hh
    tt = torch.clamp((q0 * ab0 + q1 * ab1) / torch.clamp(ab0 * ab0 + ab1 * ab1, min=1e-12),
                     0.0, 1.0)
    s0, s1 = 0.0 + ab0 * tt, hh + ab1 * tt
    e0, e1 = rho - s0, p[..., 1] - s1
    d_slant = torch.sqrt(e0 * e0 + e1 * e1)
    proj_slant = u * _col(s0) + ey * _col(s1)
    rho_b = torch.minimum(rho, r)
    proj_base = u * _col(rho_b) + ey * _col(-hh)
    d_base = _norm(p - proj_base)
    k = r / torch.clamp(2.0 * hh, min=1e-12)
    inside = (p[..., 1] >= -hh) & (p[..., 1] <= hh) & (rho <= k * (hh - p[..., 1]))
    proj_out = torch.where(_col(d_slant < d_base), proj_slant, proj_base)
    d_out = torch.minimum(d_slant, d_base)
    d_in = -torch.minimum(d_slant, p[..., 1] + hh)
    proj_in = torch.where(_col(d_slant < p[..., 1] + hh), proj_slant, proj_base)
    return (torch.where(_col(inside), proj_in, proj_out), torch.where(inside, d_in, d_out))


def _point_support(cp, cr, prm, hv, point):
    """GJK support map of a hull lane against a point (a ball of radius 0)."""
    st = torch.full(prm.shape[:1], int(ShapeType.CONVEX), dtype=torch.int32, device=cp.device)
    ball = torch.full_like(st, int(ShapeType.BALL))
    ident = torch.zeros_like(cr)
    ident[:, 3] = 1.0
    return _gjk.make_support(cp, cr, st, prm, point, ident, ball, torch.zeros_like(prm),
                             hullA=hv, types={int(ShapeType.CONVEX), int(ShapeType.BALL)})


def _point_gjk(cp, cr, prm, hv, point):
    supp = _point_support(cp, cr, prm, hv, point)
    d0 = point - cp
    d0 = torch.where(_col(_norm(d0) < 1e-9), _axis_y(d0), d0)
    return supp, _gjk.gjk(supp, d0)


def _hull_project(cp, cr, prm, hv, point):
    """Hull lanes ``[L, ...]``: (closest point in the hull's frame, signed
    distance): GJK outside, EPA depth inside."""
    supp, g = _point_gjk(cp, cr, prm, hv, point)
    n_l = cp.shape[0]
    depth = torch.zeros((n_l,), dtype=cp.dtype, device=cp.device)
    cpA_p = torch.zeros_like(cp)
    epa_ok = torch.zeros_like(depth, dtype=torch.bool)
    idx = torch.nonzero(g["intersect"]).flatten()
    if idx.numel():
        sub = _point_support(cp[idx], cr[idx], prm[idx], hv[idx], point[idx])
        d_, _n, a_, _b, ok_ = _gjk.epa(sub, {k: v[idx] for k, v in g.items()})
        depth[idx], cpA_p[idx], epa_ok[idx] = d_, a_, ok_
    border = prm[:, 1]
    inside = g["intersect"] & epa_ok
    proj_w = torch.where(_col(inside), cpA_p, g["cpA"] + g["normal"] * _col(border))
    dist = torch.where(inside, -depth, g["dist"] - border)
    return quat.inv_rotate(cr, proj_w - cp), dist


def _project_lanes(bodies, colliders, meshes, hulls, point, solid, ok):
    """Per-lane (world projection ``[B, P, C, 3]``, signed distance, rank)."""
    w_pos, w_rot = collider_world_poses(bodies, colliders)
    types = _present(colliders)
    cp, cr = w_pos.unsqueeze(1), w_rot.unsqueeze(1)
    st = colliders.shape_type.unsqueeze(1)
    prm = colliders.shape_params.unsqueeze(1)
    p = quat.inv_rotate(cr, point.unsqueeze(2) - cp)        # [B, P, C, 3]
    proj = torch.zeros_like(p)
    d = torch.full(p.shape[:-1], _INF, dtype=p.dtype, device=p.device)

    def ball():
        dist_c = _norm(p)
        return p / _col(torch.clamp(dist_c, min=1e-12)) * prm[..., 0:1], dist_c - prm[..., 0]

    def cuboid():
        h = prm[..., 0:3]
        q = torch.minimum(torch.maximum(p, -h), h)
        d_out = _norm(p - q)
        face_d = h - torch.abs(p)
        oh3 = torch.nn.functional.one_hot(torch.argmin(face_d, dim=-1), 3).to(p.dtype)
        sgn3 = torch.where(torch.sum(oh3 * p, dim=-1) >= 0, 1.0, -1.0).to(p.dtype)
        surf_in = p * (1.0 - oh3) + oh3 * _col(sgn3) * h
        inside_c = d_out < 1e-12
        return (torch.where(_col(inside_c), surf_in, q),
                torch.where(inside_c, -torch.amin(face_d, dim=-1), d_out))

    def capsule():
        cq, _ = _closest_point_segment(prm[..., 0:3], prm[..., 3:6], p)
        dd = p - cq
        dn = _norm(dd)
        return cq + dd / _col(torch.clamp(dn, min=1e-12)) * prm[..., 6:7], dn - prm[..., 6]

    def halfspace():
        n = prm[..., 0:3]
        d_hs = _dot(p, n)
        return p - n * _col(d_hs), d_hs

    for ts_, fn in (((ShapeType.BALL,), ball), (_CUBOIDS, cuboid),
                    ((ShapeType.CAPSULE,), capsule), ((ShapeType.HALFSPACE,), halfspace),
                    (_CYLINDERS, lambda: _project_cylinder(p, prm[..., 0], prm[..., 1])),
                    (_CONES, lambda: _project_cone(p, prm[..., 0], prm[..., 1]))):
        if not any(int(x) in types for x in ts_):
            continue
        pr_, d_ = fn()
        sel = _is(st, ts_).expand(d.shape)
        proj = torch.where(_col(sel), pr_, proj)
        d = torch.where(sel, d_, d)
    if hulls is not None and int(ShapeType.CONVEX) in types:
        lanes = _grid_lanes((st == ShapeType.CONVEX).expand(d.shape))
        hv = _hull_table(colliders, hulls)
        b_, c_ = lanes[0], lanes[2]
        pr_, d_ = _hull_project(w_pos[b_, c_], w_rot[b_, c_], colliders.shape_params[b_, c_],
                                hv[b_, c_], point[lanes[0], lanes[1]])
        proj, d = proj.index_put(lanes, pr_), d.index_put(lanes, d_)
    if solid:
        # Inside a solid shape the projection is the point itself.
        proj = torch.where(_col(d < 0.0), p, proj)
    rank = torch.clamp(d, min=0.0) if solid else torch.abs(d)
    rank = torch.where(ok.unsqueeze(1), rank, _INF)
    projs = quat.transform_point(cp, cr, proj)
    if meshes is not None:
        owner, has_owner, v0, v1, v2 = _mesh_tri_tables(colliders, meshes)
        bsz, n_p = point.shape[:2]
        n_c = st.shape[-1]
        cp_o = _rows(w_pos, owner).unsqueeze(1)              # [B, 1, T, 3]
        cr_o = _rows(w_rot, owner).unsqueeze(1)
        p_l = quat.inv_rotate(cr_o, point.unsqueeze(2) - cp_o)     # [B, P, T, 3]
        cpt = closest_point_triangle(
            p_l.transpose(-1, -2), v0.unsqueeze(1).transpose(-1, -2),
            v1.unsqueeze(1).transpose(-1, -2), v2.unsqueeze(1).transpose(-1, -2),
        ).transpose(-1, -2)                                  # [B, P, T, 3]
        d_tri = _norm(p_l - cpt)
        lane_ok = (has_owner & torch.gather(ok, 1, owner)).unsqueeze(1).expand(d_tri.shape)
        best, idx = _reduce_mesh_lanes(d_tri.reshape(bsz * n_p, -1),
                                       lane_ok.reshape(bsz * n_p, -1), owner, n_c)
        mesh_d, idx = best.view(bsz, n_p, n_c), idx.view(bsz, n_p, n_c)
        mesh_ok = (mesh_d < _INF) & (idx >= 0)
        ib = idx.clamp(min=0)

        def at_best(x):
            return torch.gather(x.expand(bsz, n_p, -1, x.shape[-1]), 2,
                                ib.unsqueeze(-1).expand(bsz, n_p, n_c, x.shape[-1]))

        proj_mesh = quat.transform_point(at_best(cp_o), at_best(cr_o), at_best(cpt))
        better = mesh_ok & (mesh_d < rank)
        projs = torch.where(_col(better), proj_mesh, projs)
        d = torch.where(better, mesh_d, d)
        rank = torch.where(better, mesh_d, rank)
    return projs, d, rank


def _point_args(bodies, point, exclude_collider, exclude_body):
    dev = bodies.pos.device
    bsz = bodies.pos.shape[0]
    point = _as_real(point, bodies.pos)
    n_p = point.shape[1]
    return (bsz, n_p, _scene_rows(point, bsz, n_p, 3, bodies.pos),
            _per_scene(exclude_collider, bsz, dev), _per_scene(exclude_body, bsz, dev))


def project_point(bodies, colliders, point, solid: bool = True, flags: int = 0,
                  meshes=None, hulls=None, exclude_collider=-1, exclude_body=-1,
                  groups: int = 0xFFFF_FFFF) -> PointProjection:
    """Closest point on any collider to each point ``[B, P, 3]``
    (QueryPipeline::project_point): the analytic shapes, hulls through GJK
    (EPA's depth inside), meshes through their closest triangle."""
    bsz, n_p, point, ex_c, ex_b = _point_args(bodies, point, exclude_collider, exclude_body)
    c = colliders.shape_type.shape[1]

    def run(bodies, colliders, meshes, hulls, point, ex_c, ex_b):
        ok = _filter_mask(colliders, bodies.body_type, flags, ex_c, ex_b, groups)
        projs, dists, ranks = _project_lanes(bodies, colliders, meshes, hulls, point, solid, ok)
        best = torch.amin(ranks, dim=-1)
        k = torch.argmin(ranks, dim=-1)
        found = best < _INF
        dk = torch.gather(dists, 2, k.unsqueeze(-1)).squeeze(-1)
        pk = torch.gather(projs, 2, k.view(k.shape + (1, 1)).expand(k.shape + (1, 3)))
        return PointProjection(collider=torch.where(found, k, -1), point=pk.squeeze(2),
                               distance=dk, is_inside=dk < 0.0)

    return _by_scenes(run, n_p * c, bsz, bodies, colliders, meshes, hulls, point, ex_c, ex_b)


def project_point_all(bodies, colliders, point, solid: bool = True, flags: int = 0,
                      meshes=None, hulls=None, exclude_collider=-1, exclude_body=-1,
                      groups: int = 0xFFFF_FFFF):
    """Each point's projection on every collider, the lanes `project_point`
    reduces: (point ``[B, P, C, 3]``, signed distance ``[B, P, C]``, seen
    ``[B, P, C]``: the collider passes the filter and has a projection)."""
    bsz, n_p, point, ex_c, ex_b = _point_args(bodies, point, exclude_collider, exclude_body)
    c = colliders.shape_type.shape[1]

    def run(bodies, colliders, meshes, hulls, point, ex_c, ex_b):
        ok = _filter_mask(colliders, bodies.body_type, flags, ex_c, ex_b, groups)
        projs, dists, ranks = _project_lanes(bodies, colliders, meshes, hulls, point, solid, ok)
        return projs, dists, ranks < _INF

    return _by_scenes(run, n_p * c, bsz, bodies, colliders, meshes, hulls, point, ex_c, ex_b)


def intersections_with_point(bodies, colliders, point, flags: int = 0, hulls=None,
                             exclude_collider=-1, exclude_body=-1,
                             groups: int = 0xFFFF_FFFF):
    """``[B, P, C]``: the colliders containing each point
    (QueryPipeline::intersect_point).  Mesh colliders are surfaces and never
    contain a point."""
    bsz, n_p, point, ex_c, ex_b = _point_args(bodies, point, exclude_collider, exclude_body)
    c = colliders.shape_type.shape[1]

    def run(bodies, colliders, hulls, point, ex_c, ex_b):
        ok = _filter_mask(colliders, bodies.body_type, flags, ex_c, ex_b, groups)
        w_pos, w_rot = collider_world_poses(bodies, colliders)
        cp, cr = w_pos.unsqueeze(1), w_rot.unsqueeze(1)
        st = colliders.shape_type.unsqueeze(1)
        prm = colliders.shape_params.unsqueeze(1)
        p = quat.inv_rotate(cr, point.unsqueeze(2) - cp)
        cq, _ = _closest_point_segment(prm[..., 0:3], prm[..., 3:6], p)
        rho2 = p[..., 0] * p[..., 0] + p[..., 2] * p[..., 2]
        hh, rr = prm[..., 0], prm[..., 1]
        kc = rr / torch.clamp(2.0 * hh, min=1e-12)
        cone_r = kc * (hh - p[..., 1])
        inside = torch.zeros(p.shape[:-1], dtype=torch.bool, device=p.device)
        for ts_, val in (
            ((ShapeType.BALL,), _norm(p) <= prm[..., 0]),
            (_CUBOIDS, torch.all(torch.abs(p) <= prm[..., 0:3], dim=-1)),
            ((ShapeType.CAPSULE,), _norm(p - cq) <= prm[..., 6]),
            ((ShapeType.HALFSPACE,), _dot(p, prm[..., 0:3]) <= 0.0),
            (_CYLINDERS, (rho2 <= rr * rr) & (torch.abs(p[..., 1]) <= hh)),
            (_CONES, (p[..., 1] >= -hh) & (p[..., 1] <= hh) & (rho2 <= cone_r * cone_r)),
        ):
            inside = torch.where(_is(st, ts_), val, inside)
        if hulls is not None and bool((st == ShapeType.CONVEX).any()):
            lanes = _grid_lanes((st == ShapeType.CONVEX).expand(inside.shape))
            hv = _hull_table(colliders, hulls)
            b_, c_ = lanes[0], lanes[2]
            prm_l = colliders.shape_params[b_, c_]
            _, g = _point_gjk(w_pos[b_, c_], w_rot[b_, c_], prm_l, hv[b_, c_],
                              point[lanes[0], lanes[1]])
            inside = inside.index_put(lanes, g["intersect"] | (g["dist"] <= prm_l[:, 1]))
        return inside & ok.unsqueeze(1)

    return _by_scenes(run, n_p * c, bsz, bodies, colliders, hulls, point, ex_c, ex_b)


# ---------------------------------------------------------------------------
# Shapes


def _query_tables(colliders, meshes, hulls):
    """The per-collider hull table and the mesh triangles (collider-local
    vertices ``[B, T, 3]``; padded rows moved far away, so their gap never
    wins)."""
    hv_table = _hull_table(colliders, hulls)
    mesh_ctx = None
    if meshes is not None:
        tri = meshes.triangles
        pad = torch.all(tri >= 0, dim=-1, keepdim=True)
        far = torch.full((3,), 1e8, dtype=meshes.vertices.dtype, device=tri.device)
        mesh_ctx = tuple(torch.where(pad, _rows(meshes.vertices, tri[..., k].clamp(min=0)),
                                     far) for k in range(3))
    return hv_table, mesh_ctx


def _shape_bounds(st: int, prm, pos, rot, hull=None):
    """The shape's AABB ``(lo, hi) [..., 3]`` at (pos, rot), its border
    radius included; a query hull ``[V, 3]`` is bounded by its farthest
    vertex."""
    t = torch.full(prm.shape[:-1], int(st), dtype=torch.int32, device=prm.device)
    b = _col(_gjk._border_radius(t, prm))
    if hull is not None and int(st) == int(ShapeType.CONVEX):
        rad = _norm(hull).max() + b
        return pos - rad, pos + rad
    mins, maxs = shapes.compute_aabbs(t, prm, pos, rot)
    return mins - b, maxs + b


def _swept_bounds(st: int, prm, pos, rot, end, hull=None):
    """The AABB of the shape moved from `pos` to `end` at `rot`."""
    lo0, hi0 = _shape_bounds(st, prm, pos, rot, hull)
    lo1, hi1 = _shape_bounds(st, prm, end, rot, hull)
    return torch.minimum(lo0, lo1), torch.maximum(hi0, hi1)


def _turning_bounds(st: int, prm, pos, end, hull=None):
    """The AABB of the shape moved from `pos` to `end` turning freely: a
    ball about its origin of the radius of its AABB's farthest corner."""
    ident = torch.zeros(pos.shape[:-1] + (4,), dtype=pos.dtype, device=pos.device)
    ident[..., 3] = 1.0
    lo, hi = _shape_bounds(st, prm, torch.zeros_like(pos), ident, hull)
    rad = _col(_norm(torch.maximum(lo.abs(), hi.abs())))
    return torch.minimum(pos, end) - rad, torch.maximum(pos, end) + rad


def _gap_convex(st, prm, hv_self, pos, rot, cpos, crot, tB, prmB, hvB, types):
    """GJK separation of the inner skeletons minus the border radii; a
    penetrating pair reports -1e-3 (the casts chase the zero crossing from the
    separated side).  Lanes ``[L, ...]``; normal A -> B."""
    stA = torch.full_like(tB, int(st))
    supp = _gjk.make_support(pos, rot, stA, prm, cpos, crot, tB, prmB, hullA=hv_self,
                             hullB=hvB, types=types)
    d0 = cpos - pos
    d0 = torch.where(_col(_norm(d0) < 1e-9), _axis_y(d0), d0)
    g = _gjk.gjk(supp, d0)
    b = _gjk._border_radius(stA, prm) + _gjk._border_radius(tB, prmB)
    return torch.where(g["intersect"], -1e-3, g["dist"] - b), g["normal"]


def _gap_halfspace(st, prm, hv_self, pos, rot, cpos, crot, prmB):
    """Exact plane distance of the shape's outer support (the round shapes'
    borders subtracted: their support is the inner shape's)."""
    prm_st = torch.full(prm.shape[:-1], int(st), dtype=torch.int32, device=prm.device)
    round_b = torch.where(
        prm_st == ShapeType.ROUND_CUBOID, prm[..., 3],
        torch.where(_is(prm_st, (ShapeType.ROUND_CYLINDER, ShapeType.ROUND_CONE)),
                    prm[..., 2],
                    torch.where(prm_st == ShapeType.CONVEX, prm[..., 1], 0.0)))
    n_plane = quat.rotate(crot, prmB[..., 0:3])
    s_l = shapes.support_point(prm_st, prm, quat.inv_rotate(rot, -n_plane), hv_self)
    s_w = quat.transform_point(pos, rot, s_l)
    return _dot(n_plane, s_w - cpos) - round_b, -n_plane


def _gap_mesh(st, prm, pos, rot, cpos, crot, prmB, tris):
    """The least sampled-SAT triangle gap over the collider's triangles
    (`tris`: collider-local v0, v1, v2 ``[L, T, 3]``)."""
    v0, v1, v2 = tris
    t_ids = torch.arange(v0.shape[1], device=v0.device)
    start = prmB[:, 0:1].long()
    count = prmB[:, 1:2].long()
    in_rng = (t_ids >= start) & (t_ids < start + count)       # [L, T]
    pos_l = quat.inv_rotate(crot, pos - cpos)
    rot_l = quat.mul(quat.conj(crot), rot)
    stA = torch.full(prm.shape[:1], int(st), dtype=torch.int32, device=prm.device)

    def cl(x):                                               # [L, k] -> [L, k, T]
        return x.unsqueeze(-1).expand(x.shape + (v0.shape[1],))

    gaps, tn = _triangle_sat(cl(pos_l), cl(rot_l), cl(stA), cl(prm), v0.transpose(1, 2),
                             v1.transpose(1, 2), v2.transpose(1, 2))   # [L, T], [L, 3, T]
    gaps = torch.where(in_rng, gaps, _INF)
    kt = torch.argmin(gaps, dim=1)
    d = torch.gather(gaps, 1, kt.unsqueeze(1)).squeeze(1)
    n = torch.gather(tn, 2, kt.view(-1, 1, 1).expand(-1, 3, 1)).squeeze(2)
    return d, quat.rotate(crot, n)


def _coarse_bisect(dist_at, m, iters: int):
    """The reference's TOI search on L lanes (`_coarse_bisect_cast`):
    `dist_at(t [S, L], lanes) -> (gap [S, L'], normal [S, L', 3])` for the
    lanes `lanes` (None: all).  Returns (toi [L], INF where no hit; normal
    [L, 3] towards the shape)."""
    n_l = m.shape[0]
    ts = (torch.arange(_N_COARSE + 1, dtype=m.dtype, device=m.device) / _N_COARSE
          ).unsqueeze(1) * m.unsqueeze(0)                      # [9, L]
    ds, ns = dist_at(ts, None)
    d0 = ds[0]
    neg = ds[1:] <= 0.0
    any_neg = torch.any(neg, dim=0)
    first = torch.argmax(neg.int(), dim=0)                     # the first penetrating sample
    seg = m / _N_COARSE
    lo = torch.clamp(first.to(m.dtype) * seg, min=0.0)
    hi = (first + 1).to(m.dtype) * seg
    n = torch.gather(ns, 0, first.view(1, -1, 1).expand(1, n_l, 3)).squeeze(0)
    start = d0 <= 0.0
    idx = torch.nonzero(any_neg & ~start).flatten()
    if idx.numel():
        lo_i, hi_i, n_i = lo[idx], hi[idx], n[idx]
        for _ in range(iters):
            mid = 0.5 * (lo_i + hi_i)
            dm, nm = dist_at(mid.unsqueeze(0), idx)
            dm, nm = dm[0], nm[0]
            sep = dm > 0.0
            # The normal of the last separated evaluation: it converges to
            # the surface normal as the bracket tightens.
            lo_i, hi_i = torch.where(sep, mid, lo_i), torch.where(sep, hi_i, mid)
            n_i = torch.where(_col(sep), nm, n_i)
        lo, n = lo.index_put((idx,), lo_i), n.index_put((idx,), n_i)
    toi = torch.where(start, 0.0, lo)
    n = torch.where(_col(start), ns[0], n)
    return torch.where(any_neg | start, toi, _INF), -n


def _gap_now(dist_at, m, iters: int):
    """The gap at t = 0 as `_coarse_bisect`'s result: toi 0 where the shape
    overlaps (gap <= 0), else INF."""
    d, n = dist_at(torch.zeros_like(m).unsqueeze(0), None)
    return torch.where(d[0] <= 0.0, 0.0, _INF).to(d.dtype), -n[0]


def _cast(bodies, colliders, meshes, hulls, st: int, prm, pose_at, sweep_bounds, max_toi,
          ok, iters: int, shape_hull, search=_coarse_bisect):
    """Per-lane (toi ``[B, Q, C]``, INF where none; normal ``[B, Q, C, 3]``)
    of a shape swept by `pose_at(t, b, q) -> (pos, rot)` (lanes ``[S, L]``),
    each lane searched by `search`.  `sweep_bounds` ``(lo, hi) [B, Q, 3]``
    bounds the shape over the motion."""
    w_pos, w_rot = collider_world_poses(bodies, colliders)
    bsz, n_q = max_toi.shape
    n_c = colliders.shape_type.shape[1]
    hv_table, mesh_ctx = _query_tables(colliders, meshes, hulls)
    mins, maxs = shapes.compute_aabbs(colliders.shape_type, colliders.shape_params, w_pos,
                                      w_rot)
    lo, hi = sweep_bounds
    slack = _BOUNDS_MARGIN + 1e-6 * torch.maximum(lo.abs(), hi.abs())
    reach = (torch.all(mins.unsqueeze(1) <= (hi + slack).unsqueeze(2), dim=-1)
             & torch.all(maxs.unsqueeze(1) >= (lo - slack).unsqueeze(2), dim=-1))
    lanes = reach & ok.unsqueeze(1)                           # [B, Q, C]
    toi = torch.full((bsz, n_q, n_c), _INF, dtype=lo.dtype, device=lo.device)
    nrm = torch.zeros((bsz, n_q, n_c, 3), dtype=lo.dtype, device=lo.device)
    tB_all = colliders.shape_type.unsqueeze(1).expand(bsz, n_q, n_c)
    types = _present(colliders) | {int(st)}
    cats = (
        ("convex", lanes & ~_is(tB_all, (ShapeType.HALFSPACE,) + _MESHES)),
        ("halfspace", lanes & (tB_all == ShapeType.HALFSPACE)),
        ("mesh", lanes & _is(tB_all, _MESHES) if mesh_ctx is not None else None),
    )
    for cat, mask in cats:
        if mask is None:
            continue
        b_, q_, c_ = _grid_lanes(mask)
        if b_.numel() == 0:
            continue
        cpos, crot = w_pos[b_, c_], w_rot[b_, c_]
        tB, prmB = colliders.shape_type[b_, c_], colliders.shape_params[b_, c_]
        prm_l = prm[b_, q_]
        hvB = None if hv_table is None else hv_table[b_, c_]
        hv_self = None if shape_hull is None else shape_hull.expand(
            (b_.numel(),) + shape_hull.shape[-2:])
        tris = None if cat != "mesh" else tuple(x[b_] for x in mesh_ctx)

        def dist_at(t, sub, b_=b_, q_=q_, cpos=cpos, crot=crot, tB=tB, prmB=prmB,
                    prm_l=prm_l, hvB=hvB, hv_self=hv_self, tris=tris, cat=cat):
            def pick(x):
                if x is None:
                    return None
                x = x if sub is None else x[sub]
                return x.unsqueeze(0).expand((t.shape[0],) + x.shape).reshape(
                    (-1,) + x.shape[1:])

            bb, qq = pick(b_), pick(q_)
            pos, rot = pose_at(t.reshape(-1), bb, qq)
            args = [pick(x) for x in (cpos, crot, tB, prmB, prm_l, hvB, hv_self)]
            cp_, cr_, tB_, prmB_, prm_, hvB_, hvs_ = args
            d_out, n_out = [], []
            for s in range(0, pos.shape[0], GJK_LANES):
                e = slice(s, s + GJK_LANES)

                def cut(x):
                    return None if x is None else x[e]

                if cat == "convex":
                    d_, n_ = _gap_convex(st, prm_[e], cut(hvs_), pos[e], rot[e], cp_[e],
                                         cr_[e], tB_[e], prmB_[e], cut(hvB_), types)
                elif cat == "halfspace":
                    d_, n_ = _gap_halfspace(st, prm_[e], cut(hvs_), pos[e], rot[e], cp_[e],
                                            cr_[e], prmB_[e])
                else:
                    tri = tuple(pick(x)[e] for x in tris)
                    d_, n_ = _gap_mesh(st, prm_[e], pos[e], rot[e], cp_[e], cr_[e],
                                       prmB_[e], tri)
                d_out.append(d_)
                n_out.append(n_)
            return (torch.cat(d_out).view(t.shape), torch.cat(n_out).view(t.shape + (3,)))

        t_l, n_l = search(dist_at, max_toi[b_, q_], iters)
        toi[b_, q_, c_] = t_l
        nrm[b_, q_, c_] = n_l
    return toi, nrm


def _closest_cast(toi, nrm, max_toi) -> ShapeCastHit:
    t = torch.amin(toi, dim=-1)
    k = torch.argmin(toi, dim=-1)
    hit = t < _INF
    n = torch.gather(nrm, 2, k.view(k.shape + (1, 1)).expand(k.shape + (1, 3))).squeeze(2)
    return ShapeCastHit(hit=hit, toi=torch.where(hit, t, max_toi),
                        collider=torch.where(hit, k, -1),
                        normal=torch.where(_col(hit), n, 0.0))


def _shape_args(bodies, shape_params, pos, rot, shape_hull):
    dev = bodies.pos.device
    bsz = bodies.pos.shape[0]
    pos = _as_real(pos, bodies.pos)
    n_q = pos.shape[1]
    prm = _scene_rows(shape_params, bsz, n_q, 12, bodies.pos)
    hull = None if shape_hull is None else _as_real(shape_hull, bodies.pos)
    return (bsz, n_q, prm, _scene_rows(pos, bsz, n_q, 3, bodies.pos),
            _scene_rows(rot, bsz, n_q, 4, bodies.pos), hull)


def cast_shape(bodies, colliders, shape_type, shape_params, pos, rot, direction, max_toi,
               flags: int = 0, exclude_collider=-1, exclude_body=-1,
               groups: int = 0xFFFF_FFFF, iters: int = 12, meshes=None, hulls=None,
               shape_hull=None) -> ShapeCastHit:
    """Sweep a convex shape (one type; parameters ``[12]`` or per query
    ``[B, Q, 12]``) from poses ``[B, Q, 3]`` / ``[B, Q, 4]`` along
    `direction` ``[B, Q, 3]`` up to `max_toi` (QueryPipeline::cast_shape):
    the search of the module docstring on the exact GJK separation, plane
    distance for halfspaces, the least triangle-SAT gap for meshes."""
    bsz, n_q, prm, pos, rot, hull = _shape_args(bodies, shape_params, pos, rot, shape_hull)
    dev = pos.device
    direction = _scene_rows(direction, bsz, n_q, 3, bodies.pos)
    max_toi = _per_query(max_toi, bsz, n_q, bodies.pos)
    ex_c, ex_b = _per_scene(exclude_collider, bsz, dev), _per_scene(exclude_body, bsz, dev)
    c = colliders.shape_type.shape[1]

    def run(bodies, colliders, meshes, hulls, prm, pos, rot, direction, max_toi, ex_c, ex_b):
        ok = _filter_mask(colliders, bodies.body_type, flags, ex_c, ex_b, groups)
        end = pos + direction * _col(max_toi)

        def pose_at(t, b, q):
            return pos[b, q] + direction[b, q] * _col(t), rot[b, q]

        toi, nrm = _cast(bodies, colliders, meshes, hulls, int(shape_type), prm, pose_at,
                         _swept_bounds(int(shape_type), prm, pos, rot, end, hull), max_toi, ok,
                         iters, hull)
        return _closest_cast(toi, nrm, max_toi)

    return _by_scenes(run, n_q * c, bsz, bodies, colliders, meshes, hulls, prm, pos, rot,
                      direction, max_toi, ex_c, ex_b)


def cast_shape_nonlinear(bodies, colliders, shape_type, shape_params, pos, rot, linvel,
                         angvel, max_toi, flags: int = 0, exclude_collider=-1,
                         exclude_body=-1, groups: int = 0xFFFF_FFFF, iters: int = 12,
                         meshes=None, hulls=None, shape_hull=None) -> ShapeCastHit:
    """Sweep a convex shape along a rigid motion (QueryPipeline::
    cast_shape_nonlinear, parry's NonlinearRigidMotion): pos(t) = pos +
    linvel t, rot(t) = exp(angvel t) rot, with cast_shape's search."""
    bsz, n_q, prm, pos, rot, hull = _shape_args(bodies, shape_params, pos, rot, shape_hull)
    dev = pos.device
    linvel = _scene_rows(linvel, bsz, n_q, 3, bodies.pos)
    angvel = _scene_rows(angvel, bsz, n_q, 3, bodies.pos)
    max_toi = _per_query(max_toi, bsz, n_q, bodies.pos)
    ex_c, ex_b = _per_scene(exclude_collider, bsz, dev), _per_scene(exclude_body, bsz, dev)
    c = colliders.shape_type.shape[1]

    def run(bodies, colliders, meshes, hulls, prm, pos, rot, linvel, angvel, max_toi, ex_c,
            ex_b):
        ok = _filter_mask(colliders, bodies.body_type, flags, ex_c, ex_b, groups)
        end = pos + linvel * _col(max_toi)

        def pose_at(t, b, q):
            tt = _col(t)
            return (pos[b, q] + linvel[b, q] * tt,
                    quat.normalize(quat.mul(quat.from_scaled_axis(angvel[b, q] * tt),
                                            rot[b, q])))

        toi, nrm = _cast(bodies, colliders, meshes, hulls, int(shape_type), prm, pose_at,
                         _turning_bounds(int(shape_type), prm, pos, end, hull), max_toi, ok,
                         iters, hull)
        return _closest_cast(toi, nrm, max_toi)

    return _by_scenes(run, n_q * c, bsz, bodies, colliders, meshes, hulls, prm, pos, rot,
                      linvel, angvel, max_toi, ex_c, ex_b)


def intersect_shape(bodies, colliders, shape_type, shape_params, pos, rot, flags: int = 0,
                    exclude_collider=-1, exclude_body=-1, groups: int = 0xFFFF_FFFF,
                    meshes=None, hulls=None, shape_hull=None):
    """``[B, Q, C]``: the colliders a convex shape placed at (pos, rot)
    overlaps, gap <= 0 (QueryPipeline::intersect_shape,
    query_pipeline.rs:537)."""
    bsz, n_q, prm, pos, rot, hull = _shape_args(bodies, shape_params, pos, rot, shape_hull)
    ex_c = _per_scene(exclude_collider, bsz, pos.device)
    ex_b = _per_scene(exclude_body, bsz, pos.device)
    c = colliders.shape_type.shape[1]

    def run(bodies, colliders, meshes, hulls, prm, pos, rot, ex_c, ex_b):
        ok = _filter_mask(colliders, bodies.body_type, flags, ex_c, ex_b, groups)
        zero = torch.zeros(pos.shape[:2], dtype=pos.dtype, device=pos.device)

        def pose_at(t, b, q):
            return pos[b, q], rot[b, q]

        toi, _ = _cast(bodies, colliders, meshes, hulls, int(shape_type), prm, pose_at,
                       _shape_bounds(int(shape_type), prm, pos, rot, hull), zero, ok, 0, hull,
                       search=_gap_now)
        return toi <= 0.0

    return _by_scenes(run, n_q * c, bsz, bodies, colliders, meshes, hulls, prm, pos, rot,
                      ex_c, ex_b)


def intersect_aabb_conservative(bodies, colliders, aabb_min, aabb_max, flags: int = 0,
                                exclude_collider=-1, exclude_body=-1,
                                groups: int = 0xFFFF_FFFF):
    """``[B, C]``: the colliders whose skin-inflated AABB meets the query box
    ``[B, 3]`` (QueryPipeline::intersect_aabb_conservative: may include a
    collider that does not touch it, never misses one)."""
    w_pos, w_rot = collider_world_poses(bodies, colliders)
    mins, maxs = shapes.compute_aabbs(colliders.shape_type, colliders.shape_params, w_pos,
                                      w_rot)
    skin = colliders.contact_skin.unsqueeze(-1)
    mins, maxs = mins - skin, maxs + skin
    lo = torch.as_tensor(aabb_min, dtype=mins.dtype, device=mins.device).reshape(-1, 1, 3)
    hi = torch.as_tensor(aabb_max, dtype=mins.dtype, device=mins.device).reshape(-1, 1, 3)
    ok = _filter_mask(colliders, bodies.body_type, flags, exclude_collider, exclude_body,
                      groups)
    return ok & torch.all(mins <= hi, dim=-1) & torch.all(maxs >= lo, dim=-1)
