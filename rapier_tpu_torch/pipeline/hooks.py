"""User physics hooks: pair filtering and solver-contact modification
(counterpart of rapier_tpu.pipeline.hooks).

A hook is a plain Python callable over the whole pair batch of a step,
``(bodies, colliders, man)`` with `man` the step's `ManifoldBatch` (every
leaf ``[B, ...]``, the lane axis last):

- ``filter_contact_pair(bodies, colliders, man) -> keep [B, P] bool``: a
  pair whose colliders carry ACTIVE_HOOKS_FILTER_CONTACT_PAIR (either of
  them) leaves the solve and stops touching where keep is False; its
  manifold is still tracked.
- ``modify_solver_contacts(bodies, colliders, man) -> ManifoldBatch``: on
  pairs flagged ACTIVE_HOOKS_MODIFY_SOLVER_CONTACTS the step takes the
  returned manifold's solver payload (points, distances, normal, friction,
  restitution, active points); identity and validity stay the step's own.
- ``filter_intersection_pair`` is accepted and never called, as in the
  reference, whose pipelines never call it (ROADMAP R27).

Un-flagged pairs keep the default behaviour whatever a hook returns.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass(frozen=True)
class PhysicsHooks:
    """The optional hooks of a step (see the module docstring)."""

    filter_contact_pair: Optional[Callable] = None
    filter_intersection_pair: Optional[Callable] = None
    modify_solver_contacts: Optional[Callable] = None


def one_way_platform_hook(allowed_normal, threshold: float = 0.0):
    """The one-way platform (examples3d/one_way_platforms3.rs): keep the
    contacts whose manifold normal ``[B, 3, P]`` points along
    `allowed_normal` by at least `threshold`."""
    allowed = [float(x) for x in allowed_normal]

    def filter_fn(bodies, colliders, man):
        n = man.normal
        d = n[:, 0] * allowed[0] + n[:, 1] * allowed[1] + n[:, 2] * allowed[2]
        return d >= threshold

    return PhysicsHooks(filter_contact_pair=filter_fn)


# The solver-contact payload a modifier may write (physics_hooks.rs:31:
# points, distances, friction, restitution, tangent surface velocity), never
# pair identity or validity.  The manifolds carry no surface velocity, so
# that name is skipped, as the reference skips it (ROADMAP R28).
HOOK_WRITABLE = ("point", "dist", "normal", "friction", "restitution",
                 "surface_velocity", "point_active")


def apply_contact_filter(hooks, bodies, colliders, man, fields=("solver_pair", "touching")):
    """`man` with the filter hook applied to `fields` on the gated lanes."""
    from rapier_tpu_torch.types import ACTIVE_HOOKS_FILTER_CONTACT_PAIR

    if hooks is None or hooks.filter_contact_pair is None:
        return man
    gate = (man.active_hooks_or & ACTIVE_HOOKS_FILTER_CONTACT_PAIR) != 0
    keep = hooks.filter_contact_pair(bodies, colliders, man) | ~gate
    return man._replace(**{f: getattr(man, f) & keep for f in fields})


def apply_contact_modifier(hooks, bodies, colliders, man):
    """`man` with the modifier hook's HOOK_WRITABLE fields taken on the
    gated lanes (the ``[B, P]`` gate broadcast over each field's middle
    axes)."""
    from rapier_tpu_torch.types import ACTIVE_HOOKS_MODIFY_SOLVER_CONTACTS

    if hooks is None or hooks.modify_solver_contacts is None:
        return man
    gate = (man.active_hooks_or & ACTIVE_HOOKS_MODIFY_SOLVER_CONTACTS) != 0
    mod = hooks.modify_solver_contacts(bodies, colliders, man)
    updates = {}
    for f in HOOK_WRITABLE:
        if not hasattr(man, f):
            continue
        old = getattr(man, f)
        new = torch.as_tensor(getattr(mod, f), dtype=old.dtype, device=old.device)
        g = gate.view(gate.shape[:1] + (1,) * (old.dim() - 2) + gate.shape[-1:])
        updates[f] = torch.where(g, new, old)
    return man._replace(**updates)
