"""Long f64 scenarios on rapier_tpu_torch, on the CPU; marked slow, as the
reference marks tests/test_2d_core.py (tests/conftest.py `_SLOW_MODULES`).

- The reference's `test_far_pyramid_stands_at_f64` (tests/test_2d_core.py)
  held on the port: upstream's far pyramid at (1e5, -8e4), 300 steps at
  f64, its check (the largest rest-height error below 0.15), also at step
  60, the depth chip_smoke.py runs it to.  At float32 it sinks 2.45 in
  both packages (ROADMAP R2).
- ROADMAP F5: joints3 at its 4 substeps from `joint_starts` (scene 0 and
  1), 20 steps of the reference at f64 (in a subprocess) as the float64
  answer, and each package's float32 joint impulses measured against it as
  a share of the step's largest impulse.  The port at f64 agrees with the
  reference at f64 within 1e-6 of the step's largest impulse.
"""

import numpy as np
import pytest
import torch

import test_torch_common as tp
from rapier_tpu_torch import precision

pytestmark = pytest.mark.slow

FAR_STEPS = 300
FAR_CHIP_STEPS = 60       # chip_smoke.py phase 16 runs the pile this far
FAR_TOL = 0.15
F5_STEPS = 20
F64_JOINT_TOL = 1e-6


@pytest.fixture
def f64():
    precision.set_precision("f64")
    try:
        yield
    finally:
        precision.set_precision("f32")


def test_far_pyramid_stands_at_f64(f64):
    from rapier_tpu_torch.scenes import s2d_far_pyramid_world

    w, h = s2d_far_pyramid_world(device="cpu")
    w.build()
    assert w.state.bodies.pos.dtype == torch.float64 and w.params.dt.dtype == np.float64
    origin = np.asarray(h["origin"])
    done = 0
    for steps in (FAR_CHIP_STEPS, FAR_STEPS):
        w.step(steps - done)
        done = steps
        err, idx = 0.0, 0
        for row in range(10):
            for _ in range(10 - row):
                p = np.asarray(w.body_translation2(h["boxes"][idx]), np.float64) - origin
                err = max(err, abs(p[1] - (0.5 + row * 1.0)))
                idx += 1
        print(f"\nfar pyramid at f64 after {steps} steps: largest rest-height error {err:.6f}")
        assert err < FAR_TOL, f"far pyramid collapsed at f64 by step {steps}: error {err}"


def _shares(truth, run):
    """Per step: the largest |run - truth| joint impulse over the step's
    largest truth impulse."""
    return np.array([float(np.abs(np.asarray(r, np.float64) - t).max() / np.abs(t).max())
                     for t, r in zip(truth, run)])


def test_joint_impulses_against_float64(tmp_path, capsys):
    """F5: which package's float32 joint impulses lie nearer float64."""
    from rapier_tpu_torch.pipeline.physics_pipeline import step
    from rapier_tpu_torch.types import _REAL_FIELDS, from_numpy, tree_map

    batch, jparams = tp.joint_starts(4)["joints3"]
    _, ref32, port32 = tp.joint_rollouts({"joints3": (batch, jparams)}, F5_STEPS,
                                         tp.joint_step())["joints3"]
    params32 = from_numpy(jparams)
    from rapier_tpu_torch.dynamics.solver.joint_constraints import used_slots

    params32 = params32.replace(joint_slots=used_slots(from_numpy(batch).joints))
    # The same problem in float64 arithmetic: the float32 values, widened.
    params64 = params32.replace(**{f: np.asarray(getattr(params32, f), np.float64)
                                   for f in _REAL_FIELDS})
    state64 = tree_map(lambda x: x.double() if x.is_floating_point() else x,
                       from_numpy(batch))
    fields = ("joints.impulses", "bodies.pos")
    ref64 = tp.reference_f64(tmp_path, state=state64, params=params64, steps=F5_STEPS,
                             fields=fields, timeout=1500)["reference"]
    port64, _ = tp.port_f64_rollout(state64, params64, F5_STEPS, fields=fields)
    truth = [np.asarray(r["joints.impulses"], np.float64) for r in ref64]
    assert np.all(_shares(truth, [p["joints.impulses"] for p in port64]) <= F64_JOINT_TOL)
    port_share = _shares(truth, [s.joints.impulses for s in port32])
    ref_share = _shares(truth, [s.joints.impulses for s in ref32])
    with capsys.disabled():
        print(f"\nF5, joints3 at 4 substeps, {F5_STEPS} steps: float32 joint impulses "
              f"against the reference at f64, largest gap over the step's largest impulse: "
              f"port {port_share.max():.3e} (step {port_share.argmax() + 1}), "
              f"reference {ref_share.max():.3e} (step {ref_share.argmax() + 1}); "
              f"means port {port_share.mean():.3e}, reference {ref_share.mean():.3e}")
    assert np.isfinite(port_share).all() and np.isfinite(ref_share).all()
