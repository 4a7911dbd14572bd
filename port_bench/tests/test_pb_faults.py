"""A run with the timed path broken underneath reads `correct` false, and so
does the control; a sound run reads true.  The runs skip the look for a card
and run on the CPU at a tiny size."""

import pytest
import torch

from port_bench import run

TINY = dict(scenes=3, num_layers=2, grid=2, episode_steps=8, check_every=1, check_captures=3,
            check_scenes=3)
SEED = 2**33 + 77


def port_step(state, params):
    from rapier_tpu_torch.pipeline.physics_pipeline import step

    return step(state, params)


def unchanged(state, params):
    """A step that returns its state unchanged."""
    return state, port_step(state, params)[1]


def half_the_batch(state, params):
    """Half of the batch left out: its scenes are not stepped."""
    new, events = port_step(state, params)
    half = state.bodies.pos.shape[0] // 2
    return run.zip_map(lambda n, o: torch.cat([n[:half], o[half:]]), new, state), events


def gravity_twice(state, params):
    """An answer altered where it is produced: gravity's velocity change
    applied a second time."""
    import dataclasses

    new, events = port_step(state, params)
    dv = torch.as_tensor(params.gravity, dtype=new.bodies.linvel.dtype) * float(params.dt)
    moving = (new.bodies.body_type == 0).unsqueeze(-1)
    linvel = torch.where(moving, new.bodies.linvel + dv, new.bodies.linvel)
    return dataclasses.replace(new, bodies=dataclasses.replace(new.bodies, linvel=linvel)), events


def run_tiny(bench, cell, step_fn=None, control=False):
    return run.run_cell(bench, cell, SEED, 0.3, False, device="cpu", overrides=TINY,
                        step_fn=step_fn, control=control)


@pytest.mark.parametrize("cell", ["mixed_primitives.e150", "mixed_primitives.e150-f64"])
def test_a_sound_run_is_correct(bench, f32, cell):
    out, checks, found = run_tiny(bench, cell)
    assert out["correct"], checks
    assert found["samples"] == 9 and out["failed"] == 0


@pytest.mark.parametrize("fault", [unchanged, half_the_batch, gravity_twice])
@pytest.mark.parametrize("cell", ["mixed_primitives.e150", "mixed_primitives.e150-f64"])
def test_a_broken_step_is_not_correct(bench, f32, cell, fault):
    out, checks, _ = run_tiny(bench, cell, step_fn=fault)
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in checks.values())


@pytest.mark.parametrize("cell, low", [("primitives3.e150", "bf16"),
                                       ("mixed_primitives.e150-f64", "f32")])
def test_the_control_fails_its_limits(bench, f32, cell, low):
    out, checks, found = run_tiny(bench, cell, control=True)
    assert out["correct"]
    limits = {k: c["limit"] for k, c in checks.items()}
    ctl = found["control"][low]
    assert any(ctl[k] > limits[k] for k in limits), ctl
    assert ctl["start_pos_gap_m"] > limits["start_pos_gap_m"]
    assert ctl["pos_gap_m"] > limits["pos_gap_m"]
