"""The traffic from the seed: episode offsets, jitter and the kept samples."""

import numpy as np
import pytest

from port_bench import run

BIG = 2**40 + 12345


def test_offsets_are_the_seeds_and_spread_evenly():
    a = run.episode_offsets(BIG, 4096, 150)
    assert np.array_equal(a, run.episode_offsets(BIG, 4096, 150))
    assert not np.array_equal(a, run.episode_offsets(BIG + 1, 4096, 150))
    # Every seed gets the same multiset of offsets, in another order.
    assert np.array_equal(np.sort(a), np.sort(run.episode_offsets(7, 4096, 150)))
    counts = np.bincount(a, minlength=150)
    assert counts.min() == 4096 // 150 and counts.max() == 4096 // 150 + 1


def test_after_one_episode_of_warm_up_every_scene_has_reset_and_ages_are_uniform():
    """The loop resets scene i before step t when (o_i + t) % E == 0; after
    E warm-up steps every scene has reset once and, at each later step,
    the steps since each scene's reset are spread evenly over [0, E)."""
    e, b = 150, 4096
    o = run.episode_offsets(BIG, b, e)
    last_reset = np.zeros(b, dtype=np.int64)       # every scene starts fresh at t = 0
    for t in range(2 * e):
        last_reset[(o + t) % e == 0] = t
        if t >= e:
            assert (last_reset >= 1).all()
            ages = np.bincount(t - last_reset, minlength=e)
            assert len(ages) == e and ages.min() >= b // e and ages.max() <= b // e + 1


def test_jitter_is_the_seeds_and_within_its_amplitude():
    j = run.jitter(BIG, 64, 100, 0.025)
    assert j.shape == (64, 100, 2) and np.abs(j).max() <= 0.025
    assert np.array_equal(j, run.jitter(BIG, 64, 100, 0.025))
    assert not np.array_equal(j, run.jitter(BIG + 1, 64, 100, 0.025))
    assert np.abs(j).max() > 0.02


def test_kept_samples_are_the_seeds():
    traffic = dict(check_every=5, check_captures=8, check_scenes=8)
    s = run.check_schedule(BIG, 4096, traffic)
    assert len(s) == 8 and all(len(set(v)) == 8 for v in s.values())
    steps = sorted(s)
    assert steps[0] < 5 and np.all(np.diff(steps) == 5)
    t = run.check_schedule(BIG, 4096, traffic)
    assert all(np.array_equal(s[k], t[k]) for k in s)


@pytest.mark.parametrize("cell", ["mixed_primitives.e150", "primitives3.e150"])
def test_the_built_batch_is_jittered_from_the_seed(bench, cell):
    files = run.cell_files(bench, cell)
    cfg = dict(files["config"], scenes=3, num_layers=1, grid=2)
    s1, params, one, _ = run.build_batch(cfg, files["traffic"], BIG, "cpu")
    s2, _, _, _ = run.build_batch(cfg, files["traffic"], BIG, "cpu")
    assert (s1.bodies.pos == s2.bodies.pos).all()
    d = (s1.bodies.pos - one.bodies.pos).abs()
    amp = files["traffic"]["jitter_rad"] * cfg["rad"]
    assert d[..., 1].max() == 0 and 0 < d.max() <= amp * (1 + 1e-6)
    assert d[:, 0].max() == 0   # the fixed ground stays
    readings = run.start_readings(run.rows(s1, [0, 2]), files["layout"].layout(1, 2, cfg["rad"]),
                                  BIG, cfg, files["traffic"], [0, 2], params.gravity)
    assert readings["start_pos_gap_m"] < files["limits"]["start_pos_gap_m"]
    assert readings["start_shape_gap"] < files["limits"]["start_shape_gap"]
