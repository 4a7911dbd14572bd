"""The CUDA contact-sweep kernels, the non-kernel solves and the
impulse-joint step on the card (marker `gpu`; skipped without a CUDA
device).  Run on a machine with one
card:

    python -m pytest tests/test_torch_cuda.py -m gpu -q

The kernels are held against the plain PyTorch version on the same CUDA
inputs: body tables to 1e-4 and the impulse block to 1e-3 (atol; the plain
version's scatter-adds use atomics, so its summation order varies).  The
scene-folded kernel and the block-per-scene kernel run the same per-scene
code and must agree bit for bit.  This file imports no JAX, so it runs
where only PyTorch is installed.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

TOL = dict(bodies=1e-4, impulses=1e-3)
SCALAR_ARGS = ("dt_sub", "inv_dt_sub", "erp_inv_dt", "cfm_factor",
               "allowed_lin_err", "max_corrective_velocity", "warmstart_coeff")
STATIC_ARGS = ("n_sub", "pgs_iters", "stab_iters", "max_colors")


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def solve_inputs(device):
    """One step's solve inputs from 8 scenes of the parity scene shape,
    advanced 70 steps on the card (layers resting on each other)."""
    from rapier_tpu_torch.pipeline import physics_pipeline as pp
    from rapier_tpu_torch.scenes import mixed_primitives_world, replicate_scene
    from rapier_tpu_torch.types import from_numpy

    w = mixed_primitives_world(num_layers=3, grid=3, max_pairs=256)
    params = w.params.replace(max_solver_pairs=128)
    state = replicate_scene(from_numpy(w.build(), device), 8)
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.normal(0, 0.05, (8, 27, 3)).astype(np.float32))
    state.bodies.pos[:, 1:28] += noise.to(device)
    state.bodies.next_pos[:, 1:28] += noise.to(device)
    for _ in range(69):
        state, _ = pp.step(state, params)
    captured = {}
    original = pp.solve_from_manifolds

    def record(sb, **kw):
        captured.update(sb=sb, **kw)
        return original(sb, **kw)

    pp.solve_from_manifolds = record
    try:
        pp.step(state, params)
    finally:
        pp.solve_from_manifolds = original
    assert int(captured["valid"].sum()) > 0
    return captured


def _check(inp):
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    inp = dict(inp)
    sb = inp.pop("sb")
    launches = cs.KERNEL.launches + cs.KERNEL.launches_folded
    sb_k, imp_k = cs.solve_from_manifolds(sb, **inp)
    assert cs.KERNEL.launches + cs.KERNEL.launches_folded == launches + 1
    sb_p, imp_p = cs.solve_plain(sb, **inp)
    torch.cuda.synchronize()
    for name, a, b in zip(sb._fields, sb_k, sb_p):
        err = float((a - b).abs().max())
        assert err <= TOL["bodies"], (name, err)
    err = float((imp_k - imp_p).abs().max())
    assert err <= TOL["impulses"], err
    again = cs.solve_from_manifolds(sb, **inp)
    assert torch.equal(again[1], imp_k), "kernel not deterministic"


def test_kernel_matches_plain(solve_inputs):
    _check(solve_inputs)


def test_kernel_overflow_color(solve_inputs):
    """Four lanes per scene share one dynamic body in the overflow color."""
    inp = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in solve_inputs.items()}
    mc = inp["max_colors"]
    for s in range(inp["b1"].shape[0]):
        lanes = torch.nonzero(inp["valid"][s]).flatten()[:4]
        inp["b2"][s, lanes] = int(inp["b2"][s, lanes[0]])
        inp["dyn2"][s, lanes] = True
        inp["color"][s, lanes] = mc - 1
    inp["num_colors"][:] = mc
    _check(inp)


def _packed(inp):
    """The kernels' packed inputs and keyword arguments for `inp`."""
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    inp = dict(inp)
    sb = inp.pop("sb")
    packed = cs._pack(sb, **{k: v for k, v in inp.items()
                             if k not in SCALAR_ARGS + STATIC_ARGS})
    kw = dict(scalars=[inp[k] for k in SCALAR_ARGS], **{k: inp[k] for k in STATIC_ARGS})
    return sb, inp, packed, kw


def test_folded_kernel_matches_plain(solve_inputs):
    """The parity shape (K = 128 solver lanes) through the folded launcher."""
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    sb, inp, packed, kw = _packed(solve_inputs)
    assert inp["b1"].shape[-1] <= cs.FOLD_MAX_LANES
    folded = cs.KERNEL.launches_folded
    out_body, imp = cs.KERNEL.launch_folded(*packed, **kw)
    assert cs.KERNEL.launches_folded == folded + 1
    sb_p, imp_p = cs.solve_plain(sb, **inp)
    torch.cuda.synchronize()
    plain = torch.cat([sb_p.v_lin, sb_p.v_ang, sb_p.com, sb_p.rot], dim=1)
    assert float((out_body - plain).abs().max()) <= TOL["bodies"]
    assert float((imp - imp_p).abs().max()) <= TOL["impulses"]


def test_folded_kernel_matches_block_kernel_bitwise(solve_inputs):
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    _sb, _inp, packed, kw = _packed(solve_inputs)
    body_f, imp_f = cs.KERNEL.launch_folded(*packed, **kw)
    body_b, imp_b = cs.KERNEL.launch(*packed, **kw)
    torch.cuda.synchronize()
    assert torch.equal(body_f, body_b)
    assert torch.equal(imp_f, imp_b)


LANE_KEYS = ("b1", "b2", "valid", "color", "normal", "point", "point_active", "dist",
             "friction", "restitution", "prev_impulse", "ws_n", "ws_t", "ws_tw",
             "dyn1", "dyn2")


def _mixed_storage(inp, tiles):
    """Scenes 0-3 keep their first 4 valid lanes, so they fit on chip;
    scenes 4-7 have every lane valid, past the folded kernel's capacity (and
    past the block kernel's when the lane axis is tiled wide enough).  The
    lane axis is first tiled `tiles` times (the copies invalid); the invalid
    lanes of scenes 4-7 then become inert copies of their valid lanes (same
    bodies and color, no active point, zero warmstart), so that the colors
    they join conflict and the solve stays bounded."""
    inp = dict(inp)
    k = inp["b1"].shape[-1]
    for key in LANE_KEYS:
        inp[key] = inp[key].repeat((1,) * (inp[key].dim() - 1) + (tiles,))
    inp["valid"][..., k:] = False
    for s in range(8):
        lanes = torch.nonzero(inp["valid"][s]).flatten()
        assert len(lanes) >= 4
        if s < 4:
            inp["valid"][s, lanes[4:]] = False
            continue
        idle = torch.nonzero(~inp["valid"][s]).flatten()
        src = lanes[torch.arange(len(idle), device=lanes.device) % len(lanes)]
        for key in LANE_KEYS:
            inp[key][s, ..., idle] = inp[key][s, ..., src]
        inp["point_active"][s, :, idle] = False
        for key in ("ws_n", "ws_t", "ws_tw"):
            inp[key][s, ..., idle] = 0.0
        inp["valid"][s] = True
    return inp


@pytest.mark.parametrize("tiles", [1, 4])
def test_on_chip_and_global_lanes_agree(solve_inputs, tiles):
    """One batch whose scenes take both storages (valid lanes up to the
    kernel's capacity on chip, more in the global scratch): the kernels agree
    bit for bit and each holds to the plain version."""
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    sb, inp, packed, kw = _packed(_mixed_storage(solve_inputs, tiles))
    n1 = sb.v_lin.shape[-1]
    sb_p, imp_p = cs.solve_plain(sb, **inp)
    plain = torch.cat([sb_p.v_lin, sb_p.v_ang, sb_p.com, sb_p.rot], dim=1)
    outs, stored = [], []
    for folded, fn in ((True, cs.KERNEL.launch_folded), (False, cs.KERNEL.launch)):
        out_body, imp = fn(*packed, **kw)
        torch.cuda.synchronize()
        n_valid, on_chip = cs.KERNEL.storage(folded, packed[1], n1, kw["max_colors"])
        assert torch.equal(n_valid, inp["valid"].sum(-1))
        assert float((out_body - plain).abs().max()) <= TOL["bodies"]
        assert float((imp - imp_p).abs().max()) <= TOL["impulses"]
        outs.append((out_body, imp))
        stored.append(on_chip.int().tolist())
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert stored[0] == [1] * 4 + [0] * 4          # folded: both storages
    assert stored[1] == [1] * 4 + [int(tiles == 1)] * 4  # block: past it once K is wide


def test_scene_without_valid_lanes_returns_the_closed_form(solve_inputs):
    """A scene with no valid lane: both kernels write its impulse block as
    the closed form of its warmstart inputs, bit for bit."""
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from test_torch_common import unsolved_impulses

    inp = dict(solve_inputs)
    inp["valid"] = inp["valid"].clone()
    inp["valid"][0] = False
    sb, inp, packed, kw = _packed(inp)
    assert int(cs.KERNEL.storage(False, packed[1], sb.v_lin.shape[-1],
                                 kw["max_colors"])[0][0]) == 0
    closed = unsolved_impulses(inp["ws_n"][:1], inp["ws_t"][:1], inp["ws_tw"][:1],
                               inp["point_active"][:1], inp["warmstart_coeff"],
                               inp["n_sub"])
    sb_p, _ = cs.solve_plain(sb, **inp)
    plain = torch.cat([sb_p.v_lin, sb_p.v_ang, sb_p.com, sb_p.rot], dim=1)
    for fn in (cs.KERNEL.launch_folded, cs.KERNEL.launch):
        out_body, imp = fn(*packed, **kw)
        torch.cuda.synchronize()
        assert torch.equal(imp[:1], closed)
        assert float((out_body[:1] - plain[:1]).abs().max()) <= TOL["bodies"]


def test_replicated_scenes_agree_bitwise(solve_inputs):
    """256 copies of one scene give 256 equal results in both kernels: no
    thread reads a lane or body another thread writes without a barrier."""
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    inp = {k: (v[:1].repeat((256,) + (1,) * (v.dim() - 1))
               if torch.is_tensor(v) and v.dim() > 0 else v)
           for k, v in solve_inputs.items() if k != "sb"}
    inp["sb"] = type(solve_inputs["sb"])(
        *[x[:1].repeat((256,) + (1,) * (x.dim() - 1)) for x in solve_inputs["sb"]])
    _sb, _inp, packed, kw = _packed(inp)
    for fn in (cs.KERNEL.launch_folded, cs.KERNEL.launch):
        for out in fn(*packed, **kw):
            torch.cuda.synchronize()
            assert torch.equal(out, out[:1].expand_as(out))


def test_kernel_refuses_scenes_beyond_shared_memory(device):
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    b, k, n1 = 1, 128, 2000
    with pytest.raises(ValueError, match="shared memory"):
        cs.KERNEL.launch(
            torch.zeros(b, cs.MAN_ROWS, k, device=device),
            torch.zeros(b, 4, k, dtype=torch.int32, device=device),
            torch.zeros(b, cs.BODY_ROWS, n1, device=device),
            torch.zeros(b, n1, dtype=torch.int32, device=device),
            torch.zeros(b, dtype=torch.int32, device=device),
            n_sub=4, pgs_iters=1, stab_iters=1, max_colors=16, scalars=(0.0,) * 7)


@pytest.mark.parametrize("path", ["blocked", "masked"])
def test_non_kernel_paths_on_the_card(device, monkeypatch, path):
    """The blocked solve and the masked sweep on the card: a stack-4
    pyramid on the grid broad phase with solver_backend="jax" (the routing
    limit set to 0 for the blocked path), 10 steps after 20.  Two runs are
    bitwise equal, and the card agrees with the CPU within 1e-4 in position
    and 1e-3 in velocity."""
    from rapier_tpu_torch.pipeline import physics_pipeline as pp
    from rapier_tpu_torch.scenes import pyramid3_world, replicate_scene
    from rapier_tpu_torch.types import BroadPhaseKind, from_numpy, tree_map

    if path == "blocked":
        monkeypatch.setattr(pp, "DENSE_ROUTE_ELEMS", 0)
    w = pyramid3_world(stack_height=4, device=device)
    params = w.params.replace(broad_phase=int(BroadPhaseKind.GRID), solver_backend="jax")
    state = replicate_scene(from_numpy(w.build(), device), 2)
    assert pp.solve_path(state, params) == path
    for _ in range(20):
        state, _ = pp.step(state, params)

    def run(s):
        for _ in range(10):
            s, _ = pp.step(s, params)
        return s

    a = run(tree_map(lambda x: x.clone(), state))
    b = run(tree_map(lambda x: x.clone(), state))
    cpu = run(tree_map(lambda x: x.cpu(), state))
    for name in ("pos", "rot", "linvel", "angvel"):
        assert torch.equal(getattr(a.bodies, name), getattr(b.bodies, name)), name
    assert float((a.bodies.pos.cpu() - cpu.bodies.pos).abs().max()) <= 1e-4
    assert float((a.bodies.linvel.cpu() - cpu.bodies.linvel).abs().max()) <= 1e-3


@pytest.mark.parametrize("scene", ["joints3", "impulse quadruped"])
def test_joint_step_on_the_card(device, scene):
    """The impulse-joint step on the card (the masked sweep, no contact
    kernel): 2 scenes, 10 steps after 20; two runs are bitwise equal, and
    the card agrees with the CPU within 1e-4 in position, 1e-3 in velocity
    and 1e-3 of the largest joint impulse."""
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.pipeline import physics_pipeline as pp
    from rapier_tpu_torch.scenes import joints3_world, quadruped_world, replicate_scene
    from rapier_tpu_torch.types import from_numpy, tree_map

    if scene == "joints3":
        w, _ = joints3_world(device=device)
    else:
        w, _ = quadruped_world(use_multibody=False, device=device)
    state = replicate_scene(from_numpy(w.build(), device), 2)
    assert pp.solve_path(state, w.params) == "masked"
    launches = cs.KERNEL.launches, cs.KERNEL.launches_folded
    for _ in range(20):
        state, _ = pp.step(state, w.params)

    def run(s):
        for _ in range(10):
            s, _ = pp.step(s, w.params)
        return s

    a = run(tree_map(lambda x: x.clone(), state))
    b = run(tree_map(lambda x: x.clone(), state))
    cpu = run(tree_map(lambda x: x.cpu(), state))
    assert (cs.KERNEL.launches, cs.KERNEL.launches_folded) == launches
    for name in ("pos", "rot", "linvel", "angvel"):
        assert torch.equal(getattr(a.bodies, name), getattr(b.bodies, name)), name
    assert torch.equal(a.joints.impulses, b.joints.impulses)
    assert float((a.bodies.pos.cpu() - cpu.bodies.pos).abs().max()) <= 1e-4
    assert float((a.bodies.linvel.cpu() - cpu.bodies.linvel).abs().max()) <= 1e-3
    scale = float(cpu.joints.impulses.abs().max())
    assert float((a.joints.impulses.cpu() - cpu.joints.impulses).abs().max()) <= 1e-3 * scale
