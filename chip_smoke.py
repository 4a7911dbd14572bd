#!/usr/bin/env python3
"""Chip smoke test: drive rapier_tpu_torch's main path on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero; each prints its wall time):

1. Build the contact-sweep kernels from ``rapier_tpu_torch/csrc`` (one nvcc
   call, sm_90a) and print the compiler's register / shared-memory report.
2. Block kernel vs plain version: capture one step's solve inputs from a
   settled bench-config batch of 256 scenes (K = 256 solver lanes), run
   `contact_sweep_kernel` and the plain PyTorch version on them and hold them
   to KERNEL_TOL; the folded kernel, called through its launcher on the same
   capture, must agree with the block kernel bit for bit.  Time both
   versions with CUDA events at the bench shape (4096 scenes) and at one
   scene (the `PhysicsWorld.step` shape).  Prints the kernel's registers,
   spills, shared memory a block, resident blocks an SM and on-chip lane
   capacity at this shape, and at each timed shape the valid lanes per scene
   and how many scenes hold them on chip or in the global scratch (from the
   packed lane flags and the kernel's capacity; all must be on chip).
3. Folded kernel vs plain version: the same on 256 quadruped scenes after 40
   steps (seeded noise on the trunk position and the servo targets; K = 128,
   so the step launches `contact_sweep_folded_kernel`); times at 4096 scenes
   for the folded wrapper, the folded launch alone, `contact_sweep_kernel` on
   the same packed inputs and the plain version; the same resource and
   storage lines.
4. The bench path: the bench scene (4 layers of 5x5 balls, cuboids and
   capsules on a ground cuboid, max_pairs 512, max_solver_pairs 256)
   replicated to 4096 scenes, settled for 150 steps, then 50 timed steps.
   Checks zero broad-phase / solver overflow, finite state, exactly one
   `contact_sweep_kernel` launch per step and no folded one, every scene's
   lanes on chip at the step after the timed run, bodies resting above the
   ground.
5. The robots path: 4096 replicas of `quadruped_world(use_multibody=True)`,
   240 steps, then 50 timed steps.  Checks finite state, zero overflow,
   exactly one folded launch per step and no block launch, every scene's
   lanes on chip at the step after the timed run, every scene bitwise equal
   to scene 0, and the trunk at the reference's height (R5).
6. The large single scenes: bench.py's pyramid mode (`pyramid3_world`, the
   grid broad phase, max_solver_pairs = 8 per box rounded up to 128, one
   scene) at stacks 16 and 24 (and 31 with ``--pyramid 31``), 120 steps,
   then 30 timed steps (bench.py runs 150 and 50; cut for the run's time
   limit).  Checks the blocked solve's path, zero broad-phase /
   solver overflow, finite state, and that stacks 16 and 24 have come to
   rest (the top box within PYRAMID_TOP_TOL of its resting height) and any
   other stands (not below it); prints steps/s, the top box's distance from
   rest and its vertical velocity, the lanes the reference's layout would
   drop (R7), and the
   per-stage breakdown of a step (host milliseconds between
   synchronisations, `utils/counters.profile_step`) with its kernel count
   and device-busy share (`trace_step`, torch.profiler).
   The bench step's breakdown is printed in phase 4.
7. The card against the CPU (plain) path: 2 bench scenes, 2 quadruped
   scenes, 2 joints3 scenes and 2 impulse-joint quadrupeds for 10 steps each
   (with the joints' row impulses within 1e-3 of the largest); the stack-16
   pyramid after 30 steps on the
   card (mid-landing) and after phase 6's 150 (at rest), 10 steps each
   stepped on the CPU from the card's state, bodies and contact cache (pair
   keys, touching flags, impulses) compared.  A free run of the pile
   amplifies rounding about twofold a step, so beside each it prints the
   free card-vs-CPU gap and, as its witness, the gap between two free CPU
   runs whose start differs by 1 ulp in one body's height.
8. Determinism: 10 steps run twice from one state are bitwise equal, for a
   bench batch, a quadruped batch, the stack-16 pyramid and a joints3 batch.
9. The impulse joints: 4096 replicas of the joint zoo (`scenes.joints3_world`,
   examples/joints3.py: revolute chain, prismatic slider with a position
   motor and limits, fixed-joint lattice, spherical rope with swing limits)
   and 4096 impulse-joint quadrupeds (`quadruped_world(use_multibody=False)`),
   each 240 steps, then 50 timed steps.  Both take the masked sweep (the
   reference's gate sends scenes with joints there), so neither may launch a
   contact-sweep kernel.  Checks zero overflow, finite state, every scene
   bitwise equal to scene 0, and for joints3 after 240 steps the example's
   own checks on every scene (the chain tip below y = 8, the slider within
   0.3 of y = 7.5); prints the quadruped's trunk height after 240 steps
   beside the reference's 0.188 (R5),
   env-steps/s, the stage breakdown (with the `joints` stage: row builds and
   sweeps), kernels a step and the device-busy share.

The line before the last is the kernels' JSON record (with `bound_share`,
bound over time, and each kernel's resources); the last line is
``{"ok": true, "device": {...}}``.

With ``--earlier DIR [DIR ...]`` (each DIR an unpacked checkout of another
commit, e.g. ``git archive <commit> | tar -x -C build/earlier``) the script
instead builds those checkouts' contact-sweep kernels beside this one's and
times them all on the same packed inputs, at the on-chip shapes above and at
shapes whose scenes keep their lanes in the global scratch (every lane
valid: 4096 bench scenes, one scene of 2304 lanes, 4096 quadrupeds).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

N_SCENES = 4096
N_CHECK = 256
SETTLE = 150
TIMED = 50
ROBOT_SETTLE = 240
ROBOT_CHECK_STEPS = 40
KERNEL_TOL = dict(bodies=1e-4, impulses=1e-3)   # atol, summation order only
# atol over 10 contact steps; impulses: atol times the largest impulse's
# magnitude (at least 1), since they scale with the weight a contact bears.
CPU_TOL = dict(pos=1e-4, vel=1e-3, imp=1e-3)
# The reference's quadruped falls onto its trunk (ROADMAP R5): trunk centre
# at the box's half height, 0.050, after 240 steps.  A port that stands here
# has a parity fault.
TRUNK_Z = (0.045, 0.055)
TRUNK = 1                       # body handle of the trunk
# The impulse-joint quadruped falls more slowly; the reference's trunk is at
# 0.188 after 240 steps (ROADMAP R5, a CPU run of the reference): printed
# beside the port's, not checked.
IMPULSE_TRUNK_Z_REF = 0.188
JOINT_SETTLE = 240
JOINT_TIMED = 50                # timed steps after the settle (launch-bound: ~0.2-0.6 s each)
JOINT_CPU_SETTLE = 30
PYRAMID_STACKS = (16, 24)       # bench.py's default stack and pyramid3.rs's
# Steps before and in the timed run: a pyramid step takes ~0.7-1.4 s.
# bench.py runs 150 and 50; at 150 + 50 the whole script took ~1,140 s of
# its 1,200 on an H100 80GB HBM3 machine whose host ran ~35% slow, so the
# piles run 120 + 30 (both are at rest by then: checked below).
PYRAMID_SETTLE = 120
PYRAMID_TIMED = 30
PYRAMID_CPU_SETTLE = 30
# Steps traced under torch.profiler for the launch-bound paths (pyramid and
# joints): each of their steps launches the same kernels, and the profiler's
# processing grows with the 15,000-51,000 launches a step.
TRACE_STEPS_LONG = 1
# A settled pyramid's top box rests at 2 * stack - 1 (boxes 2 high, the
# ground's top at 0); it starts 0.5 m a level higher.  Stacks 16 and 24 have
# come to rest by the end of the timed run: their top box must lie within
# PYRAMID_TOP_TOL of rest.  Stack 31's top level lands at ~17 m/s after ~105
# steps and may still move then: it must stand (its top box above rest -
# PYRAMID_TOP_TOL; a lost level would put it a box height lower), and the run
# prints how far from rest the top box is and how fast it moves.
PYRAMID_TOP_TOL = 0.1
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s and
# float32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# Float operations per valid solver lane, counted from csrc/contact_sweep.cu:
# generation once, then per substep the soft-rhs update and warmstart and per
# sweep one solve_lane (normal rows, the coupled tangent solve, twist).
FLOPS_GENERATE = 850
FLOPS_UPDATE_WARMSTART = 500
FLOPS_SOLVE = 390
# Each kernel's launch-alone time at 4096 scenes before the redesign that
# put the lane state on chip, as PERF.md records it (NVIDIA H100 80GB HBM3,
# 700.00 W): printed beside this run's time, not measured here.
RECORDED_EARLIER_MS = {"contact_sweep_kernel": 3.356, "contact_sweep_folded_kernel": 0.938}
# solve_from_manifolds arguments that are not lane tensors.
SCALAR_ARGS = ("dt_sub", "inv_dt_sub", "erp_inv_dt", "cfm_factor",
               "allowed_lin_err", "max_corrective_velocity", "warmstart_coeff")
STATIC_ARGS = ("n_sub", "pgs_iters", "stab_iters", "max_colors")


def _fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(code)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def bench_world(device, n_scenes: int):
    """The bench configuration as a batched state on `device`."""
    from rapier_tpu_torch.scenes import mixed_primitives_world, replicate_scene
    from rapier_tpu_torch.types import from_numpy

    world = mixed_primitives_world(num_layers=4, grid=5, max_pairs=512, device=device)
    world.params = world.params.replace(max_solver_pairs=256)
    scene = from_numpy(world.build(), device)      # one scene, on the card
    return replicate_scene(scene, n_scenes), world.params


def quadruped_batch(device, n_scenes: int, seed=None):
    """`quadruped_world(use_multibody=True)` replicated to `n_scenes` on
    `device`; with a seed, each scene's trunk position (0.01 m) and servo
    targets (0.05 rad) get seeded numpy noise."""
    import numpy as np
    import torch
    from rapier_tpu_torch.scenes import quadruped_world, replicate_scene
    from rapier_tpu_torch.types import from_numpy

    world, robot = quadruped_world(use_multibody=True, device=device)
    if robot.bodies["trunk"] != TRUNK:
        _fail(f"unexpected trunk handle {robot.bodies['trunk']}")
    state = replicate_scene(from_numpy(world.build(), device), n_scenes)
    if seed is not None:
        rng = np.random.default_rng(seed)
        d = torch.from_numpy(rng.normal(0, 0.01, (n_scenes, 3)).astype(np.float32))
        servo = rng.normal(0, 0.05, (n_scenes, 8)).astype(np.float32)
        d = d.to(device)
        state.multibodies.q[:, 0, 0, :3] += d
        state.bodies.pos[:, TRUNK] += d
        state.bodies.next_pos[:, TRUNK] += d
        state.multibodies.motor_target_pos[:, 0, 1:, 3] += torch.from_numpy(servo).to(device)
    return state, world.params


def joints3_batch(device, n_scenes: int):
    """The joint zoo replicated to `n_scenes` on `device`; returns (state,
    params, handles)."""
    from rapier_tpu_torch.scenes import joints3_world, replicate_scene
    from rapier_tpu_torch.types import from_numpy

    world, handles = joints3_world(device=device)
    return (replicate_scene(from_numpy(world.build(), device), n_scenes), world.params,
            handles)


def impulse_quadruped_batch(device, n_scenes: int, seed=None):
    """`quadruped_world(use_multibody=False)` replicated to `n_scenes` on
    `device`; with a seed, each scene's trunk position (0.01 m) and servo
    targets (0.05 rad) get seeded numpy noise."""
    import numpy as np
    import torch
    from rapier_tpu_torch.scenes import quadruped_world, replicate_scene
    from rapier_tpu_torch.types import from_numpy

    world, robot = quadruped_world(use_multibody=False, device=device)
    if robot.bodies["trunk"] != TRUNK:
        _fail(f"unexpected trunk handle {robot.bodies['trunk']}")
    state = replicate_scene(from_numpy(world.build(), device), n_scenes)
    if seed is not None:
        rng = np.random.default_rng(seed)
        d = torch.from_numpy(rng.normal(0, 0.01, (n_scenes, 3)).astype(np.float32))
        servo = rng.normal(0, 0.05, (n_scenes, 8)).astype(np.float32)
        state.bodies.pos[:, TRUNK] += d.to(device)
        state.bodies.next_pos[:, TRUNK] += d.to(device)
        state.joints.motor_target_pos[:, :8, 3] += torch.from_numpy(servo).to(device)
    return state, world.params


def run(state, params, n_steps: int):
    from rapier_tpu_torch.pipeline.physics_pipeline import step

    worst = {"broadphase_overflow": 0, "solver_overflow": 0}
    for _ in range(n_steps):
        state, ev = step(state, params)
        for k in worst:
            worst[k] = max(worst[k], int(getattr(ev, k).max()))
    return state, worst


def capture_solve_inputs(state, params):
    """One step's arguments to solve_from_manifolds, as the pipeline passes
    them."""
    from rapier_tpu_torch.pipeline import physics_pipeline as pp

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
    return captured


def _scenes(x, reps: int):
    """The batch tiled `reps` times along the scene axis; reps 0 keeps only
    the first scene.  Scalars pass through."""
    if not hasattr(x, "repeat") or x.dim() == 0:
        return x
    if reps == 0:
        return x[:1].contiguous()
    return x.repeat((reps,) + (1,) * (x.dim() - 1))


def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _packed(sb, inp):
    """The kernels' packed inputs and keyword arguments."""
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    packed = cs._pack(sb, **{k: v for k, v in inp.items()
                             if k not in SCALAR_ARGS + STATIC_ARGS})
    kw = dict(scalars=[inp[k] for k in SCALAR_ARGS], **{k: inp[k] for k in STATIC_ARGS})
    return packed, kw


def _bound(packed, out, inp):
    """The least time the card could take for one call: bytes (each input
    read once, each output written once) at the HBM rate, or the float
    operations this call's valid lanes need at the fp32 rate, whichever is
    larger.  Returns (ms, "bytes" or "operations")."""
    n_bytes = sum(t.numel() * t.element_size() for t in list(packed) + list(out))
    sweeps = inp["pgs_iters"] + inp["stab_iters"]
    per_lane = FLOPS_GENERATE + inp["n_sub"] * (FLOPS_UPDATE_WARMSTART + sweeps * FLOPS_SOLVE)
    flops = int(inp["valid"].sum()) * per_lane
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _resources(name, folded, inp, sb, card):
    """The kernel's registers, spills, shared memory, resident blocks an SM
    and on-chip lane capacity at this input's shape, from the CUDA runtime."""
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    res = cs.KERNEL.info(folded, inp["b1"].shape[-1], sb.v_lin.shape[-1],
                         inp["max_colors"])
    print(f"{name} at K={inp['b1'].shape[-1]}, N+1={sb.v_lin.shape[-1]}: "
          f"{res['registers']} registers, {res['spill_bytes']} bytes of spills a thread, "
          f"{res['smem_bytes']} bytes of shared memory a block, {res['blocks_per_sm']} "
          f"resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), "
          f"{res['capacity']} lanes a scene on chip ({card})")
    return res


def _storage(what, folded: bool, packed, kw, must_fit: bool):
    """Valid lanes per scene of the packed inputs and the storage each scene
    takes in the folded (or the block) kernel (`packed`, `kw` as `_packed`
    gives them); fails when `must_fit` and a scene keeps its lanes in the
    global scratch."""
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    lanes, fits = cs.KERNEL.storage(folded, packed[1], packed[2].shape[-1],
                                    kw["max_colors"])
    lanes, on_chip = lanes.cpu().float(), int(fits.sum())
    out = dict(scenes_on_chip=on_chip, scenes_in_global_scratch=lanes.shape[0] - on_chip,
               valid_lanes_mean=float(lanes.mean()), valid_lanes_max=int(lanes.max()))
    print(f"{what}: valid lanes per scene min {int(lanes.min())}, mean "
          f"{out['valid_lanes_mean']:.2f}, max {out['valid_lanes_max']}; scenes on chip "
          f"{on_chip}, in the global scratch {out['scenes_in_global_scratch']}")
    if must_fit and out["scenes_in_global_scratch"]:
        _fail(f"{what}: {out['scenes_in_global_scratch']} scenes did not fit on chip")
    return out


def _next_step_storage(what, state, params, folded: bool):
    """`_storage` for the solve of the step after `state` (its inputs
    captured from one more step, which the launch counts do not see)."""
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    launches = cs.KERNEL.launches, cs.KERNEL.launches_folded
    inp = capture_solve_inputs(state, params)
    cs.KERNEL.launches, cs.KERNEL.launches_folded = launches
    packed, kw = _packed(inp.pop("sb"), inp)
    return _storage(what, folded, packed, kw, True)


def _compare(name, sb, inp, sb_k, imp_k):
    """Hold a kernel's output to the plain version within KERNEL_TOL."""
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    sb_p, imp_p = cs.solve_plain(sb, **inp)
    torch.cuda.synchronize()
    err_b = max(float((a - b).abs().max()) for a, b in zip(sb_k, sb_p))
    err_i = float((imp_k - imp_p).abs().max())
    print(f"{name} vs plain on {sb.v_lin.shape[0]} scenes (K={inp['b1'].shape[-1]}, "
          f"{int(inp['valid'].sum())} solver lanes): max |d bodies| {err_b:.3e} "
          f"(tol {KERNEL_TOL['bodies']}), max |d impulses| {err_i:.3e} "
          f"(tol {KERNEL_TOL['impulses']})")
    if not (err_b <= KERNEL_TOL["bodies"] and err_i <= KERNEL_TOL["impulses"]):
        _fail(f"{name} disagrees with the plain version")
    return max(err_b, err_i)


def _bitwise(what, a, b):
    import torch

    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        _fail(f"{what}: the folded and block kernels differ")
    print(f"{what}: folded kernel == contact_sweep_kernel bit for bit")


def _summary(name, ms, bound, res, card):
    """Print the kernel's time beside its recorded earlier time, its bound and
    its occupancy; return the kernels line's keys beyond the contract's."""
    print(f"{name} at {N_SCENES} scenes: {ms:.3f} ms (recorded before the redesign: "
          f"{RECORDED_EARLIER_MS[name]} ms), bound {bound[0]:.3g} ms ({bound[1]}), "
          f"{bound[0] / ms:.1%} of the bound; {res['blocks_per_sm']} blocks an SM of "
          f"{res['registers']} registers a thread and {res['smem_bytes']} bytes of "
          f"shared memory ({card})")
    return dict(bound_share=bound[0] / ms, **res)


def phase_kernel(device, card):
    """Phase 2: contact_sweep_kernel against the plain version (bench)."""
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.dynamics.solver.contact_constraints import SolverBodies

    state, params = bench_world(device, N_CHECK)
    state, _ = run(state, params, SETTLE)
    inp = capture_solve_inputs(state, params)
    sb = inp.pop("sb")
    k_lanes = inp["b1"].shape[-1]
    if k_lanes != 256:
        _fail(f"expected K = 256 solver lanes, got {k_lanes}")

    counts = cs.KERNEL.launches, cs.KERNEL.launches_folded
    sb_k, imp_k = cs.solve_from_manifolds(sb, **inp)
    if cs.KERNEL.launches != counts[0] + 1:
        _fail("the bench shape did not launch contact_sweep_kernel")
    err = _compare("contact_sweep_kernel", sb, inp, sb_k, imp_k)
    res = _resources("contact_sweep_kernel", False, inp, sb, card)
    packed, kw = _packed(sb, inp)
    # The folded kernel holds no bench lane on chip (its capacity at 105
    # body columns is 0): this also holds the global scratch to the shared one.
    _bitwise("bench capture (K=256)", cs.KERNEL.launch(*packed, **kw),
             cs.KERNEL.launch_folded(*packed, **kw))
    _storage("folded kernel on the bench capture", True, packed, kw, False)

    times = {}
    for reps in (N_SCENES // N_CHECK, 0):
        sb_t = SolverBodies(*[_scenes(x, reps) for x in sb])
        inp_t = {k: _scenes(v, reps) for k, v in inp.items()}
        ms = _time_ms(lambda: cs.solve_from_manifolds(sb_t, **inp_t), 20)
        plain_ms = _time_ms(lambda: cs.solve_plain(sb_t, **inp_t), 3)
        # The launch alone, on inputs packed once: the wrapper's time above
        # also holds the packing into the kernel's layout.
        packed, kw = _packed(sb_t, inp_t)
        launch_ms = _time_ms(lambda: cs.KERNEL.launch(*packed, **kw), 20)
        # The folded kernel on the same inputs: the evidence for the dispatch
        # rule (K <= FOLD_MAX_LANES) at a shape the rule sends to the block.
        folded_ms = _time_ms(lambda: cs.KERNEL.launch_folded(*packed, **kw), 20)
        bound = _bound(packed, cs.KERNEL.launch(*packed, **kw), inp_t)
        storage = _storage(f"contact_sweep_kernel at {sb_t.v_lin.shape[0]} scene(s)", False,
                           packed, kw, True)
        times[reps] = (launch_ms, plain_ms, bound, storage)
        print(f"contact solve at {sb_t.v_lin.shape[0]} scene(s) x K={k_lanes}: "
              f"wrapper {ms:.3f} ms, launch alone {launch_ms:.3f} ms, folded kernel "
              f"{folded_ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound[0]:.3g} ms "
              f"({bound[1]}), {bound[0] / launch_ms:.1%} of the bound ({card})")
    # Comparison launches do not count.
    cs.KERNEL.launches, cs.KERNEL.launches_folded = counts
    ms, plain_ms, bound, storage = times[N_SCENES // N_CHECK]
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], **_summary("contact_sweep_kernel", ms, bound, res, card),
                one_scene_ms=times[0][0], **storage)


def phase_folded_kernel(device, card):
    """Phase 3: contact_sweep_folded_kernel against the plain version and
    the block kernel (quadruped, K = 128)."""
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.dynamics.solver.contact_constraints import SolverBodies

    state, params = quadruped_batch(device, N_CHECK, seed=7)
    state, _ = run(state, params, ROBOT_CHECK_STEPS)
    inp = capture_solve_inputs(state, params)
    sb = inp.pop("sb")
    k_lanes = inp["b1"].shape[-1]
    if k_lanes > cs.FOLD_MAX_LANES:
        _fail(f"expected at most {cs.FOLD_MAX_LANES} solver lanes, got {k_lanes}")

    counts = cs.KERNEL.launches, cs.KERNEL.launches_folded
    sb_k, imp_k = cs.solve_from_manifolds(sb, **inp)
    if cs.KERNEL.launches_folded != counts[1] + 1:
        _fail("the quadruped shape did not launch contact_sweep_folded_kernel")
    err = _compare("contact_sweep_folded_kernel", sb, inp, sb_k, imp_k)
    res = _resources("contact_sweep_folded_kernel", True, inp, sb, card)
    packed, kw = _packed(sb, inp)
    _bitwise(f"quadruped capture (K={k_lanes})", cs.KERNEL.launch(*packed, **kw),
             cs.KERNEL.launch_folded(*packed, **kw))

    reps = N_SCENES // N_CHECK
    sb_t = SolverBodies(*[_scenes(x, reps) for x in sb])
    inp_t = {k: _scenes(v, reps) for k, v in inp.items()}
    packed, kw = _packed(sb_t, inp_t)
    ms = _time_ms(lambda: cs.solve_from_manifolds(sb_t, **inp_t), 20)
    launch_ms = _time_ms(lambda: cs.KERNEL.launch_folded(*packed, **kw), 20)
    block_ms = _time_ms(lambda: cs.KERNEL.launch(*packed, **kw), 20)
    plain_ms = _time_ms(lambda: cs.solve_plain(sb_t, **inp_t), 3)
    bound = _bound(packed, cs.KERNEL.launch_folded(*packed, **kw), inp_t)
    storage = _storage(f"contact_sweep_folded_kernel at {N_SCENES} scenes", True, packed,
                       kw, True)
    print(f"quadruped contact solve at {N_SCENES} scenes x K={k_lanes}: folded wrapper "
          f"{ms:.3f} ms, folded launch alone {launch_ms:.3f} ms, contact_sweep_kernel "
          f"{block_ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound[0]:.3g} ms "
          f"({bound[1]}), {bound[0] / launch_ms:.1%} of the bound ({card})")
    cs.KERNEL.launches, cs.KERNEL.launches_folded = counts
    return dict(max_abs_err=err, ms=launch_ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], **_summary("contact_sweep_folded_kernel", launch_ms,
                                              bound, res, card), **storage)


def phase_main_path(device, card):
    """Phase 4: 4096 bench scenes through the port's step."""
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    state, params = bench_world(device, N_SCENES)
    y0 = state.bodies.pos[:, 1:101, 1].clone()
    t0 = time.time()
    state, worst = run(state, params, SETTLE)
    torch.cuda.synchronize()
    print(f"settled {N_SCENES} scenes for {SETTLE} steps in {time.time() - t0:.1f} s")
    cs.KERNEL.launches = cs.KERNEL.launches_folded = 0
    t0 = time.time()
    state, worst_t = run(state, params, TIMED)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches, folded = cs.KERNEL.launches, cs.KERNEL.launches_folded
    for k in worst:
        worst[k] = max(worst[k], worst_t[k])
    rate = N_SCENES * TIMED / elapsed
    print(f"bench path: {rate:.1f} env-steps/s ({N_SCENES} scenes x {TIMED} steps "
          f"in {elapsed:.3f} s; {card})")
    print(f"overflow: {worst}; launches in the timed run: contact_sweep_kernel "
          f"{launches}, folded {folded}")
    if worst["broadphase_overflow"] or worst["solver_overflow"]:
        _fail(f"bench config overflows: {worst}")
    if launches != TIMED or folded != 0:
        _fail(f"expected {TIMED} contact_sweep_kernel launches and no folded one, "
              f"counted {launches} and {folded}")
    _next_step_storage("bench path, the step after the timed run", state, params, False)
    b = state.bodies
    for name in ("pos", "rot", "linvel", "angvel"):
        if not bool(torch.isfinite(getattr(b, name)).all()):
            _fail(f"non-finite bodies.{name}")
    y = b.pos[:, 1:101, 1]
    if tuple(y.shape) != (N_SCENES, 100):
        _fail(f"unexpected body shape {tuple(b.pos.shape)}")
    if not (float(y.min()) > 0.2 and float(y.max()) < float(y0.max())):
        _fail(f"bodies not resting above the ground: y in [{float(y.min())}, "
              f"{float(y.max())}]")
    print(f"settled heights: min {float(y.min()):.4f}, max {float(y.max()):.4f}; "
          f"sleeping {int(b.sleeping.sum())} of {N_SCENES * 100}")
    stages = _stages(f"bench step, {N_SCENES} scenes", state, params, card)
    return launches, rate, stages


def _stages(what, state, params, card, trace_steps: int = 3):
    """Print and return the per-stage breakdown of one step from `state`
    and its profiler trace (kernels a step, device-busy share)."""
    from rapier_tpu_torch.utils import counters

    t0 = time.time()
    t = counters.profile_step(state, params).as_dict()
    tr = counters.trace_step(state, params, steps=trace_steps)
    took = time.time() - t0
    share = "not measured" if tr["device_share"] is None else f"{tr['device_share']:.1%}"
    device_ms = "not measured" if tr["device_ms"] is None else f"{tr['device_ms']:.3f} ms"
    print(f"{what}: stages (host ms between synchronisations) " + ", ".join(
        f"{k[:-3]} {v:.3f}" for k, v in t.items()) + f"; under the profiler a step is "
        f"{tr['wall_ms']:.3f} ms with {tr['kernels']:.0f} device kernels and copies "
        f"busy for {device_ms} (device busy {share}) ({card}); profile and trace took "
        f"{took:.1f} s")
    for k in tr["top"] or ():
        print(f"  {k['ms']:.3f} ms a step in {k['count']:.0f} x {k['name']}")
    return dict(stages_ms=t, **tr)


def pyramid_batch(device, stack: int):
    """bench.py's pyramid configuration (BENCH_MODE=pyramid, bench.py:63-91):
    `pyramid3_world(stack)` on the grid broad phase with max_solver_pairs = 8
    touching pairs a box, rounded up to 128, as one scene on `device`.
    Returns (state, params, boxes)."""
    from rapier_tpu_torch.scenes import pyramid3_world, replicate_scene
    from rapier_tpu_torch.types import BroadPhaseKind, from_numpy

    world = pyramid3_world(stack_height=stack, device=device)
    boxes = sum((stack - i) ** 2 for i in range(stack))
    world.params = world.params.replace(broad_phase=int(BroadPhaseKind.GRID),
                                        max_solver_pairs=-((-8 * boxes) // 128) * 128)
    return replicate_scene(from_numpy(world.build(), device), 1), world.params, boxes


def _reference_drops(state, params):
    """(lanes the reference's blocked layout would drop, touching lanes) on
    the step after `state`: the port's coloring with the reference's caps,
    whose Jacobi tail block stops at its cap (ROADMAP R7)."""
    from rapier_tpu_torch.dynamics.solver import coloring
    from rapier_tpu_torch.pipeline import physics_pipeline as pp

    captured = {}
    original = pp.color_constraints_blocked

    def record(*args):
        captured["args"] = args
        return original(*args)

    pp.color_constraints_blocked = record
    try:
        pp.step(state, params)
    finally:
        pp.color_constraints_blocked = original
    b1, b2, dyn1, dyn2, valid, n, _ = captured["args"]
    p_lanes, cap = b1.shape[-1], params.max_solver_pairs
    ref_caps = coloring.block_caps(cap if 0 < cap < p_lanes else p_lanes, params.max_colors)
    dropped = original(b1, b2, dyn1, dyn2, valid, n, ref_caps)[2]
    return int(dropped.max()), int(valid.sum())


def phase_pyramid(device, card, stacks):
    """Phase 6: single-scene box pyramids through the port's step.  Returns
    the rows for the JSON record and, for phases 7 and 8, the stack-16
    pyramid (with its params) after PYRAMID_CPU_SETTLE steps ("landing") and
    after the timed run ("settled")."""
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.pipeline.physics_pipeline import solve_path
    from rapier_tpu_torch.types import tree_map

    rows, checks = [], {}
    for stack in stacks:
        state, params, boxes = pyramid_batch(device, stack)
        path = solve_path(state, params)
        print(f"pyramid stack {stack}: {boxes} boxes, P={state.contacts.max_pairs} pair "
              f"lanes, N+1={state.bodies.pos.shape[1] + 1}, max_solver_pairs "
              f"{params.max_solver_pairs}, solve path {path}")
        if path != "blocked":
            _fail(f"stack {stack} takes the {path} path, not the reference's blocked solve")
        t0 = time.time()
        state, worst = run(state, params, PYRAMID_CPU_SETTLE)
        if stack == PYRAMID_STACKS[0]:
            # Phases 7 and 8 start from this state.
            checks["landing"] = tree_map(lambda x: x.clone(), state), params
        state, worst_s = run(state, params, PYRAMID_SETTLE - PYRAMID_CPU_SETTLE)
        torch.cuda.synchronize()
        settle_s = time.time() - t0
        for k in worst:
            worst[k] = max(worst[k], worst_s[k])
        cs.KERNEL.launches = cs.KERNEL.launches_folded = 0
        t0 = time.time()
        state, worst_t = run(state, params, PYRAMID_TIMED)
        torch.cuda.synchronize()
        elapsed = time.time() - t0
        launches = cs.KERNEL.launches, cs.KERNEL.launches_folded
        for k in worst:
            worst[k] = max(worst[k], worst_t[k])
        rate = PYRAMID_TIMED / elapsed
        if stack == PYRAMID_STACKS[0]:
            checks["settled"] = tree_map(lambda x: x.clone(), state), params
        b = state.bodies
        for name in ("pos", "rot", "linvel", "angvel"):
            if not bool(torch.isfinite(getattr(b, name)).all()):
                _fail(f"stack {stack}: non-finite bodies.{name}")
        top, rest, start = float(b.pos[0, boxes, 1]), 2 * stack - 1, (stack - 1) * 2.5 + 1.0
        top_vy = float(b.linvel[0, boxes, 1])
        at_rest = abs(top - rest) <= PYRAMID_TOP_TOL
        print(f"pyramid stack {stack}: {rate:.3f} steps/s ({PYRAMID_TIMED} steps in "
              f"{elapsed:.3f} s after {PYRAMID_SETTLE} in {settle_s:.1f} s; {card}); overflow "
              f"{worst}; contact-sweep "
              f"launches in the timed run {launches[0]} + folded {launches[1]} (this path "
              f"has none); top box y {top:.4f} ({top - rest:+.4f} from rest at {rest}, "
              f"{'at rest' if at_rest else 'not at rest'}; started at {start}), vertical "
              f"velocity {top_vy:.4f} m/s; touching pairs "
              f"{int(state.contacts.touching.sum())}, sleeping {int(b.sleeping.sum())}")
        if worst["broadphase_overflow"] or worst["solver_overflow"]:
            _fail(f"pyramid stack {stack} overflows: {worst}")
        ref_dropped, lanes = _reference_drops(state, params)
        print(f"pyramid stack {stack}: the reference's blocked layout would drop {ref_dropped} "
              f"of the {lanes} solver lanes on the next step; this one drops none (R7)")
        if stack in PYRAMID_STACKS and not at_rest:
            _fail(f"pyramid stack {stack}: the top box is at {top}, not at rest ({rest})")
        if not top > rest - PYRAMID_TOP_TOL:
            _fail(f"pyramid stack {stack}: the top box is at {top}: the stack does not stand")
        row = dict(stack=stack, boxes=boxes, steps_per_s=rate, top_y=top, top_vy=top_vy,
                   top_at_rest=at_rest,
                   reference_layout_drops=ref_dropped, solver_lanes=lanes, **worst)
        if stack != stacks[0]:
            row.update(_stages(f"pyramid stack {stack} step", state, params, card,
                               trace_steps=TRACE_STEPS_LONG))
        rows.append(row)
    return rows, checks


def _finite(state):
    import torch

    for name in ("pos", "rot", "linvel", "angvel"):
        if not bool(torch.isfinite(getattr(state.bodies, name)).all()):
            _fail(f"non-finite bodies.{name}")
    for name in ("q", "qd") if state.multibodies is not None else ():
        if not bool(torch.isfinite(getattr(state.multibodies, name)).all()):
            _fail(f"non-finite multibodies.{name}")


def phase_robots(device, card):
    """Phase 5: 4096 quadrupeds through the port's step."""
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    state, params = quadruped_batch(device, N_SCENES)
    t0 = time.time()
    state, worst = run(state, params, ROBOT_SETTLE)
    torch.cuda.synchronize()
    print(f"ran {N_SCENES} quadrupeds for {ROBOT_SETTLE} steps in {time.time() - t0:.1f} s")
    cs.KERNEL.launches = cs.KERNEL.launches_folded = 0
    t0 = time.time()
    state, worst_t = run(state, params, TIMED)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches, folded = cs.KERNEL.launches, cs.KERNEL.launches_folded
    for k in worst:
        worst[k] = max(worst[k], worst_t[k])
    rate = N_SCENES * TIMED / elapsed
    print(f"robots path: {rate:.1f} env-steps/s ({N_SCENES} quadrupeds x {TIMED} steps "
          f"in {elapsed:.3f} s; {card})")
    print(f"overflow: {worst}; launches in the timed run: folded {folded}, "
          f"contact_sweep_kernel {launches}")
    if worst["broadphase_overflow"] or worst["solver_overflow"]:
        _fail(f"quadruped overflows: {worst}")
    if folded != TIMED or launches != 0:
        _fail(f"expected {TIMED} folded launches and no contact_sweep_kernel one, "
              f"counted {folded} and {launches}")
    _next_step_storage("robots path, the step after the timed run", state, params, True)
    _finite(state)
    _replicas_equal("robots path", state, ("bodies", "contacts", "multibodies"))
    _multibody_phase_ms(state, params, 1e3 / rate * N_SCENES, card)
    z = state.bodies.pos[:, TRUNK, 2]
    print(f"trunk height after {ROBOT_SETTLE + TIMED} steps: {float(z[0]):.5f} "
          f"(the reference falls to 0.050, R5); all {N_SCENES} scenes bitwise equal "
          f"to scene 0")
    if not TRUNK_Z[0] <= float(z[0]) <= TRUNK_Z[1]:
        _fail(f"trunk height {float(z[0])} outside the reference's {TRUNK_Z}")
    return folded, rate


def _host_ms(fn, iters: int = 5) -> float:
    """Host clock around `iters` calls ending in a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _multibody_phase_ms(state, params, step_ms, card):
    """The three multibody phases of one robots step, each timed alone on the
    step's own inputs: how much of the step they are."""
    from rapier_tpu_torch.dynamics import multibody as mbmod
    from rapier_tpu_torch.dynamics.solver import velocity_solver as vs

    mb, bodies, dt = state.multibodies, state.bodies, float(params.dt)
    a_ms = _host_ms(lambda: mbmod.predict_velocities(mb, bodies, params.gravity, dt))
    mb_a, bodies_a, aux = mbmod.predict_velocities(mb, bodies, params.gravity, dt)
    sb = vs.make_solver_bodies(bodies_a, bodies_a.enabled, params)
    b_ms = _host_ms(lambda: mbmod.install_link_mobility(sb, mb_a, aux, bodies_a))
    c_ms = _host_ms(lambda: mbmod.absorb_contact_impulses(mb_a, bodies_a, sb, aux, dt))
    print(f"multibody phases alone at {bodies.pos.shape[0]} scenes: A predict_velocities "
          f"{a_ms:.3f} ms, B install_link_mobility {b_ms:.3f} ms, C "
          f"absorb_contact_impulses {c_ms:.3f} ms, of a {step_ms:.3f} ms step ({card})")


def _cpu_agreement(what, state, params, settle):
    from rapier_tpu_torch.types import tree_map

    state, _ = run(state, params, settle)          # bodies in contact
    cpu = tree_map(lambda x: x.cpu(), state)
    gpu, _ = run(state, params, 10)
    cpu, _ = run(cpu, params, 10)
    dp = float((gpu.bodies.pos.cpu() - cpu.bodies.pos).abs().max())
    dv = float((gpu.bodies.linvel.cpu() - cpu.bodies.linvel).abs().max())
    ok = dp <= CPU_TOL["pos"] and dv <= CPU_TOL["vel"]
    joints = ""
    if gpu.joints is not None:
        scale = max(1e-30, float(cpu.joints.impulses.abs().max()))
        di = float((gpu.joints.impulses.cpu() - cpu.joints.impulses).abs().max())
        joints = (f", max |d joint impulse| {di:.3e} (tol {CPU_TOL['imp']} x {scale:.4g}, "
                  f"the largest)")
        ok = ok and di <= CPU_TOL["imp"] * scale
    print(f"GPU vs CPU path, {state.bodies.pos.shape[0]} {what} scene(s) x 10 "
          f"steps: max |d pos| {dp:.3e} "
          f"(tol {CPU_TOL['pos']}), max |d linvel| {dv:.3e} (tol {CPU_TOL['vel']}){joints}")
    if not ok:
        _fail(f"GPU path disagrees with the CPU path ({what})")


def _cpu_step_agreement(what, state, params):
    """The card against the CPU one step at a time along the card's
    trajectory: each CPU step starts from the card's state, and the step's
    bodies and contact cache (pair keys, touching flags, and the impulses
    the next step warmstarts from) must agree.  Printed beside it: the gap
    between the card and the CPU run freely over the same steps, and a
    witness of how far the pile itself amplifies rounding, the gap between
    two free CPU runs whose start differs by 1 ulp in the height of the
    body moving fastest vertically (1 ulp at these heights is the card's
    one-step gap in position; a velocity's ulp would be absorbed at rest)."""
    import torch
    from rapier_tpu_torch.pipeline.physics_pipeline import step
    from rapier_tpu_torch.types import tree_map

    def gap(a, b, part, name):
        return float((getattr(getattr(a, part), name).cpu()
                      - getattr(getattr(b, part), name)).abs().max())

    imp = ("impulse", "tangent_impulse", "warmstart_impulse",
           "warmstart_tangent_impulse", "warmstart_twist_impulse")
    steps = 10
    gpu, dp, dv, di, scale, flips = state, 0.0, 0.0, 0.0, 1.0, 0
    free = tree_map(lambda x: x.cpu(), state)
    nudged = tree_map(lambda x: x.clone(), free)
    i = int(nudged.bodies.linvel[0, :, 1].abs().argmax())
    for name in ("pos", "next_pos"):
        y = getattr(nudged.bodies, name)[..., 1]
        y[0, i] = torch.nextafter(y[0, i], torch.tensor(float("inf")))
    for _ in range(steps):
        nxt, _ = step(gpu, params)
        cpu, _ = step(tree_map(lambda x: x.cpu(), gpu), params)
        free, _ = step(free, params)
        nudged, _ = step(nudged, params)
        dp = max(dp, gap(nxt, cpu, "bodies", "pos"))
        dv = max(dv, gap(nxt, cpu, "bodies", "linvel"), gap(nxt, cpu, "bodies", "angvel"))
        di = max([di] + [gap(nxt, cpu, "contacts", f) for f in imp])
        scale = max([scale] + [float(getattr(cpu.contacts, f).abs().max()) for f in imp])
        flips = max(flips, *(int((getattr(nxt.contacts, f).cpu()
                                  != getattr(cpu.contacts, f)).sum())
                             for f in ("pair_key", "touching")))
        gpu = nxt
    fp, fv = gap(gpu, free, "bodies", "pos"), gap(gpu, free, "bodies", "linvel")
    wp, wv = gap(nudged, free, "bodies", "pos"), gap(nudged, free, "bodies", "linvel")
    print(f"GPU vs CPU step, {what}, {steps} steps each from the card's state: max |d pos| "
          f"{dp:.3e} (tol {CPU_TOL['pos']}), max |d vel| {dv:.3e} (tol {CPU_TOL['vel']}), "
          f"max |d impulse| {di:.3e} (tol {CPU_TOL['imp']} x {scale:.3f}, the largest "
          f"impulse), pair keys and touching flags differing in {flips} lanes; run freely "
          f"from the same start, the card and the CPU part by {fp:.3e} in position and "
          f"{fv:.3e} in velocity after {steps} steps, and two CPU runs whose start "
          f"differs by 1 ulp in body {i}'s height by {wp:.3e} and {wv:.3e}")
    if not (dp <= CPU_TOL["pos"] and dv <= CPU_TOL["vel"]
            and di <= CPU_TOL["imp"] * scale and flips == 0):
        _fail(f"GPU step disagrees with the CPU step ({what})")


def phase_cpu_agreement(device, pyramid):
    """Phase 7: the card's path against the CPU (plain) path; `pyramid`
    holds the stack-16 pyramid after PYRAMID_CPU_SETTLE steps on the card
    ("landing") and after phase 6's timed run ("settled")."""
    _cpu_agreement("bench", *bench_world(device, 2), 100)
    _cpu_agreement("quadruped", *quadruped_batch(device, 2, seed=3), ROBOT_CHECK_STEPS)
    _cpu_agreement("joints3", *joints3_batch(device, 2)[:2], JOINT_CPU_SETTLE)
    _cpu_agreement("impulse-joint quadruped", *impulse_quadruped_batch(device, 2, seed=3),
                   ROBOT_CHECK_STEPS)
    for name, steps in (("landing", PYRAMID_CPU_SETTLE),
                        ("settled", PYRAMID_SETTLE + PYRAMID_TIMED)):
        _cpu_step_agreement(f"the stack-16 pyramid after {steps} steps", *pyramid[name])


def _rerun_equal(what, state, params, parts):
    import torch
    from rapier_tpu_torch.types import tree_map

    a, _ = run(tree_map(lambda x: x.clone(), state), params, 10)
    b, _ = run(tree_map(lambda x: x.clone(), state), params, 10)
    for part in parts:
        pa, pb = getattr(a, part), getattr(b, part)
        for f in dataclasses.fields(pa):
            if not torch.equal(getattr(pa, f.name), getattr(pb, f.name)):
                _fail(f"{what} rerun differs in {part}.{f.name}")
    print(f"determinism: two 10-step reruns of the {what} batch are bitwise equal")


def phase_determinism(device, pyramid):
    """Phase 8: bitwise reruns."""
    state, params = bench_world(device, 64)
    state, _ = run(state, params, 60)
    _rerun_equal("bench", state, params, ("bodies", "contacts"))
    state, params = quadruped_batch(device, N_CHECK, seed=5)
    state, _ = run(state, params, ROBOT_CHECK_STEPS)
    _rerun_equal("quadruped", state, params, ("bodies", "contacts", "multibodies"))
    _rerun_equal("stack-16 pyramid", *pyramid["landing"], ("bodies", "contacts"))
    state, params, _ = joints3_batch(device, N_CHECK)
    state, _ = run(state, params, JOINT_CPU_SETTLE)
    _rerun_equal("joints3", state, params, ("bodies", "contacts", "joints"))


def _replicas_equal(what, state, parts):
    import torch

    for part in parts:
        p = getattr(state, part)
        for f in dataclasses.fields(p):
            x = getattr(p, f.name)
            if not torch.equal(x, x[:1].expand_as(x)):
                _fail(f"{what}: replicas differ from scene 0 in {part}.{f.name}")


def phase_joints(device, card):
    """Phase 9: 4096 joints3 scenes and 4096 impulse-joint quadrupeds
    through the port's step, on the masked sweep."""
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.pipeline.physics_pipeline import solve_path

    rows = {}
    joints3 = joints3_batch(device, N_SCENES)
    for name, (state, params) in (("joints3", joints3[:2]),
                                  ("impulse quadruped", impulse_quadruped_batch(device,
                                                                                N_SCENES))):
        path = solve_path(state, params)
        if path != "masked":
            _fail(f"{name} takes the {path} path, not the masked sweep")
        cs.KERNEL.launches = cs.KERNEL.launches_folded = 0
        t0 = time.time()
        state, worst = run(state, params, JOINT_SETTLE)
        torch.cuda.synchronize()
        settle_s = time.time() - t0
        # The example's checks, and the trunk height, after its 240 steps.
        _finite(state)
        b = state.bodies
        if name == "joints3":
            handles = joints3[2]
            tip_y = b.pos[:, handles["chain"][-1], 1]
            slider_y = b.pos[:, handles["slider"], 1]
            print(f"joints3 after {JOINT_SETTLE} steps: chain tip y {float(tip_y[0]):.4f} "
                  f"(below 8), slider y {float(slider_y[0]):.4f} (within 0.3 of 7.5), rope "
                  f"tip {b.pos[0, handles['rope'][-1]].tolist()} in scene 0; the checks "
                  f"hold in all {N_SCENES} scenes")
            if not (bool((tip_y < 8.0).all()) and bool(((slider_y - 7.5).abs() < 0.3).all())):
                _fail("joints3: the example's checks fail")
            row = dict(chain_tip_y=float(tip_y[0]), slider_y=float(slider_y[0]))
        else:
            z = float(b.pos[0, TRUNK, 2])
            print(f"impulse-joint quadruped: trunk height {z:.5f} after {JOINT_SETTLE} "
                  f"steps (the reference's: {IMPULSE_TRUNK_Z_REF}, R5)")
            row = dict(trunk_z=z)
        t0 = time.time()
        state, worst_t = run(state, params, JOINT_TIMED)
        torch.cuda.synchronize()
        elapsed = time.time() - t0
        launches = cs.KERNEL.launches, cs.KERNEL.launches_folded
        for k in worst:
            worst[k] = max(worst[k], worst_t[k])
        rate = N_SCENES * JOINT_TIMED / elapsed
        print(f"{name}: {rate:.1f} env-steps/s ({N_SCENES} scenes x {JOINT_TIMED} steps in "
              f"{elapsed:.3f} s after {JOINT_SETTLE} in {settle_s:.1f} s; {card}); "
              f"{state.joints.n} joints a scene (padded to 8), row slots "
              f"{params.joint_slots}; overflow {worst}; contact-sweep "
              f"launches {launches[0]} + folded {launches[1]} (the masked sweep has none)")
        if worst["broadphase_overflow"] or worst["solver_overflow"]:
            _fail(f"{name} overflows: {worst}")
        if launches != (0, 0):
            _fail(f"{name} launched a contact-sweep kernel: {launches}")
        _finite(state)
        _replicas_equal(name, state, ("bodies", "contacts", "joints"))
        print(f"{name}: all {N_SCENES} scenes bitwise equal to scene 0 after "
              f"{JOINT_SETTLE + JOINT_TIMED} steps")
        rows[name] = dict(env_steps_per_s=rate, **row, **worst,
                          **_stages(f"{name} step, {N_SCENES} scenes", state, params, card,
                                    trace_steps=TRACE_STEPS_LONG))
    return rows


LANE_KEYS = ("b1", "b2", "valid", "color", "normal", "point", "point_active", "dist",
             "friction", "restitution", "prev_impulse", "ws_n", "ws_t", "ws_tw",
             "dyn1", "dyn2")


def _every_lane_valid(inp, tiles: int = 1):
    """`inp` with its lane axis tiled `tiles` times and every lane valid: a
    lane that was not becomes an inert copy of a valid lane of its scene
    (same bodies and color, no active point, zero warmstart), so a scene
    solves all its lanes, and the colors the copies join conflict."""
    import torch

    inp = dict(inp)
    k = inp["b1"].shape[-1]
    for key in LANE_KEYS:
        inp[key] = inp[key].repeat((1,) * (inp[key].dim() - 1) + (tiles,))
    inp["valid"][..., k:] = False
    for s in range(inp["b1"].shape[0]):
        lanes = torch.nonzero(inp["valid"][s]).flatten()
        idle = torch.nonzero(~inp["valid"][s]).flatten()
        src = lanes[torch.arange(len(idle), device=lanes.device) % len(lanes)]
        for key in LANE_KEYS:
            inp[key][s, ..., idle] = inp[key][s, ..., src]
        inp["point_active"][s, :, idle] = False
        for key in ("ws_n", "ws_t", "ws_tw"):
            inp[key][s, ..., idle] = 0.0
    inp["valid"][:] = True
    return inp


def _tile(inp, reps: int):
    """Captured solve inputs (with "sb") tiled as `_scenes` does."""
    from rapier_tpu_torch.dynamics.solver.contact_constraints import SolverBodies

    out = {k: _scenes(v, reps) for k, v in inp.items() if k != "sb"}
    out["sb"] = SolverBodies(*[_scenes(x, reps) for x in inp["sb"]])
    return out


def _load_kernel(root):
    """The contact-sweep wrapper of the checkout at `root`, loaded beside this
    one's: its own source, build directory and library."""
    path = os.path.join(os.path.abspath(root), "rapier_tpu_torch", "dynamics", "solver",
                        "contact_sweep.py")
    spec = importlib.util.spec_from_file_location(f"contact_sweep_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.KERNEL


def phase_earlier(device, card, roots):
    """With --earlier: this checkout's kernels and those of the checkouts at
    `roots`, timed on the same packed inputs, each output held to this
    checkout's, and this checkout's held to the plain version."""
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    kernels = {"this checkout": cs.KERNEL, **{root: _load_kernel(root) for root in roots}}
    t0 = time.time()
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda kern: kern.build(), kernels.values()))
    print(f"built {len(kernels)} kernel libraries in {time.time() - t0:.1f} s")

    state, params = bench_world(device, N_CHECK)
    state, _ = run(state, params, SETTLE)
    bench = capture_solve_inputs(state, params)
    state, params = quadruped_batch(device, N_CHECK, seed=7)
    state, _ = run(state, params, ROBOT_CHECK_STEPS)
    quad = capture_solve_inputs(state, params)
    reps = N_SCENES // N_CHECK
    cases = (
        (f"bench, {N_SCENES} scenes", False, _tile(bench, reps)),
        (f"bench, {N_SCENES} scenes, every lane valid", False,
         _tile(_every_lane_valid(bench), reps)),
        ("one bench scene, every lane valid", False, _every_lane_valid(_tile(bench, 0), 9)),
        (f"quadruped, {N_SCENES} scenes", True, _tile(quad, reps)),
        (f"quadruped, {N_SCENES} scenes, every lane valid", True,
         _tile(_every_lane_valid(quad), reps)),
    )
    rows = []
    for what, folded, inp in cases:
        inp = dict(inp)
        sb = inp.pop("sb")
        packed, kw = _packed(sb, inp)
        k, n1 = packed[0].shape[-1], packed[2].shape[-1]
        name = "contact_sweep_folded_kernel" if folded else "contact_sweep_kernel"
        print(f"{what}: K={k}, N+1={n1}, {name}")
        storage = _storage("  this checkout", folded, packed, kw, False)
        ref = None
        for source, kern in kernels.items():
            fn = kern.launch_folded if folded else kern.launch
            out = fn(*packed, **kw)
            if ref is None:
                ref = out
                body = out[0]
                _compare(f"  {name}", sb, inp,
                         sb._replace(v_lin=body[:, 0:3], v_ang=body[:, 3:6],
                                     com=body[:, 6:9], rot=body[:, 9:13]), out[1])
            ms = _time_ms(lambda: fn(*packed, **kw), 20)
            torch.cuda.synchronize()
            diff = max(float((a - b).abs().max()) for a, b in zip(out, ref))
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            print(f"  {source}: {ms:.3f} ms; max |d| from this checkout {diff:.3e}"
                  f"{' (bit for bit)' if same else ''} ({card})")
            rows.append(dict(case=what, kernel=name, source=source, ms=ms,
                             max_abs_diff=diff, bitwise=same, **storage))
    print(json.dumps({"earlier": rows}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", nargs="+", metavar="DIR",
                    help="time the kernels of these unpacked checkouts beside this one's "
                         "and run nothing else")
    ap.add_argument("--pyramid", type=int, nargs="*", default=[], metavar="STACK",
                    help="also run the pyramid phase at these stack heights (e.g. 31, "
                         "BASELINE.json's 10,416-box pyramid)")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        _fail("PyTorch is not installed", 2)
    if not torch.cuda.is_available():
        _fail("no CUDA device (torch.cuda.is_available() is False)", 2)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    except ImportError as e:
        _fail(f"rapier_tpu_torch is not importable next to this script: {e}", 3)

    device = torch.device("cuda")
    card = _card_line()
    print(card)   # name, power limit: nvidia-smi's own line

    start = t0 = time.time()
    cs.KERNEL.build()
    print(f"built contact_sweep.cu in {time.time() - t0:.1f} s")
    for line in cs.KERNEL.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  nvcc: {line.strip()}")

    def phase(fn, *args):
        t = time.time()
        out = fn(*args)
        print(f"[{fn.__name__}: {time.time() - t:.1f} s]")
        return out

    if args.earlier:
        phase(phase_earlier, device, card, args.earlier)
        return

    block = phase(phase_kernel, device, card)
    folded = phase(phase_folded_kernel, device, card)
    block["launches"], _, bench_stages = phase(phase_main_path, device, card)
    folded["launches"], _ = phase(phase_robots, device, card)
    stacks = tuple(sorted(set(PYRAMID_STACKS) | set(args.pyramid)))
    pyramids, pyramid16 = phase(phase_pyramid, device, card, stacks)
    phase(phase_cpu_agreement, device, pyramid16)
    phase(phase_determinism, device, pyramid16)
    joints = phase(phase_joints, device, card)
    print(f"[all phases, the build included: {time.time() - start:.1f} s of the 1,200 allowed]")

    print(json.dumps({"pyramid": pyramids, "bench_step": bench_stages, "joints": joints,
                      "card": card}))
    source = "rapier_tpu_torch/csrc/contact_sweep.cu"
    print(json.dumps({"kernels": [
        {"name": "contact_sweep_kernel", "route": "cuda", "source": source,
         "replaces": "rapier_tpu/dynamics/solver/pallas_sweep.py:517",
         "library_ms": None, **block},
        {"name": "contact_sweep_folded_kernel", "route": "cuda", "source": source,
         "replaces": "rapier_tpu/dynamics/solver/pallas_sweep.py:339",
         "library_ms": None, **folded},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
