#!/usr/bin/env python3
"""Chip smoke test: drive rapier_tpu_torch's main path on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero; each prints its wall time), run in the
order 1, 2, 3, 2(b), 3(b), 4-6, 10, 11, 12, 9, 13, 14, 15, 16, 7, 8:

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
2(b), 3(b). The kernels' float64 builds: phase 2 on the solve inputs of
   one f64 step of phase 2's settled bench batch (every float leaf cast to
   float64) and phase 3 on phase 3's quadruped capture cast to float64.  Each is held on 64 scenes
   to the plain version at f64 on the CPU by the f64 parity rule (within
   F64_WITNESS_FACTOR times the gap of a plain run whose velocities start 1
   ulp higher, or F64_ULPS float64 ulps of each part's largest value; every
   part's gap and witness gap printed in ulps), the other build bit for bit
   on the same packed inputs, and timed at 4096 scenes against its bound at
   the FP64 rate, with the same resource and storage lines.
4. The bench path: the bench scene (4 layers of 5x5 balls, cuboids and
   capsules on a ground cuboid, max_pairs 512, max_solver_pairs 256)
   replicated to 4096 scenes, settled for 150 steps, then 50 timed steps.
   Checks zero broad-phase / solver overflow, finite state, exactly one
   `contact_sweep_kernel` launch per step and no folded one, every scene's
   lanes on chip at the step after the timed run, bodies resting above the
   ground.
5. The robots path: 4096 replicas of `quadruped_world(use_multibody=True)`,
   60 steps (the trunk is down by ~40), then 50 timed steps.  Checks finite state, zero overflow,
   exactly one folded launch per step and no block launch, every scene's
   lanes on chip at the step after the timed run, every scene bitwise equal
   to scene 0, and the trunk at the reference's height (R5).
6. The large single scenes: bench.py's pyramid mode (`pyramid3_world`, the
   grid broad phase, max_solver_pairs = 8 per box rounded up to 128, one
   scene) at stack 16 (and 24 or 31 with ``--pyramid 24 31``), 120 steps,
   then 30 timed steps (bench.py runs 150 and 50; cut for the run's time
   limit; stack 24 left the default run to make room for phase 10, whose
   5,050-box 2D pile keeps a blocked scene of that size in it).  Checks the
   blocked solve's path, zero broad-phase / solver overflow, finite state,
   and that stack 16 has come to rest (the top box within PYRAMID_TOP_TOL
   of its resting height and slower than PYRAMID_REST_VY) and any other
   stands (not below it); prints steps/s, the top box's distance from rest and its vertical
   velocity, the lanes the reference's layout would drop (R7), and for a
   stack after the first the per-stage breakdown of a step (host
   milliseconds between synchronisations, `utils/counters.profile_step`)
   with its kernel count and device-busy share (`trace_step`,
   torch.profiler).  The bench step's breakdown is printed in phase 4.
7. The card against the CPU (plain) path: 2 bench scenes (of phase 4's
   batch after its timed run), 2 quadruped scenes (of phase 3's capture
   batch), 2 joints3 scenes (of phase 9's batch after its timed run), 2
   impulse-joint quadrupeds and 2
   high-mass-ratio 2D scenes for 5 steps each (with the joints' row
   impulses within 1e-3 of the largest); the stack-16 pyramid after 30
   steps on the card (mid-landing) and after phase 6's 150 (at rest), 1
   step each, 2 10-row 2D pyramids and 2 Coulomb stacks after 3, 5 steps
   each, and phase 10's 5,050-box 2D pile after its 60, 1 step, 2 heightfield3
   scenes of phase 11's capture batch (after 60 steps, in contact), 5 steps,
   and 2 trimesh3 scenes after
   50 (the ball on the valley floor), 10 steps, stepped on the CPU
   from the card's state, bodies and contact cache (pair keys, touching
   flags, impulses) compared; the 2D pile's bodies and impulses to the
   larger of CPU_TOL and twice the gap of two CPU steps whose starts differ
   by 1 ulp in every body's height (within one step the 100-row pile
   amplifies rounding past CPU_TOL, PERF.md).  Each line prints its wall
   time.  A free run of a
   pile amplifies rounding about twofold a step, so beside the stack-16 and
   10-row 2D checks it
   prints the free card-vs-CPU gap and, as its witness, the gap between two
   free CPU runs whose start differs by 1 ulp in one body's height.
8. Determinism: 5 steps run twice from one state are bitwise equal, for
   64 scenes of phase 4's bench batch, phase 3's quadruped capture batch,
   256 scenes of phase 9's joints3 batch and phase 11's heightfield3 capture
   batch; 2 steps for the stack-16 pyramid; 3 steps for a 10-row 2D pyramid
   batch and a Coulomb-stack batch.
9. The impulse joints: 4096 replicas of the joint zoo (`scenes.joints3_world`,
   examples/joints3.py: revolute chain, prismatic slider with a position
   motor and limits, fixed-joint lattice, spherical rope with swing limits)
   and 4096 impulse-joint quadrupeds (`quadruped_world(use_multibody=False)`),
   30 and 120 steps, then 10 timed steps.  Both take the masked sweep (the
   reference's gate sends scenes with joints there), so neither may launch a
   contact-sweep kernel.  Checks zero overflow, finite state, every scene
   bitwise equal to scene 0, and for joints3 after 30 steps the example's
   own checks on every scene (the chain tip below y = 8, the slider within
   0.3 of y = 7.5); prints the quadruped's trunk height after 120 steps
   beside the reference's 0.188 after 240 (R5; the port's is within 0.003
   of it from step 120 on),
   env-steps/s, the stage breakdown (with the `joints` stage: row builds and
   sweeps), kernels a step and the device-busy share.
10. The 2D slice (`PhysicsWorld2D`: plane-locked bodies, the 2x2 block
   solve; none of it launches a contact-sweep kernel, as the reference's
   gate sends 2x2 and Coulomb scenes to its jnp sweeps).  (a) SURVEY.md's
   s2d_pyramid at its full 100 rows (`scenes.s2d_pyramid_world(100)`, 5,050
   boxes, one scene) at 24 colors, not SimParams' default 16: at 16 the
   Luby rounds leave ~1,000 lanes to the Jacobi tail and the pile explodes,
   as the reference's blocked solve does with such a tail (ROADMAP F6; each
   reading prints the tail 16 colors would leave).  The blocked solve with
   the 2x2 flag on every pass, 55 steps, then 5 timed (examples/s2d_pyramid.py
   runs 600; cut for the run's time limit), the top box and the tail read
   every 10 steps; checks zero overflow, finite state, z and the x / y spins
   exactly 0, and that the pile holds (after its top row lands at step ~30
   no box faster than that row's free fall, none above its start, the top
   box above 0.9 x 99 and within 1.5 of rest, its swing shrinking); prints
   whether it is at rest (it still swings after 60 steps: F6), steps/s, the
   largest row-height deviation, how far the boxes sank and one traced step.
   (b) 4096 replicas of the 10-row pyramid, 5 steps, then 5 timed, and (c)
   4096 of the Coulomb stack with its kicked slider
   (`scenes.s2d_coulomb_stack_world`), 75 steps (the slider comes to rest
   at ~80), then 5 timed, each on the masked sweep; checks zero overflow,
   no contact-kernel launch, every scene bitwise equal to scene 0,
   tests/test_s2d.py's own checks on every scene (boxes within 0.15 of their
   starts; the slider at rest between x = 20.5 and 30); prints env-steps/s,
   and for (c) one traced step.
11. The meshes (the mesh narrow phase: per-triangle lanes after the pair
   lanes).  (a) `contact_sweep_kernel` at heightfield3's K = 640 lanes (128
   pair lanes and 64 x 8 mesh lanes) against the plain version on a capture
   of 256 scenes after 60 steps, timed at 4096 scenes and at one, with the
   valid lanes per scene and the scenes that keep them on chip; then 4096
   replicas of `scenes.heightfield3_world` (examples/heightfield3.py: 12
   balls, cuboids and capsules dropped on a 12 x 12 heightfield) take 90
   steps (the example runs 300; every body has landed by ~81), then 25
   timed.  Checks zero broad-phase / solver
   overflow, no (convex, mesh) pair past max_mesh_pairs (the reference drops
   those uncounted, ROADMAP R12: counted here on the 90 steps and the step
   after the timed run), finite state, exactly one `contact_sweep_kernel`
   launch per step and no folded one, every scene bitwise equal to scene 0,
   and the example's own checks on every scene (every body above -2.5 and
   below 3.0); prints env-steps/s, the peak device memory of the timed
   steps, the stage breakdown (with `mesh_narrow_phase`), kernels a step and
   the device-busy share.  (d) With ``--heightfield-full``: upstream's
   heightfield3 at its size (`scenes.heightfield3_full_world`, 1,280 bodies
   of upstream's six shapes, 1,665 colliders, on a 20 x 20-subdivision
   field, max_mesh_pairs 1,664), one scene, 60
   steps, then 10 timed; checks zero overflow, no mesh pair dropped, finite
   state, and that the bottom layer landed on the field and above it;
   prints steps/s and one traced step.
12. The convex shapes (the GJK/EPA fallback for every convex pair without
   an analytic kernel).  (a) `contact_sweep_kernel` at K = 256 against the
   plain version on a capture of 256 primitives3 scenes after 60 steps (in
   contact), timed at 4096 scenes and at one, with the valid lanes per
   scene and the scenes that keep them on chip; (b) 4096 replicas of
   upstream's primitives3 cut to 5 layers of 5 x 5 (`scenes.primitives3_world`:
   capsules, balls, round cylinders and cones of radius 1; max_pairs 512,
   max_solver_pairs 256) take 80 steps (every layer has landed), then 25
   timed.  Checks zero broad-phase and solver overflow, zero unsupported
   pairs (no lane dropped by the GJK/EPA bucket), finite state, exactly one
   `contact_sweep_kernel` launch per step and no folded one, every scene
   bitwise equal to scene 0, every body above the ground and below its drop
   height, and after the 80 steps no body faster than twice the
   reference's fastest on the CPU (tools/primitives3_reference_speed.py);
   prints env-steps/s, the peak device memory of the timed steps, the stage
   breakdown (with `gjk_epa`), kernels a step and the device-busy share.
   Phase 7 adds 2 scenes of (a)'s primitives3 capture batch (after 60
   steps) and 2 convex zoo scenes (`scenes.convex_zoo_world`) after 20, 5
   single steps each; phase 8 a 10-step rerun of that 256-scene batch.  (d) With ``--primitives-full``:
   upstream's primitives3 at its size (20 layers of 8 x 8, 1,280 bodies, one
   scene, the masked sweep), 60 + 10 steps; checks zero overflow, finite
   state and no body below the ground; prints steps/s and one traced step.
13. CCD and the multibody remainder.  (a) Upstream's ccd3
   (`scenes.ccd3_world`: 5 walls of 8-high box pyramids, two 1000 m/s CCD
   balls, 183 bodies) as one scene, 6 steps (a clamping step is ~137,000
   launches), each step's clamps recorded; checks zero
   broad-phase, solver and CCD overflow, finite state, a clamped step
   shorter than free flight for each ball, each ball's exit speed below
   600 m/s (tests/test_ccd.py's bound), the first wall's boxes moved by
   more than 0.2, one `contact_sweep_kernel` launch a step, and that a
   ball which crossed a wall's plane inside its silhouette had a clamped
   step ending at that wall; prints steps/s and the stage breakdown (with
   `ccd`), launches and busy share of the step that first clamps a ball.
   (b) 1024 replicas, 4 steps, the last 3 timed: zero
   overflow, every scene bitwise equal to scene 0; prints env-steps/s,
   peak memory, the `ccd` stage's milliseconds and the kernel's storage
   line (ccd3's ~200-350 valid lanes a scene exceed the on-chip capacity:
   the global scratch).  (c) 4096 `scenes.multibody_arm_world` arms
   (examples/multibody_arm.py), 80 steps (the example's 300 cut; its
   checks hold from step ~55): the example's checks on every scene, every
   scene bitwise equal to scene 0, one folded launch a step (K = 128);
   prints env-steps/s.  (d) 4096 arms with the elbow's velocity coupled to
   -1 x the shoulder's, 20 steps: the coupling within 1e-3 relative on
   every scene.  (e) `inverse_kinematics` on 4096 arms towards targets
   from seeded joint angles: every target within 2e-3
   (tests/test_multibody.py's), the CPU's result on the first 1024 within
   1e-4 of the card's.  Phase 7 adds 2 ccd3 scenes of (b) from the step
   that first clamps a ball (1 single step) and 2 arms and 2 coupled arms
   (5 steps); phase 8 64 ccd3 scenes and 256 arms, 1 step each.
14. The world's runtime API and the loaders.  (a) The bench scene as one
   `PhysicsWorld` (101 bodies, capacity 104, P = 512, K = 256), settled 60
   steps (the last 30 timed, plain), then for 60 steps, every 10 steps: a
   ball inserted at runtime above the pile, a body of two colliders
   inserted and one of them removed, the oldest pile body removed; both
   tables grow past 104 within three cycles (the step each grows printed,
   with the solve path and the kernel's on-chip capacity at the new N).
   Checks that stale handles raise, that no touching lane involves a
   removed collider on the step after, zero broad-phase, solver and
   unsupported-pair overflow, one `contact_sweep_kernel` launch a step, 2
   single steps against the CPU after the first mutation and after both
   tables grew (CPU_TOL); snapshot then restore, and save then load into a
   fresh world of the grown capacities, each followed by 20 steps,
   reproduce the run bitwise, and a world of the bench's capacities
   refuses the file; under nan_policy "rollback" at nan_check_every 16 a
   NaN velocity set with `set_linvel` is rolled back to the last checked
   state bitwise, and "trap" raises (at interval 1).  Prints steps/s plain, mutating and
   under the guard at 16 and at 1, the milliseconds of an insert, a
   removal, each growth, a snapshot, a save and a load, and the file's
   size.  (b) examples/urdf_pendulum.py's robot in both joint forms and the
   tendon, connect and gravcomp-mocap models of tests/test_mjcf.py
   (`scenes.urdf_pendulum_world`, `scenes.mjcf_model_world`), 10 steps on
   the card with each model's own check, then 2 single steps against the
   CPU.

15. Hooks, the collision pipeline, scene queries and the controllers.  (a)
   4096 one_way_platforms3 scenes (`scenes.one_way_platforms3_world`: the
   one-way contact filter on the platform) for 60 steps: one
   contact-sweep launch a step, of the kind the gate picks (K = 128: the
   folded kernel), the ball from above resting above y = 0.4 and the one
   from below passing y = 1.0 on every scene; then 256 scenes under a
   modifier that scales the gated lanes' friction, 2 single steps from the
   card's state against the CPU (impulses included).  (b) `collide` on
   phase 4's settled 4096 bench scenes: its pair keys and touching flags
   equal the cache a step from the same state writes, bodies bitwise
   unchanged; its milliseconds.  (c) Queries at a lidar's size on those
   scenes: a fan of 64 rays a scene from 12 m above (`cast_ray`; every ray
   hits, each hit point within 1e-4 of its collider by `project_point_all`),
   64 `project_point` points and 16 ball `cast_shape` casts a scene (every
   cast hits), 2 scenes of each against the CPU; rays/s, points/s, casts/s.
   (d) 4096 vehicles (`scenes.vehicle_world`, tests/test_controllers.py's
   curve: `update_vehicle` then the step, 150 steps; |x| > 0.8 and y in (0.2,
   1.0) on every scene) and 4096 characters (`scenes.character_world`: one
   `move_shape` with the push impulses of an 80 kg character, then 10 steps;
   the box pushed forward on every scene, 2 scenes' move and push against
   the CPU), each stepping on the kernel the gate picks once a step;
   env-steps/s, character moves/s, the traced env-step's kernels and busy
   share.  Phase 7 takes 2 hooked platform scenes after 20 steps and 2
   vehicles after 75 (5 free steps against the CPU), phase 8 reruns 64 of
   each for 5 steps bitwise.

16. The f64 axis, scene sharding and debug render.  (a) Upstream's far
   pyramid (`scenes.s2d_far_pyramid_world`, 55 boxes at (1e5, -8e4)) built
   at f64, one scene, FAR_STEPS steps (the reference test's 300, cut to
   60 for the time limit): the route
   printed (the masked sweep: the 2x2 block solve never takes the kernel),
   zero contact-sweep launches, the largest rest-height error below FAR_TOL
   (tests/test_2d_core.py's check), steps/s.  4096 bench scenes built at f64
   and the same scenes at float32, both on the kernel route (its float64
   and float32 builds, which separates the dtype's cost from the route's),
   10 + 10 steps each: zero overflow and one `contact_sweep_kernel` launch a
   step, every scene bitwise equal to scene 0, env-steps/s, peak device
   memory and one traced step.  (b) 4096 bench
   scenes (`parallel/sharding.py`) for 30 steps, the last 10 timed: a mesh
   of the one card in this process (one NCCL rank a card on a machine with
   several), then 2 gloo ranks sharing card 0, spawned; the state gathered
   on rank 0 bitwise equal (SHA-256 of every leaf) to the unsharded step's
   over the same 30 steps, one `contact_sweep_kernel` launch a step on each
   rank, env-steps/s per rank and in total, the seconds from the spawn to
   the first finished step.  (c) Debug render (`utils/debug_render.py`) of
   scene 0 of phase 4's settled bench batch, phase 9's joints3, phase 11's
   heightfield3 and the trimesh-and-hull scene of tests/test_world_api.py,
   on the card and again from the same state on the CPU: line counts and
   colors equal, coordinates within RENDER_TOL; the milliseconds of each.
   Phase 7 steps 2 f64 bench scenes (settled 45 steps on the card) 5 steps
   on the card and on the CPU, held to an f64 1-ulp witness; phase 8 reruns
   64 f64 bench scenes for 5 steps bitwise.

The line before the last is the kernels' JSON record (with `bound_share`,
bound over time, and each kernel's resources; `contact_sweep_kernel_f64`
and `contact_sweep_folded_kernel_f64` are the float64 builds, whose main
path is phase 16's f64 bench); the last line is
``{"ok": true, "device": {...}}``.

With ``--kernels-only`` the script builds the kernels and runs phases 2,
3, 2(b) and 3(b) alone, with ``--s2d-only`` phase 10,
with ``--meshes-only`` phase 11 (and (d) under ``--heightfield-full``),
with ``--convex-only`` phase 12 (and (d) under ``--primitives-full``),
with ``--ccd-only`` phase 13, with ``--world-only`` phase 14, with
``--queries-only`` phase 15 (on a bench batch settled for it) and its
phase 7 and 8 parts, with ``--remainder-only`` phase 16 (on batches
settled for it) and its phase 7 and 8 parts;
with ``--rest-steps STEPS`` it steps the ``--pyramid`` stacks (default 31)
STEPS steps each (at ``--colors N`` colors, else the default 16) and prints
the top box's distance from rest and vertical velocity every 50 steps,
with the lanes the Jacobi tail holds at N and at 16 colors.  None of these
prints the ok line.

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
# The quadruped's trunk has fallen to the reference's 0.050 by step ~40 (a
# CPU run of the port; the reference's is at 0.050 after 240, R5): the
# robots path settles ROBOT_SETTLE steps (240 until the whole script outran
# its 1,200 s limit) before its timed run and the trunk check.
ROBOT_SETTLE = 60
ROBOT_CHECK_STEPS = 40
KERNEL_TOL = dict(bodies=1e-4, impulses=1e-3)   # atol, summation order only
# atol over 10 contact steps; impulses: atol times the largest impulse's
# magnitude (at least 1), since they scale with the weight a contact bears.
CPU_TOL = dict(pos=1e-4, vel=1e-3, imp=1e-3)
# Phase 7's free runs on the card and the CPU, and phase 8's reruns, of the
# small-scene batches (10 each until phase 16 joined the script).
CPU_FREE_STEPS = 5
RERUN_STEPS = 5
# A tall pile's single steps may differ up to this many times a 1-ulp
# witness's gap (`_cpu_step_agreement`), as the reference's own float32
# rounding bounds the port's in the CPU tests.
WITNESS_FACTOR = 2.0
# The reference's quadruped falls onto its trunk (ROADMAP R5): trunk centre
# at the box's half height, 0.050, after 240 steps.  A port that stands here
# has a parity fault.
TRUNK_Z = (0.045, 0.055)
TRUNK = 1                       # body handle of the trunk
# The impulse-joint quadruped falls more slowly; the reference's trunk is at
# 0.188 after 240 steps (ROADMAP R5, a CPU run of the reference): printed
# beside the port's, not checked.  The port's own CPU run has its trunk at
# 0.188-0.191 from step 120 on, and joints3's example checks hold from step
# 20 on, so each settles its JOINT_SETTLE steps (both 240 until the whole
# script outran its 1,200 s limit).  Phases 7 and 8 reuse 2 and N_CHECK
# scenes of the joints3 batch after its timed run.
IMPULSE_TRUNK_Z_REF = 0.188
JOINT_SETTLE = {"joints3": 30, "impulse quadruped": 120}
# Timed steps after the settle (launch-bound: ~0.2-0.6 s each); 25 until
# phase 15 joined the script, 15 until phase 16 did.
JOINT_TIMED = 10
# bench.py's default stack.  pyramid3.rs's stack 24 is opt-in (--pyramid 24),
# as 31 is: its ~150 steps and ~36 s trace made room for phase 10 within the
# script's time limit; the blocked path keeps a ~5,000-body scene in the
# default run, phase 10(a).
PYRAMID_STACKS = (16,)
# Steps before and in the timed run: a pyramid step takes ~0.7-1.4 s.
# bench.py runs 150 and 50; at 150 + 50 the whole script took ~1,140 s of
# its 1,200 on an H100 80GB HBM3 machine whose host ran ~35% slow, so the
# piles run 120 + 30 (stack 16 is at rest by then: checked below; at 90 + 15
# its top box still moved at 1.2 m/s).
PYRAMID_SETTLE = 120
PYRAMID_TIMED = 30
PYRAMID_CPU_SETTLE = 30
# Single steps of the card against the CPU from each pyramid state, and
# steps of its rerun: each single step takes a card step and three CPU
# steps of the 1,496-box pile (3 until the script outran its limit, 2 until
# phase 16 joined it).
PYRAMID_CPU_STEPS = 1
# Steps traced under torch.profiler, and steps the stage timers average,
# for the launch-bound paths (pyramid and joints): each of their steps
# launches the same kernels, and the profiler's processing grows with the
# 15,000-105,000 launches a step.
TRACE_STEPS_LONG = 1
TRACE_STEPS_BENCH = 1           # 3 until phase 16 joined the script
# A settled pyramid's top box rests at 2 * stack - 1 (boxes 2 high, the
# ground's top at 0); it starts 0.5 m a level higher.  Stacks 16 and 24 have
# come to rest by the end of the timed run: their top box must lie within
# PYRAMID_TOP_TOL of rest and move slower than PYRAMID_REST_VY.  Stack 31's top level lands at ~17 m/s after ~105
# steps and may still move then: it must stand (its top box above rest -
# PYRAMID_TOP_TOL; a lost level would put it a box height lower), and the run
# prints how far from rest the top box is and how fast it moves.
PYRAMID_TOP_TOL = 0.1
PYRAMID_REST_VY = 0.1           # m/s
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s and
# float32 and float64 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12
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


# Phase 10, the 2D slice.  (a) SURVEY.md's s2d_pyramid at its full 100 rows
# (5,050 boxes), one scene on the blocked path with S2D_BIG_COLORS colors:
# S2D_BIG_SETTLE steps, then S2D_BIG_TIMED timed (examples/s2d_pyramid.py
# runs 600; cut for the run's time limit), read every S2D_READ_EVERY steps.
# At SimParams' default 16 colors the Luby rounds leave 500-1,000 of its
# ~13,000 lanes to the Jacobi tail by step 20-30 and the pile explodes, as
# the reference's blocked solve does with such a tail (ROADMAP F6,
# tests/test_torch_s2d_step.py::test_jacobi_tail_explodes_in_both); at 24 the
# tail holds a few lanes.  The top row falls freely until it lands at about
# step S2D_BIG_LANDING (at 30 steps it falls at S2D_BIG_FALL), then the pile
# swings about its rest height, the top box at S2D_BIG_REST (100 rows of
# unit boxes on the ground's top at y = 0); S2D_BIG_SETTLE was 60 until the
# whole script outran its limit (the swing's first peak is at step ~50, so the
# last reading, at 60, still shows it shrinking).  (b) 4096 replicas of the 10-row
# pyramid: S2D_SETTLE steps, then S2D_TIMED timed; (c) of the Coulomb stack:
# S2D_SLIDE steps, the kicked slider's ~6 in the air and ~74 sliding to rest,
# then S2D_TIMED timed.  Both masked.
S2D_BIG_BASE = 100
S2D_BIG_COLORS = 24
S2D_BIG_SETTLE = 55             # 55 + 5: readings every 10 steps up to 60, as
S2D_BIG_TIMED = 5               # 50 + 10 did until phase 16 joined the script
S2D_READ_EVERY = 10
S2D_BIG_LANDING = 30
S2D_BIG_FALL = 4.905            # m/s: g x 30 steps of 1/60 s
S2D_BIG_REST = 99.5
S2D_BIG_TOP_TOL = 1.5           # the pile holds: its top box within 1.5 of rest
S2D_REST_TOL = 0.1              # at rest: within 0.1 of rest, slower than 0.1 m/s
S2D_REST_VY = 0.1
S2D_SETTLE = 5                  # 10 until phase 16 joined the script
S2D_SLIDE = 75
S2D_TIMED = 5                   # 10 until phase 16 joined the script
S2D_CPU_SETTLE = 3              # 2D piles touch from their first step
# Single steps from the card's state of the 10-row pyramids and the Coulomb
# stacks, and the 2D reruns' steps (10 and 5 until the whole script outran
# its 1,200 s limit).
S2D_CPU_STEPS = 5
S2D_RERUN = 3
# tests/test_s2d.py's checks: boxes within 0.15 of their starts; the slider
# at rest (|vx| < 0.1) between x = 20.5 and 30; the standing pile's top box
# above (base - 1) x 0.9 (examples/s2d_pyramid.py:33).
S2D_BOX_TOL = 0.15
SLIDER_X = (20.5, 30.0)
SLIDER_VX = 0.1
# --rest-steps: the pyramid's top box printed every REST_EVERY steps.
REST_EVERY = 50
# Phase 11, the meshes.  (a) 4096 replicas of heightfield3 (examples/
# heightfield3.py): HF_SETTLE steps (the example runs 300; cut for the
# script's time limit: every body has landed by step ~81), then HF_TIMED
# timed, and the example's checks on every scene (every body above HF_Y[0]
# and below HF_Y[1]).  Its K = 640 solver lanes (128 pair lanes and 64 x 8 mesh lanes)
# go to contact_sweep_kernel, held to the plain version on a capture of
# N_CHECK scenes after HF_CHECK_STEPS steps (in contact).  (b), (c) The
# card against the CPU and the reruns start HF_CHECK_STEPS steps in
# (trimesh3's ball lands at ~45: TRIMESH_SETTLE).  (d) --heightfield-full:
# upstream's heightfield3 at its size, one scene, HF_FULL_SETTLE +
# HF_FULL_TIMED steps; its bottom layer must land on the field: every body
# of it above the field's surface at its (x, z) and its centre within
# HF_FULL_NEAR of it (the largest half-extent is 2, a capsule on end).
HF_SETTLE = 90
HF_TIMED = 25                   # 50 until phase 15 joined the script
HF_Y = (-2.5, 3.0)
HF_K = 640
HF_CHECK_STEPS = 60
HF_CPU_STEPS = 5
TRIMESH_SETTLE = 50
HF_FULL_SETTLE = 60
HF_FULL_TIMED = 10
HF_FULL_NEAR = 3.0

# Phase 12, the convex shapes.  (a), (b) 4096 replicas of upstream's
# primitives3 cut to P3_LAYERS layers of P3_GRID x P3_GRID (one j % 5 shape
# cycle: capsules, balls, round cylinders, cones; the cylinders and cones
# take the GJK/EPA fallback) at the bench's max_pairs and max_solver_pairs:
# P3_SETTLE steps (every layer has landed), then P3_TIMED timed, on
# contact_sweep_kernel at K = P3_K (P3_SETTLE was 120 until the whole
# script's runs took 1,068.6 and 1,161.5 s of its 1,200: the top layer has
# landed by step ~70), the kernel held to the plain version on
# a capture of N_CHECK scenes after P3_CHECK_STEPS steps (in contact).  Every
# body must stay above the ground's top (y = 0) and below its drop height,
# and after the P3_SETTLE steps no body may move faster than P3_SPEED_BOUND:
# the reference's own run of one such scene on the CPU (rapier_tpu,
# tools/primitives3_reference_speed.py,
# solver_backend="pallas", the same builders) has its fastest body at
# P3_REF_SPEED m/s after P3_SETTLE steps, and the bound is twice that.  (c) The
# card against the CPU: P3_CPU_STEPS single steps from the card's state of 2
# scenes after P3_CHECK_STEPS steps, and of 2 convex zoo scenes after
# ZOO_SETTLE.  (d) --primitives-full: upstream's size, one scene,
# P3_FULL_SETTLE + P3_FULL_TIMED steps.
P3_LAYERS, P3_GRID = 5, 5
P3_MAX_PAIRS, P3_K = 512, 256
P3_SETTLE = 80
P3_TIMED = 25
P3_CHECK_STEPS = 60
P3_CPU_STEPS = 5
P3_REF_SPEED = 4.49
P3_SPEED_BOUND = 2 * P3_REF_SPEED
ZOO_SETTLE = 20
P3_FULL_SETTLE = 60
P3_FULL_TIMED = 10
# Phase 13: CCD (upstream's ccd3) and the multibody remainder (the arm).
# A ccd3 step that clamps is ~137,000 launches, 1.8-3.7 s on an H100 (the
# host sets it), so both ccd3 runs are short: by step 6 both balls have met
# the first wall, one has crossed the second wall's plane and the other is
# pinned at that wall.
CCD3_STEPS = 6                  # one scene
CCD3_SCENES = 1024
CCD3_BATCH_STEPS = 4            # the 1024 scenes
CCD3_TIMED = 3                  # the last 3 of them
CCD3_EXIT_SPEED = 600.0         # m/s, tests/test_ccd.py:84's bound
CCD3_BOX_MOVED = 0.2
CCD3_BAND = 1.0                 # a wall's clamp ends within this of its faces
CCD3_CPU_STEPS = 1              # 2 until phase 16 joined the script
CCD3_RERUN_SCENES = 64
# The example runs 300 steps; its checks hold from step ~55 on (a CPU run
# of the port), so 80.
ARM_STEPS = 80
ARM_CAPTURE = 40                # phases 7 and 8 take the arms after these steps
ARM_RERUN_SCENES = 256
COUPLED_STEPS = 20
COUPLED_CAPTURE = 10
COUPLING_TOL = 1e-3             # relative
IK_ITERS = 100
IK_TARGET_TOL = 2e-3            # tests/test_multibody.py:252's
IK_CPU_TOL = 1e-4
IK_CPU_SCENES = 1024            # the CPU repeats the first 1024
RERUN_STEPS_13 = 1              # 2 until phase 16 joined the script
# Phase 14: the bench scene as one mutating PhysicsWorld, and the loaders.
WORLD_SETTLE = 60
WORLD_PLAIN_TIMED = 30          # the last 30 settle steps, timed
WORLD_CYCLES = 6                # a mutation cycle every WORLD_CYCLE steps
WORLD_CYCLE = 10
WORLD_REPRO = 20                # steps after a restore or a load
WORLD_GUARD = 16                # steps timed under the guard, at each interval
WORLD_CPU_STEPS = 2             # card vs CPU single steps after a mutation
LOADER_STEPS = 10               # loader scenes stepped on the card before the check
# Phase 15: hooks, the collision pipeline, queries and the controllers.
# tests/test_example_scenes.py:120 runs 150; both checks hold from step 50
# (the ball from below passes y = 1.0 at ~20, the one from above rests at
# 0.599 from ~50), so 60 for the script's time limit.
OWP_STEPS = 60
OWP_CAPTURE = 20                # phases 7 and 8 take the platforms after these steps
OWP_MOD_SCENES = 256
OWP_MOD_SETTLE = 50             # the ball from above rests on the platform from ~45
OWP_MOD_CPU_STEPS = 2
OWP_FRICTION_SCALE = 0.5
LIDAR_RAYS = 64                 # an 8 x 8 fan a scene
LIDAR_POINTS = 64
LIDAR_CASTS = 16
LIDAR_HEIGHT = 12.0
LIDAR_HALF_ANGLE = 0.6          # rad: every ray meets the 100 m ground
RAY_ON_SURFACE = 1e-4           # a hit point's distance to its collider
CAST_RADIUS = 0.2
CAST_MAX_TOI = 12.0
QUERY_TOL = 1e-5                # relative, card vs CPU
QUERY_CPU_SCENES = 2
QUERY_WARM = 64                 # scenes of the untimed warm-up call
VEHICLE_STEPS = 150             # tests/test_controllers.py's curve
VEHICLE_CAPTURE = 75            # phases 7 and 8 take the vehicles after these steps
# tests/test_controllers.py's push steps 30 after it; the pushed box moves
# 0.3 m a step, so 10 for the script's time limit.
CHAR_STEPS = 10
RERUN_SCENES_15 = 64
# Phase 16: the f64 axis, scene sharding and debug render.  (a) upstream's
# far pyramid at f64, one scene, FAR_STEPS steps with its rest-height check
# (the reference test's 300, cut for the script's time limit: 3.2-4.3
# steps/s, launch-bound; the pile has landed by ~60 steps, and on the CPU its
# largest error is 0.0244 at 60 and 0.0171 at 300,
# tests/test_torch_precision_scenes.py);
# 4096 bench scenes at f64 and at float32 on the same kernel route,
# F64_SETTLE + F64_TIMED steps each.
FAR_STEPS = 60
FAR_TOL = 0.15
F64_SETTLE = 10
F64_TIMED = 10
# (b) 4096 bench scenes sharded: SHARD_STEPS steps, the last SHARD_TIMED timed.
SHARD_STEPS = 30
SHARD_TIMED = 10
RENDER_TOL = 1e-5               # card vs CPU render coordinates
# Phase 7's f64 bench scenes: settled on the card, then F64_CPU_STEPS free
# steps on the card and the CPU, held to F64_WITNESS_FACTOR times the gap of
# two CPU runs whose starts differ by 1 ulp in every body's height, or
# F64_ULPS float64 ulps of the field's largest magnitude.
F64_CPU_SCENES = 2
F64_CPU_SETTLE = 45
F64_CPU_STEPS = 5
F64_WITNESS_FACTOR = 16.0
F64_ULPS = 64
# Phases 2(b) and 3(b): scenes of the capture held to the plain version at
# f64 on the CPU.
F64_CHECK_SCENES = 64
F64_RERUN_SCENES = 64           # phase 8's bitwise rerun


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


def run(state, params, n_steps: int, hooks=None, control=None, each=None):
    """`n_steps` steps from `state` (with the step's `hooks`, and
    `control(state) -> state` before each step, a controller's update;
    `each(state, steps done)` after each step): (the last state, each
    overflow count's largest value over the steps).
    The counts are kept on the device and read once at the end, so the host
    never waits for a step to finish."""
    import torch
    from rapier_tpu_torch.pipeline.physics_pipeline import step

    keys = ("broadphase_overflow", "solver_overflow", "unsupported_pairs", "ccd_overflow")
    worst = None
    for i in range(n_steps):
        if control is not None:
            state = control(state)
        state, ev = step(state, params, hooks)
        if each is not None:
            each(state, i + 1)
        now = torch.stack([getattr(ev, k).max().to(torch.int64) for k in keys])
        worst = now if worst is None else torch.maximum(worst, now)
    counts = [0] * len(keys) if worst is None else worst.tolist()
    return state, dict(zip(keys, counts))


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
    operations this call's valid lanes need at the fp32 (float64 inputs:
    fp64) rate, whichever is larger.  Returns (ms, "bytes" or
    "operations")."""
    import torch

    n_bytes = sum(t.numel() * t.element_size() for t in list(packed) + list(out))
    sweeps = inp["pgs_iters"] + inp["stab_iters"]
    per_lane = FLOPS_GENERATE + inp["n_sub"] * (FLOPS_UPDATE_WARMSTART + sweeps * FLOPS_SOLVE)
    flops = int(inp["valid"].sum()) * per_lane
    rate = FP64_FLOPS if packed[0].dtype == torch.float64 else FP32_FLOPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _resources(name, folded, inp, sb, card):
    """The kernel's registers, spills, shared memory, resident blocks an SM
    and on-chip lane capacity at this input's shape, from the CUDA runtime."""
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    import torch

    res = cs.KERNEL.info(folded, inp["b1"].shape[-1], sb.v_lin.shape[-1],
                         inp["max_colors"], sb.v_lin.dtype == torch.float64)
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
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    lanes, fits = cs.KERNEL.storage(folded, packed[1], packed[2].shape[-1],
                                    kw["max_colors"], packed[0].dtype == torch.float64)
    lanes, on_chip = lanes.cpu().float(), int(fits.sum())
    out = dict(scenes_on_chip=on_chip, scenes_in_global_scratch=lanes.shape[0] - on_chip,
               valid_lanes_mean=float(lanes.mean()), valid_lanes_max=int(lanes.max()))
    print(f"{what}: valid lanes per scene min {int(lanes.min())}, mean "
          f"{out['valid_lanes_mean']:.2f}, max {out['valid_lanes_max']}; scenes on chip "
          f"{on_chip}, in the global scratch {out['scenes_in_global_scratch']}")
    if must_fit and out["scenes_in_global_scratch"]:
        _fail(f"{what}: {out['scenes_in_global_scratch']} scenes did not fit on chip")
    return out


def _next_step_storage(what, state, params, folded: bool, must_fit: bool = True):
    """`_storage` for the solve of the step after `state` (its inputs
    captured from one more step, which the launch counts do not see)."""
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    launches = cs.KERNEL.launches, cs.KERNEL.launches_folded
    inp = capture_solve_inputs(state, params)
    cs.KERNEL.launches, cs.KERNEL.launches_folded = launches
    packed, kw = _packed(inp.pop("sb"), inp)
    return _storage(what, folded, packed, kw, must_fit)


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
    """Print the kernel's time beside its recorded earlier time (where there
    is one), its bound and its occupancy; return the kernels line's keys
    beyond the contract's."""
    earlier = (f" (recorded before the redesign: {RECORDED_EARLIER_MS[name]} ms)"
               if name in RECORDED_EARLIER_MS else "")
    print(f"{name} at {N_SCENES} scenes: {ms:.3f} ms{earlier}, bound {bound[0]:.3g} ms "
          f"({bound[1]}), "
          f"{bound[0] / ms:.1%} of the bound; {res['blocks_per_sm']} blocks an SM of "
          f"{res['registers']} registers a thread and {res['smem_bytes']} bytes of "
          f"shared memory ({card})")
    return dict(bound_share=bound[0] / ms, **res)


def phase_kernel(device, card):
    """Phase 2: contact_sweep_kernel against the plain version (bench).
    Returns the kernel's record and the settled N_CHECK-scene bench batch
    (with its params), which phase 2(b) reuses."""
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
                one_scene_ms=times[0][0], **storage), (state, params)


def phase_folded_kernel(device, card):
    """Phase 3: contact_sweep_folded_kernel against the plain version and
    the block kernel (quadruped, K = 128).  Returns the kernel's record and
    the captured N_CHECK-scene quadruped batch after ROBOT_CHECK_STEPS steps
    (with its params), which phases 7 and 8 reuse."""
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
                                              bound, res, card), **storage), (state, params)


def _compare_f64(name, sb, inp, sb_k, imp_k):
    """Hold a float64 kernel's output on the first F64_CHECK_SCENES scenes to
    the plain version at float64 on the CPU (whose scatter-adds keep lane
    order) by the f64 parity rule: each body row and the impulse block
    within F64_WITNESS_FACTOR times the gap of a plain run whose nonzero
    velocities start 1 ulp higher, or F64_ULPS float64 ulps of the plain
    value's largest magnitude (of 1 for a part that is all zeros), the
    larger.  Returns each part's gap and witness gap in those ulps."""
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    n = F64_CHECK_SCENES
    cut = {k: ((v[:n] if v.dim() else v).cpu() if torch.is_tensor(v) else v)
           for k, v in inp.items()}
    sb = type(sb)(*(x[:n].cpu() for x in sb))
    up = torch.tensor(float("inf"), dtype=torch.float64)
    nudged = sb._replace(**{f: torch.where(getattr(sb, f) != 0,
                                           torch.nextafter(getattr(sb, f), up), getattr(sb, f))
                            for f in ("v_lin", "v_ang")})
    sb_p, imp_p = cs.solve_plain(sb, **cut)
    sb_w, imp_w = cs.solve_plain(nudged, **cut)
    parts = [(f, getattr(sb_k, f)[:n].cpu(), getattr(sb_p, f), getattr(sb_w, f))
             for f in ("v_lin", "v_ang", "com", "rot")]
    parts.append(("impulses", imp_k[:n].cpu(), imp_p, imp_w))
    out, bad = {}, []
    for part, got, want, wit in parts:
        ulp = torch.finfo(torch.float64).eps * (float(want.abs().max()) or 1.0)
        gap, wgap = float((got - want).abs().max()), float((wit - want).abs().max())
        tol = max(F64_WITNESS_FACTOR * wgap, F64_ULPS * ulp)
        out[part] = dict(ulps=gap / ulp, witness_ulps=wgap / ulp, tol_ulps=tol / ulp)
        if not gap <= tol:
            bad.append(part)
    print(f"{name} vs plain at f64 on {sb.v_lin.shape[0]} scenes (K={inp['b1'].shape[-1]}, "
          f"{int(cut['valid'].sum())} solver lanes), in float64 ulps of each part's largest "
          f"value (gap / 1-ulp witness's gap / tolerance): "
          + ", ".join(f"{p} {v['ulps']:.1f} / {v['witness_ulps']:.1f} / {v['tol_ulps']:.1f}"
                      for p, v in out.items()))
    if bad:
        _fail(f"{name} disagrees with the plain version at f64: {bad}")
    return out


def _as_f64(sb, inp):
    """Solve inputs with every float tensor and body table at float64."""
    import torch

    return (type(sb)(*(x.double() for x in sb)),
            {k: (v.double() if torch.is_tensor(v) and v.is_floating_point() else v)
             for k, v in inp.items()})


def _timed_f64(name, folded, sb, inp, card):
    """The float64 build of the folded (or the block) kernel timed at
    N_SCENES scenes (the capture tiled): the wrapper, the launch alone, the
    other kernel's launch on the same packed inputs and the plain version;
    its bound at the FP64 rate and the storage of every scene, all on
    chip."""
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.dynamics.solver.contact_constraints import SolverBodies

    reps = N_SCENES // sb.v_lin.shape[0]
    sb_t = SolverBodies(*[_scenes(x, reps) for x in sb])
    inp_t = {k: _scenes(v, reps) for k, v in inp.items()}
    packed, kw = _packed(sb_t, inp_t)
    mine, other = ((cs.KERNEL.launch_folded, cs.KERNEL.launch) if folded
                   else (cs.KERNEL.launch, cs.KERNEL.launch_folded))
    ms = _time_ms(lambda: cs.solve_from_manifolds(sb_t, **inp_t), 20)
    launch_ms = _time_ms(lambda: mine(*packed, **kw), 20)
    other_ms = _time_ms(lambda: other(*packed, **kw), 5)
    plain_ms = _time_ms(lambda: cs.solve_plain(sb_t, **inp_t), 3)
    bound = _bound(packed, mine(*packed, **kw), inp_t)
    storage = _storage(f"{name} at {N_SCENES} scenes", folded, packed, kw, True)
    print(f"contact solve at f64, {N_SCENES} scenes x K={inp['b1'].shape[-1]}: {name} wrapper "
          f"{ms:.3f} ms, launch alone {launch_ms:.3f} ms, the other kernel {other_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound[0]:.3g} ms ({bound[1]}), "
          f"{bound[0] / launch_ms:.1%} of the bound ({card})")
    return dict(ms=launch_ms, wrapper_ms=ms, other_kernel_ms=other_ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], **storage), bound


def phase_kernel_f64(device, card, bench):
    """Phase 2(b): contact_sweep_kernel's float64 build on the bench at f64
    (phase 2's settled batch with every float leaf cast to float64, K =
    256): the solve inputs of one f64 step through the wrapper (one block
    launch) against the plain version at f64 (`_compare_f64`), the folded
    build on the same packed inputs bit for bit, its resources, and its time
    at N_SCENES scenes against its bound at the FP64 rate (`_timed_f64`)."""
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.types import tree_map

    state = tree_map(lambda x: x.double() if x.is_floating_point() else x, bench[0])
    inp = capture_solve_inputs(state, bench[1])
    sb = inp.pop("sb")
    k_lanes = inp["b1"].shape[-1]
    if k_lanes != 256 or sb.v_lin.dtype != torch.float64:
        _fail(f"expected K = 256 float64 solver lanes, got {k_lanes} of {sb.v_lin.dtype}")

    counts = cs.KERNEL.launches, cs.KERNEL.launches_folded
    sb_k, imp_k = cs.solve_from_manifolds(sb, **inp)
    if (cs.KERNEL.launches, cs.KERNEL.launches_folded) != (counts[0] + 1, counts[1]):
        _fail("the f64 bench shape did not launch contact_sweep_kernel once")
    if imp_k.dtype != torch.float64:
        _fail(f"the f64 launch returned {imp_k.dtype}")
    ulps = _compare_f64("contact_sweep_kernel (float64)", sb, inp, sb_k, imp_k)
    res = _resources("contact_sweep_kernel (float64)", False, inp, sb, card)
    packed, kw = _packed(sb, inp)
    _bitwise("bench capture at f64 (K=256)", cs.KERNEL.launch(*packed, **kw),
             cs.KERNEL.launch_folded(*packed, **kw))
    rec, bound = _timed_f64("contact_sweep_kernel (float64)", False, sb, inp, card)
    cs.KERNEL.launches, cs.KERNEL.launches_folded = counts
    return dict(ulps_vs_plain=ulps, **rec,
                **_summary("contact_sweep_kernel_f64", rec["ms"], bound, res, card))


def phase_folded_kernel_f64(device, card, quadrupeds):
    """Phase 3(b): contact_sweep_folded_kernel's float64 build on phase 3's
    quadruped batch (K = 128): one step's solve inputs, cast to float64,
    through the wrapper (one folded launch) against the plain version at
    f64, the block build bit for bit, its resources and its time at
    N_SCENES scenes against its bound at the FP64 rate."""
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    inp = capture_solve_inputs(*quadrupeds)
    sb, inp = _as_f64(inp.pop("sb"), inp)
    k_lanes = inp["b1"].shape[-1]
    if k_lanes > cs.FOLD_MAX_LANES:
        _fail(f"expected at most {cs.FOLD_MAX_LANES} solver lanes, got {k_lanes}")

    counts = cs.KERNEL.launches, cs.KERNEL.launches_folded
    sb_k, imp_k = cs.solve_from_manifolds(sb, **inp)
    if (cs.KERNEL.launches, cs.KERNEL.launches_folded) != (counts[0], counts[1] + 1):
        _fail("the f64 quadruped shape did not launch contact_sweep_folded_kernel once")
    ulps = _compare_f64("contact_sweep_folded_kernel (float64)", sb, inp, sb_k, imp_k)
    res = _resources("contact_sweep_folded_kernel (float64)", True, inp, sb, card)
    packed, kw = _packed(sb, inp)
    _bitwise(f"quadruped capture at f64 (K={k_lanes})", cs.KERNEL.launch(*packed, **kw),
             cs.KERNEL.launch_folded(*packed, **kw))
    rec, bound = _timed_f64("contact_sweep_folded_kernel (float64)", True, sb, inp, card)
    cs.KERNEL.launches, cs.KERNEL.launches_folded = counts
    return dict(ulps_vs_plain=ulps, **rec,
                **_summary("contact_sweep_folded_kernel_f64", rec["ms"], bound, res, card))


def phase_main_path(device, card):
    """Phase 4: 4096 bench scenes through the port's step.  Returns the
    kernel's launches, the rate, the stages and the batch after the timed
    run (with its params), which phases 7 and 8 reuse."""
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
    stages = _stages(f"bench step, {N_SCENES} scenes", state, params, card,
                     trace_steps=TRACE_STEPS_BENCH)
    return launches, rate, stages, (state, params)


def _stages(what, state, params, card, trace_steps: int = 3):
    """Print and return the per-stage breakdown of one step from `state`
    and its profiler trace (kernels a step, device-busy share), each over
    `trace_steps` steps (the trace after the stage timers' warm-up step)."""
    from rapier_tpu_torch.utils import counters

    t0 = time.time()
    t = counters.profile_step(state, params, iters=trace_steps).as_dict()
    tr = counters.trace_step(state, params, steps=trace_steps, warm=False)
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


def pyramid_batch(device, stack: int, colors=None):
    """bench.py's pyramid configuration (BENCH_MODE=pyramid, bench.py:63-91):
    `pyramid3_world(stack)` on the grid broad phase with max_solver_pairs = 8
    touching pairs a box, rounded up to 128, as one scene on `device`
    (`colors` colors, else SimParams' default).  Returns (state, params,
    boxes)."""
    from rapier_tpu_torch.scenes import pyramid3_world, replicate_scene
    from rapier_tpu_torch.types import BroadPhaseKind, from_numpy

    world = pyramid3_world(stack_height=stack, device=device)
    boxes = sum((stack - i) ** 2 for i in range(stack))
    world.params = world.params.replace(broad_phase=int(BroadPhaseKind.GRID),
                                        max_solver_pairs=-((-8 * boxes) // 128) * 128)
    if colors:
        world.params = world.params.replace(max_colors=int(colors))
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
        at_rest = abs(top - rest) <= PYRAMID_TOP_TOL and abs(top_vy) < PYRAMID_REST_VY
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
            _fail(f"pyramid stack {stack}: the top box is at {top} moving at {top_vy} m/s, "
                  f"not at rest ({rest})")
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


def _cpu_agreement(what, state, params, settle, hooks=None, control=None):
    """`settle` steps on the card, then CPU_FREE_STEPS steps on the card and on the CPU
    from the same state (with the step's `hooks` and the `control` before
    each step, see `run`), bodies (and joint impulses) compared."""
    from rapier_tpu_torch.types import tree_map

    t0 = time.time()
    state, _ = run(state, params, settle, hooks, control)          # bodies in contact
    cpu = tree_map(lambda x: x.cpu(), state)
    gpu, _ = run(state, params, CPU_FREE_STEPS, hooks, control)
    cpu, _ = run(cpu, params, CPU_FREE_STEPS, hooks, control)
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
    print(f"GPU vs CPU path, {state.bodies.pos.shape[0]} {what} scene(s) x {CPU_FREE_STEPS} "
          f"steps: max |d pos| {dp:.3e} "
          f"(tol {CPU_TOL['pos']}), max |d linvel| {dv:.3e} (tol {CPU_TOL['vel']}){joints} "
          f"[{time.time() - t0:.1f} s]")
    if not ok:
        _fail(f"GPU path disagrees with the CPU path ({what})")


def _nudge_up(state, body=None):
    """`state` with `body`'s height (every body's, for None) 1 ulp higher."""
    import torch

    for name in ("pos", "next_pos"):
        y = getattr(state.bodies, name)[..., 1]
        sel = (slice(None), slice(None)) if body is None else (0, body)
        y[sel] = torch.nextafter(y[sel], torch.tensor(float("inf")))
    return state


def _cpu_step_agreement(what, state, params, steps: int = 10, witness: str = "free",
                        hooks=None):
    """The card against the CPU one step at a time along the card's
    trajectory: each CPU step starts from the card's state, and the step's
    bodies and contact cache (pair keys, touching flags, and the impulses
    the next step warmstarts from) must agree.  With witness="free" it
    prints beside it the gap between the card and the CPU run freely over
    the same steps, and a witness of how far the pile itself amplifies
    rounding, the gap between two free CPU runs whose start differs by 1 ulp
    in the height of the body moving fastest vertically (1 ulp at these
    heights is the card's one-step gap in position; a velocity's ulp would
    be absorbed at rest).  With witness="step" each CPU step is taken twice,
    the second from the card's state with every body 1 ulp higher: within
    one step a tall pile amplifies rounding past CPU_TOL, so the bodies' and
    impulses' gaps may reach WITNESS_FACTOR times this witness's."""
    import torch
    from rapier_tpu_torch.pipeline.physics_pipeline import step
    from rapier_tpu_torch.types import tree_map

    def gap(a, b, part, name):
        return float((getattr(getattr(a, part), name).cpu()
                      - getattr(getattr(b, part), name)).abs().max())

    imp = ("impulse", "tangent_impulse", "warmstart_impulse",
           "warmstart_tangent_impulse", "warmstart_twist_impulse")
    t0 = time.time()
    gpu, dp, dv, di, scale, flips = state, 0.0, 0.0, 0.0, 1.0, 0
    wit = dict(pos=0.0, vel=0.0, imp=0.0)
    free = tree_map(lambda x: x.cpu(), state)
    i = int(free.bodies.linvel[0, :, 1].abs().argmax())
    nudged = _nudge_up(tree_map(lambda x: x.clone(), free), i)
    for _ in range(steps):
        nxt, _ = step(gpu, params, hooks)
        cpu, _ = step(tree_map(lambda x: x.cpu(), gpu), params, hooks)
        if witness == "free":
            free, _ = step(free, params, hooks)
            nudged, _ = step(nudged, params, hooks)
        elif witness == "step":
            one, _ = step(_nudge_up(tree_map(lambda x: x.cpu().clone(), gpu)), params, hooks)
            wit = dict(pos=max(wit["pos"], gap(one, cpu, "bodies", "pos")),
                       vel=max(wit["vel"], gap(one, cpu, "bodies", "linvel"),
                               gap(one, cpu, "bodies", "angvel")),
                       imp=max([wit["imp"]] + [gap(one, cpu, "contacts", f) for f in imp]))
        dp = max(dp, gap(nxt, cpu, "bodies", "pos"))
        dv = max(dv, gap(nxt, cpu, "bodies", "linvel"), gap(nxt, cpu, "bodies", "angvel"))
        di = max([di] + [gap(nxt, cpu, "contacts", f) for f in imp])
        scale = max([scale] + [float(getattr(cpu.contacts, f).abs().max()) for f in imp])
        flips = max(flips, *(int((getattr(nxt.contacts, f).cpu()
                                  != getattr(cpu.contacts, f)).sum())
                             for f in ("pair_key", "touching")))
        gpu = nxt
    free_runs = ""
    if witness == "free":
        fp, fv = gap(gpu, free, "bodies", "pos"), gap(gpu, free, "bodies", "linvel")
        wp, wv = gap(nudged, free, "bodies", "pos"), gap(nudged, free, "bodies", "linvel")
        free_runs = (f"; run freely from the same start, the card and the CPU part by "
                     f"{fp:.3e} in position and {fv:.3e} in velocity after {steps} steps, "
                     f"and two CPU runs whose start differs by 1 ulp in body {i}'s height by "
                     f"{wp:.3e} and {wv:.3e}")
    if witness == "step":
        free_runs = (f"; tolerances the larger of CPU_TOL and {WITNESS_FACTOR} x the gap "
                     f"of two CPU steps whose starts differ by 1 ulp in every body's height "
                     f"({wit['pos']:.3e}, {wit['vel']:.3e}, {wit['imp']:.3e})")
    tol_p = max(CPU_TOL["pos"], WITNESS_FACTOR * wit["pos"])
    tol_v = max(CPU_TOL["vel"], WITNESS_FACTOR * wit["vel"])
    tol_i = max(CPU_TOL["imp"] * scale, WITNESS_FACTOR * wit["imp"])
    print(f"GPU vs CPU step, {what}, {steps} steps each from the card's state: max |d pos| "
          f"{dp:.3e} (tol {tol_p:.3e}), max |d vel| {dv:.3e} (tol {tol_v:.3e}), "
          f"max |d impulse| {di:.3e} (tol {tol_i:.3e}; {CPU_TOL['imp']} x {scale:.3f}, the "
          f"largest impulse), pair keys and touching flags differing in {flips} "
          f"lanes{free_runs} [{time.time() - t0:.1f} s]")
    if not (dp <= tol_p and dv <= tol_v and di <= tol_i and flips == 0):
        _fail(f"GPU step disagrees with the CPU step ({what})")


def _first(batch, n: int):
    """The first `n` scenes of a (state, params) capture, copied."""
    from rapier_tpu_torch.types import tree_map

    state, params = batch
    return tree_map(lambda x: x[:n].clone(), state), params


def phase_cpu_agreement(device, captures):
    """Phase 7: the card's path against the CPU (plain) path.  `captures`
    holds batches (with their params) that earlier phases ran on the card:
    "bench" after phase 4's timed run, "quadruped" phase 3's capture after
    ROBOT_CHECK_STEPS steps, "pyramid" the stack-16 pyramid after
    PYRAMID_CPU_SETTLE steps ("landing") and after phase 6's timed run
    ("settled"), "s2d_big" the 2D pyramid after phase 10's timed run,
    "heightfield3" and "primitives3" phases 11's and 12's captures after
    HF_CHECK_STEPS and P3_CHECK_STEPS steps, "joints3" N_CHECK scenes of
    phase 9's batch after its timed run (all in contact)."""
    from rapier_tpu_torch.scenes import (
        s2d_coulomb_stack_world,
        s2d_high_mass_ratio_world,
        s2d_pyramid_world,
        trimesh3_world,
    )

    pyramid = captures["pyramid"]
    _cpu_agreement(f"bench (after {SETTLE + TIMED} steps)", *_first(captures["bench"], 2), 0)
    _cpu_agreement(f"quadruped (after {ROBOT_CHECK_STEPS} steps)",
                   *_first(captures["quadruped"], 2), 0)
    _cpu_agreement(f"joints3 (after {JOINT_SETTLE['joints3'] + JOINT_TIMED} steps)",
                   *_first(captures["joints3"], 2), 0)
    _cpu_agreement("impulse-joint quadruped", *impulse_quadruped_batch(device, 2, seed=3),
                   ROBOT_CHECK_STEPS)
    for name, steps in (("landing", PYRAMID_CPU_SETTLE),
                        ("settled", PYRAMID_SETTLE + PYRAMID_TIMED)):
        _cpu_step_agreement(f"the stack-16 pyramid after {steps} steps", *pyramid[name],
                            steps=PYRAMID_CPU_STEPS)
    # The 2D piles, as the stack-16 pyramid: a free run amplifies rounding
    # (2 scenes of the 10-row pyramid part by ~9e-04 in position after 10
    # free steps on an H100, PERF.md), so single steps from the card's state.
    _cpu_agreement("high-mass-ratio", *s2d_batch(device, s2d_high_mass_ratio_world, 2)[:2],
                   S2D_CPU_SETTLE)
    for name, make, witness in (("10-row 2D pyramid", s2d_pyramid_world, "free"),
                                ("Coulomb stack", s2d_coulomb_stack_world, None)):
        state, params, _ = s2d_batch(device, make, 2)
        state, _ = run(state, params, S2D_CPU_SETTLE)
        _cpu_step_agreement(f"2 scenes of the {name} after {S2D_CPU_SETTLE} steps", state,
                            params, steps=S2D_CPU_STEPS, witness=witness)
    _cpu_step_agreement(f"the base-{S2D_BIG_BASE} 2D pyramid after "
                        f"{S2D_BIG_SETTLE + S2D_BIG_TIMED} steps", *captures["s2d_big"],
                        steps=1, witness="step")
    # The meshes: heightfield3 in contact, single steps from the card's
    # state; trimesh3's ball on the valley floor.
    _cpu_step_agreement(f"2 heightfield3 scenes after {HF_CHECK_STEPS} steps",
                        *_first(captures["heightfield3"], 2), steps=HF_CPU_STEPS, witness=None)
    state, params, _ = mesh_batch(device, trimesh3_world, 2)
    state, _ = run(state, params, TRIMESH_SETTLE)
    _cpu_step_agreement(f"2 trimesh3 scenes after {TRIMESH_SETTLE} steps", state, params,
                        steps=10, witness=None)
    # The convex shapes: 2 scenes of phase 12's primitives3 batch in
    # contact and 2 convex zoo scenes, single steps from the card's state.
    _cpu_step_agreement(f"2 primitives3 scenes after {P3_CHECK_STEPS} steps",
                        *_first(captures["primitives3"], 2), steps=P3_CPU_STEPS,
                        witness=None)
    state, params, _ = zoo_batch(device, 2)
    state, _ = run(state, params, ZOO_SETTLE)
    _cpu_step_agreement(f"2 convex zoo scenes after {ZOO_SETTLE} steps", state, params,
                        steps=P3_CPU_STEPS, witness=None)
    if "owp" in captures:
        _cpu_agreement_15(captures)
    if "bench_f64" in captures:
        _f64_cpu_agreement(*captures["bench_f64"])
    if "ccd3" in captures:
        # Phase 13's: ccd3 from the step that first clamps a ball, single
        # steps from the card's state; the arms free for CPU_FREE_STEPS steps.
        t0 = time.time()
        _cpu_step_agreement(f"2 ccd3 scenes from step {captures['ccd3_step']} (the first "
                            f"ball's first clamp)", *_first(captures["ccd3"], 2),
                            steps=CCD3_CPU_STEPS, witness=None)
        _cpu_agreement(f"multibody arm (after {ARM_CAPTURE} steps)", *_first(captures["arm"], 2),
                       0)
        _cpu_agreement(f"coupled arm (after {COUPLED_CAPTURE} steps)", *captures["coupled_arm"],
                       0)
        print(f"[phase 7, phase 13's scenes: {time.time() - t0:.1f} s]")


def _rerun_equal(what, state, params, parts, steps: int = RERUN_STEPS, hooks=None,
                 control=None):
    import torch
    from rapier_tpu_torch.types import tree_map

    t0 = time.time()
    a, _ = run(tree_map(lambda x: x.clone(), state), params, steps, hooks, control)
    b, _ = run(tree_map(lambda x: x.clone(), state), params, steps, hooks, control)
    for part in parts:
        pa, pb = getattr(a, part), getattr(b, part)
        for f in dataclasses.fields(pa):
            if not torch.equal(getattr(pa, f.name), getattr(pb, f.name)):
                _fail(f"{what} rerun differs in {part}.{f.name}")
    print(f"determinism: two {steps}-step reruns of the {what} batch are bitwise equal "
          f"[{time.time() - t0:.1f} s]")


def _cpu_agreement_15(captures):
    """Phase 7's part for phase 15's captures: the hooked platforms and the
    vehicles, 2 scenes free for CPU_FREE_STEPS steps on the card and the CPU."""
    t0 = time.time()
    state, params, hooks = captures["owp"]
    _cpu_agreement(f"one_way_platforms3 with the one-way hook (after {OWP_CAPTURE} steps)",
                   *_first((state, params), 2), 0, hooks=hooks)
    state, params, control = captures["vehicles"]
    _cpu_agreement(f"vehicles (after {VEHICLE_CAPTURE} steps)", *_first((state, params), 2), 0,
                   control=control)
    print(f"[phase 7, phase 15's scenes: {time.time() - t0:.1f} s]")


def _rerun_15(captures):
    """Phase 8's part for phase 15's captures: bitwise reruns."""
    t0 = time.time()
    state, params, hooks = captures["owp"]
    _rerun_equal(f"{RERUN_SCENES_15}-scene one_way_platforms3", state, params,
                 ("bodies", "contacts"), hooks=hooks)
    state, params, control = captures["vehicles"]
    _rerun_equal(f"{RERUN_SCENES_15}-scene vehicle", state, params, ("bodies", "contacts"),
                 control=control)
    print(f"[phase 8, phase 15's scenes: {time.time() - t0:.1f} s]")


def phase_cpu_agreement_15(device, captures):
    """With --queries-only: phases 7's and 8's parts for phase 15."""
    _cpu_agreement_15(captures)
    _rerun_15(captures)


def phase_determinism(device, captures):
    """Phase 8: bitwise reruns, from phase 7's `captures` where an earlier
    phase left a batch in contact."""
    from rapier_tpu_torch.scenes import s2d_coulomb_stack_world, s2d_pyramid_world

    _rerun_equal("bench", *_first(captures["bench"], 64), ("bodies", "contacts"))
    _rerun_equal("quadruped", *captures["quadruped"], ("bodies", "contacts", "multibodies"))
    _rerun_equal("stack-16 pyramid", *captures["pyramid"]["landing"], ("bodies", "contacts"),
                 PYRAMID_CPU_STEPS)
    _rerun_equal("joints3", *captures["joints3"], ("bodies", "contacts", "joints"))
    for name, make in (("2D pyramid", s2d_pyramid_world),
                       ("Coulomb stack", s2d_coulomb_stack_world)):
        state, params, _ = s2d_batch(device, make, N_CHECK)
        state, _ = run(state, params, S2D_CPU_SETTLE)
        _rerun_equal(name, state, params, ("bodies", "contacts"), S2D_RERUN)
    _rerun_equal("heightfield3", *captures["heightfield3"], ("bodies", "contacts"))
    _rerun_equal("primitives3", *captures["primitives3"], ("bodies", "contacts"))
    if "owp" in captures:
        _rerun_15(captures)
    if "bench_f64" in captures:
        _rerun_equal(f"{F64_RERUN_SCENES}-scene f64 bench",
                     *_first(captures["bench_f64"], F64_RERUN_SCENES), ("bodies", "contacts"))
    if "ccd3" in captures:
        t0 = time.time()
        _rerun_equal("ccd3", *captures["ccd3"], ("bodies", "contacts"), RERUN_STEPS_13)
        _rerun_equal("multibody arm", *captures["arm"], ("bodies", "contacts", "multibodies"),
                     RERUN_STEPS_13)
        print(f"[phase 8, phase 13's scenes: {time.time() - t0:.1f} s]")


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
    through the port's step, on the masked sweep.  Returns the rows for the
    JSON record and the joints3 batch after its timed run (with its
    params), which phases 7 and 8 reuse."""
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
        settle = JOINT_SETTLE[name]
        t0 = time.time()
        state, worst = run(state, params, settle)
        torch.cuda.synchronize()
        settle_s = time.time() - t0
        # The example's checks, and the trunk height, after the settle.
        _finite(state)
        b = state.bodies
        if name == "joints3":
            handles = joints3[2]
            tip_y = b.pos[:, handles["chain"][-1], 1]
            slider_y = b.pos[:, handles["slider"], 1]
            print(f"joints3 after {settle} steps: chain tip y {float(tip_y[0]):.4f} "
                  f"(below 8), slider y {float(slider_y[0]):.4f} (within 0.3 of 7.5), rope "
                  f"tip {b.pos[0, handles['rope'][-1]].tolist()} in scene 0; the checks "
                  f"hold in all {N_SCENES} scenes")
            if not (bool((tip_y < 8.0).all()) and bool(((slider_y - 7.5).abs() < 0.3).all())):
                _fail("joints3: the example's checks fail")
            row = dict(chain_tip_y=float(tip_y[0]), slider_y=float(slider_y[0]))
        else:
            z = float(b.pos[0, TRUNK, 2])
            print(f"impulse-joint quadruped: trunk height {z:.5f} after {settle} "
                  f"steps (the reference's after 240: {IMPULSE_TRUNK_Z_REF}, R5)")
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
              f"{elapsed:.3f} s after {settle} in {settle_s:.1f} s; {card}); "
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
              f"{settle + JOINT_TIMED} steps")
        rows[name] = dict(env_steps_per_s=rate, **row, **worst,
                          **_stages(f"{name} step, {N_SCENES} scenes", state, params, card,
                                    trace_steps=TRACE_STEPS_LONG))
        if name == "joints3":
            capture = _first((state, params), N_CHECK)
    return rows, capture


def s2d_batch(device, make, n_scenes: int, **kw):
    """A scene of `rapier_tpu_torch.scenes` (`make`; the 2D ones build a
    PhysicsWorld2D) replicated to `n_scenes` on `device`: (state, params,
    handles)."""
    from rapier_tpu_torch.scenes import replicate_scene
    from rapier_tpu_torch.types import from_numpy

    world, handles = make(device=device, **kw)
    return replicate_scene(from_numpy(world.build(), device), n_scenes), world.params, handles


def _in_plane(what, state):
    """Fail unless z, its velocity and the x / y spins are exactly 0 (the
    plane lock)."""
    b = state.bodies
    if bool(b.pos[..., 2].any() | b.linvel[..., 2].any() | b.angvel[..., :2].any()):
        _fail(f"{what}: a body left the plane")


def _pile_step_facts(state, params):
    """On the step after `state` (which the launch counts do not see): the
    block_2x2 flag of every contact pass."""
    from rapier_tpu_torch.dynamics.solver import contact_constraints as cc
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.pipeline import physics_pipeline as pp

    flags = []
    solve_color = cc.solve_color

    def record_pass(*a, **kw):
        flags.append(bool(kw.get("block_2x2", False)))
        return solve_color(*a, **kw)

    launches = cs.KERNEL.launches, cs.KERNEL.launches_folded
    cc.solve_color = record_pass
    try:
        pp.step(state, params)
    finally:
        cc.solve_color = solve_color
        cs.KERNEL.launches, cs.KERNEL.launches_folded = launches
    return flags


def _run_pile(state, params, n_steps: int, boxes, t_start: int, readings: list,
              default_colors: int):
    """`run` for the 2D pile, recording every S2D_READ_EVERY steps the top
    box's height and vertical velocity, the largest box speed, and the
    lanes the step's blocked layout left to the Jacobi tail at the scene's
    colors and at `default_colors` (a coloring of the same lanes)."""
    import torch
    from rapier_tpu_torch.dynamics.solver.coloring import solve_caps
    from rapier_tpu_torch.pipeline import physics_pipeline as pp

    coloring, last = pp.color_constraints_blocked, {}

    def record(*a):
        out = coloring(*a)
        last.update(args=a, tail=(out[0] == len(a[-1]) - 1).sum())
        return out

    def tail_at(colors):
        a = last["args"]
        caps = solve_caps(params.max_solver_pairs, state.contacts.max_pairs, colors)
        return int((coloring(*a[:-1], caps)[0] == len(caps) - 1).sum())

    worst = {"broadphase_overflow": 0, "solver_overflow": 0}
    pp.color_constraints_blocked = record
    try:
        for i in range(1, n_steps + 1):
            state, ev = pp.step(state, params)
            for k in worst:
                worst[k] = max(worst[k], int(getattr(ev, k).max()))
            if (t_start + i) % S2D_READ_EVERY == 0:
                v = state.bodies.linvel[0, boxes]
                readings.append(dict(
                    step=t_start + i, top_y=float(state.bodies.pos[0, boxes[-1], 1]),
                    top_vy=float(v[-1, 1]), max_speed=float(v.norm(dim=-1).max()),
                    tail=int(last["tail"]), tail_default=tail_at(default_colors),
                    lanes=int(last["args"][4].sum())))
    finally:
        pp.color_constraints_blocked = coloring
    torch.cuda.synchronize()
    return state, worst


def _s2d_big(device, card):
    """Phase 10(a): the full-size s2d_pyramid, one scene, blocked, with
    S2D_BIG_COLORS colors."""
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.pipeline.physics_pipeline import solve_path
    from rapier_tpu_torch.scenes import s2d_pyramid_world
    from rapier_tpu_torch.types import tree_map

    state, params, handles = s2d_batch(device, s2d_pyramid_world, 1, base_count=S2D_BIG_BASE)
    default_colors = params.max_colors
    params = params.replace(max_colors=S2D_BIG_COLORS)
    boxes = torch.tensor(handles["boxes"], device=device)
    y0 = state.bodies.pos[0, boxes, 1].clone()
    path = solve_path(state, params)
    print(f"2D pyramid, base {S2D_BIG_BASE}: {len(handles['boxes'])} boxes, "
          f"P={state.contacts.max_pairs} pair lanes, N+1={state.bodies.pos.shape[1] + 1}, "
          f"max_solver_pairs {params.max_solver_pairs}, max_colors {params.max_colors} (NOT "
          f"SimParams' default {default_colors}: there the Jacobi tail explodes the pile, "
          f"ROADMAP F6), block_solver_2x2 {params.block_solver_2x2}, solve path {path}")
    if path != "blocked" or not params.block_solver_2x2:
        _fail(f"the 2D pyramid takes the {path} path (2x2: {params.block_solver_2x2}), not "
              f"the blocked solve with the 2x2 block solve")
    readings = []
    cs.KERNEL.launches = cs.KERNEL.launches_folded = 0
    t0 = time.time()
    state, worst = _run_pile(state, params, S2D_BIG_SETTLE, boxes, 0, readings,
                             default_colors)
    settle_s = time.time() - t0
    t0 = time.time()
    state, worst_t = _run_pile(state, params, S2D_BIG_TIMED, boxes, S2D_BIG_SETTLE, readings,
                               default_colors)
    elapsed = time.time() - t0
    launches = cs.KERNEL.launches, cs.KERNEL.launches_folded
    for k in worst:
        worst[k] = max(worst[k], worst_t[k])
    rate = S2D_BIG_TIMED / elapsed
    for r in readings:
        print(f"2D pyramid, base {S2D_BIG_BASE}, step {r['step']}: top box y {r['top_y']:.4f} "
              f"({r['top_y'] - S2D_BIG_REST:+.4f} from rest at {S2D_BIG_REST}), vertical "
              f"velocity {r['top_vy']:+.4f} m/s; fastest box {r['max_speed']:.4f} m/s; Jacobi "
              f"tail {r['tail']} of {r['lanes']} lanes (at {default_colors} colors it would "
              f"hold {r['tail_default']})")
    _finite(state)
    _in_plane("the 2D pyramid", state)
    y = state.bodies.pos[0, boxes, 1]
    deviation = float((y - torch.round(y * 2) / 2).abs().max())
    top, top_vy = readings[-1]["top_y"], readings[-1]["top_vy"]
    sink, raised = float((y0 - y).max()), float((y - y0).max())
    sunk = int((y0 - y > 0.25).sum())
    # The pile holds: after its top row lands no box is faster than that
    # row's free fall, none is thrown above its start, the top box stays
    # above 0.9 x 99 (examples/s2d_pyramid.py:33) and within S2D_BIG_TOP_TOL
    # of rest, and its swing shrinks.  At rest: the
    # top box within S2D_REST_TOL of rest and slower than S2D_REST_VY.
    landed = [r for r in readings if r["step"] > S2D_BIG_LANDING]
    peak_vy = max(abs(r["top_vy"]) for r in landed)
    fastest = max(r["max_speed"] for r in landed)
    holds = (fastest < S2D_BIG_FALL and raised < 0.1 and top > (S2D_BIG_BASE - 1) * 0.9
             and abs(top - S2D_BIG_REST) < S2D_BIG_TOP_TOL and abs(top_vy) < peak_vy)
    at_rest = abs(top - S2D_BIG_REST) < S2D_REST_TOL and abs(top_vy) < S2D_REST_VY
    flags = _pile_step_facts(state, params)
    print(f"2D pyramid, base {S2D_BIG_BASE}: {rate:.3f} steps/s ({S2D_BIG_TIMED} steps in "
          f"{elapsed:.3f} s after {S2D_BIG_SETTLE} in {settle_s:.1f} s; {card}); overflow "
          f"{worst}; contact-sweep launches {launches[0]} + folded {launches[1]} (this path has "
          f"none); after {readings[-1]['step']} steps the top box at {top:.4f} "
          f"({top - S2D_BIG_REST:+.4f} from rest), vertical velocity {top_vy:+.4f} m/s: "
          f"{'at rest' if at_rest else 'NOT at rest'} (within {S2D_REST_TOL} of rest and "
          f"slower than {S2D_REST_VY} m/s); the pile {'holds' if holds else 'does NOT hold'} "
          f"(after step {S2D_BIG_LANDING} no box faster than {S2D_BIG_FALL} m/s: fastest "
          f"{fastest:.4f}; no box above its start: highest {raised:+.4f}; the top box above "
          f"{(S2D_BIG_BASE - 1) * 0.9:.1f}, within {S2D_BIG_TOP_TOL} of rest and its swing "
          f"shrinking: {abs(top_vy):.4f} m/s against "
          f"a peak of {peak_vy:.4f}); largest row-height deviation {deviation:.4f}; boxes sunk "
          f"more than 0.25 below their start {sunk}, the deepest by {sink:.4f}; the next "
          f"step's {len(flags)} contact passes {'all' if all(flags) else 'not all'} with the "
          f"2x2 block solve")
    if worst["broadphase_overflow"] or worst["solver_overflow"]:
        _fail(f"the 2D pyramid overflows: {worst}")
    if launches != (0, 0):
        _fail(f"the 2D pyramid launched a contact-sweep kernel: {launches}")
    if not flags or not all(flags):
        _fail("the 2D pyramid's blocked passes run without the 2x2 block solve")
    if not holds:
        _fail(f"the 2D pyramid does not hold: its top box is at {top} ({top_vy:+.4f} m/s), "
              f"the fastest box at {fastest} m/s, a box {raised:+.4f} from its start")
    row = dict(boxes=len(handles["boxes"]), max_colors=S2D_BIG_COLORS, steps_per_s=rate,
               row_height_deviation=deviation, top_y=top, top_vy=top_vy, at_rest=at_rest,
               holds=holds, deepest_sink=sink, boxes_sunk=sunk, readings=readings, **worst,
               **_stages(f"2D pyramid step, base {S2D_BIG_BASE}", state, params, card,
                         trace_steps=TRACE_STEPS_LONG))
    return row, (tree_map(lambda x: x.clone(), state), params)


def phase_2d(device, card):
    """Phase 10: the 2D slice.  Returns the rows
    for the JSON record and (a)'s settled pile (with its params) for phase
    7."""
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.pipeline.physics_pipeline import solve_path
    from rapier_tpu_torch.scenes import s2d_coulomb_stack_world, s2d_pyramid_world

    rows = {}
    rows[f"pyramid, base {S2D_BIG_BASE}"], big = _s2d_big(device, card)
    for name, make in (("pyramid, base 10", s2d_pyramid_world),
                       ("Coulomb stack", s2d_coulomb_stack_world)):
        state, params, handles = s2d_batch(device, make, N_SCENES)
        boxes = handles["boxes"]
        start = state.bodies.pos[:, boxes, :2].clone()
        path = solve_path(state, params)
        if path != "masked":
            _fail(f"2D {name} takes the {path} path, not the masked sweep")
        settle = S2D_SLIDE if "slider" in handles else S2D_SETTLE
        cs.KERNEL.launches = cs.KERNEL.launches_folded = 0
        t0 = time.time()
        state, worst = run(state, params, settle)
        torch.cuda.synchronize()
        settle_s = time.time() - t0
        t0 = time.time()
        state, worst_t = run(state, params, S2D_TIMED)
        torch.cuda.synchronize()
        elapsed = time.time() - t0
        launches = cs.KERNEL.launches, cs.KERNEL.launches_folded
        for k in worst:
            worst[k] = max(worst[k], worst_t[k])
        rate = N_SCENES * S2D_TIMED / elapsed
        _finite(state)
        _in_plane(f"2D {name}", state)
        _replicas_equal(f"2D {name}", state, ("bodies", "contacts"))
        moved = float((state.bodies.pos[:, boxes, :2] - start).abs().max())
        row = dict(env_steps_per_s=rate, box_moved=moved, **worst)
        note = ""
        if "slider" in handles:
            x = state.bodies.pos[:, handles["slider"], 0]
            vx = state.bodies.linvel[:, handles["slider"], 0]
            slid = bool(((x > SLIDER_X[0]) & (x < SLIDER_X[1]) & (vx.abs() < SLIDER_VX)).all())
            row.update(slider_x=float(x[0]), slider_vx=float(vx[0]))
            note = (f"; slider at x {float(x[0]):.4f}, vx {float(vx[0]):.6f} (at rest between "
                    f"{SLIDER_X[0]} and {SLIDER_X[1]}: {slid})")
            if not slid:
                _fail(f"2D {name}: the slider is not at rest inside {SLIDER_X}")
        print(f"2D {name}: {rate:.1f} env-steps/s ({N_SCENES} scenes x {S2D_TIMED} steps in "
              f"{elapsed:.3f} s after {settle} in {settle_s:.1f} s; {card}); overflow "
              f"{worst}; contact-sweep launches {launches[0]} + folded {launches[1]} (the "
              f"masked sweep has none); boxes moved at most {moved:.4f} from their starts "
              f"(tol {S2D_BOX_TOL}){note}; all {N_SCENES} scenes bitwise equal to scene 0")
        if worst["broadphase_overflow"] or worst["solver_overflow"]:
            _fail(f"2D {name} overflows: {worst}")
        if launches != (0, 0):
            _fail(f"2D {name} launched a contact-sweep kernel: {launches}")
        if not moved < S2D_BOX_TOL:
            _fail(f"2D {name}: a box moved {moved} from its start")
        if "slider" in handles:
            row.update(_stages(f"2D {name} step, {N_SCENES} scenes", state, params, card,
                               trace_steps=TRACE_STEPS_LONG))
        rows[name] = row
    return rows, big


def mesh_batch(device, make, n_scenes: int):
    """A mesh scene of `rapier_tpu_torch.scenes` (`make`: heightfield3_world,
    trimesh3_world or heightfield3_full_world) replicated to `n_scenes` on
    `device`: (state, params, handles)."""
    from rapier_tpu_torch.scenes import replicate_scene
    from rapier_tpu_torch.types import from_numpy

    world, handles = make(device=device)
    return replicate_scene(from_numpy(world.build(), device), n_scenes), world.params, handles


class _MeshPairs:
    """While installed, counts each step's (convex, mesh) broad-phase pairs
    per scene, and those past max_mesh_pairs: the reference drops these
    without a count (ROADMAP R12), and so does the port.  Read once, after
    the run (`most`, `dropped`)."""

    def __enter__(self):
        import torch
        from rapier_tpu_torch.geometry import narrowphase_mesh as npm
        from rapier_tpu_torch.pipeline import physics_pipeline as pp

        self.original, self.count, self.over = pp.compute_mesh_manifolds, None, None

        def record(bodies, colliders, meshes, c1, c2, pair_valid, prediction,
                   max_mesh_pairs, tris_per_pair, **kw):
            def mesh(c):
                return npm.is_mesh_type(torch.gather(colliders.shape_type, 1,
                                                     c.clamp(min=0).long()))

            n = (pair_valid & (mesh(c1) ^ mesh(c2))).sum(dim=-1)
            over = torch.clamp(n - max_mesh_pairs, min=0)
            self.count = n if self.count is None else torch.maximum(self.count, n)
            self.over = over if self.over is None else torch.maximum(self.over, over)
            return self.original(bodies, colliders, meshes, c1, c2, pair_valid, prediction,
                                 max_mesh_pairs, tris_per_pair, **kw)

        pp.compute_mesh_manifolds = record
        return self

    def __exit__(self, *exc):
        from rapier_tpu_torch.pipeline import physics_pipeline as pp

        pp.compute_mesh_manifolds = self.original

    def most(self) -> int:
        return int(self.count.max())

    def dropped(self) -> int:
        return int(self.over.max())


def _kernel_on_capture(what, state, params, k_expected: int, card):
    """contact_sweep_kernel at K = `k_expected` lanes on the solve inputs
    of the step after `state` (N_CHECK scenes, in contact), held to the
    plain version, then timed at 4096 scenes (the batched path, the
    reference's `_kernel_fold_gather`) and at one scene (`PhysicsWorld.step`,
    the reference's `_kernel`), with the valid lanes per scene and the scenes
    that keep them on chip.  The comparison launches are not counted."""
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.dynamics.solver.contact_constraints import SolverBodies

    counts = cs.KERNEL.launches, cs.KERNEL.launches_folded
    inp = capture_solve_inputs(state, params)
    sb = inp.pop("sb")
    k_lanes = inp["b1"].shape[-1]
    if k_lanes != k_expected:
        _fail(f"expected K = {k_expected} solver lanes on {what}, got {k_lanes}")
    launched = cs.KERNEL.launches
    sb_k, imp_k = cs.solve_from_manifolds(sb, **inp)
    if cs.KERNEL.launches != launched + 1:
        _fail(f"the {what} shape did not launch contact_sweep_kernel")
    err = _compare(f"contact_sweep_kernel at K={k_lanes} ({what})", sb, inp, sb_k, imp_k)
    _resources(f"contact_sweep_kernel ({what})", False, inp, sb, card)
    out = dict(max_abs_err=err)
    for reps, key in ((N_SCENES // N_CHECK, ""), (0, "one_scene_")):
        sb_t = SolverBodies(*[_scenes(x, reps) for x in sb])
        inp_t = {k: _scenes(v, reps) for k, v in inp.items()}
        packed, kw = _packed(sb_t, inp_t)
        ms = _time_ms(lambda: cs.KERNEL.launch(*packed, **kw), 20)
        plain_ms = _time_ms(lambda: cs.solve_plain(sb_t, **inp_t), 3)
        bound = _bound(packed, cs.KERNEL.launch(*packed, **kw), inp_t)
        storage = _storage(f"contact_sweep_kernel at {sb_t.v_lin.shape[0]} {what} "
                           f"scene(s)", False, packed, kw, False)
        print(f"{what} contact solve at {sb_t.v_lin.shape[0]} scene(s) x K={k_lanes}: "
              f"launch alone {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound[0]:.3g} ms "
              f"({bound[1]}), {bound[0] / ms:.1%} of the bound ({card})")
        out.update({f"{key}ms": ms, f"{key}plain_ms": plain_ms, f"{key}bound_ms": bound[0],
                    f"{key}bound_by": bound[1]})
        out.update({f"{key}{k}": v for k, v in storage.items()})
    cs.KERNEL.launches, cs.KERNEL.launches_folded = counts
    return out


def _heightfield_kernel(device, card):
    """contact_sweep_kernel at the heightfield's K = 640 lanes, on a capture
    of N_CHECK scenes after HF_CHECK_STEPS steps (`_kernel_on_capture`).
    Returns its numbers and the captured batch (with its params)."""
    from rapier_tpu_torch.scenes import heightfield3_world

    state, params, _ = mesh_batch(device, heightfield3_world, N_CHECK)
    state, _ = run(state, params, HF_CHECK_STEPS)
    return _kernel_on_capture("heightfield3", state, params, HF_K, card), (state, params)


def phase_meshes(device, card):
    """Phase 11(a): 4096 heightfield3 scenes through the port's step, on
    contact_sweep_kernel at K = 640.  Returns (the kernel's launches in
    the timed run, the row for the JSON record, the kernel's numbers at
    K = 640, and the capture's N_CHECK-scene batch after HF_CHECK_STEPS
    steps with its params, which phases 7 and 8 reuse)."""
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.pipeline.physics_pipeline import solve_path
    from rapier_tpu_torch.scenes import heightfield3_world

    kernel, in_contact = _heightfield_kernel(device, card)
    state, params, handles = mesh_batch(device, heightfield3_world, N_SCENES)
    bodies = torch.tensor(handles["bodies"], device=device)
    path = solve_path(state, params)
    print(f"heightfield3: {len(handles['bodies'])} bodies on a "
          f"{state.meshes.triangles.shape[1]}-row triangle table, P={state.contacts.max_pairs} "
          f"lanes ({params.max_mesh_pairs} x {params.tris_per_pair} of them mesh lanes), "
          f"N+1={state.bodies.pos.shape[1] + 1}, solve path {path}")
    if path != "kernel" or state.contacts.max_pairs != HF_K:
        _fail(f"heightfield3 takes the {path} path at P={state.contacts.max_pairs}, not the "
              f"contact kernel at K={HF_K}")
    t0 = time.time()
    with _MeshPairs() as pairs:
        state, worst = run(state, params, HF_SETTLE)
    torch.cuda.synchronize()
    settle_s = time.time() - t0
    _finite(state)
    y = state.bodies.pos[:, bodies, 1]
    print(f"heightfield3 after {HF_SETTLE} steps ({settle_s:.1f} s): heights in scene 0 "
          f"min {float(y[0].min()):.4f}, max {float(y[0].max()):.4f}; the example's checks "
          f"(every body above {HF_Y[0]} and below {HF_Y[1]}) in all {N_SCENES} scenes: "
          f"{bool(((y > HF_Y[0]) & (y < HF_Y[1])).all())}; (convex, mesh) pairs at most "
          f"{pairs.most()} a scene, past max_mesh_pairs {pairs.dropped()}")
    if not bool(((y > HF_Y[0]) & (y < HF_Y[1])).all()):
        _fail("heightfield3: the example's checks fail")
    if pairs.dropped():
        _fail(f"heightfield3 dropped {pairs.dropped()} mesh pairs past max_mesh_pairs")
    torch.cuda.reset_peak_memory_stats()
    cs.KERNEL.launches = cs.KERNEL.launches_folded = 0
    t0 = time.time()
    state, worst_t = run(state, params, HF_TIMED)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = cs.KERNEL.launches, cs.KERNEL.launches_folded
    peak = torch.cuda.max_memory_allocated()
    for k in worst:
        worst[k] = max(worst[k], worst_t[k])
    rate = N_SCENES * HF_TIMED / elapsed
    print(f"heightfield3: {rate:.1f} env-steps/s ({N_SCENES} scenes x {HF_TIMED} steps in "
          f"{elapsed:.3f} s; {card}); peak device memory in the timed steps "
          f"{peak / 2**30:.3f} GiB; overflow {worst}; launches in the timed run: "
          f"contact_sweep_kernel {launches[0]}, folded {launches[1]}")
    if worst["broadphase_overflow"] or worst["solver_overflow"]:
        _fail(f"heightfield3 overflows: {worst}")
    if launches != (HF_TIMED, 0):
        _fail(f"expected {HF_TIMED} contact_sweep_kernel launches and no folded one, "
              f"counted {launches[0]} and {launches[1]}")
    with _MeshPairs() as after:
        storage = _next_step_storage("heightfield3, the step after the timed run", state,
                                     params, False, must_fit=False)
    if after.dropped():
        _fail(f"heightfield3 dropped {after.dropped()} mesh pairs after the timed run")
    _finite(state)
    _replicas_equal("heightfield3", state, ("bodies", "contacts"))
    print(f"heightfield3: all {N_SCENES} scenes bitwise equal to scene 0 after "
          f"{HF_SETTLE + HF_TIMED} steps; no mesh pair dropped")
    row = dict(env_steps_per_s=rate, peak_memory_bytes=peak, mesh_pairs_most=pairs.most(),
               **storage, **worst,
               **_stages(f"heightfield3 step, {N_SCENES} scenes", state, params, card,
                         trace_steps=TRACE_STEPS_LONG))
    return launches[0], row, kernel, in_contact


def _field_height(meshes, xz):
    """The heightfield's surface height under the points ``xz [M, 2]``
    (scene 0's triangle table; the triangle whose xz-projection holds the
    point, interpolated)."""
    import torch

    v = meshes.vertices[0].double()
    t = meshes.triangles[0]
    t = t[t[:, 0] >= 0].long()
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    p = xz.double().unsqueeze(1)                                 # [M, 1, 2]

    def cross(u, w):
        return u[..., 0] * w[..., 1] - u[..., 1] * w[..., 0]

    ab, ac, ap = (b - a)[:, [0, 2]], (c - a)[:, [0, 2]], p - a[:, [0, 2]]
    det = cross(ab, ac)
    u = cross(ap, ac) / det
    w = cross(ab, ap) / det
    inside = (u >= -1e-9) & (w >= -1e-9) & (u + w <= 1 + 1e-9)
    h = a[:, 1] + u * (b - a)[:, 1] + w * (c - a)[:, 1]
    first = torch.argmax(inside.int(), dim=1)
    return torch.gather(h, 1, first.unsqueeze(1)).squeeze(1)


def phase_heightfield_full(device, card):
    """Phase 11(d), with --heightfield-full: upstream's heightfield3 at its
    size as one scene (1,280 bodies, max_mesh_pairs 1,664)."""
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.pipeline.physics_pipeline import solve_path
    from rapier_tpu_torch.scenes import heightfield3_full_world

    state, params, handles = mesh_batch(device, heightfield3_full_world, 1)
    bottom = torch.tensor(handles["bodies"][:handles["layer"]], device=device)
    y0 = state.bodies.pos[0, bottom, 1].clone()
    path = solve_path(state, params)
    print(f"heightfield3 at upstream's size: {len(handles['bodies'])} bodies, "
          f"{int((state.meshes.triangles[0, :, 0] >= 0).sum())} triangles, "
          f"P={state.contacts.max_pairs} lanes ({params.max_mesh_pairs} x "
          f"{params.tris_per_pair} mesh lanes), N+1={state.bodies.pos.shape[1] + 1}, solve "
          f"path {path}")
    cs.KERNEL.launches = cs.KERNEL.launches_folded = 0
    t0 = time.time()
    with _MeshPairs() as pairs:
        state, worst = run(state, params, HF_FULL_SETTLE)
    torch.cuda.synchronize()
    settle_s = time.time() - t0
    t0 = time.time()
    state, worst_t = run(state, params, HF_FULL_TIMED)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    with _MeshPairs() as after:
        state, worst_a = run(state, params, 1)
    for k in worst:
        worst[k] = max(worst[k], worst_t[k], worst_a[k])
    launches = cs.KERNEL.launches, cs.KERNEL.launches_folded
    rate = HF_FULL_TIMED / elapsed
    _finite(state)
    pos = state.bodies.pos[0, bottom]
    gap = pos[:, 1].double() - _field_height(state.meshes, pos[:, [0, 2]])
    landed = bool(((gap > 0) & (gap < HF_FULL_NEAR)).all())
    print(f"heightfield3 at upstream's size: {rate:.3f} steps/s ({HF_FULL_TIMED} steps in "
          f"{elapsed:.3f} s after {HF_FULL_SETTLE} in {settle_s:.1f} s; {card}); overflow "
          f"{worst}; contact-sweep launches {launches[0]} + folded {launches[1]}; (convex, "
          f"mesh) pairs at most {max(pairs.most(), after.most())}, past max_mesh_pairs "
          f"{max(pairs.dropped(), after.dropped())}; the bottom layer's {len(bottom)} bodies "
          f"{float((y0 - pos[:, 1]).min()):.3f} to {float((y0 - pos[:, 1]).max()):.3f} below "
          f"their start, their centres {float(gap.min()):.4f} to {float(gap.max()):.4f} above "
          f"the field (landed on it and above it: {landed})")
    if worst["broadphase_overflow"] or worst["solver_overflow"]:
        _fail(f"heightfield3 at upstream's size overflows: {worst}")
    if pairs.dropped() or after.dropped():
        _fail("heightfield3 at upstream's size dropped mesh pairs")
    if not landed:
        _fail("heightfield3 at upstream's size: the bottom layer did not land on the field")
    return dict(bodies=len(handles["bodies"]), path=path, steps_per_s=rate,
                mesh_pairs_most=max(pairs.most(), after.most()),
                bottom_gap_min=float(gap.min()), bottom_gap_max=float(gap.max()), **worst,
                **_stages("heightfield3 at upstream's size, one step", state, params, card,
                          trace_steps=TRACE_STEPS_LONG))


def primitives3_batch(device, n_scenes: int, layers: int = P3_LAYERS, grid: int = P3_GRID):
    """`scenes.primitives3_world(layers, grid)` at the bench's max_pairs and
    max_solver_pairs, replicated to `n_scenes` on `device`: (state, params,
    handles)."""
    from rapier_tpu_torch.scenes import primitives3_world, replicate_scene
    from rapier_tpu_torch.types import from_numpy

    world, handles = primitives3_world(layers, grid, max_pairs=P3_MAX_PAIRS, device=device)
    world.params = world.params.replace(max_solver_pairs=P3_K)
    return replicate_scene(from_numpy(world.build(), device), n_scenes), world.params, handles


def zoo_batch(device, n_scenes: int):
    """`scenes.convex_zoo_world` replicated to `n_scenes` on `device`."""
    from rapier_tpu_torch.scenes import convex_zoo_world, replicate_scene
    from rapier_tpu_torch.types import from_numpy

    world, handles = convex_zoo_world(device=device)
    return replicate_scene(from_numpy(world.build(), device), n_scenes), world.params, handles


def _p3_heights(what, state, bodies, y0):
    """Fail unless every body lies above the ground's top and below its drop
    height, in every scene."""
    y = state.bodies.pos[:, bodies, 1]
    ok = bool(((y > 0.0) & (y < y0)).all())
    print(f"{what}: heights in scene 0 min {float(y[0].min()):.4f}, max "
          f"{float(y[0].max()):.4f}; every body above the ground and below its drop height "
          f"in all {y.shape[0]} scenes: {ok}")
    if not ok:
        _fail(f"{what}: a body left the space between the ground and its drop height")


def phase_convex(device, card):
    """Phase 12(a), (b): 4096 primitives3 scenes (round cylinders and cones
    on the GJK/EPA fallback) through the port's step, on contact_sweep_kernel
    at K = 256.  Returns (the kernel's launches in the timed run, the row for
    the JSON record, the kernel's numbers at this capture, and the capture's
    N_CHECK-scene batch after P3_CHECK_STEPS steps with its params, which
    phases 7 and 8 reuse)."""
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.pipeline.physics_pipeline import solve_path

    t_phase = time.time()
    state, params, handles = primitives3_batch(device, N_CHECK)
    state, _ = run(state, params, P3_CHECK_STEPS)
    kernel = _kernel_on_capture("primitives3", state, params, P3_K, card)
    in_contact = (state, params)

    state, params, handles = primitives3_batch(device, N_SCENES)
    bodies = torch.tensor(handles["bodies"], device=device)
    y0 = state.bodies.pos[0, bodies, 1].clone()
    path = solve_path(state, params)
    print(f"primitives3: {len(handles['bodies'])} bodies ({P3_LAYERS} layers of {P3_GRID} x "
          f"{P3_GRID}), P={state.contacts.max_pairs}, K={P3_K}, "
          f"N+1={state.bodies.pos.shape[1] + 1}, census {params.shape_types_present}, "
          f"solve path {path}")
    if path != "kernel":
        _fail(f"primitives3 takes the {path} path, not the contact kernel")
    t0 = time.time()
    state, worst = run(state, params, P3_SETTLE)
    torch.cuda.synchronize()
    settle_s = time.time() - t0
    _finite(state)
    _p3_heights(f"primitives3 after {P3_SETTLE} steps ({settle_s:.1f} s)", state, bodies, y0)
    speed = float(torch.linalg.norm(state.bodies.linvel[:, bodies], dim=-1).max())
    print(f"primitives3 after {P3_SETTLE} steps: fastest body {speed:.4f} m/s in any scene "
          f"(bound {P3_SPEED_BOUND}: twice the reference's {P3_REF_SPEED} on the CPU)")
    if not speed <= P3_SPEED_BOUND:
        _fail(f"primitives3: a body moves at {speed} m/s after {P3_SETTLE} steps")
    torch.cuda.reset_peak_memory_stats()
    cs.KERNEL.launches = cs.KERNEL.launches_folded = 0
    t0 = time.time()
    state, worst_t = run(state, params, P3_TIMED)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = cs.KERNEL.launches, cs.KERNEL.launches_folded
    peak = torch.cuda.max_memory_allocated()
    for k in worst:
        worst[k] = max(worst[k], worst_t[k])
    rate = N_SCENES * P3_TIMED / elapsed
    print(f"primitives3: {rate:.1f} env-steps/s ({N_SCENES} scenes x {P3_TIMED} steps in "
          f"{elapsed:.3f} s; {card}); peak device memory in the timed steps "
          f"{peak / 2**30:.3f} GiB; overflow and unsupported pairs {worst}; launches in the "
          f"timed run: contact_sweep_kernel {launches[0]}, folded {launches[1]}")
    if any(worst.values()):
        _fail(f"primitives3 overflows or drops pairs: {worst}")
    if launches != (P3_TIMED, 0):
        _fail(f"expected {P3_TIMED} contact_sweep_kernel launches and no folded one, "
              f"counted {launches[0]} and {launches[1]}")
    _finite(state)
    _p3_heights(f"primitives3 after {P3_SETTLE + P3_TIMED} steps", state, bodies, y0)
    _replicas_equal("primitives3", state, ("bodies", "contacts"))
    print(f"primitives3: all {N_SCENES} scenes bitwise equal to scene 0 after "
          f"{P3_SETTLE + P3_TIMED} steps")
    storage = _next_step_storage("primitives3, the step after the timed run", state, params,
                                 False, must_fit=False)
    row = dict(env_steps_per_s=rate, peak_memory_bytes=peak, fastest_body=speed,
               **storage, **worst,
               **_stages(f"primitives3 step, {N_SCENES} scenes", state, params, card,
                         trace_steps=TRACE_STEPS_LONG))
    print(f"[phase 12 (a), (b): {time.time() - t_phase:.1f} s]")
    return launches[0], row, kernel, in_contact


def phase_primitives_full(device, card):
    """Phase 12(d), with --primitives-full: upstream's primitives3 at its
    size (20 layers of 8 x 8, 1,280 bodies) as one scene, on the path the
    reference's gate picks."""
    import torch
    from rapier_tpu_torch.pipeline.physics_pipeline import solve_path
    from rapier_tpu_torch.scenes import primitives3_world, replicate_scene
    from rapier_tpu_torch.types import from_numpy

    world, handles = primitives3_world(20, 8, device=device)
    state = replicate_scene(from_numpy(world.build(), device), 1)
    params = world.params
    bodies = torch.tensor(handles["bodies"], device=device)
    path = solve_path(state, params)
    print(f"primitives3 at upstream's size: {len(handles['bodies'])} bodies, "
          f"P={state.contacts.max_pairs}, N+1={state.bodies.pos.shape[1] + 1}, solve path "
          f"{path}")
    t0 = time.time()
    state, worst = run(state, params, P3_FULL_SETTLE)
    torch.cuda.synchronize()
    settle_s = time.time() - t0
    t0 = time.time()
    state, worst_t = run(state, params, P3_FULL_TIMED)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    for k in worst:
        worst[k] = max(worst[k], worst_t[k])
    rate = P3_FULL_TIMED / elapsed
    _finite(state)
    y = state.bodies.pos[0, bodies, 1]
    print(f"primitives3 at upstream's size: {rate:.3f} steps/s ({P3_FULL_TIMED} steps in "
          f"{elapsed:.3f} s after {P3_FULL_SETTLE} in {settle_s:.1f} s; {card}); overflow "
          f"and unsupported pairs {worst}; heights min {float(y.min()):.4f}, max "
          f"{float(y.max()):.4f}")
    if worst["broadphase_overflow"] or worst["solver_overflow"]:
        _fail(f"primitives3 at upstream's size overflows: {worst}")
    if not bool((y > 0.0).all()):
        _fail("primitives3 at upstream's size: a body fell below the ground")
    return dict(bodies=len(handles["bodies"]), path=path, steps_per_s=rate, **worst,
                **_stages("primitives3 at upstream's size, one step", state, params, card,
                          trace_steps=TRACE_STEPS_LONG))


def _ccd3_one_scene(device, card):
    """Phase 13(a): upstream's ccd3 as one scene, CCD3_STEPS steps, each
    step's CCD clamps recorded (the clamp's input and output compared).
    Returns (the contact kernel's launches, the row, the index of the first
    step that clamps a ball)."""
    import numpy as np
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.pipeline import physics_pipeline as pp
    from rapier_tpu_torch.scenes import (CCD3_BALL_RADIUS, CCD3_BALL_SPEED, CCD3_WALL_ROWS,
                                         ccd3_world)
    from rapier_tpu_torch.types import tree_map

    state, params, h = s2d_batch(device, ccd3_world, 1)
    balls = torch.tensor(h["balls"], device=device)
    wall0 = torch.tensor(h["boxes"][0], device=device)
    path = pp.solve_path(state, params)
    print(f"ccd3: {state.bodies.pos.shape[1]} body slots ({sum(map(len, h['boxes']))} boxes in "
          f"{len(h['boxes'])} walls, 2 balls at {CCD3_BALL_SPEED:.0f} m/s), "
          f"P={state.contacts.max_pairs}, enable_ccd {params.enable_ccd}, solve path {path}")
    if not params.enable_ccd or path != "kernel":
        _fail(f"ccd3 takes enable_ccd={params.enable_ccd} and the {path} path")
    clamped, xs, vs, worst = [], [state.bodies.pos[0, balls].clone()], [], None
    before = []                      # each step's start, for the stage breakdown
    original = pp.clamp_motions

    def spy(bodies, colliders, p, meshes):
        out, ovf = original(bodies, colliders, p, meshes)
        clamped.append(torch.any(out.next_pos[0, balls] != bodies.next_pos[0, balls], dim=-1))
        return out, ovf

    box0 = state.bodies.pos[0, wall0].clone()
    cs.KERNEL.launches = cs.KERNEL.launches_folded = 0
    pp.clamp_motions = spy
    try:
        t0 = time.time()
        for _ in range(CCD3_STEPS):
            before.append(tree_map(lambda x: x.clone(), state))
            state, ev = pp.step(state, params)
            now = torch.stack([ev.broadphase_overflow.max(), ev.solver_overflow.max(),
                               ev.ccd_overflow.max()])
            worst = now if worst is None else torch.maximum(worst, now)
            xs.append(state.bodies.pos[0, balls].clone())
            vs.append(state.bodies.linvel[0, balls].clone())
        torch.cuda.synchronize()
        elapsed = time.time() - t0
    finally:
        pp.clamp_motions = original
    launches = cs.KERNEL.launches, cs.KERNEL.launches_folded
    worst = dict(zip(("broadphase_overflow", "solver_overflow", "ccd_overflow"),
                     worst.tolist()))
    _finite(state)
    pos = torch.stack(xs).cpu().numpy()                      # [steps + 1, 2, 3]
    cl = torch.stack(clamped).cpu().numpy()                  # [steps, 2]
    exit_speed = torch.linalg.norm(torch.stack(vs)[-1], dim=-1).cpu().numpy()
    moved = float(torch.linalg.norm(state.bodies.pos[0, wall0] - box0, dim=-1).max())
    disp = np.abs(np.diff(pos[..., 0], axis=0))             # [steps, 2]
    free = CCD3_BALL_SPEED * float(params.dt)
    first = int(np.flatnonzero(cl.any(axis=1))[0]) if cl.any() else -1
    print(f"ccd3, one scene: {CCD3_STEPS / elapsed:.3f} steps/s ({CCD3_STEPS} steps in "
          f"{elapsed:.3f} s, each step's clamps read back; {card}); overflow {worst}; "
          f"contact solve: {path}, contact_sweep_kernel {launches[0]} launches, folded "
          f"{launches[1]}")
    for b in range(2):
        steps = np.flatnonzero(cl[:, b])
        print(f"ccd3 ball {b}: clamped in steps {steps.tolist()}, x after each step "
              f"{np.round(pos[1:, b, 0], 3).tolist()}, exit speed {exit_speed[b]:.2f} m/s")
    print(f"ccd3: first wall's boxes moved up to {moved:.3f} (above {CCD3_BOX_MOVED}); the "
          f"first clamp in step {first}")
    if any(worst.values()):
        _fail(f"ccd3 overflows: {worst}")
    if launches != (CCD3_STEPS, 0):
        _fail(f"ccd3: expected {CCD3_STEPS} contact_sweep_kernel launches, counted {launches}")
    for b in range(2):
        if not (cl[:, b] & (disp[:, b] < free)).any():
            _fail(f"ccd3: ball {b} has no clamped step shorter than free flight ({free:.2f})")
        if not exit_speed[b] < CCD3_EXIT_SPEED:
            _fail(f"ccd3: ball {b} leaves at {exit_speed[b]} m/s (walls were ghosts)")
        # A wall whose plane the ball crossed inside the wall's silhouette
        # (row i spans y in [i, i + 1] and |z| <= rows - i) needs a clamped
        # step that ended at that wall.
        for x_w in h["wall_x"]:
            if pos[-1, b, 0] <= x_w + 0.5 + CCD3_BALL_RADIUS:
                continue
            k = int(np.flatnonzero(pos[1:, b, 0] > x_w)[0])
            f = (x_w - pos[k, b, 0]) / max(pos[k + 1, b, 0] - pos[k, b, 0], 1e-9)
            y, z = pos[k, b, 1:] + f * (pos[k + 1, b, 1:] - pos[k, b, 1:])
            rows = np.arange(CCD3_WALL_ROWS)
            inside = ((np.abs(y - (rows + 0.5)) < 0.5 + CCD3_BALL_RADIUS)
                      & (np.abs(z) < CCD3_WALL_ROWS - rows + CCD3_BALL_RADIUS)).any()
            ends = pos[1:, b, 0][cl[:, b]]
            near = (ends >= x_w - 0.5 - CCD3_BALL_RADIUS - CCD3_BAND) & (
                ends <= x_w + 0.5 + CCD3_BALL_RADIUS + CCD3_BAND)
            print(f"ccd3 ball {b} crossed the wall at x = {x_w} at y {y:.3f}, z {z:.3f} "
                  f"({'inside' if inside else 'outside'} its silhouette; clamped there: "
                  f"{bool(near.any())})")
            if inside and not near.any():
                _fail(f"ccd3: ball {b} passed through the wall at x = {x_w} without a "
                      "clamped step there")
    if not moved > CCD3_BOX_MOVED:
        _fail(f"ccd3: the first wall's boxes moved only {moved}")
    row = dict(steps_per_s=CCD3_STEPS / elapsed, path=path, **worst,
               exit_speed=exit_speed.tolist(), first_clamp_step=first,
               **_stages("ccd3, the step that first clamps a ball, one scene", before[first],
                         params, card, trace_steps=TRACE_STEPS_LONG))
    return launches[0], row, first


def _ccd3_batch(device, card, first: int):
    """Phase 13(b): CCD3_SCENES replicas of ccd3, CCD3_BATCH_STEPS steps, the
    last CCD3_TIMED timed.  Returns (the row, the batch's first
    CCD3_RERUN_SCENES scenes before step `first`, with the params)."""
    import torch
    from rapier_tpu_torch.scenes import ccd3_world
    from rapier_tpu_torch.types import tree_map
    from rapier_tpu_torch.utils import counters

    state, params, _ = s2d_batch(device, ccd3_world, CCD3_SCENES)
    state, worst = run(state, params, first)
    capture = (tree_map(lambda x: x[:CCD3_RERUN_SCENES].clone(), state), params)
    ccd_ms = counters.profile_step(state, params, iters=1).as_dict()["ccd_ms"]
    state, w2 = run(state, params, max(0, CCD3_BATCH_STEPS - CCD3_TIMED - first))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    state, w3 = run(state, params, CCD3_TIMED)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    worst = {k: max(worst[k], w2[k], w3[k]) for k in worst}
    rate = CCD3_SCENES * CCD3_TIMED / elapsed
    print(f"ccd3 x {CCD3_SCENES}: {rate:.1f} env-steps/s ({CCD3_TIMED} steps in {elapsed:.3f} s "
          f"after {CCD3_BATCH_STEPS - CCD3_TIMED}; {card}); peak device memory "
          f"{peak / 2**30:.3f} GiB; "
          f"the ccd stage {ccd_ms:.3f} ms of the step that first clamps a ball; overflow "
          f"{worst}")
    if worst["broadphase_overflow"] or worst["solver_overflow"] or worst["ccd_overflow"]:
        _fail(f"ccd3 x {CCD3_SCENES} overflows: {worst}")
    _finite(state)
    _replicas_equal(f"ccd3 x {CCD3_SCENES}", state, ("bodies", "contacts"))
    print(f"ccd3 x {CCD3_SCENES}: all scenes bitwise equal to scene 0 after "
          f"{CCD3_BATCH_STEPS} steps")
    # ~500 valid lanes a scene: past the on-chip capacity, in the global scratch.
    storage = _next_step_storage(f"ccd3 x {CCD3_SCENES}, the step after the run", state,
                                 params, False, must_fit=False)
    return dict(env_steps_per_s=rate, peak_memory_bytes=peak, ccd_ms=ccd_ms, **worst,
                **storage), capture


def _arm_checks(what, state, h, mb_tree=0):
    """examples/multibody_arm.py's checks on every scene."""
    import torch
    from rapier_tpu_torch.scenes import ARM_SHOULDER_TARGET

    q = state.multibodies.q[:, mb_tree, 1, 5]
    p = state.bodies.pos[:, h["ball"]]
    knocked = ((p[:, 0] - 1.8).abs() > 0.4) | (p[:, 1] < 0.6)
    print(f"{what}: shoulder angle {float(q[0]):.4f} rad (target {ARM_SHOULDER_TARGET}; "
          f"every scene below -0.9: {bool((q < -0.9).all())}), ball at "
          f"{[round(v, 3) for v in p[0].tolist()]} (knocked off in "
          f"{int(knocked.sum())} of {q.shape[0]} scenes)")
    if not (bool((q < -0.9).all()) and bool(knocked.all())):
        _fail(f"{what}: the example's checks fail")
    if not bool(torch.isfinite(q).all()):
        _fail(f"{what}: non-finite joint angles")


def _arms(device, card):
    """Phase 13(c), (d): N_SCENES arms for ARM_STEPS steps, N_SCENES coupled
    arms for COUPLED_STEPS.  Returns (the folded kernel's launches, the row,
    the captures for phases 7 and 8)."""
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.pipeline.physics_pipeline import solve_path
    from rapier_tpu_torch.scenes import multibody_arm_world
    from rapier_tpu_torch.types import tree_map

    state, params, h = s2d_batch(device, multibody_arm_world, N_SCENES)
    path, k = solve_path(state, params), state.contacts.max_pairs
    cs.KERNEL.launches = cs.KERNEL.launches_folded = 0
    t0 = time.time()
    state, worst = run(state, params, ARM_CAPTURE)
    capture = (tree_map(lambda x: x[:ARM_RERUN_SCENES].clone(), state), params)
    state, w2 = run(state, params, ARM_STEPS - ARM_CAPTURE)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = cs.KERNEL.launches, cs.KERNEL.launches_folded
    worst = {key: max(worst[key], w2[key]) for key in worst}
    rate = N_SCENES * ARM_STEPS / elapsed
    print(f"multibody arm x {N_SCENES}: {rate:.1f} env-steps/s ({ARM_STEPS} steps in "
          f"{elapsed:.3f} s; {card}); K={k}, solve path {path}: folded {launches[1]} launches, "
          f"contact_sweep_kernel {launches[0]}; overflow {worst}")
    if any(worst.values()):
        _fail(f"multibody arm overflows: {worst}")
    if path != "kernel" or launches != ((0, ARM_STEPS) if k <= 128 else (ARM_STEPS, 0)):
        _fail(f"multibody arm: path {path}, launches {launches} at K={k}")
    _finite(state)
    _arm_checks(f"multibody arm after {ARM_STEPS} steps", state, h)
    _replicas_equal("multibody arm", state, ("bodies", "contacts", "multibodies"))
    print(f"multibody arm: all {N_SCENES} scenes bitwise equal to scene 0")
    row = dict(env_steps_per_s=rate, k=k, **worst)

    cstate, cparams, _ = s2d_batch(device, multibody_arm_world, N_SCENES, coupled=True)
    t0 = time.time()
    cstate, cw = run(cstate, cparams, COUPLED_CAPTURE)
    ccapture = (tree_map(lambda x: x[:2].clone(), cstate), cparams)
    cstate, cw2 = run(cstate, cparams, COUPLED_STEPS - COUPLED_CAPTURE)
    torch.cuda.synchronize()
    crate = N_SCENES * COUPLED_STEPS / (time.time() - t0)
    _finite(cstate)
    qd = cstate.multibodies.qd[:, 0]
    shoulder, elbow = qd[:, 1 * 6 + 5], qd[:, 2 * 6 + 5]
    rel = float(((elbow + shoulder).abs() / shoulder.abs().clamp(min=1e-6)).max())
    print(f"coupled arm x {N_SCENES}: {crate:.1f} env-steps/s over {COUPLED_STEPS} steps; "
          f"elbow qd {float(elbow[0]):.6f} vs -1 x shoulder qd {float(-shoulder[0]):.6f} in "
          f"scene 0; worst relative gap over the scenes {rel:.3e} (tol {COUPLING_TOL}); "
          f"overflow {dict((key, max(cw[key], cw2[key])) for key in cw)}")
    if not rel <= COUPLING_TOL:
        _fail(f"coupled arm: the coupling is off by {rel} relative")
    row.update(coupled_env_steps_per_s=crate, coupling_rel_gap=rel)
    return launches[1] if k <= 128 else launches[0], row, capture, ccapture


def _ik(device, card):
    """Phase 13(e): inverse kinematics on N_SCENES arms towards targets from
    seeded joint angles, on the card and on the CPU."""
    import numpy as np
    import torch
    from rapier_tpu_torch.dynamics import multibody as mbm
    from rapier_tpu_torch.scenes import multibody_arm_world
    from rapier_tpu_torch.types import tree_map

    state, _, _ = s2d_batch(device, multibody_arm_world, N_SCENES)
    mb, bodies = state.multibodies, state.bodies
    rng = np.random.default_rng(13)
    ang = torch.from_numpy(rng.uniform(-1.2, -0.3, (N_SCENES, 3)).astype(np.float32)).to(device)
    q, jr = mb.q.clone(), torch.zeros_like(mb.joint_rot)
    q[:, 0, 1:, 5] = ang
    jr[:, 0, :, 3] = 1.0
    jr[:, 0, 1:, 2], jr[:, 0, 1:, 3] = torch.sin(ang / 2), torch.cos(ang / 2)
    posed = mb.replace(q=q, joint_rot=jr)
    target = mbm.forward_kinematics(posed, bodies, *mbm._root_pose(posed, bodies))[0][:, :, 3]
    link = torch.full((N_SCENES, 1), 3, device=device)
    rot = torch.zeros((N_SCENES, 1, 4), device=device)
    rot[..., 3] = 1.0
    # eps 0: every scene runs all IK_ITERS iterations on both devices (an
    # early stop compares a float32 error with eps, a tie between devices).
    kw = dict(damping=0.5, max_iters=IK_ITERS, constrained_axes=0b000111, eps_linear=0.0,
              eps_angular=0.0)

    def solve(mb_, bodies_, link_, target_, rot_):
        out = mbm.inverse_kinematics(mb_, bodies_, link_, target_, rot_, **kw)
        end = mbm.forward_kinematics(out, bodies_, *mbm._root_pose(out, bodies_))[0][:, :, 3]
        return out, end

    t0 = time.time()
    out, end = solve(mb, bodies, link, target, rot)
    torch.cuda.synchronize()
    card_s = time.time() - t0
    cpu = tree_map(lambda x: x[:IK_CPU_SCENES].cpu(), state)
    t0 = time.time()
    out_c, _ = solve(cpu.multibodies, cpu.bodies, *(x[:IK_CPU_SCENES].cpu()
                                                    for x in (link, target, rot)))
    cpu_s = time.time() - t0
    gap = float((out.q[:IK_CPU_SCENES].cpu() - out_c.q).abs().max())
    miss = float(torch.linalg.norm(end - target, dim=-1).max())
    print(f"inverse kinematics on {N_SCENES} arms, {IK_ITERS} iterations: {card_s:.3f} s on "
          f"the card ({card}), {cpu_s:.3f} s on the CPU for its first {IK_CPU_SCENES}; card vs "
          f"CPU max |d q| {gap:.3e} (tol "
          f"{IK_CPU_TOL}); worst distance to the target {miss:.3e} (tol {IK_TARGET_TOL})")
    if not (gap <= IK_CPU_TOL and miss <= IK_TARGET_TOL):
        _fail("inverse kinematics misses its targets or disagrees with the CPU")
    return dict(ik_card_s=card_s, ik_cpu_gap=gap, ik_worst_miss=miss)


def phase_ccd_multibody(device, card):
    """Phase 13: CCD (upstream's ccd3) and the multibody remainder (the
    arm, its dof coupling, inverse kinematics).  Returns (the launches by
    path, the rows, the captures phases 7 and 8 reuse)."""
    t_phase = time.time()
    ccd3_launches, one, first = _ccd3_one_scene(device, card)
    batch, ccd3_capture = _ccd3_batch(device, card, first)
    arm_launches, arm, arm_capture, coupled_capture = _arms(device, card)
    arm.update(_ik(device, card))
    print(f"[phase 13: {time.time() - t_phase:.1f} s]")
    captures = dict(ccd3=ccd3_capture, ccd3_step=first, arm=arm_capture,
                    coupled_arm=coupled_capture)
    return (dict(ccd3=ccd3_launches, multibody_arm=arm_launches),
            dict(ccd3=one, ccd3_batch=batch, multibody_arm=arm), captures)


def _sync_ms(fn):
    """(fn's result, its wall time in ms, the card synchronised after)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _states_equal(a, b) -> bool:
    """Every leaf of two states equal bitwise (NaN where NaN)."""
    from rapier_tpu_torch.world import _state_leaves

    for x, y in zip(_state_leaves(a), _state_leaves(b)):
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        same = x == y
        if x.is_floating_point():
            same |= x.isnan() & y.isnan()
        if not bool(same.all()):
            return False
    return True


def _stepped_world(world, steps: int, worst: dict):
    """`steps` PhysicsWorld steps, each overflow count's largest value
    folded into `worst` (one read at the end)."""
    import torch

    keys = ("broadphase_overflow", "solver_overflow", "unsupported_pairs")
    acc = None
    for _ in range(steps):
        world.step()
        now = torch.stack([getattr(world.last_events, k).max().to(torch.int64) for k in keys])
        acc = now if acc is None else torch.maximum(acc, now)
    for k, v in zip(keys, acc.tolist()):
        worst[k] = max(worst.get(k, 0), v)


def _uncounted(fn, *args, **kw):
    """fn(*args) with the kernel launch counts left as they were: card
    steps taken to compare with the CPU are not the run's."""
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    launches = cs.KERNEL.launches, cs.KERNEL.launches_folded
    try:
        return fn(*args, **kw)
    finally:
        cs.KERNEL.launches, cs.KERNEL.launches_folded = launches


def _bench_physics_world(device, **kw):
    """bench.py's configuration as one PhysicsWorld (101 bodies, capacity
    104, P = 512, K = 256), built on `device`."""
    from rapier_tpu_torch.scenes import mixed_primitives_world

    world = mixed_primitives_world(num_layers=4, grid=5, max_pairs=512, device=device, **kw)
    world.params = world.params.replace(max_solver_pairs=256)
    world.build()
    return world


def _world_mutations(world, cycle: int, pile: list, removed: set, ms: dict):
    """One cycle: a ball inserted above the pile; a body of two colliders
    inserted, then one of them removed; the oldest pile body removed.  The
    first call of each kind is timed into `ms` (an insert that grows a table
    as "grow_bodies" or "grow_colliders"); stale handles must raise."""
    from rapier_tpu_torch.world import ColliderBuilder as CB
    from rapier_tpu_torch.world import RigidBodyBuilder as RB

    def timed(kind, fn):
        sizes = world.state.bodies.n, world.state.colliders.n
        out, t = _sync_ms(fn)
        grew = (world.state.bodies.n, world.state.colliders.n) != sizes
        ms.setdefault(f"grow_{kind}_table" if grew else f"insert_{kind}", t)
        return out

    x = -2.5 + 1.0 * cycle
    h = timed("body", lambda: world.insert_body_runtime(
        RB.dynamic().with_translation((x, 8.0, 0.5))))
    timed("collider", lambda: world.insert_collider_runtime(CB.ball(0.4), h))
    h2 = timed("body", lambda: world.insert_body_runtime(
        RB.dynamic().with_translation((x, 9.5, -0.5))))
    timed("collider", lambda: world.insert_collider_runtime(CB.cuboid(0.3, 0.3, 0.3), h2))
    extra = timed("collider", lambda: world.insert_collider_runtime(
        CB.ball(0.25).with_translation((0.4, 0.0, 0.0)), h2))
    _, t = _sync_ms(lambda: world.remove_collider_runtime(extra))
    ms.setdefault("remove_collider", t)
    oldest = pile.pop(0)
    removed.add(extra.index)
    removed.update(ci for ci, (_, p) in world._collider_meta.items() if p == oldest.index)
    _, t = _sync_ms(lambda: world.remove_body_runtime(oldest))
    ms.setdefault("remove_body", t)
    for remove, stale in ((world.remove_body_runtime, oldest),
                          (world.remove_collider_runtime, extra)):
        try:
            remove(stale)
        except AssertionError:
            continue
        _fail(f"a stale handle was accepted: {stale}")
    pile += [h, h2]
    removed.difference_update(world._collider_meta)


def _removed_untouched(world, removed: set, what: str):
    """No touching lane involves a removed (and not reused) collider."""
    import torch

    if not removed:
        return
    c = world.state.contacts
    gone = torch.tensor(sorted(removed), device=c.collider1.device)
    bad = c.touching[0] & (torch.isin(c.collider1[0], gone) | torch.isin(c.collider2[0], gone))
    if bool(bad.any()):
        _fail(f"{what}: {int(bad.sum())} touching lanes involve removed colliders")


def _world_bench(device, card):
    """Phase 14(a): the bench scene as one PhysicsWorld, settled, then
    mutated every WORLD_CYCLE steps.  Returns (the kernel's launches in the
    mutating run, the row, the world)."""
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.pipeline.physics_pipeline import solve_path
    from rapier_tpu_torch.world import BodyHandle

    world = _bench_physics_world(device)
    n_cap, c_cap = world.state.bodies.n, world.state.colliders.n
    print(f"bench world: {world.n_bodies} bodies, body capacity {n_cap}, collider capacity "
          f"{c_cap}, P = {world.state.contacts.max_pairs}, K = {world.params.max_solver_pairs}, "
          f"solve path {solve_path(world.state, world.params)!r}")
    worst = {}
    _stepped_world(world, WORLD_SETTLE - WORLD_PLAIN_TIMED, worst)
    _, t = _sync_ms(lambda: _stepped_world(world, WORLD_PLAIN_TIMED, worst))
    rates = {"plain": WORLD_PLAIN_TIMED / (t / 1e3)}
    pile = [BodyHandle(i, 0) for i in range(1, world.n_bodies)]
    removed, ms, grew, checked = set(), {}, {}, set()
    cs.KERNEL.launches = cs.KERNEL.launches_folded = 0
    t_run = 0.0
    for cycle in range(WORLD_CYCLES):
        step_now = WORLD_SETTLE + cycle * WORLD_CYCLE
        n0, c0 = world.state.bodies.n, world.state.colliders.n
        _, t = _sync_ms(lambda: _world_mutations(world, cycle, pile, removed, ms))
        t_run += t
        for what, before, after in (("bodies", n0, world.state.bodies.n),
                                    ("colliders", c0, world.state.colliders.n)):
            if after != before:
                grew.setdefault(what, step_now)
                n1 = world.state.bodies.n + 1
                cap = cs.KERNEL.capacity(False, world.params.max_solver_pairs, n1,
                                         world.params.max_colors)
                print(f"step {step_now}: the {what} table grew {before} -> {after}; solve "
                      f"path {solve_path(world.state, world.params)!r}, the kernel's on-chip "
                      f"capacity {cap} lanes a scene at N+1 = {n1}")
        label = ("the first mutation" if cycle == 0 else
                 "both tables grew" if len(grew) == 2 and "growth" not in checked else None)
        if label:
            checked.add("growth" if cycle else "first")
            _uncounted(_cpu_step_agreement, f"bench world at step {step_now}, after {label}",
                       world.state, world.params, steps=WORLD_CPU_STEPS, witness=None)
        _, t = _sync_ms(lambda: _stepped_world(world, 1, worst))
        t_run += t
        _removed_untouched(world, removed, f"step {step_now + 1}")
        _, t = _sync_ms(lambda: _stepped_world(world, WORLD_CYCLE - 1, worst))
        t_run += t
    steps = WORLD_CYCLES * WORLD_CYCLE
    launches, folded = cs.KERNEL.launches, cs.KERNEL.launches_folded
    rates["mutating"] = steps / (t_run / 1e3)
    _next_step_storage("bench world after the mutating run", world.state, world.params,
                       False, must_fit=False)
    print(f"mutating run: {steps} steps, {WORLD_CYCLES} cycles; bodies {world.state.bodies.n}, "
          f"colliders {world.state.colliders.n}; overflow {worst}; contact_sweep_kernel "
          f"launches {launches}, folded {folded}; grew at steps {grew}")
    if set(grew) != {"bodies", "colliders"} or max(grew.values()) > WORLD_SETTLE + 2 * WORLD_CYCLE:
        _fail(f"the tables did not both grow within three cycles: {grew}")
    if any(worst.values()):
        _fail(f"the mutating bench world overflows: {worst}")
    if launches != steps or folded:
        _fail(f"expected {steps} contact_sweep_kernel launches, counted {launches} and "
              f"{folded} folded")
    _finite(world.state)
    row = dict(steps=steps, grew_at=grew, ms=ms, rates=rates)
    row.update(_world_snapshots(device, world, worst))
    row["rates"].update(_world_guard(world))
    if any(worst.values()):
        _fail(f"the bench world overflows: {worst}")
    print(f"bench world rates (steps/s): " + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
          + "; ms: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f" ({card})")
    return launches, row, world


def _world_snapshots(device, world, worst):
    """Snapshot and restore, save and load into a fresh world of the grown
    capacities (the world's params), each followed by WORLD_REPRO steps,
    against the run itself, bitwise; a world of the bench's own capacities
    refuses the file."""
    import torch

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "world_snapshot.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    snap, t_snap = _sync_ms(world.snapshot)
    _, t_save = _sync_ms(lambda: world.save_snapshot(path))
    size = os.path.getsize(path)
    _stepped_world(world, WORLD_REPRO, worst)
    run_end = world.snapshot()
    world.restore(snap)
    _stepped_world(world, WORLD_REPRO, worst)
    if not _states_equal(world.state, run_end):
        _fail("snapshot, restore and the same steps do not reproduce the run bitwise")
    fresh = _bench_physics_world(device, body_capacity=world.state.bodies.n,
                                 collider_capacity=world.state.colliders.n)
    fresh.params = world.params
    _, t_load = _sync_ms(lambda: fresh.load_snapshot(path))
    _stepped_world(fresh, WORLD_REPRO, worst)
    if not _states_equal(fresh.state, run_end):
        _fail("save, load into a fresh world and the same steps do not reproduce the run")
    other = _bench_physics_world(device)
    try:
        other.load_snapshot(path)
        _fail("a world of other capacities accepted the snapshot file")
    except ValueError as e:
        print(f"a world of capacities {other.state.bodies.n}/{other.state.colliders.n} refuses "
              f"the file: {str(e).splitlines()[0][:100]}")
    os.remove(path)
    world.state = run_end
    print(f"snapshot {t_snap:.3f} ms, save {t_save:.3f} ms, load {t_load:.3f} ms; file "
          f"{size} bytes; restore and load each reproduce {WORLD_REPRO} steps bitwise")
    return dict(snapshot_ms=t_snap, save_ms=t_save, load_ms=t_load, snapshot_bytes=size)


def _world_guard(world):
    """The NaN guard on the bench world: steps/s under "rollback" at
    nan_check_every 16 and 1; at 16 a NaN velocity set with set_linvel is
    rolled back to the last checked state bitwise; "trap" raises."""
    rates = {}
    world.nan_policy = "rollback"
    for every in (16, 1):
        world.nan_check_every, world._nan_tick = every, 0
        _, t = _sync_ms(lambda: world.step(WORLD_GUARD))
        rates[f"guard_{every}"] = WORLD_GUARD / (t / 1e3)
    world.nan_check_every, world._nan_tick = 16, 0
    world.step(16)
    kept = world.snapshot()
    body = int(world.state.bodies.inv_mass[0].argmax())
    world.set_linvel(body, (float("nan"), 0.0, 0.0))
    world.step(15)
    if world.nan_rollbacks:
        _fail("the guard rolled back before its check")
    world.step(1)
    if world.nan_rollbacks != 1 or not _states_equal(world.state, kept):
        _fail(f"the guard did not roll back to the last finite state bitwise "
              f"({world.nan_rollbacks} rollbacks)")
    world.nan_policy, world.nan_check_every = "trap", 1
    world.set_linvel(body, (float("nan"), 0.0, 0.0))
    try:
        world.step(1)
        _fail("nan_policy 'trap' did not raise")
    except FloatingPointError:
        pass
    world.nan_policy = "ignore"
    world.restore(kept)
    print("NaN guard: rolled back bitwise to the check 16 steps before at check interval "
          "16; 'trap' raised at interval 1")
    return rates


def _world_loaders(device, card):
    """Phase 14(b): examples/urdf_pendulum.py's robot in both joint forms and
    three MJCF models of the reference's tests, stepped on the card, then
    single steps from the card's state against the CPU."""
    import numpy as np
    import torch
    from rapier_tpu_torch.scenes import mjcf_model_world, urdf_pendulum_world

    rows = {}
    cases = [(f"urdf pendulum, {'multibody' if mb else 'impulse'} joints",
              lambda mb=mb: urdf_pendulum_world(mb, device=device)) for mb in (False, True)]
    cases += [("mjcf tendon (multibody)", lambda: mjcf_model_world("tendon", True, device=device)),
              ("mjcf connect", lambda: mjcf_model_world("connect", device=device)),
              ("mjcf gravcomp and mocap", lambda: mjcf_model_world("gravcomp_mocap",
                                                                   device=device))]
    for what, make in cases:
        t0 = time.time()
        world, h = make()
        world.build()
        if "tendon" in what:
            h.apply_controls(world, [0.8])
        if "mocap" in what:
            h.apply_keyframe(world, "home")
        z0 = world.body_translation(h.bodies["float"])[2] if "mocap" in what else None
        world.step(LOADER_STEPS)
        _finite(world.state)
        if "urdf" in what:
            base, arm1 = (world.body_translation(h.bodies[n]) for n in ("base", "arm1"))
            fact = abs(float(np.linalg.norm(arm1 - base)) - 0.1)
            ok = fact < (1e-4 if "multibody" in what else 0.05)
            label = "|anchor distance - 0.1|"
        elif "tendon" in what:
            fact = abs(h.joint_value(world, "j2") - h.joint_value(world, "j1"))
            ok, label = fact < 0.05, "|q2 - q1|"
        elif "connect" in what:
            fact = abs(float(np.linalg.norm(world.body_translation(h.bodies["a"])
                                            - world.body_translation(h.bodies["b"]))) - 1.0)
            ok, label = fact < 0.05, "|distance - 1|"
        else:
            fact = abs(float(world.body_translation(h.bodies["float"])[2] - z0))
            tip = h.site_position(world, "s_tip")
            ok = fact < 0.02 and np.allclose(tip, [0.5, 0.5, 2.0], atol=1e-5)
            label = "gravcomp drift"
        t_card = time.time() - t0
        print(f"{what}: {LOADER_STEPS} steps on the card in {t_card:.1f} s; {label} {fact:.3e}")
        if not ok:
            _fail(f"{what}: {label} {fact}")
        _cpu_step_agreement(what, world.state, world.params, steps=WORLD_CPU_STEPS,
                            witness=None)
        rows[what] = dict(check=fact, card_s=t_card)
    return rows


def phase_world(device, card):
    """Phase 14: the world's runtime API and the loaders.  Returns (the
    kernel's launches in the mutating bench run, the rows)."""
    t_phase = time.time()
    launches, bench, _ = _world_bench(device, card)
    loaders = _world_loaders(device, card)
    print(f"[phase 14: {time.time() - t_phase:.1f} s]")
    return launches, dict(bench_world=bench, loaders=loaders)


# ---------------------------------------------------------------------------
# Phase 15: hooks, the collision pipeline, scene queries and the controllers


def owp_batch(device, n_scenes: int, hooks=None, active_hooks=None):
    """`scenes.one_way_platforms3_world` replicated to `n_scenes` on
    `device`; returns (state, params, hooks, handles)."""
    from rapier_tpu_torch.scenes import one_way_platforms3_world, replicate_scene
    from rapier_tpu_torch.types import from_numpy

    kw = {} if hooks is None else {"hooks": hooks}
    world, h = one_way_platforms3_world(active_hooks=active_hooks, device=device, **kw)
    return (replicate_scene(from_numpy(world.build(), device), n_scenes), world.params,
            world.hooks, h)


def _friction_hooks():
    """The one-way filter and a modifier that scales the friction of the
    lanes it gates by OWP_FRICTION_SCALE."""
    from rapier_tpu_torch.pipeline.hooks import PhysicsHooks, one_way_platform_hook

    def scale_friction(bodies, colliders, man):
        return man._replace(friction=man.friction * OWP_FRICTION_SCALE)

    return PhysicsHooks(filter_contact_pair=one_way_platform_hook(
        (0.0, 1.0, 0.0)).filter_contact_pair, modify_solver_contacts=scale_friction)


def _launches_ok(what, launches, steps: int, k: int):
    """One launch a step of the kernel the gate picks at K lanes, none of
    the other; returns that kernel's count."""
    want = (0, steps) if k <= 128 else (steps, 0)
    kind = "contact_sweep_folded_kernel" if k <= 128 else "contact_sweep_kernel"
    print(f"{what}: K={k}, {steps} steps: contact_sweep_kernel {launches[0]}, folded "
          f"{launches[1]} launches ({kind} expected once a step)")
    if tuple(launches) != want:
        _fail(f"{what}: launches {launches}, expected {want}")
    return launches[1] if k <= 128 else launches[0]


def _counted_run(state, params, steps: int, hooks=None, control=None, each=None):
    """`run` with the contact-sweep counts set to 0 just before and read just
    after.  Returns (state, worst, launches, seconds)."""
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs

    torch.cuda.synchronize()
    cs.KERNEL.launches = cs.KERNEL.launches_folded = 0
    t0 = time.time()
    state, worst = run(state, params, steps, hooks, control, each)
    torch.cuda.synchronize()
    return state, worst, (cs.KERNEL.launches, cs.KERNEL.launches_folded), time.time() - t0


def _owp(device, card):
    """Phase 15(a): the one-way platforms on the contact-sweep kernel."""
    import torch
    from rapier_tpu_torch.pipeline.physics_pipeline import solve_path
    from rapier_tpu_torch.types import ACTIVE_HOOKS_FILTER_CONTACT_PAIR as FILTER
    from rapier_tpu_torch.types import ACTIVE_HOOKS_MODIFY_SOLVER_CONTACTS as MODIFY
    from rapier_tpu_torch.types import tree_map

    state, params, hooks, h = owp_batch(device, N_SCENES)
    k, path = state.contacts.max_pairs, solve_path(state, params)
    if path != "kernel":
        _fail(f"one_way_platforms3 takes the {path} path")
    max_below = torch.full((N_SCENES,), -1e9, device=device)
    capture = {}

    def each(st, done):
        max_below.copy_(torch.maximum(max_below, st.bodies.pos[:, h["below"], 1]))
        if done == OWP_CAPTURE:
            capture["owp"] = (tree_map(lambda x: x[:RERUN_SCENES_15].clone(), st), params,
                              hooks)

    state, worst, launches, secs = _counted_run(state, params, OWP_STEPS, hooks, each=each)
    rate = N_SCENES * OWP_STEPS / secs
    above = state.bodies.pos[:, h["above"], 1]
    print(f"one_way_platforms3 x {N_SCENES}: {rate:.1f} env-steps/s ({OWP_STEPS} steps in "
          f"{secs:.3f} s, the filter hook on every step; {card}); the ball from above at "
          f"y in [{float(above.min()):.4f}, {float(above.max()):.4f}] (must be > 0.4), the "
          f"ball from below reached y in [{float(max_below.min()):.4f}, "
          f"{float(max_below.max()):.4f}] (must be > 1.0); overflow {worst}")
    _finite(state)
    if any(worst.values()):
        _fail(f"one_way_platforms3 overflows: {worst}")
    if not (bool((above > 0.4).all()) and bool((max_below > 1.0).all())):
        _fail("one_way_platforms3: a ball from above fell through or one from below "
              "did not pass")
    n_launch = _launches_ok("one_way_platforms3", launches, OWP_STEPS, k)
    _replicas_equal("one_way_platforms3", state, ("bodies", "contacts"))

    # The modifier: friction scaled on the gated lanes, held to the CPU.
    mhooks = _friction_hooks()
    mstate, mparams, _, _ = owp_batch(device, OWP_MOD_SCENES, mhooks, FILTER | MODIFY)
    mstate, mworst = run(mstate, mparams, OWP_MOD_SETTLE, mhooks)
    touching = int(mstate.contacts.touching.sum())
    print(f"one_way_platforms3 with the friction modifier x {OWP_MOD_SCENES}: "
          f"{touching} touching lanes after {OWP_MOD_SETTLE} steps; overflow {mworst}")
    if touching < OWP_MOD_SCENES:
        _fail("one_way_platforms3 with the modifier: the ball from above is not in contact")
    _cpu_step_agreement(f"2 one_way_platforms3 scenes with the friction modifier after "
                        f"{OWP_MOD_SETTLE} steps", *_first((mstate, mparams), 2),
                        steps=OWP_MOD_CPU_STEPS, witness=None, hooks=mhooks)
    return n_launch, k, dict(env_steps_per_s=rate, k=k, **worst), capture["owp"]


def _collide(bench):
    """Phase 15(b): `collide` on the settled bench batch against the contact
    cache a step writes from the same state."""
    import torch
    from rapier_tpu_torch.pipeline.collision_pipeline import collide
    from rapier_tpu_torch.pipeline.physics_pipeline import step
    from rapier_tpu_torch.types import tree_map

    state, params = bench
    before = tree_map(lambda x: x.clone(), state)
    collided, ev = collide(state, params)
    stepped, _ = step(state, params)
    ms = _time_ms(lambda: collide(state, params), 5)
    for f in dataclasses.fields(before.bodies):
        if not torch.equal(getattr(collided.bodies, f.name), getattr(before.bodies, f.name)):
            _fail(f"collide changed bodies.{f.name}")
    for name in ("pair_key", "touching"):
        if not torch.equal(getattr(collided.contacts, name), getattr(stepped.contacts, name)):
            _fail(f"collide's {name} differs from the step's contact cache")
    n = state.bodies.pos.shape[0]
    print(f"collide on {n} settled bench scenes: {ms:.3f} ms ({n * 1e3 / ms:.1f} scenes/s); "
          f"pair keys and touching flags equal to a step's cache from the same state "
          f"({int(collided.contacts.touching.sum())} touching lanes); bodies bitwise "
          f"unchanged; started {int(ev.started_pairs.sum())}")
    return dict(collide_ms=ms)


def _query_inputs(device, n_scenes: int):
    """The seeded lidar fan, points and cast starts over the bench pile."""
    import numpy as np
    import torch

    rng = np.random.default_rng(15)
    side = int(round(LIDAR_RAYS ** 0.5))
    a = np.linspace(-LIDAR_HALF_ANGLE, LIDAR_HALF_ANGLE, side, dtype=np.float32)
    ax, az = np.meshgrid(a, a, indexing="ij")
    fan = np.stack([np.sin(ax), -np.cos(ax) * np.cos(az), np.sin(az)], -1).reshape(-1, 3)
    jitter = rng.normal(0, 0.02, (n_scenes, LIDAR_RAYS, 3)).astype(np.float32)
    dirs = fan[None] + jitter
    dirs[..., 1] = -np.abs(dirs[..., 1])
    origin = np.zeros((n_scenes, LIDAR_RAYS, 3), np.float32)
    origin[..., 1] = LIDAR_HEIGHT
    points = rng.uniform((-4, 0, -4), (4, 6, 4), (n_scenes, LIDAR_POINTS, 3)).astype(np.float32)
    starts = rng.uniform((-3, 9, -3), (3, 10, 3), (n_scenes, LIDAR_CASTS, 3)).astype(np.float32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return t(origin), t(dirs), t(points), t(starts)


def _lidar_queries(state, origin, dirs, points, starts):
    """(rays, projections, casts) of `_query_inputs` on `state`."""
    from rapier_tpu_torch.geometry import queries

    b, c = state.bodies, state.colliders
    return (queries.cast_ray(b, c, origin, dirs, meshes=state.meshes, hulls=state.hulls),
            queries.project_point(b, c, points, meshes=state.meshes, hulls=state.hulls),
            _casts(state, starts))


def _casts(state, starts):
    """A ball of CAST_RADIUS cast straight down from each start."""
    from rapier_tpu_torch.geometry import queries
    from rapier_tpu_torch.types import ShapeType

    n = starts.shape[0]
    down = starts.new_tensor([0.0, -1.0, 0.0]).expand(n, LIDAR_CASTS, 3)
    ident = starts.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(n, LIDAR_CASTS, 4)
    return queries.cast_shape(state.bodies, state.colliders, int(ShapeType.BALL),
                              [CAST_RADIUS], starts, ident, down, CAST_MAX_TOI,
                              meshes=state.meshes, hulls=state.hulls)


def _queries(device, bench, card):
    """Phase 15(c): lidar-sized queries on the settled bench batch."""
    import torch
    from rapier_tpu_torch.geometry import queries
    from rapier_tpu_torch.types import tree_map

    state, _ = bench
    n = state.bodies.pos.shape[0]
    origin, dirs, points, starts = _query_inputs(device, n)
    # Warm up on QUERY_WARM scenes, then time the checked calls.
    warm = tree_map(lambda x: x[:QUERY_WARM], state)
    _lidar_queries(warm, *(x[:QUERY_WARM] for x in (origin, dirs, points, starts)))
    rows, out = {}, {}
    for what, fn, count in (
            ("rays", lambda: queries.cast_ray(state.bodies, state.colliders, origin, dirs),
             n * LIDAR_RAYS),
            ("points", lambda: queries.project_point(state.bodies, state.colliders, points),
             n * LIDAR_POINTS),
            ("casts", lambda: _casts(state, starts), n * LIDAR_CASTS)):
        torch.cuda.synchronize()
        t0 = time.time()
        out[what] = fn()
        torch.cuda.synchronize()
        secs = time.time() - t0
        rows[f"{what}_per_s"] = count / secs
        print(f"queries: {count} {what} over {n} bench scenes in {secs * 1e3:.1f} ms: "
              f"{count / secs:.1f} {what}/s ({card})")
    rays, proj, casts = out["rays"], out["points"], out["casts"]
    if not bool(rays.hit.all()):
        _fail(f"lidar: {int((~rays.hit).sum())} downward rays missed")
    # Each hit point lies on its collider's surface.
    pts, dist, seen = queries.project_point_all(state.bodies, state.colliders, rays.point,
                                                solid=False)
    d_hit = torch.gather(dist, 2, rays.collider.unsqueeze(-1)).squeeze(-1)
    worst = float(d_hit.abs().max())
    print(f"lidar: every one of {n * LIDAR_RAYS} rays hit ({int((rays.collider == 0).sum())} "
          f"on the ground); each hit point's distance to its collider at most {worst:.3e} "
          f"(tol {RAY_ON_SURFACE})")
    if not worst <= RAY_ON_SURFACE:
        _fail(f"lidar: a hit point lies {worst} from its collider")
    if not (bool(casts.hit.all()) and bool(torch.isfinite(proj.distance).all())):
        _fail("queries: a downward cast missed or a projection is not finite")
    # Two scenes against the CPU.
    sl = slice(0, QUERY_CPU_SCENES)
    cpu = tree_map(lambda x: x[sl].cpu(), state)
    got = _lidar_queries(cpu, *(x[sl].cpu() for x in (origin, dirs, points, starts)))
    card_r = [tuple(f[sl].cpu() for f in r) for r in (rays, proj, casts)]
    ray_tol = QUERY_TOL * max(1.0, float(rays.toi[sl].abs().max()))
    cast_tol = 2 * CAST_MAX_TOI / 8 / 2 ** 12
    gaps = {}
    for name, a, b, tol, t_idx, c_idx in (("ray toi", card_r[0], got[0], ray_tol, 1, 2),
                                          ("projection distance", card_r[1], got[1],
                                           QUERY_TOL, 2, 0),
                                          ("cast toi", card_r[2], got[2], cast_tol, 1, 2)):
        d = float((a[t_idx] - b[t_idx]).abs().max())
        other = a[c_idx] != b[c_idx]
        gaps[name] = d
        print(f"queries GPU vs CPU, {QUERY_CPU_SCENES} scenes: max |d {name}| {d:.3e} (tol "
              f"{tol:.3e}), colliders differing in {int(other.sum())} queries")
        if not (d <= tol and not bool(other.any())):
            _fail(f"queries: the card's {name} disagrees with the CPU")
    rows.update(max_ray_gap_to_surface=worst, **{f"cpu_gap_{k.replace(' ', '_')}": v
                                                for k, v in gaps.items()})
    return rows


def vehicle_batch(device, n_scenes: int):
    """`scenes.vehicle_world` replicated to `n_scenes` with its controller:
    (state, params, control(state) -> state, chassis)."""
    from rapier_tpu_torch.control.vehicle import (
        default_wheels,
        update_vehicle,
        with_chassis_velocities,
    )
    from rapier_tpu_torch.scenes import (
        VEHICLE_ENGINE,
        VEHICLE_STEER,
        VEHICLE_WHEELS,
        replicate_scene,
        vehicle_world,
    )
    from rapier_tpu_torch.types import from_numpy

    world, h = vehicle_world(device=device)
    state = replicate_scene(from_numpy(world.build(), device), n_scenes)
    params, chassis = world.params, h["chassis"]
    wheels = default_wheels(VEHICLE_WHEELS, radius=0.25, rest_length=0.3, device=device)
    engine = [VEHICLE_ENGINE] * 4
    dt = float(params.dt)

    def control(st):
        upd = update_vehicle(st.bodies, st.colliders, chassis, wheels, engine, [0.0] * 4,
                             VEHICLE_STEER, dt)
        return dataclasses.replace(st, bodies=with_chassis_velocities(st.bodies, chassis, upd))

    return state, params, control, chassis


def _vehicles(device, card):
    """Phase 15(d), vehicles: tests/test_controllers.py's curve on every
    scene."""
    import torch
    from rapier_tpu_torch.pipeline.physics_pipeline import step
    from rapier_tpu_torch.types import tree_map
    from rapier_tpu_torch.utils import counters

    state, params, control, chassis = vehicle_batch(device, N_SCENES)
    k = state.contacts.max_pairs
    capture = {}

    def each(st, done):
        if done == VEHICLE_CAPTURE:
            capture["vehicles"] = (tree_map(lambda x: x[:RERUN_SCENES_15].clone(), st),
                                   params, control)

    state, worst, launches, secs = _counted_run(state, params, VEHICLE_STEPS, control=control,
                                                each=each)
    rate = N_SCENES * VEHICLE_STEPS / secs
    p = state.bodies.pos[:, chassis]
    _finite(state)
    print(f"vehicles x {N_SCENES}: {rate:.1f} env-steps/s ({VEHICLE_STEPS} steps of "
          f"update_vehicle and step in {secs:.3f} s; {card}); chassis |x| in "
          f"[{float(p[:, 0].abs().min()):.4f}, {float(p[:, 0].abs().max()):.4f}] (must be "
          f"> 0.8), y in [{float(p[:, 1].min()):.4f}, {float(p[:, 1].max()):.4f}] (must be in "
          f"(0.2, 1.0)); overflow {worst}")
    if any(worst.values()):
        _fail(f"vehicles overflow: {worst}")
    if not (bool((p[:, 0].abs() > 0.8).all()) and bool(((p[:, 1] > 0.2) & (p[:, 1] < 1.0)).all())):
        _fail("vehicles: a vehicle did not hold the curve")
    n_launch = _launches_ok("vehicles", launches, VEHICLE_STEPS, k)
    tr = counters.trace_step(state, params, steps=3,
                             step_fn=lambda s, pr: step(control(s), pr))
    _print_trace("vehicles", tr, card)
    return n_launch, k, dict(env_steps_per_s=rate, k=k, **worst, **tr), capture["vehicles"]


def _print_trace(what, tr, card):
    share = "not measured" if tr["device_share"] is None else f"{tr['device_share']:.1%}"
    print(f"{what}: under the profiler an env-step is {tr['wall_ms']:.3f} ms with "
          f"{tr['kernels']:.0f} device kernels and copies (device busy {share}) ({card})")


def _characters(device, card):
    """Phase 15(d), characters: tests/test_controllers.py's push on every
    scene."""
    import torch
    from rapier_tpu_torch.control.character import (
        CharacterControllerOptions,
        move_shape,
        solve_character_collision_impulses,
    )
    from rapier_tpu_torch.scenes import (
        CHARACTER_CAPSULE,
        CHARACTER_MASS,
        CHARACTER_MOVE,
        CHARACTER_START,
        character_world,
        replicate_scene,
    )
    from rapier_tpu_torch.types import ShapeType, from_numpy, tree_map
    from rapier_tpu_torch.utils import counters

    world, h = character_world(device=device)
    state = replicate_scene(from_numpy(world.build(), device), N_SCENES)
    params, box = world.params, h["box"]
    prm = torch.zeros(12)
    prm[:7] = torch.tensor(CHARACTER_CAPSULE)
    opts = CharacterControllerOptions()
    rot = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    start = torch.tensor(CHARACTER_START, device=device)

    def push(st):
        dev = st.bodies.pos.device
        mv = move_shape(st.bodies, st.colliders, int(ShapeType.CAPSULE), prm, start.to(dev),
                        rot.to(dev), CHARACTER_MOVE, opts)
        bodies = solve_character_collision_impulses(
            st.bodies, st.colliders, int(ShapeType.CAPSULE), prm, start.to(dev) + mv.translation,
            rot.to(dev), mv.remaining, float(params.dt), CHARACTER_MASS, opts)
        return dataclasses.replace(st, bodies=bodies), mv

    two = tree_map(lambda x: x[:QUERY_CPU_SCENES].clone(), state)
    torch.cuda.synchronize()
    t0 = time.time()
    state, mv = push(state)
    torch.cuda.synchronize()
    move_s = time.time() - t0
    x0 = state.bodies.pos[:, box, 0].clone()
    v1 = state.bodies.linvel[:, box, 0]
    state, worst, launches, secs = _counted_run(state, params, CHAR_STEPS)
    moved = state.bodies.pos[:, box, 0] - x0
    print(f"characters x {N_SCENES}: the move and push in {move_s * 1e3:.1f} ms "
          f"({N_SCENES / move_s:.1f} character moves/s), then {CHAR_STEPS} steps at "
          f"{N_SCENES * CHAR_STEPS / secs:.1f} env-steps/s ({card}); hit an obstacle in "
          f"{int(mv.hit_obstacle.sum())} scenes, box velocity after the push in "
          f"[{float(v1.min()):.4f}, {float(v1.max()):.4f}] (must be > 0.3), box moved "
          f"[{float(moved.min()):.4f}, {float(moved.max()):.4f}] (must be > 0.05); "
          f"overflow {worst}")
    _finite(state)
    if any(worst.values()):
        _fail(f"characters overflow: {worst}")
    if not (bool(mv.hit_obstacle.all()) and bool((v1 > 0.3).all())
            and bool((moved > 0.05).all())):
        _fail("characters: a box was not pushed forward")
    n_launch = _launches_ok("characters", launches, CHAR_STEPS, state.contacts.max_pairs)
    # Two scenes' move and push on the CPU.
    card_two, card_mv = push(two)
    cpu_two, cpu_mv = push(tree_map(lambda x: x.cpu(), two))
    tol = 2 * (float(torch.linalg.norm(torch.tensor(CHARACTER_MOVE))) + opts.offset) / 8 / 2 ** 12
    dt_ = float((card_mv.translation.cpu() - cpu_mv.translation).abs().max())
    dv = float((card_two.bodies.linvel.cpu() - cpu_two.bodies.linvel).abs().max())
    scale = float(cpu_two.bodies.linvel.abs().max())
    print(f"characters GPU vs CPU, {QUERY_CPU_SCENES} scenes: max |d translation| {dt_:.3e} "
          f"(tol {tol:.3e}), max |d linvel| after the push {dv:.3e} (tol {QUERY_TOL} x "
          f"{scale:.4g})")
    if not (dt_ <= tol and dv <= QUERY_TOL * max(1.0, scale)):
        _fail("characters: the card's move or push disagrees with the CPU")
    rate = N_SCENES * CHAR_STEPS / secs
    tr = counters.trace_step(state, params, steps=3)
    _print_trace("characters (the steps after the push)", tr, card)
    return n_launch, state.contacts.max_pairs, dict(
        moves_per_s=N_SCENES / move_s, env_steps_per_s=rate, **worst, **tr)


def phase_queries(device, card, bench):
    """Phase 15: hooks on the kernel, the collision pipeline, queries at a
    lidar's size and the controllers.  `bench`: phase 4's settled bench
    batch with its params.  Returns (launches by path and kernel, the rows,
    the captures phases 7 and 8 reuse)."""
    t_phase = time.time()
    owp_n, owp_k, owp, owp_cap = _owp(device, card)
    rows = dict(one_way_platforms3=owp, collide=_collide(bench), queries=_queries(device, bench,
                                                                                  card))
    veh_n, veh_k, rows["vehicles"], veh_cap = _vehicles(device, card)
    chr_n, chr_k, rows["characters"] = _characters(device, card)
    launches = {"one_way_platforms3": (owp_k, owp_n), "vehicles": (veh_k, veh_n),
                "characters": (chr_k, chr_n)}
    took = time.time() - t_phase
    rows["phase_s"] = took
    print(f"[phase 15: {took:.1f} s]")
    return launches, rows, dict(owp=owp_cap, vehicles=veh_cap)


def _f64(fn, *args, **kw):
    """`fn` with the precision axis at f64 (the builders read it), restored
    after."""
    from rapier_tpu_torch import precision

    precision.set_precision("f64")
    try:
        return fn(*args, **kw)
    finally:
        precision.set_precision("f32")


def _peak_gib(fn):
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**30


def _far_pyramid_f64(device, card):
    """Phase 16(a), part 1: upstream's far pyramid at f64, one scene."""
    import numpy as np
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.pipeline.physics_pipeline import solve_path
    from rapier_tpu_torch.scenes import s2d_far_pyramid_world

    world, h = _f64(s2d_far_pyramid_world, device=device)
    _f64(world.build)
    state, params = world.state, world.params
    if state.bodies.pos.dtype != torch.float64:
        _fail(f"the far pyramid built at f64 holds {state.bodies.pos.dtype}")
    route = solve_path(state, params)
    cs.KERNEL.launches = cs.KERNEL.launches_folded = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, worst = run(state, params, FAR_STEPS)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launches = cs.KERNEL.launches + cs.KERNEL.launches_folded
    pos = state.bodies.pos[0].cpu().numpy()
    origin = np.asarray(h["origin"])
    err, idx = 0.0, 0
    for row in range(10):
        for _ in range(10 - row):
            err = max(err, abs(pos[h["boxes"][idx], 1] - origin[1] - (0.5 + row)))
            idx += 1
    print(f"far pyramid at f64 (55 boxes at (1e5, -8e4), one scene, route {route}): "
          f"{FAR_STEPS / took:.3f} steps/s ({FAR_STEPS} steps in {took:.3f} s; {card}); "
          f"largest rest-height error {err:.6f} (tol {FAR_TOL}); contact-sweep launches "
          f"{launches}; overflow {worst}")
    if route == "kernel" or launches:
        _fail("the far pyramid's 2x2 block solve reached the contact-sweep kernel")
    if not err < FAR_TOL or any(worst.values()):
        _fail(f"the far pyramid does not stand at f64 (error {err}, overflow {worst})")
    return dict(steps_per_s=FAR_STEPS / took, rest_error=err, route=route, launches=launches)


def _bench_dtypes(device, card):
    """Phase 16(a), part 2: 4096 bench scenes at f64 and at float32, both
    on the kernel route."""
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.pipeline.physics_pipeline import solve_path

    rows, capture = {}, None
    for kind in ("f64", "f32"):
        state, params = (_f64(bench_world, device, N_SCENES) if kind == "f64"
                         else bench_world(device, N_SCENES))
        route = solve_path(state, params)
        cs.KERNEL.launches = cs.KERNEL.launches_folded = 0
        state, worst = run(state, params, F64_SETTLE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (state, worst_t), peak = _peak_gib(lambda: run(state, params, F64_TIMED))
        took = time.perf_counter() - t0
        launches, folded = cs.KERNEL.launches, cs.KERNEL.launches_folded
        rate = N_SCENES * F64_TIMED / took
        worst = {k: max(worst[k], worst_t[k]) for k in worst}
        print(f"bench at {kind}, {N_SCENES} scenes, route {route}: {rate:.1f} env-steps/s "
              f"({F64_TIMED} steps in {took:.3f} s after {F64_SETTLE}; {card}); peak device "
              f"memory in the timed steps {peak:.3f} GiB; contact-sweep launches {launches} + "
              f"folded {folded}; overflow {worst}; dtype {state.bodies.pos.dtype}")
        if (route != "kernel" or launches != F64_SETTLE + F64_TIMED or folded
                or any(worst.values())):
            _fail(f"bench at {kind}: route {route}, launches {launches} + folded {folded}, "
                  f"overflow {worst}")
        _replicas_equal(f"bench at {kind}", state, ("bodies", "contacts"))
        print(f"bench at {kind}: all {N_SCENES} scenes bitwise equal to scene 0 after "
              f"{F64_SETTLE + F64_TIMED} steps")
        stages = _stages(f"bench step at {kind}, {N_SCENES} scenes, kernel", state, params,
                         card, trace_steps=1)
        rows[kind] = dict(env_steps_per_s=rate, peak_gib=peak, route=route,
                          launches=launches, launches_folded=folded, kernels=stages["kernels"],
                          device_share=stages["device_share"])
        if kind == "f64":
            capture = (state, params)
        del state
    rows["f64_over_f32"] = rows["f64"]["env_steps_per_s"] / rows["f32"]["env_steps_per_s"]
    print(f"bench kernel route: f64 / f32 env-steps/s = {rows['f64_over_f32']:.3f}")
    return rows, capture


def _sharded_bench(device, card):
    """Phase 16(b): 4096 bench scenes sharded: a mesh of every card (in
    process with one card, one NCCL rank a card with several), then 2 gloo
    ranks sharing card 0; the gathered state bitwise equal to the unsharded
    step's."""
    import torch
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.parallel import sharding as sh
    from rapier_tpu_torch.scenes import mixed_primitives_world

    world = mixed_primitives_world(num_layers=4, grid=5, max_pairs=512, device=device)
    world.params = world.params.replace(max_solver_pairs=256)
    scene, params = world.build(), world.params        # one scene, numpy leaves
    n_cards = torch.cuda.device_count()
    rows = {}

    # The unsharded step of the same 4096 scenes: a mesh of the one card.
    state, _ = bench_world(device, N_SCENES)
    mesh = sh.make_mesh([device])
    block = sh.shard_batch(state, mesh)
    del state
    sharded_step = sh.make_sharded_step(mesh)
    cs.KERNEL.launches = cs.KERNEL.launches_folded = 0
    worst = 0
    for i in range(SHARD_STEPS):
        if i == SHARD_STEPS - SHARD_TIMED:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        block, ev = sharded_step(block, params)
        worst = max(worst, int(ev.broadphase_overflow.max()) + int(ev.solver_overflow.max()))
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    one = dict(launches=cs.KERNEL.launches, launches_folded=cs.KERNEL.launches_folded,
               env_steps_per_s=N_SCENES * SHARD_TIMED / took)
    digest = sh.state_digest(sh.gather_batch(block, mesh))
    del block
    print(f"sharded bench, a mesh of the one card in this process: {one['env_steps_per_s']:.1f} "
          f"env-steps/s ({N_SCENES} scenes x {SHARD_TIMED} steps in {took:.3f} s after "
          f"{SHARD_STEPS - SHARD_TIMED}; {card}); launches {one['launches']} + folded "
          f"{one['launches_folded']}; overflow {worst}")
    if one["launches"] != SHARD_STEPS or one["launches_folded"] or worst:
        _fail(f"sharded bench on one card: {one}, overflow {worst}")
    rows["one_card"] = one
    torch.cuda.empty_cache()        # the ranks are other processes on this card
    runs = [("2 gloo ranks on card 0", ["cuda:0", "cuda:0"], "gloo")]
    if n_cards > 1:
        runs.insert(0, (f"{n_cards} NCCL ranks, a card each",
                        [f"cuda:{i}" for i in range(n_cards)], "nccl"))
    for what, devices, backend in runs:
        stats, first_s = sh.sharded_rollout(scene, params, SHARD_STEPS, devices,
                                            replicate=N_SCENES, timed=SHARD_TIMED,
                                            backend=backend)
        per_rank = [s["scenes"] * SHARD_TIMED / s["timed_s"] for s in stats]
        total = N_SCENES * SHARD_TIMED / max(s["timed_s"] for s in stats)
        launches = [(s["launches"], s["launches_folded"]) for s in stats]
        print(f"sharded bench, {what}: {total:.1f} env-steps/s in total, per rank "
              + ", ".join(f"{r:.1f}" for r in per_rank)
              + f" ({[s['scenes'] for s in stats]} scenes; {card}); spawn to the first "
              f"finished step {first_s:.1f} s; launches per rank (block, folded) {launches}; "
              f"gathered state {'bitwise equal' if stats[0]['digest'] == digest else 'DIFFERS'}"
              f" to the unsharded step's")
        if stats[0]["digest"] != digest:
            _fail(f"sharded bench ({what}) differs from the unsharded step")
        if any(l != (SHARD_STEPS, 0) for l in launches) or any(s["overflow"] for s in stats):
            _fail(f"sharded bench ({what}): launches {launches}")
        rows[what] = dict(env_steps_per_s=total, per_rank=per_rank, spawn_to_first_s=first_s,
                          launches=[l[0] for l in launches])
    return rows


def _render_pair(what, state):
    """Phase 16(c): debug render of scene 0 on the card, then of the same
    state moved to the CPU: counts and colors equal, coordinates within
    RENDER_TOL."""
    import numpy as np
    import torch
    from rapier_tpu_torch.types import tree_map
    from rapier_tpu_torch.utils.debug_render import DebugRenderMode, debug_render

    one = tree_map(lambda x: x[:1] if x.dim() else x, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = debug_render(one, mode=DebugRenderMode.ALL)
    card_ms = (time.perf_counter() - t0) * 1e3
    cpu_state = tree_map(lambda x: x.cpu(), one)
    t0 = time.perf_counter()
    cpu = debug_render(cpu_state, mode=DebugRenderMode.ALL)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    gap = max(float(np.abs(a - b).max(initial=0.0)) for a, b in zip(card[:2], cpu[:2]))
    print(f"debug render, {what}: {len(card[0])} lines in {card_ms:.1f} ms from the card, "
          f"{cpu_ms:.1f} ms from the CPU; largest coordinate gap {gap:.3e} (tol {RENDER_TOL})")
    if len(card[0]) != len(cpu[0]) or not np.array_equal(card[2], cpu[2]) or gap > RENDER_TOL:
        _fail(f"debug render differs between the card and the CPU ({what})")
    if not len(card[0]):
        _fail(f"debug render drew nothing ({what})")
    return dict(lines=len(card[0]), card_ms=card_ms, cpu_ms=cpu_ms)


def _hull_mesh_world(device):
    """tests/test_world_api.py's debug-render scene: a trimesh quad and a
    convex hull."""
    import numpy as np
    from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld(device=device)
    g = w.insert_body(RigidBodyBuilder.fixed())
    verts = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32)
    w.insert_collider(ColliderBuilder.trimesh(verts, np.array([[0, 1, 2], [0, 2, 3]],
                                                               np.int32)), g)
    hb = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, 2, 0)))
    w.insert_collider(ColliderBuilder.convex_hull(
        [(x, y, z) for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)]), hb)
    w.build()
    w.step(3)
    return w.state


def phase_remainder(device, card, captures):
    """Phase 16: the f64 axis, scene sharding and debug render.  `captures`
    holds phase 4's settled bench batch ("bench"), phase 9's joints3 batch
    ("joints3") and phase 11's heightfield3 capture ("heightfield3"), each
    with its params.  Returns (the launches of its paths, its rows, phase
    7's and 8's f64 capture)."""
    t_phase = time.time()
    rows = dict(far_pyramid_f64=_far_pyramid_f64(device, card))
    rows["bench_dtypes"], bench64 = _bench_dtypes(device, card)
    rows["sharding"] = _sharded_bench(device, card)
    rows["render"] = {
        "bench": _render_pair("scene 0 of the settled bench batch", captures["bench"][0]),
        "joints3": _render_pair("joints3 scene 0", captures["joints3"][0]),
        "heightfield3": _render_pair("heightfield3 scene 0", captures["heightfield3"][0]),
        "trimesh_hull": _render_pair("the trimesh and hull scene", _hull_mesh_world(device)),
    }
    shard = rows["sharding"]
    dtypes = rows["bench_dtypes"]
    # Each path's (block, folded) launches, both counted (the sharded runs
    # fail on any folded launch).
    launches = {"far_pyramid_f64": (0, 0),
                **{f"bench_{kind}": (dtypes[kind]["launches"], dtypes[kind]["launches_folded"])
                   for kind in ("f64", "f32")},
                "sharded_bench_one_card": (shard["one_card"]["launches"], 0),
                "sharded_bench_2_ranks": (sum(shard["2 gloo ranks on card 0"]["launches"]), 0)}
    took = time.time() - t_phase
    rows["phase_s"] = took
    print(f"[phase 16: {took:.1f} s]")
    return launches, rows, bench64


def _remainder_captures(device):
    """With --remainder-only: the batches phase 16 renders, made here (a
    bench batch of 64 scenes settled 60 steps, 2 joints3 scenes after 30,
    2 heightfield3 scenes after 60)."""
    from rapier_tpu_torch.scenes import heightfield3_world

    bench = bench_world(device, 64)
    joints = joints3_batch(device, 2)[:2]
    hf = mesh_batch(device, heightfield3_world, 2)[:2]
    return dict(bench=(run(*bench, 60)[0], bench[1]), joints3=(run(*joints, 30)[0], joints[1]),
                heightfield3=(run(*hf, 60)[0], hf[1]))


def _f64_cpu_agreement(state, params):
    """Phase 7's f64 part: F64_CPU_SCENES bench scenes at f64 settled on the
    card, then F64_CPU_STEPS free steps on the card and on the CPU, against
    an f64 1-ulp witness (two CPU runs whose starts differ by 1 ulp in every
    body's height)."""
    import torch
    from rapier_tpu_torch.types import tree_map

    t0 = time.time()
    state, _ = run(tree_map(lambda x: x[:F64_CPU_SCENES].clone(), state), params,
                   F64_CPU_SETTLE)
    cpu = tree_map(lambda x: x.cpu(), state)
    wit = _nudge_up(tree_map(lambda x: x.clone(), cpu))
    gpu, _ = run(state, params, F64_CPU_STEPS)
    cpu, _ = run(cpu, params, F64_CPU_STEPS)
    wit, _ = run(wit, params, F64_CPU_STEPS)
    imp = ("impulse", "tangent_impulse", "warmstart_impulse")
    worst = []
    for part, names in (("bodies", ("pos", "rot", "linvel", "angvel")), ("contacts", imp)):
        scale = max(float(getattr(getattr(cpu, part), n).abs().max()) for n in names)
        for n in names:
            a = getattr(getattr(gpu, part), n).cpu()
            b, w = getattr(getattr(cpu, part), n), getattr(getattr(wit, part), n)
            gap, wgap = float((a - b).abs().max()), float((w - b).abs().max())
            tol = max(F64_WITNESS_FACTOR * wgap,
                      F64_ULPS * torch.finfo(torch.float64).eps * scale)
            worst.append((n, gap, tol))
    print(f"GPU vs CPU path at f64, {F64_CPU_SCENES} bench scenes after {F64_CPU_SETTLE} "
          f"steps, {F64_CPU_STEPS} free steps: " + ", ".join(
              f"{n} {g:.3e} (tol {t:.3e})" for n, g, t in worst)
          + f" [{time.time() - t0:.1f} s]")
    if gpu.bodies.pos.dtype != torch.float64 or any(g > t for _, g, t in worst):
        _fail("the card disagrees with the CPU at f64")


def phase_cpu_agreement_16(device, captures):
    """With --remainder-only: phases 7's and 8's parts for phase 16."""
    _f64_cpu_agreement(*captures["bench_f64"])
    _rerun_equal(f"{F64_RERUN_SCENES}-scene f64 bench", *_first(captures["bench_f64"],
                                                                   F64_RERUN_SCENES),
                 ("bodies", "contacts"))


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


def phase_rest(device, card, stacks, steps: int, colors=None):
    """With --rest-steps: each pyramid stack stepped `steps` steps (at
    `colors` colors, else the default), its top box's height above rest and
    vertical velocity printed every REST_EVERY steps (does the pile come to
    rest?), beside the lanes that step's blocked layout left to the Jacobi
    tail at the run's colors and at the default 16 (ROADMAP F4)."""
    import torch
    from rapier_tpu_torch.dynamics.solver.coloring import solve_caps
    from rapier_tpu_torch.pipeline import physics_pipeline as pp

    coloring, last = pp.color_constraints_blocked, {}

    def record(*a):
        out = coloring(*a)
        last["args"] = a
        return out

    def tail_at(params, max_colors):
        a = last["args"]
        caps = solve_caps(params.max_solver_pairs, a[0].shape[-1], max_colors)
        return int((coloring(*a[:-1], caps)[0] == len(caps) - 1).sum())

    pp.color_constraints_blocked = record
    try:
        for stack in stacks:
            state, params, boxes = pyramid_batch(device, stack, colors)
            rest, worst, t0 = 2 * stack - 1, {}, time.time()
            for done in range(REST_EVERY, steps + 1, REST_EVERY):
                state, w = run(state, params, REST_EVERY)
                worst = {k: max(v, worst.get(k, 0)) for k, v in w.items()}
                _finite(state)
                top = float(state.bodies.pos[0, boxes, 1])
                vy = float(state.bodies.linvel[0, boxes, 1])
                tails = {c: tail_at(params, c) for c in sorted({params.max_colors, 16})}
                torch.cuda.synchronize()
                print(f"pyramid stack {stack} at {params.max_colors} colors, step {done}: top "
                      f"box {top - rest:+.4f} from rest ({rest}), vertical velocity "
                      f"{vy:+.4f} m/s; touching pairs {int(state.contacts.touching.sum())}, "
                      f"solver lanes {int(last['args'][4].sum())}, Jacobi tail lanes by "
                      f"colors {tails}, sleeping {int(state.bodies.sleeping.sum())}; overflow "
                      f"{worst}; {time.time() - t0:.1f} s ({card})", flush=True)
    finally:
        pp.color_constraints_blocked = coloring


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", nargs="+", metavar="DIR",
                    help="time the kernels of these unpacked checkouts beside this one's "
                         "and run nothing else")
    ap.add_argument("--pyramid", type=int, nargs="*", default=[], metavar="STACK",
                    help="also run the pyramid phase at these stack heights (e.g. 24, "
                         "pyramid3.rs's, or 31, BASELINE.json's 10,416-box pyramid)")
    ap.add_argument("--rest-steps", type=int, metavar="STEPS",
                    help="step the --pyramid stacks (default 31) STEPS steps each, print the "
                         f"top box's distance from rest every {REST_EVERY} steps, and run "
                         "nothing else")
    ap.add_argument("--colors", type=int, metavar="N",
                    help="with --rest-steps: step the stacks at N colors (SimParams.max_colors)")
    ap.add_argument("--world-only", action="store_true",
                    help="run the build and phase 14 (the world's runtime API and the "
                         "loaders) only")
    ap.add_argument("--s2d-only", action="store_true",
                    help="run the build and phase 10 (the 2D slice) only")
    ap.add_argument("--heightfield-full", action="store_true",
                    help="also run phase 11(d): upstream's heightfield3 at its size, one "
                         "scene of 1,280 bodies")
    ap.add_argument("--meshes-only", action="store_true",
                    help="run the build and phase 11(a) (with (d) under "
                         "--heightfield-full) only")
    ap.add_argument("--primitives-full", action="store_true",
                    help="also run phase 12(d): upstream's primitives3 at its size, one "
                         "scene of 1,280 bodies")
    ap.add_argument("--convex-only", action="store_true",
                    help="run the build and phase 12(a), (b) (with (d) under "
                         "--primitives-full) only")
    ap.add_argument("--ccd-only", action="store_true",
                    help="run the build and phase 13 (CCD and the multibody remainder) only")
    ap.add_argument("--kernels-only", action="store_true",
                    help="run the build and phases 2 and 3 at float32 and float64 (the "
                         "contact-sweep kernels against the plain version, timed) only")
    ap.add_argument("--remainder-only", action="store_true",
                    help="run the build and phase 16 (the f64 axis, scene sharding and debug "
                         "render; on batches settled for it) and its phase 7 and 8 parts only")
    ap.add_argument("--queries-only", action="store_true",
                    help="run the build and phase 15 (hooks, the collision pipeline, queries "
                         "and the controllers; on a bench batch settled here) only")
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
    if args.rest_steps:
        phase(phase_rest, device, card, tuple(args.pyramid) or (31,), args.rest_steps,
              args.colors)
        return
    if args.world_only:
        print(json.dumps({"world": phase(phase_world, device, card)[1], "card": card}))
        return
    if args.s2d_only:
        print(json.dumps({"s2d": phase(phase_2d, device, card)[0],
                          "card": card}))
        return
    if args.meshes_only:
        rows = {"heightfield3": phase(phase_meshes, device, card)[1:3]}
        if args.heightfield_full:
            rows["heightfield3_full"] = phase(phase_heightfield_full, device, card)
        print(json.dumps({"meshes": rows, "card": card}))
        return
    if args.convex_only:
        rows = {"primitives3": phase(phase_convex, device, card)[:3]}
        if args.primitives_full:
            rows["primitives3_full"] = phase(phase_primitives_full, device, card)
        print(json.dumps({"convex": rows, "card": card}))
        return

    if args.ccd_only:
        print(json.dumps({"ccd_multibody": phase(phase_ccd_multibody, device, card)[1],
                          "card": card}))
        return
    if args.queries_only:
        state, params = bench_world(device, N_SCENES)
        state, _ = run(state, params, SETTLE)
        launches, rows, captures = phase(phase_queries, device, card, (state, params))
        phase(phase_cpu_agreement_15, device, captures)
        print(json.dumps({"queries": rows, "launches": launches, "card": card}))
        return

    if args.kernels_only:
        (block, bench), (folded, quadrupeds) = (phase(phase_kernel, device, card),
                                                phase(phase_folded_kernel, device, card))
        print(json.dumps({"kernels_only": {
            "contact_sweep_kernel": block, "contact_sweep_folded_kernel": folded,
            "contact_sweep_kernel_f64": phase(phase_kernel_f64, device, card, bench),
            "contact_sweep_folded_kernel_f64": phase(phase_folded_kernel_f64, device, card,
                                                     quadrupeds)}, "card": card}))
        return
    if args.remainder_only:
        launches, rows, bench64 = phase(phase_remainder, device, card,
                                        _remainder_captures(device))
        phase(phase_cpu_agreement_16, device, dict(bench_f64=bench64))
        print(json.dumps({"remainder": rows, "launches": launches, "card": card}))
        return

    block, settled = phase(phase_kernel, device, card)
    folded, quadrupeds = phase(phase_folded_kernel, device, card)
    block64 = phase(phase_kernel_f64, device, card, settled)
    folded64 = phase(phase_folded_kernel_f64, device, card, quadrupeds)
    block["launches"], _, bench_stages, bench = phase(phase_main_path, device, card)
    folded["launches"], _ = phase(phase_robots, device, card)
    stacks = tuple(sorted(set(PYRAMID_STACKS) | set(args.pyramid)))
    pyramids, pyramid16 = phase(phase_pyramid, device, card, stacks)
    s2d, s2d_big = phase(phase_2d, device, card)
    hf_launches, meshes, hf_kernel, hf_in_contact = phase(phase_meshes, device, card)
    meshes = {"heightfield3": meshes}
    if args.heightfield_full:
        meshes["heightfield3_full"] = phase(phase_heightfield_full, device, card)
    p3_launches, convex, p3_kernel, p3_in_contact = phase(phase_convex, device, card)
    convex = {"primitives3": convex}
    if args.primitives_full:
        convex["primitives3_full"] = phase(phase_primitives_full, device, card)
    joints, joints3 = phase(phase_joints, device, card)
    by_path, ccd_multibody, ccd_captures = phase(phase_ccd_multibody, device, card)
    world_launches, world = phase(phase_world, device, card)
    q_launches, queries, q_captures = phase(phase_queries, device, card, bench)
    captures = dict(bench=bench, quadruped=quadrupeds, pyramid=pyramid16, s2d_big=s2d_big,
                    heightfield3=hf_in_contact, primitives3=p3_in_contact, joints3=joints3,
                    **ccd_captures, **q_captures)
    r_launches, remainder, captures["bench_f64"] = phase(phase_remainder, device, card,
                                                         captures)
    phase(phase_cpu_agreement, device, captures)
    phase(phase_determinism, device, captures)
    print(f"[all phases, the build included: {time.time() - start:.1f} s of the 1,200 allowed]")

    print(json.dumps({"pyramid": pyramids, "s2d": s2d, "bench_step": bench_stages,
                      "joints": joints, "meshes": meshes, "convex": convex,
                      "ccd_multibody": ccd_multibody, "world": world, "queries": queries,
                      "remainder": remainder, "card": card}))
    # Each path's launches, its counts set to 0 just before it and read just
    # after; `launches` is the bench's, the contract's main path.
    block["launches_by_path"] = {"bench": block["launches"], "heightfield3": hf_launches,
                                 "primitives3": p3_launches, "ccd3": by_path["ccd3"],
                                 "world": world_launches}
    block["heightfield3_k640"] = hf_kernel
    block["primitives3_k256"] = p3_kernel
    folded["launches_by_path"] = {"robots": folded["launches"],
                                  "multibody_arm": by_path["multibody_arm"]}
    for path, (k, n) in q_launches.items():
        (folded if k <= 128 else block)["launches_by_path"][path] = n
    # Phase 16: each path's block and folded launches, the f64 paths' to the
    # float64 builds, whose main path is the f64 bench.
    block64["launches"], folded64["launches"] = r_launches["bench_f64"]
    for path, (n_block, n_folded) in r_launches.items():
        f64 = path.endswith("_f64")
        (block64 if f64 else block).setdefault("launches_by_path", {})[path] = n_block
        (folded64 if f64 else folded).setdefault("launches_by_path", {})[path] = n_folded
    source = "rapier_tpu_torch/csrc/contact_sweep.cu"
    print(json.dumps({"kernels": [
        {"name": "contact_sweep_kernel", "route": "cuda", "source": source,
         "replaces": "rapier_tpu/dynamics/solver/pallas_sweep.py:517",
         "library_ms": None, **block},
        {"name": "contact_sweep_folded_kernel", "route": "cuda", "source": source,
         "replaces": "rapier_tpu/dynamics/solver/pallas_sweep.py:339",
         "library_ms": None, **folded},
        {"name": "contact_sweep_kernel_f64", "route": "cuda", "source": source,
         "replaces": "rapier_tpu/dynamics/solver/pallas_sweep.py:517",
         "library_ms": None, **block64},
        {"name": "contact_sweep_folded_kernel_f64", "route": "cuda", "source": source,
         "replaces": "rapier_tpu/dynamics/solver/pallas_sweep.py:339",
         "library_ms": None, **folded64},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
