"""The benchmark's plain reference: one physics step of a batch of contact
scenes in plain PyTorch, and the plain layout of each configuration's scene.

Frozen from rapier_tpu_torch at commit 4adbf044245c8c7e0b37ea110fd28ee56df385f0
(the port's plain PyTorch path, which its CPU tests hold against the JAX
package), with imports made relative:

    precision.py, types.py (without the multibody slot), math/quat.py,
    geometry/{shapes, broadphase, dispatch, narrowphase, narrowphase_boxbox,
    narrowphase_convex, narrowphase_mesh, gjk}.py,
    dynamics/solver/{coloring, velocity_solver (without the joint rows),
    contact_constraints}.py, utils/{compaction, routing}.py,
    pipeline/physics_pipeline.py (cut down to `step.py`: the contacts-only
    step on the masked sweep).

`counters.py` (a no-op stage marker), `masses.py` (the shapes' mass
properties, with which each configuration's plain layout, `configs/<name>.py`,
checks the program's built scene) and `params.py` (the SimParams the harness
steps this reference under) are the benchmark's own.  The harness reads the
package through `step.step`, `types.tree_map` and `params.sim_params`; a
configuration that needs another reference names its own package of those
three modules (`"reference"` in `configs/<name>.json`).  Nothing here imports the port, the JAX package or JAX; the harness's
tests check that in a fresh interpreter.
"""
