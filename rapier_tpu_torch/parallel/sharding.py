"""Multi-device scaling: the scene axis split over ranks (counterpart of
`rapier_tpu.parallel.sharding`).

Scenes are independent, so a step needs no collective.  The reference has
one controller drive a `jax.sharding` mesh; here each rank is a process
with one device, which holds and steps its own contiguous block of the
scene axis (one Python thread driving every card would hold them all to its
launch rate).  `make_mesh` names the devices of the ranks, `shard_batch`
takes this rank's block, `make_sharded_step` steps it, and `gather_batch`
puts the whole batch, or a range of its scenes, on one rank: it stands for
reading a sharded `jax.Array`.

The ranks join a `torch.distributed` process group that the caller starts;
`spawn_ranks` starts one with the spawn method (forking after CUDA is up
breaks it) and a `file://` rendezvous in a temporary directory.  NCCL
refuses two ranks on one card, so ranks that share a device use gloo; only
`gather_batch` goes through the group.  The sharded step takes the route
the unsharded step takes: the reference pins solver_backend="jax" on a CPU
mesh, a workaround for its TPU-only kernels that the port does not copy
(ROADMAP R33).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from rapier_tpu_torch.pipeline.physics_pipeline import step as _step
from rapier_tpu_torch.types import from_numpy, to_numpy, tree_map


def batched_step(state, params, hooks=None):
    """The port's step: it takes a leading scene axis already."""
    return _step(state, params, hooks)


@dataclasses.dataclass(frozen=True)
class SceneMesh:
    """The devices of the ranks, in rank order, and this process's rank."""

    devices: tuple
    axis_name: str
    rank: int

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]


def _indexed(d) -> torch.device:
    """`d` with its index ("cuda" is the current card, "cuda:0" say)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices, axis_name: str = "scenes") -> SceneMesh:
    """A 1-D scene mesh over an EXPLICIT device list, one device a rank.

    `devices` is required, as in the reference.  With one device no process
    group is needed; with more, `torch.distributed` must be initialised with
    one rank a device."""
    if devices is None:
        raise ValueError(
            "make_mesh requires an explicit device list (e.g. ['cuda:0', 'cuda:1'], "
            "one device a rank); no implicit default.")
    devs = tuple(_indexed(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh needs at least one device")
    if len(devs) == 1:
        return SceneMesh(devs, axis_name, 0)
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {len(devs)} devices needs an initialised "
                           "torch.distributed process group, one rank a device")
    if dist.get_world_size() != len(devs):
        raise ValueError(f"{len(devs)} devices for {dist.get_world_size()} ranks")
    mesh = SceneMesh(devs, axis_name, dist.get_rank())
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)   # NCCL collectives run on it
    return mesh


def block(batch: int, mesh: SceneMesh) -> tuple[int, int]:
    """The scenes ``[start, stop)`` this rank holds: contiguous equal blocks,
    as NamedSharding(P("scenes")) lays them out."""
    if batch % mesh.size:
        raise ValueError(f"{batch} scenes do not split over {mesh.size} devices "
                         "(the reference refuses such a batch too)")
    per = batch // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def shard_batch(state, mesh: SceneMesh, axis_name: str = "scenes"):
    """This rank's block of the scene axis of the batch `state`, on its
    device."""
    start, stop = block(state.bodies.pos.shape[0], mesh)
    return tree_map(lambda x: x[start:stop].to(mesh.device, copy=True)
                    if isinstance(x, torch.Tensor) and x.dim() else x, state)


def make_sharded_step(mesh: SceneMesh, axis_name: str = "scenes", donate: bool = True):
    """The step of this rank's block.  It needs no collective.  The port
    steps in place, so `donate=False` clones the block first and leaves
    the caller's state intact."""

    def sharded_step(state, params, hooks=None):
        if _indexed(state.bodies.pos.device) != mesh.device:
            raise ValueError(f"the block lies on {state.bodies.pos.device}, "
                             f"the rank's device is {mesh.device}")
        if not donate:
            state = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                             state)
        return batched_step(state, params, hooks)

    return sharded_step


def gather_batch(state, mesh: SceneMesh, scenes=None):
    """The whole batch, or the scene range `scenes = (start, stop)` of it,
    from every rank's block onto rank 0's device.  Returns the state on rank
    0, None on the others.  Every rank must call it."""
    if mesh.size == 1:
        out = state
    else:
        gloo = dist.get_backend() == "gloo"
        root = mesh.rank == 0

        def gather(x):
            if not isinstance(x, torch.Tensor) or not x.dim():
                return x
            y = (x.detach().cpu() if gloo else x.detach()).contiguous()
            parts = [torch.empty_like(y) for _ in range(mesh.size)] if root else None
            dist.gather(y, parts, dst=0)
            return torch.cat(parts).to(mesh.devices[0]) if root else x

        out = tree_map(gather, state)
        if not root:
            return None
    if scenes is not None:
        start, stop = scenes
        out = tree_map(lambda x: x[start:stop] if isinstance(x, torch.Tensor) and x.dim()
                       else x, out)
    return out


def _rank_main(rank, world, backend, init_file, fn, args):
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args, backend: str = "gloo"):
    """Run `fn(rank, *args)` in `world` spawned processes joined in one
    process group (`backend`), with a file rendezvous in a temporary
    directory; returns when every rank has ended and raises if one failed.
    `fn` must be importable (a module-level function).  Ranks on CUDA
    devices that step on the kernel need it built before
    (`contact_sweep.KERNEL.build()`), as `sharded_rollout` does."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        mp.start_processes(_rank_main, args=(world, backend, init_file, fn, args),
                           nprocs=world, join=True, start_method="spawn")


def state_digest(state) -> str:
    """SHA-256 of every leaf's bytes, in the state's leaf order: equal
    digests mean bitwise-equal states."""
    h = hashlib.sha256()
    tree_map(lambda x: h.update(np.ascontiguousarray(
        x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)).tobytes()),
        state)
    return h.hexdigest()


def _rollout_rank(rank, job_file, out_dir):
    from rapier_tpu_torch.dynamics.solver.contact_sweep import KERNEL
    from rapier_tpu_torch.scenes import replicate_scene

    job = torch.load(job_file, weights_only=False)
    mesh = make_mesh(job["devices"])
    if job["replicate"]:
        start, stop = block(job["replicate"], mesh)
        state = from_numpy(replicate_scene(job["state"], stop - start), mesh.device)
    else:
        state = shard_batch(from_numpy(job["state"]), mesh)
    params, steps, timed = job["params"], job["steps"], job["timed"]
    sharded_step = make_sharded_step(mesh)
    cuda = mesh.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(mesh.device)

    KERNEL.launches = KERNEL.launches_folded = 0
    overflow, first_step_at, t0 = 0, None, None
    for i in range(steps):
        if i == steps - timed:
            sync()
            t0 = time.perf_counter()
        state, ev = sharded_step(state, params)
        overflow += int(ev.broadphase_overflow.sum()) + int(ev.solver_overflow.sum())
        if i == 0:
            sync()
            first_step_at = time.time()
    sync()
    timed_s = time.perf_counter() - t0 if timed else 0.0
    stats = dict(rank=rank, scenes=state.bodies.pos.shape[0], launches=KERNEL.launches,
                 launches_folded=KERNEL.launches_folded, overflow=overflow,
                 first_step_at=first_step_at, timed_s=timed_s, device=str(mesh.device))
    gathered = gather_batch(state, mesh)
    if rank == 0:
        stats["digest"] = state_digest(gathered)
        if job["return_state"]:
            stats["state"] = to_numpy(gathered)
    torch.save(stats, os.path.join(out_dir, f"rank{rank}.pt"))


def sharded_rollout(state, params, steps: int, devices, *, replicate: int = 0,
                    timed: int = 0, backend: str = "gloo", return_state: bool = False):
    """Step a batch sharded over `devices`, one spawned rank a device, and
    gather it on rank 0.  `state` is a batch with numpy leaves, or with
    `replicate` one scene that each rank copies into its block of
    `replicate` scenes.  The last `timed` steps are timed.  Returns
    (per-rank stats, seconds from the spawn to the first finished step of
    the slowest rank); rank 0's stats hold the gathered state's
    `state_digest` and, with `return_state`, the state itself.  On CUDA
    devices the contact kernel is built here first, so that the ranks load
    it and never build it at once."""
    if any(torch.device(d).type == "cuda" for d in devices):
        from rapier_tpu_torch.dynamics.solver.contact_sweep import KERNEL

        KERNEL.build()
    with tempfile.TemporaryDirectory() as tmp:
        job_file = os.path.join(tmp, "job.pt")
        torch.save(dict(state=state, params=params, steps=steps, timed=timed,
                        replicate=replicate, devices=[str(d) for d in devices],
                        return_state=return_state), job_file)
        t_spawn = time.time()
        spawn_ranks(_rollout_rank, len(devices), job_file, tmp, backend=backend)
        stats = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(len(devices))]
    return stats, max(s["first_step_at"] for s in stats) - t_spawn
