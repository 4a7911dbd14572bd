"""The contacts-only contact solve: generate + the TGS-soft substep loop.

Counterpart of rapier_tpu.dynamics.solver.pallas_sweep.solve_from_manifolds
(its `_kernel`, `_kernel_fold_gather` and `_kernel_folded` TPU kernels).  On
a CUDA tensor `solve_from_manifolds` launches a hand-written kernel of
``csrc/contact_sweep.cu``; on a CPU tensor it runs `solve_plain`, the same
function written over `contact_constraints`.  There is no fallback between
the two: a CUDA input either launches a kernel or raises.

Which kernel is a fixed rule on the shape: scenes of at most
`FOLD_MAX_LANES` solver lanes go to `contact_sweep_folded_kernel` (8 scenes
per block at float32, 4 at float64, one warp each), larger ones to
`contact_sweep_kernel` (a block per scene).  The two compute the same
function bit for bit.  Each solves a scene's valid lanes only, with their
state in shared memory up to a capacity the library computes from the
shapes (`ContactSweepKernel.capacity`); a scene with more valid lanes keeps
them in a global scratch buffer.  Both kernels come in float32 and float64:
the inputs' dtype picks them, and a float64 solve computes and stores every
number in float64.

The kernel library is built with nvcc for sm_90a at first use, into
``build/rapier_tpu_torch/`` beside the package, and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from rapier_tpu_torch.dynamics.solver import contact_constraints as cc
from rapier_tpu_torch.utils import counters

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "contact_sweep.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "rapier_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
MAN_ROWS = 32        # packed float manifold rows (ManRow in the source)
BODY_ROWS = 31       # packed body-table rows (BodyRow in the source)
BLOCK_WARPS = 4      # warps of contact_sweep_kernel's block
FOLD_MAX_LANES = 128  # solver lanes up to which a scene takes the folded kernel


# Rows of the reference's packed manifold matrix (pallas_sweep.D_MAN).
D_MAN = 42


def vmem_feasible(p_lanes: int, n1: int) -> bool:
    """The reference's `pallas_sweep.vmem_feasible` (pallas_sweep.py:973-977):
    whether its kernel's per-scene working set fits 10 MiB.  The step's solve
    gate keeps it, so the port solves exactly the scenes the reference's
    kernel solves."""
    est = (p_lanes * (2 * n1 + 4 * D_MAN + 700)) * 4
    return est < 10 * 2**20


# ---------------------------------------------------------------------------
# The gate's shared-memory rule, from the shapes without the library: the
# fixed words of ``csrc/contact_sweep.cu``'s `capacity` (4-byte words).
# ---------------------------------------------------------------------------


def _fixed_words(folded: bool, n1: int, max_colors: int, f64: bool) -> int:
    """A scene's shared words before its lanes: body table and int tables."""
    nb = max_colors + 1
    warps = 1 if folded else BLOCK_WARPS
    fixed = ((2 if f64 else 1) * BODY_ROWS * n1 + n1 + (n1 + 1) + max_colors + (nb + 1) + nb
             + warps * nb)
    return -(-fixed // 4) * 4


def kernel_fits(k: int, n1: int, max_colors: int, f64: bool = False) -> bool:
    """Whether the body tables and fixed words of the scenes a block of the
    kernel that K lanes take (`FOLD_MAX_LANES`; the folded kernel holds 8
    scenes a block at float32, 4 at float64) fit a block's shared memory;
    their lanes always do, on chip or in the global scratch."""
    folded = k <= FOLD_MAX_LANES
    scenes = (4 if f64 else 8) if folded else 1
    return 4 * scenes * _fixed_words(folded, n1, max_colors, f64) <= SMEM_LIMIT


# ---------------------------------------------------------------------------
# Plain PyTorch version (the substep loop of pallas_sweep._kernel).
# ---------------------------------------------------------------------------


def _integrate_linearized(q, w, dt):
    """The kernel's normalised linearised quaternion step, ``[B, 4, N+1]``."""
    h = dt * 0.5
    hx, hy, hz = w[:, 0:1] * h, w[:, 1:2] * h, w[:, 2:3] * h
    qx, qy, qz, qw = q[:, 0:1], q[:, 1:2], q[:, 2:3], q[:, 3:4]
    rx = qx + hx * qw + hy * qz - hz * qy
    ry = qy - hx * qz + hy * qw + hz * qx
    rz = qz + hx * qy - hy * qx + hz * qw
    rw = qw - hx * qx - hy * qy - hz * qz
    n2 = rx * rx + ry * ry + rz * rz + rw * rw
    inv = 1.0 / torch.sqrt(torch.clamp(n2, min=1e-24))
    return torch.cat([rx * inv, ry * inv, rz * inv, rw * inv], dim=1)


def solve_plain(sb: cc.SolverBodies, *, b1, b2, valid, color, num_colors,
                normal, point, point_active, dist, friction, restitution,
                prev_impulse, ws_n, ws_t, ws_tw, dv_inc, dw_inc, move_mask,
                dt_sub, inv_dt_sub, erp_inv_dt, cfm_factor, allowed_lin_err,
                max_corrective_velocity, warmstart_coeff, n_sub, pgs_iters,
                stab_iters, dyn1=None, dyn2=None, max_colors=16):
    """Plain PyTorch contact solve; same contract as
    `solve_from_manifolds`.  Every scene sweeps the batch's largest color
    count: colors past a scene's own count are empty and change nothing."""
    cons = cc.generate_from(b1, b2, valid, color, normal, point, point_active,
                            dist, friction, restitution, sb, prev_impulse)
    cons = cons._replace(impulse=ws_n * point_active.to(ws_n.dtype),
                         tan_impulse=ws_t, twist_impulse=ws_tw)
    ncol = int(torch.max(num_colors)) if num_colors.numel() else 0
    move = move_mask.unsqueeze(1)

    def sweep(cons, sb, use_bias):
        for ci in range(ncol):
            cons, sb = cc.solve_color(cons, sb, ci, use_bias=use_bias)
        return cons, sb

    for _ in range(n_sub):
        sb = sb._replace(v_lin=sb.v_lin + dv_inc, v_ang=sb.v_ang + dw_inc)
        cons = cc.update(
            cons, sb, cfm_factor=cfm_factor, inv_dt=inv_dt_sub,
            allowed_lin_err=allowed_lin_err, erp_inv_dt=erp_inv_dt,
            max_corrective_velocity=max_corrective_velocity,
            warmstart_coeff=warmstart_coeff)
        sb = cc.warmstart(cons, sb)
        for _ in range(pgs_iters):
            cons, sb = sweep(cons, sb, True)
        com = sb.com + torch.where(move, sb.v_lin * dt_sub, 0.0)
        rot = torch.where(move, _integrate_linearized(sb.rot, sb.v_ang, dt_sub), sb.rot)
        sb = sb._replace(com=com, rot=rot)
        for _ in range(stab_iters):
            cons, sb = sweep(cons, sb, False)

    imp = torch.cat([
        cons.impulse, cons.impulse_acc, cons.tan_impulse, cons.tan_impulse_acc,
        cons.twist_impulse.unsqueeze(1), cons.twist_impulse_acc.unsqueeze(1),
    ], dim=1)
    return sb, imp


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch.
# ---------------------------------------------------------------------------


class ContactSweepKernel:
    """ctypes binding of ``csrc/contact_sweep.cu``.  `launches` counts the
    launches of `contact_sweep_kernel` made through `launch`,
    `launches_folded` those of `contact_sweep_folded_kernel` made through
    `launch_folded`, at either precision; `build_log` holds nvcc's register
    and shared-memory report of the last build."""

    def __init__(self):
        self.launches = 0
        self.launches_folded = 0
        self.build_log = ""
        self._lib = None

    def build(self) -> ctypes.CDLL:
        """Compile the library from the repository's source (once per
        source version) and load it."""
        if self._lib is not None:
            return self._lib
        src = _SRC.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"libcontact_sweep_{tag}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = shutil.which("nvcc")
            if nvcc is None:
                from torch.utils.cpp_extension import CUDA_HOME

                nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{self.build_log}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        p, i, f, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
        lib.contact_sweep_launch.argtypes = [i] + [p] * 8 + [i] * 7 + [f] * 7 + [p]
        lib.contact_sweep_launch.restype = ctypes.c_int
        lib.contact_sweep_launch_f64.argtypes = [i] + [p] * 8 + [i] * 7 + [d] * 7 + [p]
        lib.contact_sweep_launch_f64.restype = ctypes.c_int
        lib.contact_sweep_capacity.argtypes = [i] * 5
        lib.contact_sweep_capacity.restype = ctypes.c_int
        lib.contact_sweep_smem_bytes.argtypes = [i] * 5
        lib.contact_sweep_smem_bytes.restype = ctypes.c_size_t
        lib.contact_sweep_scratch_words.argtypes = [i] * 2
        lib.contact_sweep_scratch_words.restype = ctypes.c_int
        lib.contact_sweep_kernel_info.argtypes = [i] * 5 + [ctypes.POINTER(ctypes.c_int)]
        lib.contact_sweep_kernel_info.restype = ctypes.c_int
        for name in ("contact_sweep_body_rows", "contact_sweep_man_rows"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        self._lib = lib
        return lib

    def capacity(self, folded: bool, k: int, n1: int, max_colors: int,
                 f64: bool = False) -> int:
        """The library's `capacity`: valid lanes a scene of K lanes and N+1
        body columns holds on chip in the folded (or the block) kernel at
        float32 (or float64)."""
        return self.build().contact_sweep_capacity(int(f64), int(folded), k, n1, max_colors)

    def storage(self, folded: bool, man_i, n1: int, max_colors: int, f64: bool = False):
        """Per scene of the packed int rows `man_i` ``[B, 4, K]``: its valid
        lanes (flag bit 0), and whether the kernel holds them on chip (at
        most `capacity` of them) or in the global scratch."""
        valid = (man_i[:, 3] & 1).sum(-1)
        return valid, valid <= self.capacity(folded, man_i.shape[-1], n1, max_colors, f64)

    def info(self, folded: bool, k: int, n1: int, max_colors: int, f64: bool = False) -> dict:
        """The kernel's resources at this shape, from the CUDA runtime:
        registers and local (spill) bytes a thread, dynamic shared bytes a
        block, resident blocks an SM, and the on-chip lane capacity."""
        out = (ctypes.c_int * 4)()
        err = self.build().contact_sweep_kernel_info(int(f64), int(folded), k, n1, max_colors,
                                                     out)
        if err != 0:
            raise RuntimeError(f"contact_sweep: kernel info failed: CUDA error {err}")
        return dict(registers=out[0], spill_bytes=out[1], smem_bytes=out[2],
                    blocks_per_sm=out[3],
                    capacity=self.capacity(folded, k, n1, max_colors, f64))

    def launch(self, man_f, man_i, bodies_in, move, ncol, *, n_sub, pgs_iters,
               stab_iters, max_colors, scalars):
        """Run `contact_sweep_kernel` (a block per scene) on PyTorch's current
        stream.  Inputs: man_f ``[B, 32, K]`` float32 or float64, man_i
        ``[B, 4, K]`` i32 (b1, b2, color, flags), bodies_in ``[B, 31, N+1]``
        of man_f's dtype, move ``[B, N+1]`` i32, ncol ``[B]`` i32.  Returns
        (bodies ``[B, 13, N+1]``, impulse block ``[B, 14, K]``) of man_f's
        dtype; a float64 call passes its scalars as doubles."""
        out = self._run(False, man_f, man_i, bodies_in, move, ncol, n_sub=n_sub,
                        pgs_iters=pgs_iters, stab_iters=stab_iters,
                        max_colors=max_colors, scalars=scalars)
        self.launches += 1
        return out

    def launch_folded(self, man_f, man_i, bodies_in, move, ncol, *, n_sub,
                      pgs_iters, stab_iters, max_colors, scalars):
        """Run `contact_sweep_folded_kernel` (8 scenes per block at float32,
        4 at float64, a warp each); the same inputs and outputs as
        `launch`."""
        out = self._run(True, man_f, man_i, bodies_in, move, ncol, n_sub=n_sub,
                        pgs_iters=pgs_iters, stab_iters=stab_iters,
                        max_colors=max_colors, scalars=scalars)
        self.launches_folded += 1
        return out

    def _run(self, folded, man_f, man_i, bodies_in, move, ncol, *, n_sub,
             pgs_iters, stab_iters, max_colors, scalars):
        bsz, _, k = man_f.shape
        n1 = bodies_in.shape[-1]
        real = man_f.dtype
        if real not in (torch.float32, torch.float64):
            raise ValueError(f"contact_sweep: expected float32 or float64 inputs, got {real}")
        f64 = real == torch.float64
        checks = (
            (man_f, real, (bsz, MAN_ROWS, k)),
            (man_i, torch.int32, (bsz, 4, k)),
            (bodies_in, real, (bsz, BODY_ROWS, n1)),
            (move, torch.int32, (bsz, n1)),
            (ncol, torch.int32, (bsz,)),
        )
        for t, dtype, shape in checks:
            if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != shape \
                    or not t.is_contiguous():
                raise ValueError(
                    f"contact_sweep: expected a contiguous CUDA {dtype} tensor of "
                    f"shape {shape}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        lib = self.build()
        if (lib.contact_sweep_man_rows(), lib.contact_sweep_body_rows()) != (
                MAN_ROWS, BODY_ROWS):
            raise RuntimeError("contact_sweep: library layout does not match the wrapper")
        smem = lib.contact_sweep_smem_bytes(int(f64), int(folded), k, n1, max_colors)
        if smem > SMEM_LIMIT:
            raise ValueError(
                f"contact_sweep: {n1 - 1} bodies need {smem} bytes of shared "
                f"memory per block, above the {SMEM_LIMIT} a block can use")
        dev = man_f.device
        out_body = torch.empty((bsz, 13, n1), dtype=real, device=dev)
        out_imp = torch.empty((bsz, 14, k), dtype=real, device=dev)
        # The global scratch only where a scene can have more valid lanes
        # than the kernel holds on chip.
        scratch = None
        if lib.contact_sweep_capacity(int(f64), int(folded), k, n1, max_colors) < k:
            scratch = torch.empty((bsz, lib.contact_sweep_scratch_words(int(f64), k)),
                                  dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = lib.contact_sweep_launch_f64 if f64 else lib.contact_sweep_launch
        err = entry(
            int(folded), man_f.data_ptr(), man_i.data_ptr(), bodies_in.data_ptr(),
            move.data_ptr(), ncol.data_ptr(), out_body.data_ptr(),
            out_imp.data_ptr(), None if scratch is None else scratch.data_ptr(),
            bsz, k, n1, n_sub, pgs_iters, stab_iters, max_colors,
            *[float(s) for s in scalars], stream)
        if err != 0:
            raise RuntimeError(f"contact_sweep kernel launch failed: CUDA error {err}")
        return out_body, out_imp


KERNEL = ContactSweepKernel()


def _pack(sb, *, b1, b2, valid, color, num_colors, normal, point,
          point_active, dist, friction, restitution, prev_impulse, ws_n, ws_t,
          ws_tw, dv_inc, dw_inc, move_mask, dyn1, dyn2):
    """The kernel's packed inputs from the reference's logical arrays, at
    the solver bodies' float dtype (every float input must have it)."""
    bsz, k = b1.shape
    n1 = sb.v_lin.shape[-1]
    floats = (normal, point, dist, friction, restitution, prev_impulse, ws_n, ws_t, ws_tw,
              dv_inc, dw_inc, *sb)
    if any(t.dtype != sb.v_lin.dtype for t in floats):
        raise ValueError(f"contact_sweep: every float input must be {sb.v_lin.dtype}, got "
                         f"{sorted({str(t.dtype) for t in floats})}")
    man_f = torch.cat([
        normal, point.reshape(bsz, 12, k), dist, friction.unsqueeze(1),
        restitution.unsqueeze(1), prev_impulse, ws_n, ws_t, ws_tw.unsqueeze(1),
    ], dim=1).contiguous()
    flags = (valid.int() | (dyn1.int() << 1) | (dyn2.int() << 2))
    for kk in range(4):
        flags = flags | (point_active[:, kk].int() << (3 + kk))
    man_i = torch.stack([b1.int(), b2.int(), color.int(), flags], dim=1).contiguous()
    bodies_in = torch.cat([
        sb.v_lin, sb.v_ang, sb.com, sb.rot, sb.im, sb.ii.reshape(bsz, 9, n1),
        dv_inc, dw_inc,
    ], dim=1).contiguous()
    return (man_f, man_i, bodies_in, move_mask.int().contiguous(),
            num_colors.int().contiguous())


def _count_storage(packed, max_colors: int):
    """A launch's counters on `_pack`'s inputs: `sweep_lanes`, the valid
    lanes it solves, and `sweep_onchip`, those of scenes the kernel holds on
    chip (`KERNEL.storage`, the library's capacity at the launch's kernel
    and dtype)."""
    man_f, man_i, bodies_in = packed[:3]
    n_valid, on_chip = KERNEL.storage(man_i.shape[-1] <= FOLD_MAX_LANES, man_i,
                                      bodies_in.shape[-1], max_colors,
                                      man_f.dtype == torch.float64)
    counters.count("sweep_lanes", n_valid.sum())
    counters.count("sweep_onchip", torch.where(on_chip, n_valid, 0).sum())


def solve_from_manifolds(sb: cc.SolverBodies, *, b1, b2, valid, color,
                         num_colors, normal, point, point_active, dist,
                         friction, restitution, prev_impulse, ws_n, ws_t,
                         ws_tw, dv_inc, dw_inc, move_mask, dt_sub, inv_dt_sub,
                         erp_inv_dt, cfm_factor, allowed_lin_err,
                         max_corrective_velocity, warmstart_coeff, n_sub: int,
                         pgs_iters: int, stab_iters: int, dyn1=None, dyn2=None,
                         max_colors: int = 16):
    """Contacts-only TGS-soft solve with constraint generation, over a batch
    of scenes.  Lane inputs are ``[B, ..., K]`` (b1/b2 resolved solver-body
    columns, the sentinel N for static or dominant endpoints); `sb` tables
    ``[B, d, N+1]``.  Returns (sb, impulse block ``[B, 14, K]``: impulse(4),
    impulse_acc(4), tan(2), tan_acc(2), twist, twist_acc).

    On the card, K <= FOLD_MAX_LANES launches the scene-folded kernel and a
    larger K the block-per-scene kernel, at the solver bodies' dtype
    (float32 or float64); on the CPU, `solve_plain`.  Under
    `counters.recording()` a launch counts its storage (`_count_storage`)."""
    if dyn1 is None:
        dyn1 = torch.zeros_like(valid)
    if dyn2 is None:
        dyn2 = torch.zeros_like(valid)
    lanes = dict(b1=b1, b2=b2, valid=valid, color=color, num_colors=num_colors,
                 normal=normal, point=point, point_active=point_active, dist=dist,
                 friction=friction, restitution=restitution,
                 prev_impulse=prev_impulse, ws_n=ws_n, ws_t=ws_t, ws_tw=ws_tw,
                 dv_inc=dv_inc, dw_inc=dw_inc, move_mask=move_mask,
                 dyn1=dyn1, dyn2=dyn2)
    device = sb.v_lin.device
    if device.type == "cpu":
        return solve_plain(
            sb, dt_sub=dt_sub, inv_dt_sub=inv_dt_sub, erp_inv_dt=erp_inv_dt,
            cfm_factor=cfm_factor, allowed_lin_err=allowed_lin_err,
            max_corrective_velocity=max_corrective_velocity,
            warmstart_coeff=warmstart_coeff, n_sub=n_sub, pgs_iters=pgs_iters,
            stab_iters=stab_iters, max_colors=max_colors, **lanes)
    if device.type != "cuda":
        raise ValueError(f"contact_sweep: unsupported device {device}")
    launch = KERNEL.launch_folded if b1.shape[-1] <= FOLD_MAX_LANES else KERNEL.launch
    packed = _pack(sb, **lanes)
    if counters.is_recording():
        _count_storage(packed, max_colors)
    out_body, imp = launch(
        *packed, n_sub=n_sub, pgs_iters=pgs_iters,
        stab_iters=stab_iters, max_colors=max_colors,
        scalars=(dt_sub, inv_dt_sub, erp_inv_dt, cfm_factor, allowed_lin_err,
                 max_corrective_velocity, warmstart_coeff))
    sb = sb._replace(v_lin=out_body[:, 0:3], v_ang=out_body[:, 3:6],
                     com=out_body[:, 6:9], rot=out_body[:, 9:13])
    return sb, imp
