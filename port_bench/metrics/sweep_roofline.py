"""`contact_sweep_kernel`'s share of its roofline: the least time the card
could take for the solve of a traced step over the kernel's device time a
step, in %.  Nothing where the traced steps launched no such kernel (the
float64 scenes take the masked solve).

The least time is the larger of the solve's bytes at the HBM rate and its
float operations at the float32 rate (H100 SXM, NVIDIA's data sheet, at the
700 W limit).  The work is counted from the problem, not from any packing:
read once, each awake dynamic body's pose, velocity and mass properties and,
for each solved pair (a touching pair with an active point), its normal,
friction, restitution, body indices and tangent and twist warmstart
impulses, and for each of its active points the point, depth and warmstart
impulse; written once, each such body's velocity and pose and each pair's
and point's impulses.  Operations: the per-lane counts of the kernel's
generation, substep update and warmstart, and sweep solve (counted from
csrc/contact_sweep.cu at commit 4adbf044245c) for each solved pair."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
FLOPS_GENERATE = 850
FLOPS_UPDATE_WARMSTART = 500
FLOPS_SOLVE = 390
BODY_READ = 3 + 4 + 3 + 3 + 1 + 3 + 4 + 3   # pos, rot, linvel, angvel, inv mass,
#                                             inverse principal inertia, frame, com
BODY_WRITTEN = 3 + 3 + 3 + 4                # linvel, angvel, pos, rot
PAIR_READ = 3 + 1 + 1 + 2 + 2 + 1           # normal, friction, restitution, bodies,
#                                             tangent and twist warmstart
PAIR_WRITTEN = 2 + 1                        # tangent and twist impulses
POINT_READ = 3 + 1 + 1                      # point, depth, warmstart impulse
POINT_WRITTEN = 1                           # normal impulse
WORD = 4                                    # float32 and int32


def solve_work(state, params):
    """(bytes, float operations) of the contact solve whose results `state`
    (a step's output) holds."""
    from rapier_tpu_torch.types import BodyType

    b, c = state.bodies, state.contacts
    bodies = int(((b.body_type == int(BodyType.DYNAMIC)) & b.enabled & ~b.sleeping).sum())
    points = c.point_active & c.touching.unsqueeze(1)
    pairs = int(points.any(dim=1).sum())
    n_points = int(points.sum())
    words = (bodies * (BODY_READ + BODY_WRITTEN) + pairs * (PAIR_READ + PAIR_WRITTEN)
             + n_points * (POINT_READ + POINT_WRITTEN))
    sweeps = params.num_internal_pgs_iterations + params.num_internal_stabilization_iterations
    per_lane = FLOPS_GENERATE + params.num_solver_iterations * (
        FLOPS_UPDATE_WARMSTART + sweeps * FLOPS_SOLVE)
    return words * WORD, pairs * per_lane


def least_seconds(n_bytes, flops):
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    kernel_ns = sum(b - a for a, b, name in tr["events"]
                    if "contact_sweep_kernel" in name and "folded" not in name)
    if kernel_ns == 0:
        return None
    least = sum(least_seconds(*solve_work(s, run["params"])) for s in tr["outputs"])
    return 100.0 * least / (kernel_ns / 1e9)
