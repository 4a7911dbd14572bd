// Contacts-only TGS-soft contact solve for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of rapier_tpu/dynamics/solver/pallas_sweep.py:
// `_kernel` (:112, one scene per launch) and `_kernel_fold_gather` (:517,
// 8 scenes per grid step under vmap) with `contact_sweep_kernel`, and
// `_kernel_folded` (:339, 8 scenes per grid instance) with
// `contact_sweep_folded_kernel`.  All compute `solve_from_manifolds`: twist-model
// constraint generation with the warmstart injected, then `n_sub` substeps
// of velocity increments, the soft-rhs update, the warmstart, `pgs_iters`
// biased color sweeps, masked pose integration and `stab_iters` unbiased
// sweeps.  The plain PyTorch version is `contact_sweep.solve_plain`.
//
// Design.  One thread group per scene: a whole block (`contact_sweep_kernel`)
// or one warp of a block (`contact_sweep_folded_kernel`).  The scene's body
// table (v_lin, v_ang, com, rot, im, ii, dv, dw: 31 floats, plus the mover
// flag, per body) sits in shared memory, so every gather and scatter of a
// color pass is a shared-memory access; a pass is "lanes of color c read
// both endpoints, solve, write their deltas", then a group barrier.
//
// Solved lanes only, their state on chip.  The Pallas kernels keep the
// constraint rows in VMEM; here the scene first compacts its valid lanes,
// color-major and in lane order within a color (a stable counting sort in
// shared memory), so that a color pass runs on consecutive threads, and
// generation, update, warmstart, the color passes and the per-body endpoint
// lists run over the compacted lanes only.  Their state (117 floats a lane
// plus 12 delta floats, a lane's fields together) lives in shared memory.
// Fields that are functions of the body table are not stored: im1/im2 are the
// body's `im`, and the ii-weighted torque directions are the body's `ii`
// (constant over the substeps) times a stored direction, recomputed with the
// same `ii_mul`, so with the same bits.  A lane that is not valid never
// enters a pass and its warmstart deltas are zero, so its impulse rows are a
// closed form of its warmstart inputs, written with the same float
// operations in the same order.  Each kernel has a fixed on-chip capacity per
// scene, computed by the launcher from the shapes alone; a scene with more
// valid lanes keeps them in a global scratch buffer, laid out field-major
// so that a warp's reads coalesce, through the same code
// (`solve_lanes<G, false>`).
//
// Writes.  In a conflict-free color a lane adds its deltas to its dynamic
// endpoints directly.  A color in which two lanes share a dynamic body (the
// Luby overflow color, wherever the renumbering put it; detected per scene
// at block start) and the warmstart (a sum over all lanes) first store every
// lane's deltas, computed from the pre-pass velocities; then each body's
// thread sums its endpoints' deltas in lane order (endpoint-1 lanes, then
// endpoint-2 lanes, the reference's route order) from a per-scene endpoint
// list.  No float atomics: a run reproduces bit for bit.  The sentinel
// column N (static and dominant endpoints) is never written.  Skipping the
// zero deltas of unsolved lanes leaves every sum's bits as they were: a sum
// starts at +0 and so never holds -0.
//
// Bounds on an H100.  The bytes a call must move (packed inputs once,
// outputs once) take 0.086 ms at the bench shape (4096 scenes x K 256) and
// 0.035 ms at the quadruped's (4096 x K 128); the valid lanes' float
// operations take less.  The card did not show the kernel latency-bound, as
// this note once said: with every lane's state in a global scratch the two
// kernels took 3.356 and 0.938 ms, and eight times the quadruped scenes in
// flight bought no time, which is the mark of the scratch traffic (~1.5 MB
// and ~0.44 MB a scene a step).  With the state on chip they take ~1.6 and
// ~0.16 ms (PERF.md, NVIDIA H100 80GB HBM3 at 700 W).  What sets the time
// now is a scene's chain of ~70 (bench) or ~25 (quadruped) barrier-
// separated passes, each one lane solve deep and issued by one warp, times
// the waves of scenes: a lone bench scene takes ~0.1 ms, and 4096 of them
// at two an SM make 15.5 waves.  Shared memory sets the scenes an SM holds:
// the block kernel keeps 183 lanes of a scene on chip (138 words a lane plus
// the body table, 115 KB), so two bench scenes share an SM; the folded
// kernel keeps up to 32 lanes a scene, as many as let two 8-scene blocks
// share an SM (21 at the quadruped's 17 body columns).  A scene past that
// capacity pays for the global scratch: 4096 bench scenes with all 256 lanes
// valid take ~5.8 ms, field-major (a lane-major scratch took ~10.9).  Both
// compile to no or few spills (`__launch_bounds__` with two blocks an SM).
// Compiled with -fmad=false so the arithmetic rounds like the plain version.
//
// Float64.  Everything above is templated on the real type R and built for
// float and double; a float64 scene (rapier3d-f64) computes and stores every
// number in double, with the plain version's double constants and sqrt /
// fmax / fmin / fabs.  Shared memory follows the same capacity rule on
// 8-byte values: a lane takes 258 words of fields (the ints stay 4 bytes),
// the bench's body table 6.5 KB.  The block kernel runs one block an SM at
// double, holding 192 lanes of a bench scene on chip (232 KB), not two
// blocks with 82: at 4096 bench piles of 0-149 valid lanes the one block
// took 2.59 ms with every scene on chip, the two 2.99 ms with half of them
// in the global scratch (PERF.md, NVIDIA H100 80GB HBM3 at 700 W; the
// float build took 1.39 ms on the same inputs rounded to float).  Both use
// all 255 registers a thread allows.  The folded kernel keeps a warp a scene and holds 4 scenes a
// block at double (their slices of the float block's shared memory), so a
// quadruped scene keeps 22 lanes on chip (21 at float).  The bound at double
// is the bytes: the packed inputs and outputs, ~0.56 GB at the bench shape,
// take 0.17 ms at 3.35 TB/s, where the valid lanes' ~6,000 operations each
// take 0.05 ms at the FP64 vector rate of 34 TFLOP/s; the kernel, like the
// float one, is paced by its scenes' chains of barrier-separated passes.
//
// The scene-folded kernel packs kFoldScenes = 8 scenes into a block, one
// warp per scene: each warp owns an aligned shared-memory slice and
// separates passes with __syncwarp(), so the scenes of a block never wait on
// each other.  Both kernels run the same per-scene code (`solve_scene`,
// templated on the thread group), so they agree bit for bit; a scene sweeps
// its own color count where the TPU kernel swept the batch maximum (the
// extra colors are empty: the same function).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockThreads = 128;  // threads of contact_sweep_kernel's block (a scene)
constexpr int kFoldThreads = 256;   // threads of a folded block (8 scenes)

// Body-table rows (packed input [B, BR_ROWS, N1] and shared memory).
enum BodyRow {
  BR_VLIN = 0, BR_VANG = 3, BR_COM = 6, BR_ROT = 9, BR_IM = 13, BR_II = 16,
  BR_DV = 25, BR_DW = 28, BR_ROWS = 31
};
// Float manifold rows (packed input [B, MR_ROWS, K]); point rows are
// 3 * point + component.
enum ManRow {
  MR_NORMAL = 0, MR_POINT = 3, MR_DIST = 15, MR_FRIC = 19, MR_REST = 20,
  MR_PREV = 21, MR_WSN = 25, MR_WST = 29, MR_WSTW = 31, MR_ROWS = 32
};
// Int manifold rows (packed input [B, 4, K]).
enum IntRow { IR_B1 = 0, IR_B2 = 1, IR_COLOR = 2, IR_FLAGS = 3 };
// flags: bit 0 valid, bit 1 dyn1, bit 2 dyn2, bits 3..6 point_active.
// Constraint fields of a compacted lane (contact_constraints
// ContactConstraints without the fields the body table gives); vectors are
// 3 consecutive fields, per-point vectors 4 x 3.
enum Field {
  F_DIR1 = 0, F_TAN1 = 3, F_LIMIT = 6, F_TD1 = 7, F_TD2 = 19, F_R = 31,
  F_LP1 = 35, F_LP2 = 47, F_DIST0 = 59, F_NVRHS = 63, F_RHS = 67, F_RHSWO = 71,
  F_IMP = 75, F_IMPACC = 79, F_TTD1 = 83, F_TTD2 = 89, F_TANR = 95,
  F_TRHS = 98, F_TIMP = 100, F_TIMPACC = 102, F_FC1 = 104, F_FC2 = 107,
  F_TWR = 110, F_TWD = 111, F_TWIMP = 115, F_TWIMPACC = 116,
  F_DELTA = 117,  // 12 delta rows: dv1 dw1 dv2 dw2
  LF = 129
};
// Int words of a compacted lane: its endpoints, color, flags and lane index
// (IF is odd, like LF, for the same reason).
enum InfoRow { I_B1 = 0, I_B2 = 1, I_COLOR = 2, I_FLAGS = 3, I_LANE = 4, IF = 7 };
// Words a lane occupies: fields, info rows and its two endpoint-list entries.
constexpr int kLaneWords = LF + IF + 2;

// The arithmetic, templated on its real type R: float, or double for a
// float64 scene.  Constants are R's own (a double 1e-12 is not the double
// of the float 1e-12f), and the math functions R's: sqrt/fmax/fmin/fabs at
// double, their f-suffixed forms at float.
template <class R> struct Eps;
template <> struct Eps<float> {
  __device__ static float tiny() { return 1e-12f; }
  __device__ static float axis() { return 1e-6f; }
  __device__ static float slip() { return 1e-4f; }
  __device__ static float norm2() { return 1e-24f; }
};
template <> struct Eps<double> {
  __device__ static double tiny() { return 1e-12; }
  __device__ static double axis() { return 1e-6; }
  __device__ static double slip() { return 1e-4; }
  __device__ static double norm2() { return 1e-24; }
};
__device__ __forceinline__ float msqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double msqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float mmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double mmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float mmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double mmin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float mabs(float x) { return fabsf(x); }
__device__ __forceinline__ double mabs(double x) { return fabs(x); }

template <class R>
struct V3 { R x, y, z; };

template <class R>
__device__ __forceinline__ V3<R> mk(R x, R y, R z) { return {x, y, z}; }
template <class R>
__device__ __forceinline__ V3<R> operator+(V3<R> a, V3<R> b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
template <class R>
__device__ __forceinline__ V3<R> operator-(V3<R> a, V3<R> b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
template <class R>
__device__ __forceinline__ V3<R> operator-(V3<R> a) { return {-a.x, -a.y, -a.z}; }
template <class R>
__device__ __forceinline__ V3<R> operator*(V3<R> a, V3<R> b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
template <class R>
__device__ __forceinline__ V3<R> operator*(V3<R> a, R s) { return {a.x * s, a.y * s, a.z * s}; }
template <class R>
__device__ __forceinline__ V3<R> operator/(V3<R> a, R s) { return {a.x / s, a.y / s, a.z / s}; }
template <class R>
__device__ __forceinline__ R dot(V3<R> a, V3<R> b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
template <class R>
__device__ __forceinline__ V3<R> cross(V3<R> a, V3<R> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

template <class R>
struct Q { R x, y, z, w; };

template <class R>
__device__ __forceinline__ V3<R> rotate(Q<R> q, V3<R> v) {
  V3<R> u = mk(q.x, q.y, q.z);
  V3<R> t = cross(u, v) * R(2);
  return v + t * q.w + cross(u, t);
}
template <class R>
__device__ __forceinline__ V3<R> inv_rotate(Q<R> q, V3<R> v) {
  return rotate(Q<R>{-q.x, -q.y, -q.z, q.w}, v);
}
template <class R>
__device__ __forceinline__ V3<R> ii_mul(const R* ii, V3<R> v) {
  return {ii[0] * v.x + ii[1] * v.y + ii[2] * v.z,
          ii[3] * v.x + ii[4] * v.y + ii[5] * v.z,
          ii[6] * v.x + ii[7] * v.y + ii[8] * v.z};
}

// A compacted lane's fields: field f at base[f * stride].  On chip a lane's
// fields lie together and lanes LF (odd) words apart, so a warp reading one
// field of consecutive lanes touches 32 banks, and every field is an
// immediate offset from the lane's base.  In the global scratch the fields
// lie field-major (stride: the scene's lane count), so the same read is one
// coalesced load.
template <class R, bool kOnChip>
struct Lane {
  R* base;
  int stride;
  __device__ R& operator[](int f) const { return kOnChip ? base[f] : base[f * stride]; }
  __device__ V3<R> v(int f) const { return mk((*this)[f], (*this)[f + 1], (*this)[f + 2]); }
  __device__ void set(int f, V3<R> a) const {
    (*this)[f] = a.x; (*this)[f + 1] = a.y; (*this)[f + 2] = a.z;
  }
};

// Shared body table, a body's BR_ROWS (odd) words together: row r of body j
// at s[j * BR_ROWS + r].
template <class R>
struct Table {
  R* s;
  __device__ R& at(int r, int j) const { return s[j * BR_ROWS + r]; }
  __device__ V3<R> v(int r, int j) const { return mk(at(r, j), at(r + 1, j), at(r + 2, j)); }
  __device__ Q<R> q(int r, int j) const { return {at(r, j), at(r + 1, j), at(r + 2, j), at(r + 3, j)}; }
  __device__ void add(int r, int j, V3<R> d) const {
    at(r, j) = at(r, j) + d.x; at(r + 1, j) = at(r + 1, j) + d.y; at(r + 2, j) = at(r + 2, j) + d.z;
  }
  // Body j's inverse inertia (constant over the solve).
  __device__ void ii(int j, R* out) const {
    for (int e = 0; e < 9; ++e) out[e] = at(BR_II + e, j);
  }
};

template <class R>
struct Params {
  R dt_sub, inv_dt_sub, erp_inv_dt, cfm_factor, allowed_lin_err,
      max_corrective_velocity, warmstart_coeff;
  int n_sub, pgs_iters, stab_iters, max_colors;
};

template <class R>
__device__ V3<R> tangent_direction(V3<R> dir1, V3<R> lv1, V3<R> lv2) {
  V3<R> rel = lv1 - lv2;
  V3<R> tan = rel - dir1 * dot(dir1, rel);
  R norm = msqrt(dot(tan, tan));
  V3<R> tan_n = tan / mmax(norm, Eps<R>::tiny());
  V3<R> a = mk(R(0), dir1.z, -dir1.y);
  V3<R> b = mk(-dir1.z, R(0), dir1.x);
  V3<R> fb = msqrt(dot(a, a)) > Eps<R>::axis() ? a : b;
  fb = fb / mmax(msqrt(dot(fb, fb)), Eps<R>::tiny());
  return norm < Eps<R>::slip() ? fb : tan_n;
}

// contact_constraints.generate_from + warmstart injection, one lane; `mf`
// points at the lane's column of the packed float rows.
template <class R, class LaneT>
__device__ void generate_lane(const LaneT& L, const R* mf, int K, int i1, int i2,
                              int flags, const Table<R>& T) {
  V3<R> v1l = T.v(BR_VLIN, i1), w1 = T.v(BR_VANG, i1), com1 = T.v(BR_COM, i1);
  V3<R> v2l = T.v(BR_VLIN, i2), w2 = T.v(BR_VANG, i2), com2 = T.v(BR_COM, i2);
  Q<R> rot1 = T.q(BR_ROT, i1), rot2 = T.q(BR_ROT, i2);
  V3<R> im1 = T.v(BR_IM, i1), im2 = T.v(BR_IM, i2);
  R ii1[9], ii2[9];
  T.ii(i1, ii1);
  T.ii(i2, ii2);

  V3<R> dir1 = -mk(mf[(MR_NORMAL) * K], mf[(MR_NORMAL + 1) * K], mf[(MR_NORMAL + 2) * K]);
  V3<R> tan1 = tangent_direction(dir1, v1l, v2l);
  V3<R> tan2 = cross(dir1, tan1);
  V3<R> pts[4];
  R fm[4];
  for (int k = 0; k < 4; ++k) {
    pts[k] = mk(mf[(MR_POINT + 3 * k) * K], mf[(MR_POINT + 3 * k + 1) * K],
                mf[(MR_POINT + 3 * k + 2) * K]);
    fm[k] = (flags >> (3 + k)) & 1 ? R(1) : R(0);
  }
  R npts = fm[0] + fm[1] + fm[2] + fm[3];
  R inv_np = R(1) / mmax(npts, R(1));
  V3<R> imsum = im1 + im2;
  R dir_im = dot(dir1, imsum * dir1);
  R rest = mf[MR_REST * K];
  for (int k = 0; k < 4; ++k) {
    V3<R> dp1 = pts[k] - com1, dp2 = pts[k] - com2;
    V3<R> vel1 = v1l + cross(w1, dp1), vel2 = v2l + cross(w2, dp2);
    V3<R> td1 = cross(dp1, dir1), td2 = cross(dp2, -dir1);
    V3<R> iitd1 = ii_mul(ii1, td1), iitd2 = ii_mul(ii2, td2);
    R denom = dir_im + dot(iitd1, td1) + dot(iitd2, td2);
    R proj = dot(vel1 - vel2, dir1);
    L.set(F_TD1 + 3 * k, td1);
    L.set(F_TD2 + 3 * k, td2);
    L[F_R + k] = R(1) / mmax(denom, Eps<R>::tiny());
    L.set(F_LP1 + 3 * k, inv_rotate(rot1, dp1));
    L.set(F_LP2 + 3 * k, inv_rotate(rot2, dp2));
    // `prev_impulse == 0` exactly: a new contact bounces whenever
    // restitution > 0, a persisting one only at restitution >= 1.
    R bouncy = mf[(MR_PREV + k) * K] == R(0) ? (rest > R(0) ? R(1) : R(0))
                                             : (rest >= R(1) ? R(1) : R(0));
    L[F_NVRHS + k] = bouncy * rest * proj;
    L[F_DIST0 + k] = mf[(MR_DIST + k) * K];
    L[F_RHS + k] = R(0);
    L[F_RHSWO + k] = R(0);
    L[F_IMP + k] = mf[(MR_WSN + k) * K] * fm[k];
    L[F_IMPACC + k] = R(0);
  }
  V3<R> fc = mk(R(0), R(0), R(0));
  for (int k = 0; k < 4; ++k) fc = fc + pts[k] * fm[k];
  fc = fc * inv_np;
  L.set(F_FC1, inv_rotate(rot1, fc - com1));
  L.set(F_FC2, inv_rotate(rot2, fc - com2));
  for (int k = 0; k < 4; ++k) {
    V3<R> d = fc - pts[k];
    L[F_TWD + k] = fm[k] > R(0) ? msqrt(mmax(dot(d, d), R(0))) : R(0);
  }
  V3<R> dfp1 = fc - com1, dfp2 = fc - com2;
  V3<R> tans[2] = {tan1, tan2};
  V3<R> ttd1[2], ttd2[2], tiitd1[2], tiitd2[2];
  R tr[2];
  for (int j = 0; j < 2; ++j) {
    ttd1[j] = cross(dfp1, tans[j]);
    ttd2[j] = cross(dfp2, -tans[j]);
    tiitd1[j] = ii_mul(ii1, ttd1[j]);
    tiitd2[j] = ii_mul(ii2, ttd2[j]);
    tr[j] = dot(tans[j], imsum * tans[j]) + dot(tiitd1[j], ttd1[j]) + dot(tiitd2[j], ttd2[j]);
    L.set(F_TTD1 + 3 * j, ttd1[j]);
    L.set(F_TTD2 + 3 * j, ttd2[j]);
  }
  L[F_TANR] = tr[0];
  L[F_TANR + 1] = tr[1];
  L[F_TANR + 2] = R(2) * (dot(tiitd1[0], ttd1[1]) + dot(tiitd2[0], ttd2[1]));
  V3<R> twii1 = ii_mul(ii1, dir1), twii2 = ii_mul(ii2, -dir1);
  L[F_TWR] = R(1) / mmax(dot(twii1, dir1) + dot(twii2, -dir1), Eps<R>::tiny());
  L.set(F_DIR1, dir1);
  L.set(F_TAN1, tan1);
  L[F_LIMIT] = mf[MR_FRIC * K];
  for (int j = 0; j < 2; ++j) {
    L[F_TRHS + j] = R(0);
    L[F_TIMP + j] = mf[(MR_WST + j) * K];
    L[F_TIMPACC + j] = R(0);
  }
  L[F_TWIMP] = mf[MR_WSTW * K];
  L[F_TWIMPACC] = R(0);
}

// contact_constraints.update, one lane.
template <class R, class LaneT>
__device__ void update_lane(const LaneT& L, int i1, int i2, const Table<R>& T,
                            const Params<R>& p) {
  V3<R> com1 = T.v(BR_COM, i1), com2 = T.v(BR_COM, i2);
  Q<R> rot1 = T.q(BR_ROT, i1), rot2 = T.q(BR_ROT, i2);
  V3<R> dir1 = L.v(F_DIR1);
  for (int k = 0; k < 4; ++k) {
    V3<R> a = com1 + rotate(rot1, L.v(F_LP1 + 3 * k));
    V3<R> b = com2 + rotate(rot2, L.v(F_LP2 + 3 * k));
    R dist = L[F_DIST0 + k] + dot(a - b, dir1);
    R rhs_wo = L[F_NVRHS + k] + mmax(dist, R(0)) * p.inv_dt_sub;
    R bias = mmin(mmax((dist + p.allowed_lin_err) * p.erp_inv_dt,
                       -p.max_corrective_velocity), R(0));
    L[F_RHSWO + k] = rhs_wo;
    L[F_RHS + k] = rhs_wo + bias;
    R imp = L[F_IMP + k];
    L[F_IMPACC + k] = L[F_IMPACC + k] + imp;
    L[F_IMP + k] = imp * p.warmstart_coeff;
  }
  V3<R> tan1 = L.v(F_TAN1);
  V3<R> tan2 = cross(dir1, tan1);
  V3<R> dfc = (com1 + rotate(rot1, L.v(F_FC1))) - (com2 + rotate(rot2, L.v(F_FC2)));
  // The tangent rhs without bias is zero after generation.
  L[F_TRHS] = R(0) + dot(dfc, tan1) * p.inv_dt_sub;
  L[F_TRHS + 1] = R(0) + dot(dfc, tan2) * p.inv_dt_sub;
  for (int j = 0; j < 2; ++j) {
    R t = L[F_TIMP + j];
    L[F_TIMPACC + j] = L[F_TIMPACC + j] + t;
    L[F_TIMP + j] = t * p.warmstart_coeff;
  }
  R tw = L[F_TWIMP];
  L[F_TWIMPACC] = L[F_TWIMPACC] + tw;
  L[F_TWIMP] = tw * p.warmstart_coeff;
}

// contact_constraints.warmstart: this (valid) lane's velocity deltas for
// both endpoints, stored in the delta rows.
template <class R, class LaneT>
__device__ void warmstart_lane(const LaneT& L, int i1, int i2, int flags, const Table<R>& T) {
  R imp[4];
  R imp_sum = R(0);
  for (int k = 0; k < 4; ++k) {
    R act = ((flags >> (3 + k)) & 1) ? R(1) : R(0);
    imp[k] = L[F_IMP + k] * act;
  }
  imp_sum = imp[0] + imp[1] + imp[2] + imp[3];
  V3<R> dir1 = L.v(F_DIR1), tan1 = L.v(F_TAN1);
  V3<R> im1 = T.v(BR_IM, i1), im2 = T.v(BR_IM, i2);
  R ii1[9], ii2[9];
  T.ii(i1, ii1);
  T.ii(i2, ii2);
  V3<R> dv1 = dir1 * im1 * imp_sum;
  V3<R> dv2 = -dir1 * im2 * imp_sum;
  V3<R> dw1 = mk(R(0), R(0), R(0)), dw2 = mk(R(0), R(0), R(0));
  for (int k = 0; k < 4; ++k) {
    dw1 = dw1 + ii_mul(ii1, L.v(F_TD1 + 3 * k)) * imp[k];
    dw2 = dw2 + ii_mul(ii2, L.v(F_TD2 + 3 * k)) * imp[k];
  }
  R ti0 = L[F_TIMP], ti1 = L[F_TIMP + 1];
  V3<R> tan_lin = tan1 * ti0 + cross(dir1, tan1) * ti1;
  dv1 = dv1 + tan_lin * im1;
  dv2 = dv2 - tan_lin * im2;
  dw1 = dw1 + ii_mul(ii1, L.v(F_TTD1)) * ti0 + ii_mul(ii1, L.v(F_TTD1 + 3)) * ti1;
  dw2 = dw2 + ii_mul(ii2, L.v(F_TTD2)) * ti0 + ii_mul(ii2, L.v(F_TTD2 + 3)) * ti1;
  R wi = L[F_TWIMP];
  dw1 = dw1 + ii_mul(ii1, dir1) * wi;
  dw2 = dw2 + ii_mul(ii2, -dir1) * wi;
  L.set(F_DELTA, dv1);
  L.set(F_DELTA + 3, dw1);
  L.set(F_DELTA + 6, dv2);
  L.set(F_DELTA + 9, dw2);
}

// contact_constraints.solve_color for one lane of the color being swept.
// Returns the velocity deltas of both endpoints through d[4] (dv1 dw1 dv2
// dw2) and updates the lane's impulses.
template <class R, class LaneT>
__device__ void solve_lane(const LaneT& L, int i1, int i2, int flags,
                           const Table<R>& T, bool use_bias, R cfm_factor,
                           V3<R>* d) {
  V3<R> v1 = T.v(BR_VLIN, i1), w1 = T.v(BR_VANG, i1);
  V3<R> v2 = T.v(BR_VLIN, i2), w2 = T.v(BR_VANG, i2);
  const V3<R> v1_0 = v1, w1_0 = w1, v2_0 = v2, w2_0 = w2;
  const R cfm = use_bias ? cfm_factor : R(1);
  const int rhs_f = use_bias ? F_RHS : F_RHSWO;
  V3<R> dir1 = L.v(F_DIR1);
  V3<R> im1 = T.v(BR_IM, i1), im2 = T.v(BR_IM, i2);
  R ii1[9], ii2[9];
  T.ii(i1, ii1);
  T.ii(i2, ii2);

  R imp[4], act[4];
  for (int k = 0; k < 4; ++k) {
    act[k] = (flags >> (3 + k)) & 1 ? R(1) : R(0);
    imp[k] = L[F_IMP + k];
    V3<R> td1 = L.v(F_TD1 + 3 * k), td2 = L.v(F_TD2 + 3 * k);
    R dvel = dot(dir1, v1) + dot(td1, w1) - dot(dir1, v2) + dot(td2, w2) + L[rhs_f + k];
    R new_imp = cfm * mmax(imp[k] - L[F_R + k] * dvel, R(0));
    R dl = (new_imp - imp[k]) * act[k];
    imp[k] = imp[k] + dl;
    v1 = v1 + dir1 * im1 * dl;
    w1 = w1 + ii_mul(ii1, td1) * dl;
    v2 = v2 - dir1 * im2 * dl;
    w2 = w2 + ii_mul(ii2, td2) * dl;
  }
  for (int k = 0; k < 4; ++k) L[F_IMP + k] = imp[k];

  // Friction limits scale with the solved normal impulses.
  R ar[4];
  for (int k = 0; k < 4; ++k) ar[k] = act[k] * imp[k];
  R limit = L[F_LIMIT];
  R tangent_limit = (ar[0] + ar[1] + ar[2] + ar[3]) * limit;
  R tw_sum = R(0);
  for (int k = 0; k < 4; ++k) tw_sum = tw_sum + ar[k] * L[F_TWD + k];
  R twist_limit = tw_sum * limit;

  // Coupled 2-D tangent solve (contact_constraint_element.rs:161-203).
  V3<R> tan1 = L.v(F_TAN1);
  V3<R> t2 = cross(dir1, tan1);
  R trhs0 = use_bias ? L[F_TRHS] : R(0), trhs1 = use_bias ? L[F_TRHS + 1] : R(0);
  V3<R> ttd1_0 = L.v(F_TTD1), ttd1_1 = L.v(F_TTD1 + 3);
  V3<R> ttd2_0 = L.v(F_TTD2), ttd2_1 = L.v(F_TTD2 + 3);
  R d0 = dot(tan1, v1) + dot(ttd1_0, w1) - dot(tan1, v2) + dot(ttd2_0, w2) + trhs0;
  R d1 = dot(t2, v1) + dot(ttd1_1, w1) - dot(t2, v2) + dot(ttd2_1, w2) + trhs1;
  R d00 = d0 * d0, d11 = d1 * d1, d01 = d0 * d1;
  R denom = d00 * L[F_TANR] + d11 * L[F_TANR + 1] + d01 * L[F_TANR + 2];
  R inv_lhs = (d00 + d11) / (mabs(denom) < Eps<R>::tiny() ? Eps<R>::tiny() : denom);
  R ti0 = L[F_TIMP], ti1 = L[F_TIMP + 1];
  R nt0 = ti0 - inv_lhs * d0;
  R nt1 = ti1 - inv_lhs * d1;
  R t_norm = msqrt(nt0 * nt0 + nt1 * nt1);
  R scale = t_norm > tangent_limit ? tangent_limit / mmax(t_norm, Eps<R>::tiny()) : R(1);
  R dl0 = nt0 * scale - ti0, dl1 = nt1 * scale - ti1;
  L[F_TIMP] = ti0 + dl0;
  L[F_TIMP + 1] = ti1 + dl1;
  V3<R> dvt = tan1 * dl0 + t2 * dl1;
  v1 = v1 + dvt * im1;
  v2 = v2 - dvt * im2;
  w1 = w1 + ii_mul(ii1, ttd1_0) * dl0 + ii_mul(ii1, ttd1_1) * dl1;
  w2 = w2 + ii_mul(ii2, ttd2_0) * dl0 + ii_mul(ii2, ttd2_1) * dl1;

  // Twist (only with >= 2 points), clamped to the twist limit.
  R npts = act[0] + act[1] + act[2] + act[3];
  R has_twist = npts > R(1.5) ? R(1) : R(0);
  R tw = L[F_TWIMP];
  R new_tw = mmin(mmax(tw - L[F_TWR] * dot(dir1, w1 - w2), -twist_limit), twist_limit);
  R dl_tw = (new_tw - tw) * has_twist;
  L[F_TWIMP] = tw + dl_tw;
  w1 = w1 + ii_mul(ii1, dir1) * dl_tw;
  w2 = w2 + ii_mul(ii2, -dir1) * dl_tw;

  d[0] = v1 - v1_0;
  d[1] = w1 - w1_0;
  d[2] = v2 - v2_0;
  d[3] = w2 - w2_0;
}

// The threads that solve one scene: a whole block, or one warp of a block.
struct BlockGroup {
  static constexpr int kSize = kBlockThreads;
  __device__ static int rank() { return threadIdx.x; }
  __device__ static void sync() { __syncthreads(); }
};
struct WarpGroup {
  static constexpr int kSize = 32;
  __device__ static int rank() { return threadIdx.x & 31; }
  __device__ static void sync() { __syncwarp(); }
};

// 4-byte words of one R.
template <class R>
constexpr int kWords = sizeof(R) / 4;
// Scenes per folded block: as many as fill the float block's shared words,
// so 8 at float and 4 at double (a scene's slice holds about as many lanes).
template <class R>
constexpr int kFoldScenes = 8 / kWords<R>;
template <class R>
constexpr int kFoldBlockThreads = kFoldScenes<R> * WarpGroup::kSize;
// Resident blocks of contact_sweep_kernel an SM: two at float; at double,
// one, so that a scene keeps ~190 lanes on chip (two would keep ~80, and a
// pile's 100-180 valid lanes would spill to the global scratch).
template <class R>
constexpr int kBlocksPerSM = sizeof(R) == 4 ? 2 : 1;
// Lanes a folded scene holds on chip at most: one per thread of its warp.
constexpr int kFoldMaxCapacity = 32;
// Shared memory of an SM, what each resident block reserves of it, and the
// most one block may use.
constexpr int kSmemPerSM = 233472;
constexpr int kSmemReserved = 1024;
constexpr int kSmemPerBlockMax = 232448;

// Color buckets: colors 0 .. max_colors - 1, and one for any other value (a
// lane no sweep reaches).
__device__ __forceinline__ int bucket(int color, int max_colors) {
  return color >= 0 && color < max_colors ? color : max_colors;
}

// Shared words of one scene before its lanes: body table (kWords<R> words
// a value), mover flags, endpoint-list offsets, conflict flags, bucket
// starts and counts, and the per-warp bucket counts of the compaction;
// rounded up to 16 bytes.
template <class R>
__host__ __device__ inline int scene_fixed_words(int n1, int max_colors, int warps) {
  const int nb = max_colors + 1;
  int words = kWords<R> * BR_ROWS * n1 + n1 + (n1 + 1) + max_colors + (nb + 1) + nb + warps * nb;
  return (words + 3) / 4 * 4;
}

// The words after `lanes` compacted lanes' info words and endpoint-list
// entries that bring their fields to a whole R: none at float.
template <class R>
__host__ __device__ inline int lane_pad(int lanes) {
  return sizeof(R) == 4 ? 0 : ((IF + 2) * lanes) & 1;
}

// 4-byte words of `lanes` compacted lanes' storage on chip: their int
// words, the pad, then LF fields a lane.
template <class R>
__host__ __device__ inline int lanes_words(int lanes) {
  return (IF + 2) * lanes + lane_pad<R>(lanes) + kWords<R> * LF * lanes;
}

// R a lane of a scene's global scratch takes, its int words rounded up:
// the scene's K lanes fit kLaneReals<R> * K of them.
template <class R>
constexpr int kLaneReals = sizeof(R) == 4 ? kLaneWords : LF + (IF + 2 + 1) / 2;

// One scene's inputs and shared tables.
template <class R>
struct Scene {
  const R* mf;       // packed float rows [MR_ROWS, K]
  const int* mi;     // packed int rows [4, K]
  Table<R> T;
  int* s_move;
  int* s_off;        // [n1 + 1] endpoint-list offsets
  int* s_conflict;   // [max_colors] self-conflicting colors
  int* s_cstart;     // [nb + 1] first compacted lane of each color bucket
  int* s_ccnt;       // [nb] lanes placed so far per bucket
  int* s_wcc;        // [warps, nb] a compaction chunk's bucket counts per warp
  int K, n1, nv, ncol, nb;
};

// Everything after the scene's valid lanes are counted: compaction, lists,
// generation, the substep loop and the valid lanes' outputs.  Room for
// `lanes` compacted lanes at `store`: their info words, [2 * lanes]
// endpoint-list entries, then (at an R boundary) their fields.  kOnChip
// says whether `store` is the scene's shared memory past its fixed words (a
// lane's words together: [lanes, IF] and [lanes, LF]) or its slice of the
// global scratch (field-major: [IF, lanes] and [LF, lanes]); the arithmetic
// is the same code.
template <class G, bool kOnChip, class R>
__device__ __forceinline__ void solve_lanes(const Scene<R>& S, R* store, int lanes,
                                            R* __restrict__ oi, const Params<R>& p) {
  constexpr int NT = G::kSize;
  const int tid = G::rank(), warp = tid >> 5, wl = tid & 31;
  const int K = S.K, n1 = S.n1, nv = S.nv, nb = S.nb;
  const int n = n1 - 1;  // sentinel column
  const Table<R>& T = S.T;
  const int* mi = S.mi;
  int* const info_words = reinterpret_cast<int*>(store);
  int* const csr = info_words + IF * lanes;
  R* const state = reinterpret_cast<R*>(csr + 2 * lanes + lane_pad<R>(lanes));
  auto info = [&](int pos, int w) -> int& {
    return info_words[kOnChip ? pos * IF + w : w * lanes + pos];
  };
  auto lane = [&](int pos) {
    if constexpr (kOnChip)
      return Lane<R, true>{state + pos * LF, 1};
    else
      return Lane<R, false>{state + pos, lanes};
  };

  // Compaction, color-major: the valid lanes of color bucket c take
  // positions s_cstart[c] .. s_cstart[c + 1] - 1 in lane order, so a color
  // pass runs on consecutive threads.  A chunk ranks its lanes within their
  // bucket by warp (__match_any_sync) and across the warps before.
  for (int k0 = 0; k0 < K; k0 += NT) {
    const int k = k0 + tid;
    const int flags = k < K ? mi[IR_FLAGS * K + k] : 0;
    const int color = flags & 1 ? mi[IR_COLOR * K + k] : 0;
    const int c = flags & 1 ? bucket(color, p.max_colors) : -1;
    const unsigned m = __match_any_sync(0xffffffffu, c);
    const int wr = __popc(m & ((1u << wl) - 1u));
    if (c >= 0 && wr == 0) S.s_wcc[warp * nb + c] = __popc(m);
    G::sync();
    if (c >= 0) {
      int pos = S.s_cstart[c] + S.s_ccnt[c] + wr;
      for (int w = 0; w < warp; ++w) pos += S.s_wcc[w * nb + c];
      info(pos, I_B1) = mi[IR_B1 * K + k];
      info(pos, I_B2) = mi[IR_B2 * K + k];
      info(pos, I_COLOR) = color;
      info(pos, I_FLAGS) = flags;
      info(pos, I_LANE) = k;
    }
    G::sync();
    for (int b = tid; b < nb; b += NT) {
      int placed = 0;
      for (int w = 0; w < NT / 32; ++w) {
        placed += S.s_wcc[w * nb + b];
        S.s_wcc[w * nb + b] = 0;
      }
      S.s_ccnt[b] += placed;
    }
    G::sync();
  }

  // Per-body endpoint lists, in the reference's order restricted to valid
  // lanes: endpoint-1 entries by lane index, then endpoint-2 entries.  An
  // entry is 2 * position + endpoint; each body's thread gathers its entries
  // and sorts them by (endpoint, lane).  Sentinel endpoints are never listed.
  auto entry_key = [&](int e) { return (e & 1) * K + info(e >> 1, I_LANE); };
  for (int j = tid; j < n1; j += NT) {
    int cnt = 0;
    if (j < n)
      for (int pos = 0; pos < nv; ++pos)
        cnt += (info(pos, I_B1) == j) + (info(pos, I_B2) == j);
    S.s_off[j + 1] = cnt;
  }
  G::sync();
  if (tid == 0) {
    S.s_off[0] = 0;
    for (int j = 0; j < n1; ++j) S.s_off[j + 1] += S.s_off[j];
  }
  G::sync();
  for (int j = tid; j < n; j += NT) {
    const int lo = S.s_off[j], hi = S.s_off[j + 1];
    int w = lo;
    for (int pos = 0; pos < nv; ++pos) {
      if (info(pos, I_B1) == j) csr[w++] = 2 * pos;
      if (info(pos, I_B2) == j) csr[w++] = 2 * pos + 1;
    }
    for (int a = lo + 1; a < hi; ++a) {
      const int e = csr[a], key = entry_key(e);
      int b = a - 1;
      for (; b >= lo && entry_key(csr[b]) > key; --b) csr[b + 1] = csr[b];
      csr[b + 1] = e;
    }
    // A color is self-conflicting when two lanes of it share this dynamic
    // body.
    for (int a = lo; a < hi; ++a) {
      const int ea = csr[a];
      if (!((info(ea >> 1, I_FLAGS) >> (1 + (ea & 1))) & 1)) continue;
      const int ca = info(ea >> 1, I_COLOR);
      for (int c2 = a + 1; c2 < hi; ++c2) {
        const int eb = csr[c2];
        if (!((info(eb >> 1, I_FLAGS) >> (1 + (eb & 1))) & 1)) continue;
        if (ca == info(eb >> 1, I_COLOR) && ca >= 0 && ca < p.max_colors)
          S.s_conflict[ca] = 1;
      }
    }
  }

  for (int pos = tid; pos < nv; pos += NT)
    generate_lane(lane(pos), S.mf + info(pos, I_LANE), K, info(pos, I_B1),
                  info(pos, I_B2), info(pos, I_FLAGS), T);

  // Each body's thread adds the listed deltas of the lanes of `color` (all
  // lanes when color < 0) to its velocities.
  auto owner_sum = [&](int color) {
    const int lo = color >= 0 ? S.s_cstart[color] : 0;
    const int hi = color >= 0 ? S.s_cstart[color + 1] : nv;
    for (int j = tid; j < n; j += NT) {
      V3<R> dv = mk(R(0), R(0), R(0)), dw = mk(R(0), R(0), R(0));
      for (int a = S.s_off[j]; a < S.s_off[j + 1]; ++a) {
        const int e = csr[a], pos = e >> 1, ep = e & 1;
        if (pos < lo || pos >= hi) continue;
        const auto L = lane(pos);
        dv = dv + L.v(F_DELTA + 6 * ep);
        dw = dw + L.v(F_DELTA + 6 * ep + 3);
      }
      T.add(BR_VLIN, j, dv);
      T.add(BR_VANG, j, dw);
    }
  };

  auto sweep = [&](bool use_bias) {
    for (int c = 0; c < S.ncol; ++c) {
      G::sync();
      const bool conflict = S.s_conflict[c] != 0;
      for (int pos = S.s_cstart[c] + tid; pos < S.s_cstart[c + 1]; pos += NT) {
        const int flags = info(pos, I_FLAGS);
        const int i1 = info(pos, I_B1), i2 = info(pos, I_B2);
        const auto L = lane(pos);
        V3<R> d[4];
        solve_lane(L, i1, i2, flags, T, use_bias, p.cfm_factor, d);
        if (conflict) {
          for (int q = 0; q < 4; ++q) L.set(F_DELTA + 3 * q, d[q]);
        } else {
          if ((flags & 2) && i1 < n) { T.add(BR_VLIN, i1, d[0]); T.add(BR_VANG, i1, d[1]); }
          if ((flags & 4) && i2 < n) { T.add(BR_VLIN, i2, d[2]); T.add(BR_VANG, i2, d[3]); }
        }
      }
      if (conflict) {
        G::sync();
        owner_sum(c);
      }
    }
  };

  for (int s = 0; s < p.n_sub; ++s) {
    G::sync();
    for (int j = tid; j < n1; j += NT) {
      T.add(BR_VLIN, j, T.v(BR_DV, j));
      T.add(BR_VANG, j, T.v(BR_DW, j));
    }
    G::sync();
    for (int pos = tid; pos < nv; pos += NT) {
      const int i1 = info(pos, I_B1), i2 = info(pos, I_B2);
      update_lane(lane(pos), i1, i2, T, p);
      warmstart_lane(lane(pos), i1, i2, info(pos, I_FLAGS), T);
    }
    G::sync();
    owner_sum(-1);
    for (int it = 0; it < p.pgs_iters; ++it) sweep(true);
    G::sync();
    // integrate_poses, masked to movers (pallas_sweep.py:88-99, 221-225).
    for (int j = tid; j < n1; j += NT) {
      if (!S.s_move[j]) continue;
      V3<R> v = T.v(BR_VLIN, j), w = T.v(BR_VANG, j);
      T.add(BR_COM, j, v * p.dt_sub);
      Q<R> q = T.q(BR_ROT, j);
      R h = p.dt_sub * R(0.5);
      R hx = w.x * h, hy = w.y * h, hz = w.z * h;
      R rx = q.x + hx * q.w + hy * q.z - hz * q.y;
      R ry = q.y - hx * q.z + hy * q.w + hz * q.x;
      R rz = q.z + hx * q.y - hy * q.x + hz * q.w;
      R rw = q.w - hx * q.x - hy * q.y - hz * q.z;
      R n2 = rx * rx + ry * ry + rz * rz + rw * rw;
      R inv = R(1) / msqrt(mmax(n2, Eps<R>::norm2()));
      T.at(BR_ROT, j) = rx * inv;
      T.at(BR_ROT + 1, j) = ry * inv;
      T.at(BR_ROT + 2, j) = rz * inv;
      T.at(BR_ROT + 3, j) = rw * inv;
    }
    for (int it = 0; it < p.stab_iters; ++it) sweep(false);
  }
  // A color pass puts a lane on thread (position - color start), not on the
  // thread that writes it out.
  G::sync();

  for (int pos = tid; pos < nv; pos += NT) {
    const auto L = lane(pos);
    const int k = info(pos, I_LANE);
    for (int q = 0; q < 4; ++q) {
      oi[q * K + k] = L[F_IMP + q];
      oi[(4 + q) * K + k] = L[F_IMPACC + q];
    }
    for (int q = 0; q < 2; ++q) {
      oi[(8 + q) * K + k] = L[F_TIMP + q];
      oi[(10 + q) * K + k] = L[F_TIMPACC + q];
    }
    oi[12 * K + k] = L[F_TWIMP];
    oi[13 * K + k] = L[F_TWIMPACC];
  }
}

// Solve scene `b` with the threads of group G, its tables in `smem` and room
// there for `cap` compacted lanes.  `scratch` (may be null when cap >= K)
// holds a scene's lanes when it has more than `cap` valid ones.
template <class G, class R>
__device__ __forceinline__ void solve_scene(
    int b, R* smem, const R* __restrict__ man_f, const int* __restrict__ man_i,
    const R* __restrict__ bodies_in, const int* __restrict__ move_in,
    const int* __restrict__ ncol_in, R* __restrict__ out_body,
    R* __restrict__ out_imp, R* __restrict__ scratch, int K, int n1, int cap,
    const Params<R>& p) {
  constexpr int NT = G::kSize;
  const int tid = G::rank();
  const int mc = p.max_colors, nb = mc + 1;
  Scene<R> S;
  S.mf = man_f + (size_t)b * MR_ROWS * K;
  S.mi = man_i + (size_t)b * 4 * K;
  S.T = Table<R>{smem};
  S.s_move = reinterpret_cast<int*>(smem + BR_ROWS * n1);
  S.s_off = S.s_move + n1;
  S.s_conflict = S.s_off + n1 + 1;
  S.s_cstart = S.s_conflict + mc;
  S.s_ccnt = S.s_cstart + nb + 1;
  S.s_wcc = S.s_ccnt + nb;
  S.K = K;
  S.n1 = n1;
  S.nb = nb;
  S.ncol = min(ncol_in[b], mc);

  // The body table, transposed to a body's rows together.
  const R* bin = bodies_in + (size_t)b * BR_ROWS * n1;
  for (int i = tid; i < BR_ROWS * n1; i += NT) {
    const int r = i / n1;
    smem[(i - r * n1) * BR_ROWS + r] = bin[i];
  }
  for (int j = tid; j < n1; j += NT) S.s_move[j] = move_in[(size_t)b * n1 + j];
  for (int c = tid; c < mc; c += NT) S.s_conflict[c] = 0;
  for (int c = tid; c < nb; c += NT) S.s_ccnt[c] = 0;
  for (int i = tid; i < (NT / 32) * nb; i += NT) S.s_wcc[i] = 0;
  G::sync();

  // Count the valid lanes of each color bucket (integer counts: the order
  // of the atomic adds does not matter), then take the storage that holds
  // them.
  for (int k = tid; k < K; k += NT) {
    const int flags = S.mi[IR_FLAGS * K + k];
    if (flags & 1) atomicAdd(&S.s_ccnt[bucket(S.mi[IR_COLOR * K + k], mc)], 1);
  }
  G::sync();
  if (tid == 0) {
    S.s_cstart[0] = 0;
    for (int c = 0; c < nb; ++c) {
      S.s_cstart[c + 1] = S.s_cstart[c] + S.s_ccnt[c];
      S.s_ccnt[c] = 0;
    }
  }
  G::sync();
  const int nv = S.s_cstart[nb];
  S.nv = nv;
  R* oi = out_imp + (size_t)b * 14 * K;
  if (nv <= cap)
    solve_lanes<G, true>(S, smem + scene_fixed_words<R>(n1, mc, NT / 32) / kWords<R>, cap, oi,
                         p);
  else
    solve_lanes<G, false>(S, scratch + (size_t)b * kLaneReals<R> * K, K, oi, p);

  // Unsolved lanes: generation sets their impulses from the warmstart, each
  // substep accumulates and decays them, no pass touches them.
  for (int k = tid; k < K; k += NT) {
    const int flags = S.mi[IR_FLAGS * K + k];
    if (flags & 1) continue;
    const R* mf = S.mf + k;
    for (int q = 0; q < 4; ++q) {
      R imp = mf[(MR_WSN + q) * K] * ((flags >> (3 + q)) & 1 ? R(1) : R(0)), acc = R(0);
      for (int s = 0; s < p.n_sub; ++s) { acc = acc + imp; imp = imp * p.warmstart_coeff; }
      oi[q * K + k] = imp;
      oi[(4 + q) * K + k] = acc;
    }
    for (int q = 0; q < 3; ++q) {
      // Rows 8-9 / 10-11 are tangent impulse / accumulator, 12 / 13 twist.
      R imp = q < 2 ? mf[(MR_WST + q) * K] : mf[MR_WSTW * K], acc = R(0);
      for (int s = 0; s < p.n_sub; ++s) { acc = acc + imp; imp = imp * p.warmstart_coeff; }
      oi[(q < 2 ? 8 + q : 12) * K + k] = imp;
      oi[(q < 2 ? 10 + q : 13) * K + k] = acc;
    }
  }
  G::sync();

  R* ob = out_body + (size_t)b * 13 * n1;
  for (int i = tid; i < 13 * n1; i += NT) {
    const int r = i / n1;
    ob[i] = smem[(i - r * n1) * BR_ROWS + r];
  }
}

// One block per scene; kBlocksPerSM<R> blocks share an SM.  The float and
// double kernels are overloads of one name.
__global__ void __launch_bounds__(kBlockThreads, kBlocksPerSM<float>)
contact_sweep_kernel(const float* __restrict__ man_f, const int* __restrict__ man_i,
                     const float* __restrict__ bodies_in, const int* __restrict__ move_in,
                     const int* __restrict__ ncol_in, float* __restrict__ out_body,
                     float* __restrict__ out_imp, float* __restrict__ scratch, int K,
                     int n1, int cap, Params<float> p) {
  extern __shared__ float smem[];
  solve_scene<BlockGroup>(blockIdx.x, smem, man_f, man_i, bodies_in, move_in, ncol_in,
                          out_body, out_imp, scratch, K, n1, cap, p);
}

__global__ void __launch_bounds__(kBlockThreads, kBlocksPerSM<double>)
contact_sweep_kernel(const double* __restrict__ man_f, const int* __restrict__ man_i,
                     const double* __restrict__ bodies_in, const int* __restrict__ move_in,
                     const int* __restrict__ ncol_in, double* __restrict__ out_body,
                     double* __restrict__ out_imp, double* __restrict__ scratch, int K,
                     int n1, int cap, Params<double> p) {
  extern __shared__ double smem_f64[];
  solve_scene<BlockGroup>(blockIdx.x, smem_f64, man_f, man_i, bodies_in, move_in, ncol_in,
                          out_body, out_imp, scratch, K, n1, cap, p);
}

// kFoldScenes<R> scenes per block, one warp each, in shared-memory slices of
// `slice` R; two blocks share an SM.  A warp without a scene leaves at
// once: no block-wide barrier follows, so no warp ever waits for another.
__global__ void __launch_bounds__(kFoldBlockThreads<float>, 2)
contact_sweep_folded_kernel(const float* __restrict__ man_f, const int* __restrict__ man_i,
                            const float* __restrict__ bodies_in,
                            const int* __restrict__ move_in, const int* __restrict__ ncol_in,
                            float* __restrict__ out_body, float* __restrict__ out_imp,
                            float* __restrict__ scratch, int B, int K, int n1, int cap,
                            int slice, Params<float> p) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / WarpGroup::kSize;
  const int b = blockIdx.x * kFoldScenes<float> + warp;
  if (b >= B) return;
  solve_scene<WarpGroup>(b, smem + (size_t)warp * slice, man_f, man_i, bodies_in, move_in,
                         ncol_in, out_body, out_imp, scratch, K, n1, cap, p);
}

__global__ void __launch_bounds__(kFoldBlockThreads<double>, 2)
contact_sweep_folded_kernel(const double* __restrict__ man_f, const int* __restrict__ man_i,
                            const double* __restrict__ bodies_in,
                            const int* __restrict__ move_in, const int* __restrict__ ncol_in,
                            double* __restrict__ out_body, double* __restrict__ out_imp,
                            double* __restrict__ scratch, int B, int K, int n1, int cap,
                            int slice, Params<double> p) {
  extern __shared__ double smem_f64[];
  const int warp = threadIdx.x / WarpGroup::kSize;
  const int b = blockIdx.x * kFoldScenes<double> + warp;
  if (b >= B) return;
  solve_scene<WarpGroup>(b, smem_f64 + (size_t)warp * slice, man_f, man_i, bodies_in,
                         move_in, ncol_in, out_body, out_imp, scratch, K, n1, cap, p);
}

template <class R>
int fixed_words(bool folded, int n1, int max_colors) {
  return scene_fixed_words<R>(n1, max_colors, folded ? 1 : kBlockThreads / 32);
}

// Lanes one scene holds on chip, from the shapes alone: as many as let
// kBlocksPerSM<R> blocks share an SM (the block kernel takes a whole
// block's maximum where they do not fit), and a folded scene at most a
// warp's width.
template <class R>
int capacity(bool folded, int K, int n1, int max_colors) {
  const int fixed = fixed_words<R>(folded, n1, max_colors);
  const int lane = kWords<R> * LF + IF + 2;
  const int share = (kSmemPerSM / (folded ? 2 : kBlocksPerSM<R>) - kSmemReserved) / 4;
  int words = (folded ? share / kFoldScenes<R> : share) - fixed;
  if (!folded && words < lane) words = kSmemPerBlockMax / 4 - fixed;
  // An odd lane count pads its int words to a whole R.
  int cap = words > 0 ? (words - (kWords<R> - 1)) / lane : 0;
  if (folded && cap > kFoldMaxCapacity) cap = kFoldMaxCapacity;
  return cap < K ? cap : K;
}

// One scene's shared words, rounded up to 16 bytes.
template <class R>
int scene_words(bool folded, int K, int n1, int max_colors) {
  int words = fixed_words<R>(folded, n1, max_colors) +
              lanes_words<R>(capacity<R>(folded, K, n1, max_colors));
  return (words + 3) / 4 * 4;
}

template <class R>
size_t smem_bytes(bool folded, int K, int n1, int max_colors) {
  return 4 * (size_t)(folded ? kFoldScenes<R> : 1) * scene_words<R>(folded, K, n1, max_colors);
}

template <class R>
const void* kernel_fn(bool folded) {
  void (*block)(const R*, const int*, const R*, const int*, const int*, R*, R*, R*, int, int,
                int, Params<R>) = contact_sweep_kernel;
  void (*fold)(const R*, const int*, const R*, const int*, const int*, R*, R*, R*, int, int,
               int, int, int, Params<R>) = contact_sweep_folded_kernel;
  return folded ? (const void*)fold : (const void*)block;
}

template <class R>
int kernel_info(bool folded, int K, int n1, int max_colors, int* out) {
  const void* fn = kernel_fn<R>(folded);
  size_t smem = smem_bytes<R>(folded, K, n1, max_colors);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, folded ? kFoldBlockThreads<R> : kBlockThreads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return 0;
}

template <class R>
int launch(bool fold, const R* man_f, const int* man_i, const R* bodies_in, const int* move,
           const int* ncol, R* out_body, R* out_imp, R* scratch, int B, int K, int n1,
           const Params<R>& p, void* stream) {
  const int cap = capacity<R>(fold, K, n1, p.max_colors);
  size_t smem = smem_bytes<R>(fold, K, n1, p.max_colors);
  cudaError_t err = cudaFuncSetAttribute(
      kernel_fn<R>(fold), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (fold) {
    int grid = (B + kFoldScenes<R> - 1) / kFoldScenes<R>;
    contact_sweep_folded_kernel<<<grid, kFoldBlockThreads<R>, smem, s>>>(
        man_f, man_i, bodies_in, move, ncol, out_body, out_imp, scratch, B, K, n1, cap,
        scene_words<R>(true, K, n1, p.max_colors) / kWords<R>, p);
  } else {
    contact_sweep_kernel<<<B, kBlockThreads, smem, s>>>(
        man_f, man_i, bodies_in, move, ncol, out_body, out_imp, scratch, K, n1, cap, p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int contact_sweep_body_rows() { return BR_ROWS; }
int contact_sweep_man_rows() { return MR_ROWS; }

// The entries below take `f64`: 0 for the float kernels, 1 for the double
// ones.

// 4-byte words of one scene's global scratch: [B, this] words in all.
int contact_sweep_scratch_words(int f64, int K) {
  return f64 ? kWords<double> * kLaneReals<double> * K : kWords<float> * kLaneReals<float> * K;
}

int contact_sweep_capacity(int f64, int folded, int K, int n1, int max_colors) {
  return f64 ? capacity<double>(folded != 0, K, n1, max_colors)
             : capacity<float>(folded != 0, K, n1, max_colors);
}

size_t contact_sweep_smem_bytes(int f64, int folded, int K, int n1, int max_colors) {
  return f64 ? smem_bytes<double>(folded != 0, K, n1, max_colors)
             : smem_bytes<float>(folded != 0, K, n1, max_colors);
}

// The kernel's resources at this shape: out[0] registers a thread, out[1]
// local (spill) bytes a thread, out[2] dynamic shared bytes a block, out[3]
// resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// Returns a CUDA error code (0 on success).
int contact_sweep_kernel_info(int f64, int folded, int K, int n1, int max_colors, int* out) {
  return f64 ? kernel_info<double>(folded != 0, K, n1, max_colors, out)
             : kernel_info<float>(folded != 0, K, n1, max_colors, out);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `scratch`
// holds [B, contact_sweep_scratch_words(0, K)] words when the capacity is
// below K, and may be null otherwise.
int contact_sweep_launch(int folded, const float* man_f, const int* man_i,
                         const float* bodies_in, const int* move, const int* ncol,
                         float* out_body, float* out_imp, float* scratch, int B, int K,
                         int n1, int n_sub, int pgs_iters, int stab_iters,
                         int max_colors, float dt_sub, float inv_dt_sub,
                         float erp_inv_dt, float cfm_factor, float allowed_lin_err,
                         float max_corrective_velocity, float warmstart_coeff,
                         void* stream) {
  Params<float> p{dt_sub, inv_dt_sub, erp_inv_dt, cfm_factor, allowed_lin_err,
                  max_corrective_velocity, warmstart_coeff, n_sub, pgs_iters, stab_iters,
                  max_colors};
  return launch<float>(folded != 0, man_f, man_i, bodies_in, move, ncol, out_body, out_imp,
                       scratch, B, K, n1, p, stream);
}

// The same at double: every float input, output and scalar a double, the
// scratch [B, contact_sweep_scratch_words(1, K)] words.
int contact_sweep_launch_f64(int folded, const double* man_f, const int* man_i,
                             const double* bodies_in, const int* move, const int* ncol,
                             double* out_body, double* out_imp, double* scratch, int B,
                             int K, int n1, int n_sub, int pgs_iters, int stab_iters,
                             int max_colors, double dt_sub, double inv_dt_sub,
                             double erp_inv_dt, double cfm_factor, double allowed_lin_err,
                             double max_corrective_velocity, double warmstart_coeff,
                             void* stream) {
  Params<double> p{dt_sub, inv_dt_sub, erp_inv_dt, cfm_factor, allowed_lin_err,
                   max_corrective_velocity, warmstart_coeff, n_sub, pgs_iters, stab_iters,
                   max_colors};
  return launch<double>(folded != 0, man_f, man_i, bodies_in, move, ncol, out_body, out_imp,
                        scratch, B, K, n1, p, stream);
}

}  // extern "C"
