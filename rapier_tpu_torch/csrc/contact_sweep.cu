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
// Design.  One thread block per scene; threads stride over the K solver
// lanes.  The scene's body table (v_lin, v_ang, com, rot, im, ii, dv, dw:
// 31 floats, plus the mover flag, per body) sits in shared memory, so every
// gather and scatter of a color pass is a shared-memory access; a pass is
// "lanes of color c read both endpoints, solve, write their deltas", then
// __syncthreads().  Each lane's constraint state (~171 floats) lives in a
// global scratch buffer laid out [field][lane], so neighbouring threads
// touch neighbouring addresses; a scene's state (~180 KB at K = 256) stays
// L2-resident while its block runs.
//
// Writes.  In a conflict-free color a lane adds its deltas to its dynamic
// endpoints directly.  A color in which two lanes share a dynamic body (the
// Luby overflow color, wherever the renumbering put it; detected per scene
// at block start) and the warmstart (a sum over all lanes) first store every
// lane's deltas, computed from the pre-pass velocities; then each body's
// thread sums its endpoints' deltas in lane order (endpoint-1 lanes, then
// endpoint-2 lanes, the reference's route order) from a per-scene endpoint
// list.  No float atomics: a run reproduces bit for bit.  The sentinel
// column N (static and dominant endpoints) is never written.
//
// Bounds on an H100.  The work per scene is small and sequential across
// colors (~8 colors x 2 sweeps x 4 substeps of barrier-separated passes),
// so the kernel is latency-bound: barriers, shared-memory round trips and
// the L2 traffic of the lane state, not FLOPs or HBM bandwidth.  At 128
// registers a thread two blocks are resident per SM (264 on the card), so
// 4096 scenes run in ~16 waves; a many-scene batch, not a faster block, is
// what fills the card (PERF.md has the times).  Shared memory bounds
// the scene size: 33 words per body plus the per-color flags must fit the
// 227 KB a block can use (~1,750 bodies); the wrapper refuses larger scenes.
// Compiled with -fmad=false so the arithmetic rounds like the plain version.
//
// The scene-folded kernel (`_kernel_folded`'s counterpart).  Small scenes
// (the batched quadruped: K = 128 lanes, 17 body columns, ~9 solved lanes)
// leave most of a 256-thread block idle behind block-wide barriers, and the
// block's latency, not its work, sets the time.  The folded kernel packs
// kFoldScenes = 8 scenes into a block, one warp per scene: each warp owns an
// aligned shared-memory slice (the same body table, mover flags, endpoint
// lists and conflict flags), strides its scene's lanes by 32 and separates
// passes with __syncwarp(), so the scenes of a block never wait on each
// other and a block costs 8 x ~2.3 KB of shared memory at N1 = 17.  Both
// kernels run the same per-scene code (`solve_scene`, templated on the
// thread group), so they agree bit for bit; a scene sweeps its own color
// count where the TPU kernel swept the batch maximum (the extra colors are
// empty: the same function).  Its byte bound is ~30 KB a scene; on an H100
// it is far from it and no faster than the block kernel at 4096 quadruped
// scenes (PERF.md).  The suspect, not yet measured: every lane of a scene,
// solved or not (~9 of 128 are), is generated and updated in the global
// scratch (~90 KB a scene), and with 16 scenes resident per SM the scratch
// in flight overflows the 50 MB L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
// Constraint fields in the scratch buffer [B, CF, K] (contact_constraints
// ContactConstraints); vectors are 3 consecutive fields, per-point vectors
// 4 x 3.
enum Field {
  F_DIR1 = 0, F_TAN1 = 3, F_IM1 = 6, F_IM2 = 9, F_LIMIT = 12,
  F_TD1 = 13, F_TD2 = 25, F_IITD1 = 37, F_IITD2 = 49, F_R = 61,
  F_LP1 = 65, F_LP2 = 77, F_DIST0 = 89, F_NVRHS = 93, F_RHS = 97,
  F_RHSWO = 101, F_IMP = 105, F_IMPACC = 109,
  F_TTD1 = 113, F_TTD2 = 119, F_TIITD1 = 125, F_TIITD2 = 131, F_TANR = 137,
  F_TRHS = 140, F_TIMP = 142, F_TIMPACC = 144, F_FC1 = 146, F_FC2 = 149,
  F_TWII1 = 152, F_TWII2 = 155, F_TWR = 158, F_TWD = 159, F_TWIMP = 163,
  F_TWIMPACC = 164, F_DELTA = 165,  // 12 delta rows: dv1 dw1 dv2 dw2
  CF = 177
};

struct V3 { float x, y, z; };

__device__ __forceinline__ V3 mk(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator/(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

struct Q { float x, y, z, w; };

__device__ __forceinline__ V3 rotate(Q q, V3 v) {
  V3 u = mk(q.x, q.y, q.z);
  V3 t = cross(u, v) * 2.0f;
  return v + t * q.w + cross(u, t);
}
__device__ __forceinline__ V3 inv_rotate(Q q, V3 v) {
  return rotate({-q.x, -q.y, -q.z, q.w}, v);
}
__device__ __forceinline__ V3 ii_mul(const float* ii, V3 v) {
  return {ii[0] * v.x + ii[1] * v.y + ii[2] * v.z,
          ii[3] * v.x + ii[4] * v.y + ii[5] * v.z,
          ii[6] * v.x + ii[7] * v.y + ii[8] * v.z};
}

// Lane view of the scratch buffer: field f of this lane at base[f * K].
struct Lane {
  float* base;
  int K;
  __device__ float& operator[](int f) const { return base[(size_t)f * K]; }
  __device__ V3 v(int f) const { return mk((*this)[f], (*this)[f + 1], (*this)[f + 2]); }
  __device__ void set(int f, V3 a) const {
    (*this)[f] = a.x; (*this)[f + 1] = a.y; (*this)[f + 2] = a.z;
  }
};

// Shared body table: row r, body j.
struct Table {
  float* s;
  int n1;
  __device__ float& at(int r, int j) const { return s[r * n1 + j]; }
  __device__ V3 v(int r, int j) const { return mk(at(r, j), at(r + 1, j), at(r + 2, j)); }
  __device__ Q q(int r, int j) const { return {at(r, j), at(r + 1, j), at(r + 2, j), at(r + 3, j)}; }
  __device__ void add(int r, int j, V3 d) const {
    at(r, j) = at(r, j) + d.x; at(r + 1, j) = at(r + 1, j) + d.y; at(r + 2, j) = at(r + 2, j) + d.z;
  }
};

struct Params {
  float dt_sub, inv_dt_sub, erp_inv_dt, cfm_factor, allowed_lin_err,
      max_corrective_velocity, warmstart_coeff;
  int n_sub, pgs_iters, stab_iters, max_colors;
};

__device__ V3 tangent_direction(V3 dir1, V3 lv1, V3 lv2) {
  V3 rel = lv1 - lv2;
  V3 tan = rel - dir1 * dot(dir1, rel);
  float norm = sqrtf(dot(tan, tan));
  V3 tan_n = tan / fmaxf(norm, 1e-12f);
  V3 a = mk(0.0f, dir1.z, -dir1.y);
  V3 b = mk(-dir1.z, 0.0f, dir1.x);
  V3 fb = sqrtf(dot(a, a)) > 1e-6f ? a : b;
  fb = fb / fmaxf(sqrtf(dot(fb, fb)), 1e-12f);
  return norm < 1e-4f ? fb : tan_n;
}

// contact_constraints.generate_from + warmstart injection, one lane.
__device__ void generate_lane(const Lane& L, const float* mf, const int* mi,
                              int K, const Table& T) {
  int i1 = mi[IR_B1 * K], i2 = mi[IR_B2 * K];
  int flags = mi[IR_FLAGS * K];
  V3 v1l = T.v(BR_VLIN, i1), w1 = T.v(BR_VANG, i1), com1 = T.v(BR_COM, i1);
  V3 v2l = T.v(BR_VLIN, i2), w2 = T.v(BR_VANG, i2), com2 = T.v(BR_COM, i2);
  Q rot1 = T.q(BR_ROT, i1), rot2 = T.q(BR_ROT, i2);
  V3 im1 = T.v(BR_IM, i1), im2 = T.v(BR_IM, i2);
  float ii1[9], ii2[9];
  for (int e = 0; e < 9; ++e) { ii1[e] = T.at(BR_II + e, i1); ii2[e] = T.at(BR_II + e, i2); }

  V3 dir1 = -mk(mf[(MR_NORMAL) * K], mf[(MR_NORMAL + 1) * K], mf[(MR_NORMAL + 2) * K]);
  V3 tan1 = tangent_direction(dir1, v1l, v2l);
  V3 tan2 = cross(dir1, tan1);
  V3 pts[4];
  float fm[4];
  for (int k = 0; k < 4; ++k) {
    pts[k] = mk(mf[(MR_POINT + 3 * k) * K], mf[(MR_POINT + 3 * k + 1) * K],
                mf[(MR_POINT + 3 * k + 2) * K]);
    fm[k] = (flags >> (3 + k)) & 1 ? 1.0f : 0.0f;
  }
  float npts = fm[0] + fm[1] + fm[2] + fm[3];
  float inv_np = 1.0f / fmaxf(npts, 1.0f);
  V3 imsum = im1 + im2;
  float dir_im = dot(dir1, imsum * dir1);
  float rest = mf[MR_REST * K];
  for (int k = 0; k < 4; ++k) {
    V3 dp1 = pts[k] - com1, dp2 = pts[k] - com2;
    V3 vel1 = v1l + cross(w1, dp1), vel2 = v2l + cross(w2, dp2);
    V3 td1 = cross(dp1, dir1), td2 = cross(dp2, -dir1);
    V3 iitd1 = ii_mul(ii1, td1), iitd2 = ii_mul(ii2, td2);
    float denom = dir_im + dot(iitd1, td1) + dot(iitd2, td2);
    float proj = dot(vel1 - vel2, dir1);
    L.set(F_TD1 + 3 * k, td1);
    L.set(F_TD2 + 3 * k, td2);
    L.set(F_IITD1 + 3 * k, iitd1);
    L.set(F_IITD2 + 3 * k, iitd2);
    L[F_R + k] = 1.0f / fmaxf(denom, 1e-12f);
    L.set(F_LP1 + 3 * k, inv_rotate(rot1, dp1));
    L.set(F_LP2 + 3 * k, inv_rotate(rot2, dp2));
    // `prev_impulse == 0` exactly: a new contact bounces whenever
    // restitution > 0, a persisting one only at restitution >= 1.
    float bouncy = mf[(MR_PREV + k) * K] == 0.0f ? (rest > 0.0f ? 1.0f : 0.0f)
                                                 : (rest >= 1.0f ? 1.0f : 0.0f);
    L[F_NVRHS + k] = bouncy * rest * proj;
    L[F_DIST0 + k] = mf[(MR_DIST + k) * K];
    L[F_RHS + k] = 0.0f;
    L[F_RHSWO + k] = 0.0f;
    L[F_IMP + k] = mf[(MR_WSN + k) * K] * fm[k];
    L[F_IMPACC + k] = 0.0f;
  }
  V3 fc = mk(0.0f, 0.0f, 0.0f);
  for (int k = 0; k < 4; ++k) fc = fc + pts[k] * fm[k];
  fc = fc * inv_np;
  L.set(F_FC1, inv_rotate(rot1, fc - com1));
  L.set(F_FC2, inv_rotate(rot2, fc - com2));
  for (int k = 0; k < 4; ++k) {
    V3 d = fc - pts[k];
    L[F_TWD + k] = fm[k] > 0.0f ? sqrtf(fmaxf(dot(d, d), 0.0f)) : 0.0f;
  }
  V3 dfp1 = fc - com1, dfp2 = fc - com2;
  V3 tans[2] = {tan1, tan2};
  V3 ttd1[2], ttd2[2], tiitd1[2], tiitd2[2];
  float tr[2];
  for (int j = 0; j < 2; ++j) {
    ttd1[j] = cross(dfp1, tans[j]);
    ttd2[j] = cross(dfp2, -tans[j]);
    tiitd1[j] = ii_mul(ii1, ttd1[j]);
    tiitd2[j] = ii_mul(ii2, ttd2[j]);
    tr[j] = dot(tans[j], imsum * tans[j]) + dot(tiitd1[j], ttd1[j]) + dot(tiitd2[j], ttd2[j]);
    L.set(F_TTD1 + 3 * j, ttd1[j]);
    L.set(F_TTD2 + 3 * j, ttd2[j]);
    L.set(F_TIITD1 + 3 * j, tiitd1[j]);
    L.set(F_TIITD2 + 3 * j, tiitd2[j]);
  }
  L[F_TANR] = tr[0];
  L[F_TANR + 1] = tr[1];
  L[F_TANR + 2] = 2.0f * (dot(tiitd1[0], ttd1[1]) + dot(tiitd2[0], ttd2[1]));
  V3 twii1 = ii_mul(ii1, dir1), twii2 = ii_mul(ii2, -dir1);
  L.set(F_TWII1, twii1);
  L.set(F_TWII2, twii2);
  L[F_TWR] = 1.0f / fmaxf(dot(twii1, dir1) + dot(twii2, -dir1), 1e-12f);
  L.set(F_DIR1, dir1);
  L.set(F_TAN1, tan1);
  L.set(F_IM1, im1);
  L.set(F_IM2, im2);
  L[F_LIMIT] = mf[MR_FRIC * K];
  for (int j = 0; j < 2; ++j) {
    L[F_TRHS + j] = 0.0f;
    L[F_TIMP + j] = mf[(MR_WST + j) * K];
    L[F_TIMPACC + j] = 0.0f;
  }
  L[F_TWIMP] = mf[MR_WSTW * K];
  L[F_TWIMPACC] = 0.0f;
}

// contact_constraints.update, one lane.
__device__ void update_lane(const Lane& L, int i1, int i2, const Table& T,
                            const Params& p) {
  V3 com1 = T.v(BR_COM, i1), com2 = T.v(BR_COM, i2);
  Q rot1 = T.q(BR_ROT, i1), rot2 = T.q(BR_ROT, i2);
  V3 dir1 = L.v(F_DIR1);
  for (int k = 0; k < 4; ++k) {
    V3 a = com1 + rotate(rot1, L.v(F_LP1 + 3 * k));
    V3 b = com2 + rotate(rot2, L.v(F_LP2 + 3 * k));
    float dist = L[F_DIST0 + k] + dot(a - b, dir1);
    float rhs_wo = L[F_NVRHS + k] + fmaxf(dist, 0.0f) * p.inv_dt_sub;
    float bias = fminf(fmaxf((dist + p.allowed_lin_err) * p.erp_inv_dt,
                             -p.max_corrective_velocity), 0.0f);
    L[F_RHSWO + k] = rhs_wo;
    L[F_RHS + k] = rhs_wo + bias;
    float imp = L[F_IMP + k];
    L[F_IMPACC + k] = L[F_IMPACC + k] + imp;
    L[F_IMP + k] = imp * p.warmstart_coeff;
  }
  V3 tan1 = L.v(F_TAN1);
  V3 tan2 = cross(dir1, tan1);
  V3 dfc = (com1 + rotate(rot1, L.v(F_FC1))) - (com2 + rotate(rot2, L.v(F_FC2)));
  // The tangent rhs without bias is zero after generation.
  L[F_TRHS] = 0.0f + dot(dfc, tan1) * p.inv_dt_sub;
  L[F_TRHS + 1] = 0.0f + dot(dfc, tan2) * p.inv_dt_sub;
  for (int j = 0; j < 2; ++j) {
    float t = L[F_TIMP + j];
    L[F_TIMPACC + j] = L[F_TIMPACC + j] + t;
    L[F_TIMP + j] = t * p.warmstart_coeff;
  }
  float tw = L[F_TWIMP];
  L[F_TWIMPACC] = L[F_TWIMPACC] + tw;
  L[F_TWIMP] = tw * p.warmstart_coeff;
}

// contact_constraints.warmstart: this lane's velocity deltas for both
// endpoints, stored in the delta rows.
__device__ void warmstart_lane(const Lane& L, bool valid, int flags) {
  float imp[4];
  float imp_sum = 0.0f;
  for (int k = 0; k < 4; ++k) {
    float act = (valid && ((flags >> (3 + k)) & 1)) ? 1.0f : 0.0f;
    imp[k] = L[F_IMP + k] * act;
  }
  imp_sum = imp[0] + imp[1] + imp[2] + imp[3];
  V3 dir1 = L.v(F_DIR1), im1 = L.v(F_IM1), im2 = L.v(F_IM2), tan1 = L.v(F_TAN1);
  V3 dv1 = dir1 * im1 * imp_sum;
  V3 dv2 = -dir1 * im2 * imp_sum;
  V3 dw1 = mk(0.0f, 0.0f, 0.0f), dw2 = mk(0.0f, 0.0f, 0.0f);
  for (int k = 0; k < 4; ++k) {
    dw1 = dw1 + L.v(F_IITD1 + 3 * k) * imp[k];
    dw2 = dw2 + L.v(F_IITD2 + 3 * k) * imp[k];
  }
  float vm = valid ? 1.0f : 0.0f;
  float ti0 = L[F_TIMP] * vm, ti1 = L[F_TIMP + 1] * vm;
  V3 tan_lin = tan1 * ti0 + cross(dir1, tan1) * ti1;
  dv1 = dv1 + tan_lin * im1;
  dv2 = dv2 - tan_lin * im2;
  dw1 = dw1 + L.v(F_TIITD1) * ti0 + L.v(F_TIITD1 + 3) * ti1;
  dw2 = dw2 + L.v(F_TIITD2) * ti0 + L.v(F_TIITD2 + 3) * ti1;
  float wi = L[F_TWIMP] * vm;
  dw1 = dw1 + L.v(F_TWII1) * wi;
  dw2 = dw2 + L.v(F_TWII2) * wi;
  L.set(F_DELTA, dv1);
  L.set(F_DELTA + 3, dw1);
  L.set(F_DELTA + 6, dv2);
  L.set(F_DELTA + 9, dw2);
}

// contact_constraints.solve_color for one lane of the color being swept.
// Returns the velocity deltas of both endpoints through d[4] (dv1 dw1 dv2
// dw2) and updates the lane's impulses.
__device__ void solve_lane(const Lane& L, int i1, int i2, int flags,
                           const Table& T, bool use_bias, float cfm_factor,
                           V3* d) {
  V3 v1 = T.v(BR_VLIN, i1), w1 = T.v(BR_VANG, i1);
  V3 v2 = T.v(BR_VLIN, i2), w2 = T.v(BR_VANG, i2);
  const V3 v1_0 = v1, w1_0 = w1, v2_0 = v2, w2_0 = w2;
  const float cfm = use_bias ? cfm_factor : 1.0f;
  const int rhs_f = use_bias ? F_RHS : F_RHSWO;
  V3 dir1 = L.v(F_DIR1), im1 = L.v(F_IM1), im2 = L.v(F_IM2);

  float imp[4], act[4];
  for (int k = 0; k < 4; ++k) {
    act[k] = (flags >> (3 + k)) & 1 ? 1.0f : 0.0f;
    imp[k] = L[F_IMP + k];
    V3 td1 = L.v(F_TD1 + 3 * k), td2 = L.v(F_TD2 + 3 * k);
    float dvel = dot(dir1, v1) + dot(td1, w1) - dot(dir1, v2) + dot(td2, w2) + L[rhs_f + k];
    float new_imp = cfm * fmaxf(imp[k] - L[F_R + k] * dvel, 0.0f);
    float dl = (new_imp - imp[k]) * act[k];
    imp[k] = imp[k] + dl;
    v1 = v1 + dir1 * im1 * dl;
    w1 = w1 + L.v(F_IITD1 + 3 * k) * dl;
    v2 = v2 - dir1 * im2 * dl;
    w2 = w2 + L.v(F_IITD2 + 3 * k) * dl;
  }
  for (int k = 0; k < 4; ++k) L[F_IMP + k] = imp[k];

  // Friction limits scale with the solved normal impulses.
  float ar[4];
  for (int k = 0; k < 4; ++k) ar[k] = act[k] * imp[k];
  float limit = L[F_LIMIT];
  float tangent_limit = (ar[0] + ar[1] + ar[2] + ar[3]) * limit;
  float tw_sum = 0.0f;
  for (int k = 0; k < 4; ++k) tw_sum = tw_sum + ar[k] * L[F_TWD + k];
  float twist_limit = tw_sum * limit;

  // Coupled 2-D tangent solve (contact_constraint_element.rs:161-203).
  V3 tan1 = L.v(F_TAN1);
  V3 t2 = cross(dir1, tan1);
  float trhs0 = use_bias ? L[F_TRHS] : 0.0f, trhs1 = use_bias ? L[F_TRHS + 1] : 0.0f;
  V3 ttd1_0 = L.v(F_TTD1), ttd1_1 = L.v(F_TTD1 + 3);
  V3 ttd2_0 = L.v(F_TTD2), ttd2_1 = L.v(F_TTD2 + 3);
  float d0 = dot(tan1, v1) + dot(ttd1_0, w1) - dot(tan1, v2) + dot(ttd2_0, w2) + trhs0;
  float d1 = dot(t2, v1) + dot(ttd1_1, w1) - dot(t2, v2) + dot(ttd2_1, w2) + trhs1;
  float d00 = d0 * d0, d11 = d1 * d1, d01 = d0 * d1;
  float denom = d00 * L[F_TANR] + d11 * L[F_TANR + 1] + d01 * L[F_TANR + 2];
  float inv_lhs = (d00 + d11) / (fabsf(denom) < 1e-12f ? 1e-12f : denom);
  float ti0 = L[F_TIMP], ti1 = L[F_TIMP + 1];
  float nt0 = ti0 - inv_lhs * d0;
  float nt1 = ti1 - inv_lhs * d1;
  float t_norm = sqrtf(nt0 * nt0 + nt1 * nt1);
  float scale = t_norm > tangent_limit ? tangent_limit / fmaxf(t_norm, 1e-12f) : 1.0f;
  float dl0 = nt0 * scale - ti0, dl1 = nt1 * scale - ti1;
  L[F_TIMP] = ti0 + dl0;
  L[F_TIMP + 1] = ti1 + dl1;
  V3 dvt = tan1 * dl0 + t2 * dl1;
  v1 = v1 + dvt * im1;
  v2 = v2 - dvt * im2;
  w1 = w1 + L.v(F_TIITD1) * dl0 + L.v(F_TIITD1 + 3) * dl1;
  w2 = w2 + L.v(F_TIITD2) * dl0 + L.v(F_TIITD2 + 3) * dl1;

  // Twist (only with >= 2 points), clamped to the twist limit.
  float npts = act[0] + act[1] + act[2] + act[3];
  float has_twist = npts > 1.5f ? 1.0f : 0.0f;
  float tw = L[F_TWIMP];
  float new_tw = fminf(fmaxf(tw - L[F_TWR] * dot(dir1, w1 - w2), -twist_limit), twist_limit);
  float dl_tw = (new_tw - tw) * has_twist;
  L[F_TWIMP] = tw + dl_tw;
  w1 = w1 + L.v(F_TWII1) * dl_tw;
  w2 = w2 + L.v(F_TWII2) * dl_tw;

  d[0] = v1 - v1_0;
  d[1] = w1 - w1_0;
  d[2] = v2 - v2_0;
  d[3] = w2 - w2_0;
}

__device__ __forceinline__ int entry_body(const int* mi, int K, int e) {
  return e < K ? mi[IR_B1 * K + e] : mi[IR_B2 * K + (e - K)];
}

// The threads that solve one scene: a whole block, or one warp of a block.
struct BlockGroup {
  static constexpr int kSize = kThreads;
  __device__ static int rank() { return threadIdx.x; }
  __device__ static void sync() { __syncthreads(); }
};
struct WarpGroup {
  static constexpr int kSize = 32;
  __device__ static int rank() { return threadIdx.x & 31; }
  __device__ static void sync() { __syncwarp(); }
};

constexpr int kFoldScenes = kThreads / WarpGroup::kSize;  // scenes per folded block

// Solve scene `b` with the threads of group G, its tables in `smem`.
template <class G>
__device__ __forceinline__ void solve_scene(
    int b, float* smem, const float* __restrict__ man_f, const int* __restrict__ man_i,
    const float* __restrict__ bodies_in, const int* __restrict__ move_in,
    const int* __restrict__ ncol_in, float* __restrict__ out_body,
    float* __restrict__ out_imp, float* __restrict__ scratch, int* __restrict__ csr_g,
    int K, int n1, const Params& p) {
  constexpr int NT = G::kSize;
  const int tid = G::rank();
  const int n = n1 - 1;  // sentinel column
  Table T{smem, n1};
  int* s_move = reinterpret_cast<int*>(smem + BR_ROWS * n1);
  int* s_off = s_move + n1;            // [n1 + 1] endpoint-list offsets
  int* s_conflict = s_off + n1 + 1;    // [max_colors] self-conflicting colors

  const float* mf = man_f + (size_t)b * MR_ROWS * K;
  const int* mi = man_i + (size_t)b * 4 * K;
  const float* bin = bodies_in + (size_t)b * BR_ROWS * n1;
  int* csr = csr_g + (size_t)b * 2 * K;
  float* sc = scratch + (size_t)b * CF * K;

  for (int i = tid; i < BR_ROWS * n1; i += NT) smem[i] = bin[i];
  for (int j = tid; j < n1; j += NT) s_move[j] = move_in[(size_t)b * n1 + j];
  for (int c = tid; c < p.max_colors; c += NT) s_conflict[c] = 0;
  const int ncol = ncol_in[b];

  // Per-body endpoint lists, in entry order e = lane (endpoint 1) then
  // K + lane (endpoint 2).  Sentinel endpoints are never listed.
  for (int j = tid; j < n1; j += NT) {
    int cnt = 0;
    if (j < n)
      for (int e = 0; e < 2 * K; ++e) cnt += entry_body(mi, K, e) == j;
    s_off[j + 1] = cnt;
  }
  G::sync();
  if (tid == 0) {
    s_off[0] = 0;
    for (int j = 0; j < n1; ++j) s_off[j + 1] += s_off[j];
  }
  G::sync();
  for (int j = tid; j < n; j += NT) {
    int w = s_off[j];
    for (int e = 0; e < 2 * K; ++e)
      if (entry_body(mi, K, e) == j) csr[w++] = e;
    // A color is self-conflicting when two valid lanes of it share this
    // dynamic body.
    for (int a = s_off[j]; a < s_off[j + 1]; ++a) {
      int ea = csr[a], la = ea % K;
      int fa = mi[IR_FLAGS * K + la];
      if (!(fa & 1) || !((fa >> (1 + ea / K)) & 1)) continue;
      for (int c2 = a + 1; c2 < s_off[j + 1]; ++c2) {
        int eb = csr[c2], lb = eb % K;
        int fb = mi[IR_FLAGS * K + lb];
        if (!(fb & 1) || !((fb >> (1 + eb / K)) & 1)) continue;
        int ca = mi[IR_COLOR * K + la];
        if (ca == mi[IR_COLOR * K + lb] && ca < p.max_colors) s_conflict[ca] = 1;
      }
    }
  }
  G::sync();

  for (int k = tid; k < K; k += NT)
    generate_lane(Lane{sc + k, K}, mf + k, mi + k, K, T);

  // Each body's thread adds the listed deltas of the lanes selected by
  // `color` (all lanes when color < 0) to its velocities.
  auto owner_sum = [&](int color) {
    for (int j = tid; j < n; j += NT) {
      V3 dv = mk(0.0f, 0.0f, 0.0f), dw = mk(0.0f, 0.0f, 0.0f);
      for (int a = s_off[j]; a < s_off[j + 1]; ++a) {
        int e = csr[a], lane = e % K, ep = e / K;
        if (color >= 0 && !((mi[IR_FLAGS * K + lane] & 1) &&
                            mi[IR_COLOR * K + lane] == color))
          continue;
        Lane L{sc + lane, K};
        dv = dv + L.v(F_DELTA + 6 * ep);
        dw = dw + L.v(F_DELTA + 6 * ep + 3);
      }
      T.add(BR_VLIN, j, dv);
      T.add(BR_VANG, j, dw);
    }
  };

  auto sweep = [&](bool use_bias) {
    for (int c = 0; c < ncol; ++c) {
      G::sync();
      const bool conflict = s_conflict[c] != 0;
      for (int k = tid; k < K; k += NT) {
        int flags = mi[IR_FLAGS * K + k];
        if (!(flags & 1) || mi[IR_COLOR * K + k] != c) continue;
        int i1 = mi[IR_B1 * K + k], i2 = mi[IR_B2 * K + k];
        Lane L{sc + k, K};
        V3 d[4];
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
    for (int k = tid; k < K; k += NT) {
      Lane L{sc + k, K};
      update_lane(L, mi[IR_B1 * K + k], mi[IR_B2 * K + k], T, p);
      warmstart_lane(L, mi[IR_FLAGS * K + k] & 1, mi[IR_FLAGS * K + k]);
    }
    G::sync();
    owner_sum(-1);
    for (int it = 0; it < p.pgs_iters; ++it) sweep(true);
    G::sync();
    // integrate_poses, masked to movers (pallas_sweep.py:88-99, 221-225).
    for (int j = tid; j < n1; j += NT) {
      if (!s_move[j]) continue;
      V3 v = T.v(BR_VLIN, j), w = T.v(BR_VANG, j);
      T.add(BR_COM, j, v * p.dt_sub);
      Q q = T.q(BR_ROT, j);
      float h = p.dt_sub * 0.5f;
      float hx = w.x * h, hy = w.y * h, hz = w.z * h;
      float rx = q.x + hx * q.w + hy * q.z - hz * q.y;
      float ry = q.y - hx * q.z + hy * q.w + hz * q.x;
      float rz = q.z + hx * q.y - hy * q.x + hz * q.w;
      float rw = q.w - hx * q.x - hy * q.y - hz * q.z;
      float n2 = rx * rx + ry * ry + rz * rz + rw * rw;
      float inv = 1.0f / sqrtf(fmaxf(n2, 1e-24f));
      T.at(BR_ROT, j) = rx * inv;
      T.at(BR_ROT + 1, j) = ry * inv;
      T.at(BR_ROT + 2, j) = rz * inv;
      T.at(BR_ROT + 3, j) = rw * inv;
    }
    for (int it = 0; it < p.stab_iters; ++it) sweep(false);
  }
  G::sync();

  float* ob = out_body + (size_t)b * 13 * n1;
  for (int i = tid; i < 13 * n1; i += NT) ob[i] = smem[i];
  float* oi = out_imp + (size_t)b * 14 * K;
  for (int k = tid; k < K; k += NT) {
    Lane L{sc + k, K};
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

// One block per scene.
__global__ void __launch_bounds__(kThreads)
contact_sweep_kernel(const float* __restrict__ man_f, const int* __restrict__ man_i,
                     const float* __restrict__ bodies_in, const int* __restrict__ move_in,
                     const int* __restrict__ ncol_in, float* __restrict__ out_body,
                     float* __restrict__ out_imp, float* __restrict__ scratch,
                     int* __restrict__ csr_g, int K, int n1, Params p) {
  extern __shared__ float smem[];
  solve_scene<BlockGroup>(blockIdx.x, smem, man_f, man_i, bodies_in, move_in, ncol_in,
                          out_body, out_imp, scratch, csr_g, K, n1, p);
}

// kFoldScenes scenes per block, one warp each, in shared-memory slices of
// `slice` floats.  A warp without a scene leaves at once: no block-wide
// barrier follows, so no warp ever waits for another.
__global__ void __launch_bounds__(kThreads)
contact_sweep_folded_kernel(const float* __restrict__ man_f, const int* __restrict__ man_i,
                            const float* __restrict__ bodies_in,
                            const int* __restrict__ move_in, const int* __restrict__ ncol_in,
                            float* __restrict__ out_body, float* __restrict__ out_imp,
                            float* __restrict__ scratch, int* __restrict__ csr_g, int B,
                            int K, int n1, int slice, Params p) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / WarpGroup::kSize;
  const int b = blockIdx.x * kFoldScenes + warp;
  if (b >= B) return;
  solve_scene<WarpGroup>(b, smem + (size_t)warp * slice, man_f, man_i, bodies_in, move_in,
                         ncol_in, out_body, out_imp, scratch, csr_g, K, n1, p);
}

}  // namespace

extern "C" {

int contact_sweep_scratch_fields() { return CF; }
int contact_sweep_body_rows() { return BR_ROWS; }
int contact_sweep_man_rows() { return MR_ROWS; }

size_t contact_sweep_smem_bytes(int n1, int max_colors) {
  return sizeof(float) * (size_t)BR_ROWS * n1 + sizeof(int) * ((size_t)2 * n1 + 1 + max_colors);
}

// One folded scene's slice in floats, rounded up to 16 bytes.
static int folded_slice_floats(int n1, int max_colors) {
  int words = (int)(contact_sweep_smem_bytes(n1, max_colors) / sizeof(float));
  return (words + 3) / 4 * 4;
}

size_t contact_sweep_folded_smem_bytes(int n1, int max_colors) {
  return sizeof(float) * (size_t)kFoldScenes * folded_slice_floats(n1, max_colors);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
int contact_sweep_launch(const float* man_f, const int* man_i, const float* bodies_in,
                         const int* move, const int* ncol, float* out_body,
                         float* out_imp, float* scratch, int* csr, int B, int K,
                         int n1, int n_sub, int pgs_iters, int stab_iters,
                         int max_colors, float dt_sub, float inv_dt_sub,
                         float erp_inv_dt, float cfm_factor, float allowed_lin_err,
                         float max_corrective_velocity, float warmstart_coeff,
                         void* stream) {
  Params p{dt_sub, inv_dt_sub, erp_inv_dt, cfm_factor, allowed_lin_err,
           max_corrective_velocity, warmstart_coeff, n_sub, pgs_iters, stab_iters,
           max_colors};
  size_t smem = contact_sweep_smem_bytes(n1, max_colors);
  cudaError_t err = cudaFuncSetAttribute(
      contact_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  contact_sweep_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      man_f, man_i, bodies_in, move, ncol, out_body, out_imp, scratch, csr, K, n1, p);
  return (int)cudaGetLastError();
}

// The scene-folded kernel on `stream`; the same arguments.
int contact_sweep_folded_launch(const float* man_f, const int* man_i, const float* bodies_in,
                                const int* move, const int* ncol, float* out_body,
                                float* out_imp, float* scratch, int* csr, int B, int K,
                                int n1, int n_sub, int pgs_iters, int stab_iters,
                                int max_colors, float dt_sub, float inv_dt_sub,
                                float erp_inv_dt, float cfm_factor, float allowed_lin_err,
                                float max_corrective_velocity, float warmstart_coeff,
                                void* stream) {
  Params p{dt_sub, inv_dt_sub, erp_inv_dt, cfm_factor, allowed_lin_err,
           max_corrective_velocity, warmstart_coeff, n_sub, pgs_iters, stab_iters,
           max_colors};
  size_t smem = contact_sweep_folded_smem_bytes(n1, max_colors);
  cudaError_t err = cudaFuncSetAttribute(
      contact_sweep_folded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int grid = (B + kFoldScenes - 1) / kFoldScenes;
  contact_sweep_folded_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      man_f, man_i, bodies_in, move, ncol, out_body, out_imp, scratch, csr, B, K, n1,
      folded_slice_floats(n1, max_colors), p);
  return (int)cudaGetLastError();
}

}  // extern "C"
