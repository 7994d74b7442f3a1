// Kernel 1: n_iter damped Gauss-Newton iterations of the condensed lanes MPC
// solver in one launch, with a group of lanes of a warp per instance.
//
// Replaces cartpole_tpu/ops/fused.py::make_fused_iteration (the Pallas TPU
// megakernel: pallas_call at ops/fused.py:938, tile body at :214-743) in its
// single_launch mode. Plain PyTorch version, mirrored stage by stage:
// cartpole_tpu_torch/ops/fused.py::fused_iteration_reference.
//
// What bounds it on an H100. At the bench point (B=4096, K=40, N=9, S=8,
// sp=5, four terminal rows, 8 iterations) a solve needs ~4.7e9 f32
// operations and moves ~3.7 MB: the operations bound it, ~0.07 ms at
// 67 TFLOP/s. Per instance-iteration the work is a long chain of dependent
// scalar arithmetic, so what holds a kernel back is latency and instruction
// throughput: one thread per instance gives B / 32 = 128 warps, one per SM,
// with nothing to hide a latency behind, and a per-thread working set that
// spills.
//
// Layout. Each instance gets LANES consecutive lanes of a warp (a warp or
// half of one; fused_iteration.cu) and its own workspace in dynamic shared
// memory, sized from the runtime shape (make_layout; ~1.7k reals, 6.7 KB in
// f32 at the bench point). The carry lives there for all n_iter iterations
// and goes to device memory once, at the end. The KKT solve's buffers, what
// the adjoint stage hands on, and the line-search trials share one region.
// A block holds W instances and first stages the eigenbasis Q, with its row
// stride padded to K + 1 so that lanes over a row index hit distinct banks,
// and the eigenvalues. The u-cost Jacobian, the largest static, is read
// from device memory through the read-only cache, so that shared memory
// holds more instances. Registers, not shared memory, then cap how many
// instances an SM holds.
//
// Stages. An iteration is a fixed sequence of stages, each a function of
// (lane, n_lanes) over the workspace; the executor runs every lane of the
// group through a stage and then synchronises them (__syncwarp on the
// card). A stage reads only what earlier stages wrote, and each lane writes
// its own outputs. Lanes take segments in the linearization, columns of M
// in the condensation, output indices in the spectral products, rows in the
// QR's updates, and (trial, segment) pairs and u-cost rows in the line
// search. The QR's dot products, the Schur solves, the recursions over
// segments and the scalar logic run on single lanes. Every output is
// computed whole by one lane, with its inner sums in the plain version's
// order; the maxima of the first-order diagnostic are taken in any order,
// which a max allows. No sum is split across lanes, so there is no
// cross-lane reduction and no atomic, the result does not depend on the
// number of lanes, and one launch of n_iter iterations equals n_iter
// launches of one. host_check.cc runs the same stages lane by lane on the
// CPU.
//
// Every function is __host__ __device__ and templated on the real type T.
// The linearization is kernel 2's chain rule (segment_jac.cuh), with the
// RK4 stage sums accumulated as they come (rk4_step_jac_acc: the same
// operations, fewer live registers).
//
// Models. The model (segment_jac.cuh's SingleCartPole, DoubleCartPole,
// TripleCartPole) is a compile-time parameter: what depends on it (its
// state and parameter counts, its terminal rows, at most one per state
// coordinate, the workspace layout they give, and its generated cores) is
// a static member of Body<Model>; the configuration, the statics and the
// per-instance scalars are shared. The double's and triple's per-lane
// chain-rule arrays grow with SD^2, so their instantiations run at the
// register cap with spills (PERF.md has the counts and times).
#pragma once

#include "segment_jac.cuh"

namespace fused {

// The largest count of terminal rows (costs + equalities): one per state
// coordinate of the largest compiled model. FusedArgs holds this many.
constexpr int ROWS_MAX = segjac::SD_MAX;

// Configuration passed by value (mirrored by ops/fused.py::_args_struct).
template <typename T>
struct FusedArgs {
  int B, K, N, S, sp, n_u, n_tc, n_t, n_ls, n_iter, angle_mask;
  // Terminal rows: soft costs first, then hard equalities.
  int row_coord[ROWS_MAX];
  int row_is_angle[ROWS_MAX];
  int row_is_setpoint[ROWS_MAX];
  T row_target[ROWS_MAX];
  T w_costs[ROWS_MAX];
  T D_diag[ROWS_MAX];
  T sqrtD[ROWS_MAX];
  // dt, dt/2, dt/6 rounded from double, as the reference's scalars are.
  T dt, h_half, h_sixth, u_limit, b_x_limit, w_du, w_u;
  T penalty_margin, armijo_c1, slack_coef, lambda_decrease, lambda_increase,
      lambda_failure_floor, lambda_max, relative_exit_tol, abs_first_tol;
};

// Device (or host) pointers, batch-last layouts (mirrored by _Tensors).
template <typename T>
struct FusedTensors {
  const T* params;  // (NP, B)
  const T* Q;       // (K, K)
  const T* eigs;    // (K,)
  const T* Juc;     // (n_u, K)
  const T* xc;      // (SD, B)
  const T* spt;     // (B,)
  const T* up;      // (B,)
  const T* xs;      // (SD, N, B)
  const T* u;       // (K, B)
  const T* lam;
  const T* mu;
  const T* merit;
  const int* done;
  const int* term;
  const T* fo;
  T* xs_o;
  T* u_o;
  T* lam_o;
  T* mu_o;
  T* merit_o;
  int* done_o;
  int* term_o;
  T* fo_o;
  T* tr_cost;  // (n_iter, B) each
  T* tr_viol;
  T* tr_lam;
  T* tr_alpha;
  T* tr_first;
  int* tr_applied;
};

__host__ __device__ inline float abs_t(float a) { return fabsf(a); }
__host__ __device__ inline double abs_t(double a) { return fabs(a); }
__host__ __device__ inline float sqrt_t(float a) { return sqrtf(a); }
__host__ __device__ inline double sqrt_t(double a) { return sqrt(a); }
template <typename T>
__host__ __device__ inline T qr_eps();
template <>
__host__ __device__ inline float qr_eps<float>() { return 1.0e-6f; }
template <>
__host__ __device__ inline double qr_eps<double>() { return 1.0e-14; }

// x - x is 0 exactly for finite x and NaN for inf/NaN.
template <typename T>
__host__ __device__ inline bool finite_t(T x) { return (x - x) == T(0); }
using cartpole_gen::dyn_max;  // NaN-propagating, like jnp.maximum
template <typename T>
__host__ __device__ inline T clip_t(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);  // NaN passes through
}

using segjac::mod_pi;

template <typename T>
__host__ __device__ inline T wrap(const FusedArgs<T>& a, int i, T v) {
  return segjac::wrap(a.angle_mask, i, v);
}

template <typename T>
__host__ __device__ inline T row_target(const FusedArgs<T>& a, int r, T spt) {
  return a.row_is_setpoint[r] ? spt : a.row_target[r];
}

template <typename T>
__host__ __device__ inline T row_diff(const FusedArgs<T>& a, int r,
                                      const T* xl, T spt) {
  T d = xl[a.row_coord[r]] - row_target(a, r, spt);
  return a.row_is_angle[r] ? mod_pi(d) : d;
}

// Row r of the u-cost residual: the K - 1 difference rows and the
// continuity row (when w_du > 0), then the K magnitude rows (when w_u > 0).
template <typename T>
__host__ __device__ inline T u_cost_row(const FusedArgs<T>& a, const T* u,
                                        T up, int r) {
  if (a.w_du > T(0)) {
    if (r < a.K - 1) return a.w_du * (u[r] - u[r + 1]);
    if (r == a.K - 1) return a.w_du * (u[0] - up);
    r -= a.K;
  }
  return a.w_u * u[r];
}

// The per-instance scalars at the head of a workspace: the carry (done and
// term held as reals, exact), the per-instance inputs, and what one stage
// hands to the next. All fields are T, so the arrays after it stay aligned.
template <typename T>
struct Scalars {
  T lam, mu, merit, fo, done, term;
  T spt, up;
  T cost, viol1, violmax, nu_inf, jr_dz, qp_ok;
  T mu_new, phi0, dphi, slack;
  T found, alpha_used, phi_sel, any_accept;
};
constexpr int N_SCALARS = 22;  // mirrored by ops/fused.py::N_SCALARS

// Offsets, in reals, of the buffers of one instance's workspace.
struct Layout {
  int p, xc, xs, u;                     // inputs and carry
  int jx, ju, defect, pin, M, m;        // linearization and condensation
  int small, R;                         // terminal rows, multipliers, R
  int ru, g, dinv, sdinv;               // u-cost rows, spectral scales
  int du, dxs, fo;                      // the step, first-order terms
  int Y, CiA, Cig, Gc, t1, t2, y2;      // the KKT solve, then
  int jd, pis;                          //   Juc du and the adjoint, then
  int trial, trial_size, P;             //   the line-search trials
  int total;
};

// The small per-instance vectors, Body::ALLMAX reals each from Layout::small.
enum SmallVec {
  R_TERM, TERM_AFF, B_ALL, C_TERM, MU, RHS, E, RES_C, ORIG, QR_H, N_SMALL
};

// Reals of the per-block statics in shared memory: Q with row stride
// K + 1, and eigs.
__host__ __device__ inline int statics_reals(int K) {
  return K * (K + 1) + K;
}

// A read of a static that stays in device memory, through the read-only
// cache on the card.
template <typename T>
__host__ __device__ inline T ldg(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

template <typename T>
struct Statics {
  const T* Q;     // shared: Q[j * ld + k] = Q[j][k]
  const T* eigs;  // shared
  const T* Juc;   // device memory, (n_u, K), read with ldg
  int ld;         // K + 1
};

// Thread `tid` of `nthreads` copies its share of the statics into `sm`.
// The u-cost Jacobian (n_u x K, the largest static) stays in device memory
// and is read through the read-only cache: in shared memory it would cost
// every block n_u (K + 1) reals and so cap the instances resident per SM.
template <typename T>
__host__ __device__ inline Statics<T> stage_statics(const FusedTensors<T>& t,
                                                    const FusedArgs<T>& a,
                                                    T* sm, int tid,
                                                    int nthreads) {
  const int K = a.K, ld = K + 1;
  T* Q = sm;
  T* eigs = Q + K * ld;
  for (int e = tid; e < K * K; e += nthreads) Q[(e / K) * ld + e % K] = t.Q[e];
  for (int k = tid; k < K; k += nthreads) eigs[k] = t.eigs[k];
  return Statics<T>{Q, eigs, t.Juc, ld};
}

template <typename T>
__host__ __device__ inline void write_traces(const FusedTensors<T>& t,
                                             int o, T cost, T viol, T lam,
                                             T alpha, T first, int applied) {
  t.tr_cost[o] = cost;
  t.tr_viol[o] = viol;
  t.tr_lam[o] = lam;
  t.tr_alpha[o] = alpha;
  t.tr_first[o] = first;
  t.tr_applied[o] = applied;
}

// One RK4 step with its chain-ruled step Jacobians: segment_jac.cuh's
// rk4_step_jac with the final sums A = I + h/6 (A1 + 2 d2 + 2 d3 + d4),
// Bv and the state update accumulated as each stage is done, the same
// operations in the same order, so that fewer stage Jacobians are live.
template <typename Model, typename T>
__host__ __device__ inline void rk4_step_jac_acc(const T* p, T* x, T u, T h,
                                                 T h_half, T h_sixth,
                                                 int angle_mask, T* A,
                                                 T* Bv) {
  constexpr int SD = Model::SD;
  T k[SD], ks[SD], xt[SD], Aj[SD * SD], Bj[SD];
  T d[SD * SD], du[SD], dn[SD * SD], dun[SD];
  Model::jac(p, x, u, k, Aj, Bj);
  for (int e = 0; e < SD * SD; ++e) A[e] = d[e] = Aj[e];
  for (int i = 0; i < SD; ++i) {
    Bv[i] = du[i] = Bj[i];
    ks[i] = k[i];
  }
  for (int stage = 2; stage <= 4; ++stage) {
    const T c = stage == 4 ? h : h_half;
    for (int i = 0; i < SD; ++i) xt[i] = x[i] + c * k[i];
    Model::jac(p, xt, u, k, Aj, Bj);
    segjac::stage_jac<SD>(Aj, Bj, d, du, c, dn, dun);
    const T w = stage == 4 ? T(1) : T(2);
    for (int e = 0; e < SD * SD; ++e) {
      A[e] = stage == 4 ? A[e] + dn[e] : A[e] + w * dn[e];
      d[e] = dn[e];
    }
    for (int i = 0; i < SD; ++i) {
      Bv[i] = stage == 4 ? Bv[i] + dun[i] : Bv[i] + w * dun[i];
      ks[i] = stage == 4 ? ks[i] + k[i] : ks[i] + w * k[i];
      du[i] = dun[i];
    }
  }
  for (int i = 0; i < SD; ++i) {
    x[i] = segjac::wrap(angle_mask, i, x[i] + h_sixth * ks[i]);
    for (int j = 0; j < SD; ++j) {
      const int e = i * SD + j;
      A[e] = (i == j ? T(1) : T(0)) + h_sixth * A[e];
    }
    Bv[i] = h_sixth * Bv[i];
  }
}

// segment_jac.cuh's segment_rollout_with_jac over rk4_step_jac_acc.
template <typename Model, typename T>
__host__ __device__ inline void segment_rollout_with_jac_acc(
    const T* p, const T* x0, const T* us, int steps, T h, T h_half,
    T h_sixth, int angle_mask, T* x_end, T* Jx, T* Ju) {
  constexpr int SD = Model::SD;
  T x[SD];
  for (int i = 0; i < SD; ++i) {
    x[i] = x0[i];
    for (int j = 0; j < SD; ++j) Jx[i * SD + j] = (i == j) ? T(1) : T(0);
  }
  for (int k = 0; k < steps; ++k) {
    T A[SD * SD], Bv[SD], tmp[SD * SD];
    rk4_step_jac_acc<Model>(p, x, us[k], h, h_half, h_sixth, angle_mask, A,
                            Bv);
    for (int i = 0; i < SD; ++i)
      for (int j = 0; j < SD; ++j) {
        T acc = T(0);
        for (int q = 0; q < SD; ++q) acc += A[i * SD + q] * Jx[q * SD + j];
        tmp[i * SD + j] = acc;
      }
    for (int e = 0; e < SD * SD; ++e) Jx[e] = tmp[e];
    for (int c = 0; c < k; ++c) {
      T col[SD];
      for (int i = 0; i < SD; ++i) col[i] = Ju[c * SD + i];
      for (int i = 0; i < SD; ++i) {
        T acc = T(0);
        for (int q = 0; q < SD; ++q) acc += A[i * SD + q] * col[q];
        Ju[c * SD + i] = acc;
      }
    }
    for (int i = 0; i < SD; ++i) Ju[k * SD + i] = Bv[i];
  }
  for (int i = 0; i < SD; ++i) x_end[i] = x[i];
}

// alpha of trial t: 1, 1/2, 1/4, ... (exact).
template <typename T>
__host__ __device__ inline T trial_alpha(int t) {
  T al = T(1);
  for (int j = 0; j < t; ++j) al *= T(0.5);
  return al;
}

// ------------------------------------------------------------- the solve
// Profile indices of steps (a -DFUSED_PROFILE build of fused_iteration.cu).
constexpr int PROFILE_FROZEN = 96;
constexpr int PROFILE_NONE = 128;

// ------------------------------------------------------- the model body
// Everything that depends on the model: its state and parameter counts,
// its terminal rows (at most one per state coordinate,
// cartpole_tpu/mpc/problem.py:252-257), the workspace layout they give,
// and its generated dynamics cores. The members are not indented.
template <typename Model>
struct Body {
static constexpr int SD = Model::SD;
static constexpr int NP = Model::NP;
static constexpr int ALLMAX = Model::SD;  // terminal rows

// One RK4 step (no Jacobians) followed by the angle wrap; x updated in place.
template <typename T>
__host__ __device__ static inline void rk4_step(const FusedArgs<T>& a,
                                                const T* p, T* x, T u) {
  T k1[SD], k2[SD], k3[SD], k4[SD], xt[SD];
  Model::core(p, x, u, k1);
  for (int i = 0; i < SD; ++i) xt[i] = x[i] + a.h_half * k1[i];
  Model::core(p, xt, u, k2);
  for (int i = 0; i < SD; ++i) xt[i] = x[i] + a.h_half * k2[i];
  Model::core(p, xt, u, k3);
  for (int i = 0; i < SD; ++i) xt[i] = x[i] + a.dt * k3[i];
  Model::core(p, xt, u, k4);
  for (int i = 0; i < SD; ++i)
    x[i] = wrap(a, i, x[i] + a.h_sixth * (k1[i] + T(2) * k2[i] +
                                          T(2) * k3[i] + k4[i]));
}

// (T^T T)^{-1} b via the R factor (row-major, stride ALLMAX): R^T y = b,
// then R x = y.
template <typename T>
__host__ __device__ static inline void schur_solve(const T* R, int n,
                                                   const T* b, T* x) {
  T y[ALLMAX];
  for (int i = 0; i < n; ++i) {
    T acc = b[i];
    for (int k = 0; k < i; ++k) acc = acc - R[k * ALLMAX + i] * y[k];
    y[i] = acc / R[i * ALLMAX + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    T acc = y[i];
    for (int k = i + 1; k < n; ++k) acc = acc - R[i * ALLMAX + k] * x[k];
    x[i] = acc / R[i * ALLMAX + i];
  }
}

// Workspace layout for a window of K controls, N shooting states, S
// segments, n_u u-cost rows, n_all terminal rows, n_ls line-search trials
// and `lanes` lanes per instance. Trials run P at a time, as many as there
// are lanes for all their segments (at least one). Mirrored by
// ops/fused.py::workspace_reals.
__host__ __device__ static inline Layout make_layout(int K, int N, int S,
                                                     int n_u, int n_all,
                                                     int n_ls, int lanes) {
  Layout L;
  int o = N_SCALARS;
  auto take = [&o](int n) { const int at = o; o += n; return at; };
  L.p = take(NP);
  L.xc = take(SD);
  L.xs = take(SD * N);
  L.u = take(K);
  L.jx = take(S * SD * SD);
  L.ju = take(K * SD);
  L.defect = take(S * SD);
  L.pin = take(SD);
  L.M = take(SD * K);
  L.m = take(SD);
  L.small = take(N_SMALL * ALLMAX);
  L.R = take(ALLMAX * ALLMAX);
  L.ru = take(n_u);
  L.g = take(K);
  L.dinv = take(K);
  L.sdinv = take(K);
  L.du = take(K);
  L.dxs = take(N * SD);
  L.fo = take(K);
  // Three uses of one region: the KKT solve's buffers (until du2), then
  // what st_post hands to st_merit, then the line-search trials.
  const int shared = o;
  L.Y = take((n_all + 1) * K);
  L.CiA = take(n_all * K);
  L.Cig = take(K);
  L.Gc = take(n_all * (K + n_all));
  L.t1 = take(K);
  L.t2 = take(K);
  L.y2 = take(K);
  const int solve_end = o;
  o = shared;
  L.jd = take(n_u);
  L.pis = take(S * SD);
  const int post_end = o;
  L.P = lanes / S < 1 ? 1 : (lanes / S < n_ls ? lanes / S : n_ls);
  L.trial = shared;
  // xt, ua, |defects|, squared u-cost rows, phi, accept
  L.trial_size = N * SD + K + S * SD + n_u + 2;
  const int trial_end = shared + L.P * L.trial_size;
  L.total = solve_end > trial_end ? solve_end : trial_end;
  if (post_end > L.total) L.total = post_end;
  return L;
}

// One instance: its configuration, the block's statics, its workspace.
template <typename T>
struct Inst {
  const FusedArgs<T>& a;
  const Statics<T>& st;
  const Layout& L;
  T* w;
  __host__ __device__ Scalars<T>& sc() const {
    return *reinterpret_cast<Scalars<T>*>(w);
  }
  __host__ __device__ T* at(int off) const { return w + off; }
  __host__ __device__ T* small(int v) const {
    return w + L.small + v * ALLMAX;
  }
  // Row r of M (the terminal row's coordinate), K reals.
  __host__ __device__ const T* Arow(int r) const {
    return w + L.M + a.row_coord[r] * a.K;
  }
  __host__ __device__ int n_all() const { return a.n_tc + a.n_t; }
};

// ------------------------------------------------------------ load / store
template <typename T>
__host__ __device__ static inline void load_instance(const FusedTensors<T>& t,
                                                     const Inst<T>& I, int b,
                                                     int lane, int n) {
  const FusedArgs<T>& a = I.a;
  const int B = a.B;
  for (int j = lane; j < NP; j += n) I.at(I.L.p)[j] = t.params[j * B + b];
  for (int i = lane; i < SD; i += n) I.at(I.L.xc)[i] = t.xc[i * B + b];
  for (int e = lane; e < SD * a.N; e += n) I.at(I.L.xs)[e] = t.xs[e * B + b];
  for (int k = lane; k < a.K; k += n) I.at(I.L.u)[k] = t.u[k * B + b];
  if (lane == 0) {
    Scalars<T>& sc = I.sc();
    sc.lam = t.lam[b];
    sc.mu = t.mu[b];
    sc.merit = t.merit[b];
    sc.fo = t.fo[b];
    sc.done = T(t.done[b]);
    sc.term = T(t.term[b]);
    sc.spt = t.spt[b];
    sc.up = t.up[b];
  }
}

template <typename T>
__host__ __device__ static inline void store_instance(const FusedTensors<T>& t,
                                                      const Inst<T>& I, int b,
                                                      int lane, int n) {
  const FusedArgs<T>& a = I.a;
  const int B = a.B;
  for (int e = lane; e < SD * a.N; e += n) t.xs_o[e * B + b] = I.at(I.L.xs)[e];
  for (int k = lane; k < a.K; k += n) t.u_o[k * B + b] = I.at(I.L.u)[k];
  if (lane == 0) {
    const Scalars<T>& sc = I.sc();
    t.lam_o[b] = sc.lam;
    t.mu_o[b] = sc.mu;
    t.merit_o[b] = sc.merit;
    t.fo_o[b] = sc.fo;
    t.done_o[b] = int(sc.done);
    t.term_o[b] = int(sc.term);
  }
}

// ------------------------------------------------------------------ stages
// Segment linearization (lanes over segments), defects and pins.
template <typename T>
__host__ __device__ static inline void st_linearize(const Inst<T>& I, int lane,
                                                    int n) {
  const FusedArgs<T>& a = I.a;
  const int N = a.N, S = a.S, sp = a.sp;
  const T* xs = I.at(I.L.xs);
  for (int s = lane; s < S; s += n) {
    T p[NP], x0[SD], xe[SD];
    for (int j = 0; j < NP; ++j) p[j] = I.at(I.L.p)[j];
    for (int i = 0; i < SD; ++i) x0[i] = xs[i * N + s];
    segment_rollout_with_jac_acc<Model>(
        p, x0, I.at(I.L.u) + s * sp, sp, a.dt, a.h_half, a.h_sixth,
        a.angle_mask, xe, I.at(I.L.jx) + s * SD * SD,
        I.at(I.L.ju) + s * sp * SD);
    for (int i = 0; i < SD; ++i)
      I.at(I.L.defect)[s * SD + i] = wrap(a, i, xe[i] - xs[i * N + s + 1]);
  }
  if (lane == n - 1)
    for (int i = 0; i < SD; ++i)
      I.at(I.L.pin)[i] = wrap(a, i, xs[i * N] - I.at(I.L.xc)[i]);
}

// Forward condensation dx_s = M_s du + m_s, lanes over the columns of M
// (column K is the affine part m); the u-cost rows; the spectral scales.
// Column k is Ju_k carried through the Jacobians of the later segments.
template <typename T>
__host__ __device__ static inline void st_condense(const Inst<T>& I, int lane,
                                                   int n) {
  const FusedArgs<T>& a = I.a;
  const int K = a.K, S = a.S, sp = a.sp;
  const T* jx = I.at(I.L.jx);
  for (int k = lane; k <= K; k += n) {
    T col[SD];
    int s0;
    if (k < K) {
      for (int i = 0; i < SD; ++i) col[i] = I.at(I.L.ju)[k * SD + i];
      s0 = k / sp + 1;
    } else {
      for (int i = 0; i < SD; ++i) col[i] = -I.at(I.L.pin)[i];
      s0 = 0;
    }
    for (int s = s0; s < S; ++s) {
      const T* J = jx + s * SD * SD;
      T nx[SD];
      for (int i = 0; i < SD; ++i) {
        T acc = T(0);
        for (int j = 0; j < SD; ++j) acc += J[i * SD + j] * col[j];
        nx[i] = k < K ? acc : acc + I.at(I.L.defect)[s * SD + i];
      }
      for (int i = 0; i < SD; ++i) col[i] = nx[i];
    }
    if (k < K)
      for (int i = 0; i < SD; ++i) I.at(I.L.M)[i * K + k] = col[i];
    else
      for (int i = 0; i < SD; ++i) I.at(I.L.m)[i] = col[i];
  }
  const Scalars<T>& sc = I.sc();
  for (int r = lane; r < a.n_u; r += n)
    I.at(I.L.ru)[r] = u_cost_row(a, I.at(I.L.u), sc.up, r);
  for (int k = lane; k < K; k += n) {
    const T d = T(1) / (I.st.eigs[k] + sc.lam);
    I.at(I.L.dinv)[k] = d;
    I.at(I.L.sdinv)[k] = sqrt_t(d);
  }
}

// Terminal rows (one lane); g = Juc^T r_u (lanes over k); Y_r = Q^T A_r
// for every terminal row (lanes over (r, k)).
template <typename T>
__host__ __device__ static inline void st_project(const Inst<T>& I, int lane,
                                                  int n) {
  const FusedArgs<T>& a = I.a;
  const int K = a.K, N = a.N, ld = I.st.ld, n_all = I.n_all();
  const Scalars<T>& sc = I.sc();
  if (lane == n - 1) {
    T xl[SD];
    for (int i = 0; i < SD; ++i) xl[i] = I.at(I.L.xs)[i * N + N - 1];
    const T* m = I.at(I.L.m);
    T *r_term = I.small(R_TERM), *term_aff = I.small(TERM_AFF);
    T *b_all = I.small(B_ALL), *c_term = I.small(C_TERM);
    for (int t = 0; t < a.n_tc; ++t) {
      r_term[t] = a.w_costs[t] * row_diff(a, t, xl, sc.spt);
      term_aff[t] = a.w_costs[t] * m[a.row_coord[t]];
      b_all[t] = (r_term[t] + term_aff[t]) / a.w_costs[t];
    }
    for (int j = 0; j < a.n_t; ++j) {
      const int r = a.n_tc + j;
      c_term[j] = row_diff(a, r, xl, sc.spt);
      b_all[r] = c_term[j] + m[a.row_coord[r]];
    }
  }
  for (int idx = lane; idx < (n_all + 1) * K; idx += n) {
    T acc = T(0);
    if (idx < K) {
      const T* ru = I.at(I.L.ru);
      for (int r = 0; r < a.n_u; ++r) acc += ldg(I.st.Juc + r * K + idx) * ru[r];
      I.at(I.L.g)[idx] = acc;
    } else {
      const int r = (idx - K) / K, k = (idx - K) % K;
      const T* X = I.Arow(r);
      for (int j = 0; j < K; ++j) acc += I.st.Q[j * ld + k] * X[j];
      I.at(I.L.Y)[r * K + k] = acc;
    }
  }
}

// Y_g = Q^T g (lanes over k); C^{-1} A_r = Q (dinv .* Y_r) and the Schur
// factor column Q (sqrt(dinv) .* Y_r) over sqrt(D) e_r (lanes over (r, k)).
template <typename T>
__host__ __device__ static inline void st_spectral(const Inst<T>& I, int lane,
                                                   int n) {
  const FusedArgs<T>& a = I.a;
  const int K = a.K, ld = I.st.ld, n_all = I.n_all(), GL = K + n_all;
  const T* Q = I.st.Q;
  const T* Y = I.at(I.L.Y);
  const T* dinv = I.at(I.L.dinv);
  const T* sdinv = I.at(I.L.sdinv);
  for (int idx = lane; idx < (n_all + 1) * K; idx += n) {
    if (idx < K) {
      const T* g = I.at(I.L.g);
      T acc = T(0);
      for (int j = 0; j < K; ++j) acc += Q[j * ld + idx] * g[j];
      I.at(I.L.Y)[n_all * K + idx] = acc;
    } else {
      const int r = (idx - K) / K, k = (idx - K) % K;
      const T* y = Y + r * K;
      T acc = T(0), acc2 = T(0);
      for (int j = 0; j < K; ++j) {
        acc += Q[k * ld + j] * (y[j] * dinv[j]);
        acc2 += Q[k * ld + j] * (y[j] * sdinv[j]);
      }
      I.at(I.L.CiA)[r * K + k] = acc;
      I.at(I.L.Gc)[r * GL + k] = acc2;
    }
  }
  for (int idx = lane; idx < n_all * n_all; idx += n) {
    const int r = idx / n_all, q = idx % n_all;
    I.at(I.L.Gc)[r * GL + K + q] = q == r ? a.sqrtD[r] : T(0);
  }
}

// C^{-1} g = Q (dinv .* Y_g) (lanes over k; without terminal rows the step
// is its negative), and the norm of each column of the stacked Schur factor
// before the QR (lanes over columns).
template <typename T>
__host__ __device__ static inline void st_cig(const Inst<T>& I, int lane,
                                              int n) {
  const FusedArgs<T>& a = I.a;
  const int K = a.K, ld = I.st.ld, n_all = I.n_all(), GL = K + n_all;
  const T* yg = I.at(I.L.Y) + n_all * K;
  const T* dinv = I.at(I.L.dinv);
  for (int k = lane; k < K; k += n) {
    T acc = T(0);
    for (int j = 0; j < K; ++j) acc += I.st.Q[k * ld + j] * (yg[j] * dinv[j]);
    I.at(I.L.Cig)[k] = acc;
    if (!n_all) I.at(I.L.du)[k] = -acc;
  }
  for (int j = lane; j < n_all; j += n) {
    const T* v = I.at(I.L.Gc) + j * GL;
    T acc = T(0);
    for (int q = 0; q < GL; ++q) acc += v[q] * v[q];
    I.small(ORIG)[j] = sqrt_t(acc);
  }
}

// The 2-pass modified Gram-Schmidt QR of the stacked Schur factor, column
// j against column i < j in pass `pass`: h = g_i . v_j (one lane), and
// R_ij accumulates it.
template <typename T>
__host__ __device__ static inline void st_qr_dot(const Inst<T>& I, int lane,
                                                 int i, int j, int pass) {
  if (lane != 0) return;
  const int GL = I.a.K + I.n_all();
  const T* gi = I.at(I.L.Gc) + i * GL;
  const T* v = I.at(I.L.Gc) + j * GL;
  T h = T(0);
  for (int q = 0; q < GL; ++q) h += gi[q] * v[q];
  T* R = I.at(I.L.R);
  R[i * ALLMAX + j] = (pass ? R[i * ALLMAX + j] : T(0)) + h;
  I.small(QR_H)[0] = h;
}

// v_j -= h g_i (lanes over rows).
template <typename T>
__host__ __device__ static inline void st_qr_axpy(const Inst<T>& I, int lane,
                                                  int n, int i, int j) {
  const int GL = I.a.K + I.n_all();
  const T* gi = I.at(I.L.Gc) + i * GL;
  T* v = I.at(I.L.Gc) + j * GL;
  const T h = I.small(QR_H)[0];
  for (int q = lane; q < GL; q += n) v[q] = v[q] - h * gi[q];
}

// R_jj = max(|v_j|, eps |v_j before the QR| + 1e-30) (one lane).
template <typename T>
__host__ __device__ static inline void st_qr_norm(const Inst<T>& I, int lane,
                                                  int j) {
  if (lane != 0) return;
  const int GL = I.a.K + I.n_all();
  const T* v = I.at(I.L.Gc) + j * GL;
  T acc = T(0);
  for (int q = 0; q < GL; ++q) acc += v[q] * v[q];
  I.at(I.L.R)[j * ALLMAX + j] =
      dyn_max(sqrt_t(acc), qr_eps<T>() * I.small(ORIG)[j] + T(1.0e-30));
}

// g_j = v_j / R_jj (lanes over rows).
template <typename T>
__host__ __device__ static inline void st_qr_scale(const Inst<T>& I, int lane,
                                                   int n, int j) {
  const int GL = I.a.K + I.n_all();
  T* v = I.at(I.L.Gc) + j * GL;
  const T nrm = I.at(I.L.R)[j * ALLMAX + j];
  for (int q = lane; q < GL; q += n) v[q] = v[q] / nrm;
}

// A_r . x for terminal row r.
template <typename T>
__host__ __device__ static inline T arow_dot(const Inst<T>& I, int r,
                                             const T* x) {
  const T* A = I.Arow(r);
  T acc = T(0);
  for (int k = 0; k < I.a.K; ++k) acc += A[k] * x[k];
  return acc;
}

// rhs_r = b_r - A_r . C^{-1} g (lanes over r).
template <typename T>
__host__ __device__ static inline void st_rhs1(const Inst<T>& I, int lane,
                                               int n) {
  for (int r = lane; r < I.n_all(); r += n)
    I.small(RHS)[r] = I.small(B_ALL)[r] - arow_dot(I, r, I.at(I.L.Cig));
}

// One Schur solve (one lane): into MU, or into E for the refinement.
template <typename T>
__host__ __device__ static inline void st_schur(const Inst<T>& I, int lane,
                                                SmallVec out) {
  if (lane == 0)
    schur_solve(I.at(I.L.R), I.n_all(), I.small(RHS), I.small(out));
}

// du = -(C^{-1} g + C^{-1} A^T mu); t1 = A^T mu (lanes over k).
template <typename T>
__host__ __device__ static inline void st_du1(const Inst<T>& I, int lane,
                                              int n) {
  const int K = I.a.K, n_all = I.n_all();
  const T* mu = I.small(MU);
  const T* CiA = I.at(I.L.CiA);
  for (int k = lane; k < K; k += n) {
    T acc = T(0), acc2 = T(0);
    for (int r = 0; r < n_all; ++r) acc += CiA[r * K + k] * mu[r];
    for (int r = 0; r < n_all; ++r) acc2 += I.Arow(r)[k] * mu[r];
    I.at(I.L.du)[k] = -(I.at(I.L.Cig)[k] + acc);
    I.at(I.L.t1)[k] = acc2;
  }
}

// y2 = (Q^T x) .* s, with s = eigs + lam when scale_eigs, else dinv (lanes
// over k): the first half of an eigenbasis product.
template <typename T>
__host__ __device__ static inline void st_qt(const Inst<T>& I, int lane, int n,
                                             const T* x, bool scale_eigs) {
  const int K = I.a.K, ld = I.st.ld;
  const T lam = I.sc().lam;
  for (int k = lane; k < K; k += n) {
    T acc = T(0);
    for (int j = 0; j < K; ++j) acc += I.st.Q[j * ld + k] * x[j];
    const T s = scale_eigs ? I.st.eigs[k] + lam : I.at(I.L.dinv)[k];
    I.at(I.L.y2)[k] = acc * s;
  }
}

// Q y2 as row k (the second half of an eigenbasis product).
template <typename T>
__host__ __device__ static inline T q_row(const Inst<T>& I, int k) {
  const int K = I.a.K, ld = I.st.ld;
  const T* y2 = I.at(I.L.y2);
  T acc = T(0);
  for (int j = 0; j < K; ++j) acc += I.st.Q[k * ld + j] * y2[j];
  return acc;
}

// Residuals of the augmented system: res_d = -g - (C du + A^T mu) into t2
// (lanes over k), res_c (lanes over r, after the k).
template <typename T>
__host__ __device__ static inline void st_residuals(const Inst<T>& I, int lane,
                                                    int n) {
  const FusedArgs<T>& a = I.a;
  const int K = a.K;
  for (int idx = lane; idx < K + I.n_all(); idx += n) {
    if (idx < K) {
      I.at(I.L.t2)[idx] =
          -I.at(I.L.g)[idx] - (q_row(I, idx) + I.at(I.L.t1)[idx]);
    } else {
      const int r = idx - K;
      I.small(RES_C)[r] =
          -I.small(B_ALL)[r] -
          (arow_dot(I, r, I.at(I.L.du)) - a.D_diag[r] * I.small(MU)[r]);
    }
  }
}

// t1 = C^{-1} res_d = Q y2 (lanes over k).
template <typename T>
__host__ __device__ static inline void st_cird(const Inst<T>& I, int lane,
                                               int n) {
  for (int k = lane; k < I.a.K; k += n) I.at(I.L.t1)[k] = q_row(I, k);
}

// rhs_r = A_r . C^{-1} res_d - res_c (lanes over r).
template <typename T>
__host__ __device__ static inline void st_rhs2(const Inst<T>& I, int lane,
                                               int n) {
  for (int r = lane; r < I.n_all(); r += n)
    I.small(RHS)[r] = arow_dot(I, r, I.at(I.L.t1)) - I.small(RES_C)[r];
}

// The refined step du += C^{-1} res_d - C^{-1} A^T e (lanes over k) and
// mu += e (lane 0).
template <typename T>
__host__ __device__ static inline void st_du2(const Inst<T>& I, int lane,
                                              int n) {
  const int K = I.a.K, n_all = I.n_all();
  const T* e = I.small(E);
  const T* CiA = I.at(I.L.CiA);
  for (int k = lane; k < K; k += n) {
    T acc = T(0);
    for (int r = 0; r < n_all; ++r) acc += CiA[r * K + k] * e[r];
    I.at(I.L.du)[k] = I.at(I.L.du)[k] + I.at(I.L.t1)[k] - acc;
  }
  if (lane == 0)
    for (int r = 0; r < n_all; ++r) I.small(MU)[r] = I.small(MU)[r] + e[r];
}

// State-step expansion by the forward recursion.
template <typename T>
__host__ __device__ static inline void expand_dxs(const Inst<T>& I) {
  const int S = I.a.S, sp = I.a.sp;
  T* dxs = I.at(I.L.dxs);
  const T* jx = I.at(I.L.jx);
  const T* ju = I.at(I.L.ju);
  const T* du = I.at(I.L.du);
  for (int i = 0; i < SD; ++i) dxs[i] = -I.at(I.L.pin)[i];
  for (int s = 0; s < S; ++s)
    for (int i = 0; i < SD; ++i) {
      T acc = T(0);
      for (int j = 0; j < SD; ++j) acc += jx[s * SD * SD + i * SD + j] *
                                         dxs[s * SD + j];
      for (int t = 0; t < sp; ++t)
        acc += ju[(s * sp + t) * SD + i] * du[s * sp + t];
      dxs[(s + 1) * SD + i] = acc + I.at(I.L.defect)[s * SD + i];
    }
}

// pi <- Jx_s^T pi.
template <typename T>
__host__ __device__ static inline void adjoint_step(const T* J, T* pi) {
  T pn[SD];
  for (int j = 0; j < SD; ++j) {
    T acc = T(0);
    for (int i = 0; i < SD; ++i) acc += J[i * SD + j] * pi[i];
    pn[j] = acc;
  }
  for (int i = 0; i < SD; ++i) pi[i] = pn[i];
}

// The adjoint passes pi <- Jx_s^T pi from the last segment down, one code
// path for both: `which` 0 starts from the post-step multipliers and gives
// the estimate nu_inf; `which` 1 starts from the pre-step residual
// multipliers and keeps pi at each segment for the first-order diagnostic.
template <typename T>
__host__ __device__ static inline void adjoint_pass(const Inst<T>& I,
                                                    int which) {
  const FusedArgs<T>& a = I.a;
  const T* mu = I.small(MU);
  const T* r_term = I.small(R_TERM);
  T pi[SD];
  for (int i = 0; i < SD; ++i) pi[i] = T(0);
  for (int r = 0; r < I.n_all(); ++r)
    pi[a.row_coord[r]] += which == 0 || r >= a.n_tc
                              ? mu[r]
                              : a.w_costs[r] * r_term[r];
  T pi_max = T(0);
  for (int s = a.S - 1; s >= 0; --s) {
    T mags = abs_t(pi[0]);
    for (int i = 1; i < SD; ++i) mags = dyn_max(mags, abs_t(pi[i]));
    pi_max = dyn_max(pi_max, mags);
    if (which == 1)
      for (int i = 0; i < SD; ++i) I.at(I.L.pis)[s * SD + i] = pi[i];
    adjoint_step(I.at(I.L.jx) + s * SD * SD, pi);
  }
  if (which != 0) return;
  T sigma = abs_t(pi[0]);
  for (int i = 1; i < SD; ++i) sigma = dyn_max(sigma, abs_t(pi[i]));
  T nu_abs = T(0);
  if (a.n_t) {
    nu_abs = abs_t(mu[a.n_tc]);
    for (int j = 1; j < a.n_t; ++j)
      nu_abs = dyn_max(nu_abs, abs_t(mu[a.n_tc + j]));
  }
  I.sc().nu_inf = dyn_max(nu_abs, dyn_max(pi_max, sigma));
}

// The pre-step merit's cost and its L1 and max constraint violations.
template <typename T>
__host__ __device__ static inline void cost_and_violation(const Inst<T>& I) {
  const FusedArgs<T>& a = I.a;
  const T* r_term = I.small(R_TERM);
  const T* c_term = I.small(C_TERM);
  const T* ru = I.at(I.L.ru);
  const T* defect = I.at(I.L.defect);
  const T* pin = I.at(I.L.pin);
  T cost_t = T(0), cost_u = T(0);
  for (int t = 0; t < a.n_tc; ++t) cost_t += r_term[t] * r_term[t];
  for (int r = 0; r < a.n_u; ++r) cost_u += ru[r] * ru[r];
  T viol1 = T(0), violmax = T(0);
  for (int i = 0; i < SD; ++i) {
    T acc = T(0), mx = T(0);
    for (int s = 0; s < a.S; ++s) {
      acc += abs_t(defect[s * SD + i]);
      mx = dyn_max(mx, abs_t(defect[s * SD + i]));
    }
    viol1 = viol1 + acc;
    viol1 = viol1 + abs_t(pin[i]);
    violmax = dyn_max(dyn_max(violmax, mx), abs_t(pin[i]));
  }
  for (int j = 0; j < a.n_t; ++j) {
    viol1 = viol1 + abs_t(c_term[j]);
    violmax = dyn_max(violmax, abs_t(c_term[j]));
  }
  Scalars<T>& sc = I.sc();
  sc.cost = T(0.5) * (cost_t + cost_u);
  sc.viol1 = viol1;
  sc.violmax = violmax;
}

// Juc du row by row (lanes over r), and the serial passes: both adjoint
// passes (lanes 0 and 1), the state step (lane 2), cost and violation
// (lane 3).
template <typename T>
__host__ __device__ static inline void st_post(const Inst<T>& I, int lane,
                                               int n) {
  const int K = I.a.K;
  const T* du = I.at(I.L.du);
  for (int r = lane; r < I.a.n_u; r += n) {
    T jd = T(0);
    for (int k = 0; k < K; ++k) jd += ldg(I.st.Juc + r * K + k) * du[k];
    I.at(I.L.jd)[r] = jd;
  }
  for (int which = lane; which < 2; which += n) adjoint_pass(I, which);
  if (lane == 2 % n) expand_dxs(I);
  if (lane == 3 % n) cost_and_violation(I);
}

// The first-order diagnostic's terms |g_k + Ju_k . pi_s(k)| (lanes over k);
// (J^T r) . dz, qp_ok and the merit's terms for the line search (lane 0).
template <typename T>
__host__ __device__ static inline void st_merit(const Inst<T>& I, int lane,
                                                int n) {
  const FusedArgs<T>& a = I.a;
  const int K = a.K;
  for (int k = lane; k < K; k += n) {
    const T* pi = I.at(I.L.pis) + (k / a.sp) * SD;
    T acc = T(0);
    for (int i = 0; i < SD; ++i) acc += I.at(I.L.ju)[k * SD + i] * pi[i];
    I.at(I.L.fo)[k] = abs_t(I.at(I.L.g)[k] + acc);
  }
  if (lane != 0) return;
  Scalars<T>& sc = I.sc();
  const T* du = I.at(I.L.du);
  const T* r_term = I.small(R_TERM);
  T jr_dz = T(0);
  for (int t = 0; t < a.n_tc; ++t) {
    const T* Mc = I.Arow(t);
    T acc = T(0);
    for (int k = 0; k < K; ++k) acc += (a.w_costs[t] * Mc[k]) * du[k];
    jr_dz += r_term[t] * (acc + I.small(TERM_AFF)[t]);
  }
  {
    T acc = T(0);
    for (int r = 0; r < a.n_u; ++r) acc += I.at(I.L.ru)[r] * I.at(I.L.jd)[r];
    jr_dz = jr_dz + acc;
  }
  bool qp_ok = true;
  for (int k = 0; k < K; ++k) qp_ok = qp_ok && finite_t(du[k]);
  for (int e = 0; e < a.N * SD; ++e) qp_ok = qp_ok && finite_t(I.at(I.L.dxs)[e]);
  for (int r = 0; r < I.n_all(); ++r) qp_ok = qp_ok && finite_t(I.small(MU)[r]);
  const T mu_new = dyn_max(sc.mu, a.penalty_margin * sc.nu_inf);
  sc.jr_dz = jr_dz;
  sc.qp_ok = qp_ok ? T(1) : T(0);
  sc.mu_new = mu_new;
  sc.phi0 = sc.cost + mu_new * sc.viol1;
  sc.dphi = jr_dz - mu_new * sc.viol1;
  sc.slack = a.slack_coef * abs_t(sc.phi0);
  sc.found = T(0);
  sc.alpha_used = T(0);
  sc.phi_sel = T(0);
}

// Retract trials t0 .. t0 + nq - 1 of the line search: shooting states and
// controls at alpha (lanes over (trial, entry)).
template <typename T>
__host__ __device__ static inline void st_trial_retract(const Inst<T>& I,
                                                        int lane, int n, int t0,
                                                        int nq) {
  const FusedArgs<T>& a = I.a;
  const int N = a.N, K = a.K, per = N * SD + K;
  for (int idx = lane; idx < nq * per; idx += n) {
    const int q = idx / per, r = idx % per;
    const T al = trial_alpha<T>(t0 + q);
    T* tr = I.at(I.L.trial) + q * I.L.trial_size;
    if (r < N * SD) {
      const int nn = r / SD, i = r % SD;
      const T v = wrap(a, i, I.at(I.L.xs)[i * N + nn] +
                                 al * I.at(I.L.dxs)[nn * SD + i]);
      tr[r] = i == 0 ? clip_t(v, -a.b_x_limit, a.b_x_limit) : v;
    } else {
      const int k = r - N * SD;
      tr[r] = clip_t(I.at(I.L.u)[k] + al * I.at(I.L.du)[k], -a.u_limit,
                     a.u_limit);
    }
  }
}

// Roll out each segment of each trial (lanes over (trial, segment)) and
// keep |defect| per coordinate; square the trial's u-cost rows (lanes over
// (trial, row)).
template <typename T>
__host__ __device__ static inline void st_trial_rollout(const Inst<T>& I,
                                                        int lane, int n,
                                                        int nq) {
  const FusedArgs<T>& a = I.a;
  const int N = a.N, S = a.S, sp = a.sp, K = a.K;
  for (int idx = lane; idx < nq * S; idx += n) {
    const int q = idx / S, s = idx % S;
    T* tr = I.at(I.L.trial) + q * I.L.trial_size;
    const T* ua = tr + N * SD;
    T p[NP], x[SD];
    for (int j = 0; j < NP; ++j) p[j] = I.at(I.L.p)[j];
    for (int i = 0; i < SD; ++i) x[i] = tr[s * SD + i];
    for (int t = 0; t < sp; ++t) rk4_step(a, p, x, ua[s * sp + t]);
    T* dabs = tr + N * SD + K;
    for (int i = 0; i < SD; ++i)
      dabs[s * SD + i] = abs_t(wrap(a, i, x[i] - tr[(s + 1) * SD + i]));
  }
  for (int idx = lane; idx < nq * a.n_u; idx += n) {
    const int q = idx / a.n_u, r = idx % a.n_u;
    T* tr = I.at(I.L.trial) + q * I.L.trial_size;
    const T v = u_cost_row(a, tr + N * SD, I.sc().up, r);
    tr[N * SD + K + S * SD + r] = v * v;
  }
}

// The merit of each trial and its Armijo test (lanes over trials).
template <typename T>
__host__ __device__ static inline void st_trial_merit(const Inst<T>& I,
                                                      int lane, int n, int t0,
                                                      int nq) {
  const FusedArgs<T>& a = I.a;
  const int N = a.N, S = a.S, K = a.K;
  const Scalars<T>& sc = I.sc();
  for (int q = lane; q < nq; q += n) {
    T* tr = I.at(I.L.trial) + q * I.L.trial_size;
    const T* dabs = tr + N * SD + K;
    const T* sq = dabs + S * SD;
    const T* xl = tr + (N - 1) * SD;
    T dsum[SD];
    for (int i = 0; i < SD; ++i) dsum[i] = T(0);
    for (int s = 0; s < S; ++s)
      for (int i = 0; i < SD; ++i) dsum[i] += dabs[s * SD + i];
    T viol = T(0);
    for (int i = 0; i < SD; ++i) {
      viol = viol + dsum[i];
      viol = viol + abs_t(wrap(a, i, tr[i] - I.at(I.L.xc)[i]));
    }
    T cost_a = T(0);
    for (int t = 0; t < a.n_tc; ++t) {
      const T rt = a.w_costs[t] * row_diff(a, t, xl, sc.spt);
      cost_a = cost_a + T(0.5) * (rt * rt);
    }
    T su = T(0);
    for (int r = 0; r < a.n_u; ++r) su += sq[r];
    cost_a = cost_a + T(0.5) * su;
    for (int j = 0; j < a.n_t; ++j)
      viol = viol + abs_t(row_diff(a, a.n_tc + j, xl, sc.spt));
    T phi = cost_a + sc.mu_new * viol;
    if (!finite_t(phi)) phi = T(INFINITY);
    const T al = trial_alpha<T>(t0 + q);
    T* out = tr + I.L.trial_size - 2;
    out[0] = phi;
    out[1] = phi <= sc.phi0 + a.armijo_c1 * (al * sc.dphi) + sc.slack ? T(1)
                                                                    : T(0);
  }
}

// The first accepted trial in alpha order wins (one lane).
template <typename T>
__host__ __device__ static inline void st_trial_select(const Inst<T>& I,
                                                       int lane, int t0,
                                                       int nq) {
  if (lane != 0) return;
  Scalars<T>& sc = I.sc();
  for (int q = 0; q < nq && sc.found == T(0); ++q) {
    const T* out = I.at(I.L.trial) + q * I.L.trial_size + I.L.trial_size - 2;
    if (out[1] != T(0)) {
      sc.found = T(1);
      sc.alpha_used = trial_alpha<T>(t0 + q);
      sc.phi_sel = out[0];
    }
  }
}

// Acceptance, the LM lambda update, termination and this iteration's
// traces (one lane).
template <typename T>
__host__ __device__ static inline void st_finish(const FusedTensors<T>& t,
                                                 const Inst<T>& I, int lane,
                                                 int o) {
  if (lane != 0) return;
  const FusedArgs<T>& a = I.a;
  Scalars<T>& sc = I.sc();
  const T lam = sc.lam;
  T first = T(0);  // a max: the same in any order
  for (int k = 0; k < a.K; ++k) first = dyn_max(first, I.at(I.L.fo)[k]);
  const bool qp_ok = sc.qp_ok != T(0);
  const bool any_accept = sc.found != T(0) && qp_ok;
  const T alpha_used = any_accept ? sc.alpha_used : T(0);
  const T phi_new = any_accept ? sc.phi_sel : sc.phi0;
  const T lam_next = any_accept
                         ? lam * a.lambda_decrease
                         : dyn_max(lam * a.lambda_increase,
                                   a.lambda_failure_floor);
  const bool prev_ok = finite_t(sc.merit);
  const T mp = prev_ok ? sc.merit : T(0);
  const T rel_change = prev_ok ? abs_t(mp - phi_new) /
                                     dyn_max(abs_t(mp), T(1.0e-30))
                               : T(INFINITY);
  const bool conv_rel = any_accept && (rel_change < a.relative_exit_tol);
  const bool conv_first = first < a.abs_first_tol;
  const bool fail_lambda = lam_next > a.lambda_max;
  const bool fail_qp = !qp_ok;
  const int new_term = conv_first ? 2 : conv_rel ? 1 : fail_qp ? 4
                                                   : fail_lambda ? 3 : 0;
  const bool now_done = conv_rel || conv_first || fail_lambda || fail_qp;
  write_traces(t, o, sc.cost, sc.violmax, lam, alpha_used, first, 1);
  sc.any_accept = any_accept ? T(1) : T(0);
  sc.alpha_used = alpha_used;
  sc.lam = lam_next;
  sc.mu = sc.mu_new;
  sc.merit = phi_new;
  sc.term = T(new_term);
  sc.fo = first;
  sc.done = now_done ? T(1) : T(0);
}

// Re-retract the carry at the accepted alpha (lanes over entries).
template <typename T>
__host__ __device__ static inline void st_accept(const Inst<T>& I, int lane,
                                                 int n) {
  const FusedArgs<T>& a = I.a;
  const int N = a.N, K = a.K;
  const T al = I.sc().alpha_used;
  for (int k = lane; k < K; k += n)
    I.at(I.L.u)[k] = clip_t(I.at(I.L.u)[k] + al * I.at(I.L.du)[k],
                            -a.u_limit, a.u_limit);
  for (int e = lane; e < SD * N; e += n) {
    const int i = e / N, nn = e % N;
    const T v = wrap(a, i, I.at(I.L.xs)[e] + al * I.at(I.L.dxs)[nn * SD + i]);
    I.at(I.L.xs)[e] = i == 0 ? clip_t(v, -a.b_x_limit, a.b_x_limit) : v;
  }
}

// n_iter iterations of instance b with workspace w. `ex.step(f)` runs
// f(lane, n_lanes) on every lane of the instance and then synchronises
// them; the control flow between steps reads only the workspace's scalars,
// so it is the same on every lane. `ex.mark(i)` numbers the next step i for
// a profiling build: the steps of an active iteration from 0, a frozen
// iteration's from PROFILE_FROZEN, and the final store PROFILE_NONE.
template <typename T, typename Exec>
__host__ __device__ static inline void solve_instance(const FusedTensors<T>& t,
                                                      const FusedArgs<T>& a,
                                                      const Statics<T>& st,
                                                      const Layout& L, T* w,
                                                      int b, Exec& ex) {
  const Inst<T> I{a, st, L, w};
  const Scalars<T>& sc = I.sc();
  ex.step([&](int lane, int n) { load_instance(t, I, b, lane, n); });
  for (int it = 0; it < a.n_iter; ++it) {
    const int o = it * a.B + b;
    ex.mark(sc.done != T(0) ? PROFILE_FROZEN : 0);
    if (sc.done != T(0)) {  // frozen: the carry stays, the traces are masked
      ex.step([&](int lane, int) {
        if (lane == 0)
          write_traces(t, o, T(NAN), T(NAN), T(NAN), T(0), T(NAN), 0);
      });
      continue;
    }
    ex.step([&](int lane, int n) { st_linearize(I, lane, n); });
    ex.step([&](int lane, int n) { st_condense(I, lane, n); });
    ex.step([&](int lane, int n) { st_project(I, lane, n); });
    ex.step([&](int lane, int n) { st_spectral(I, lane, n); });
    ex.step([&](int lane, int n) { st_cig(I, lane, n); });
    if (I.n_all()) {
      for (int j = 0; j < I.n_all(); ++j) {
        for (int pass = 0; pass < 2; ++pass)
          for (int i = 0; i < j; ++i) {
            ex.step([&](int lane, int) { st_qr_dot(I, lane, i, j, pass); });
            ex.step([&](int lane, int n) { st_qr_axpy(I, lane, n, i, j); });
          }
        ex.step([&](int lane, int) { st_qr_norm(I, lane, j); });
        ex.step([&](int lane, int n) { st_qr_scale(I, lane, n, j); });
      }
      ex.step([&](int lane, int n) { st_rhs1(I, lane, n); });
      ex.step([&](int lane, int) { st_schur(I, lane, MU); });
      ex.step([&](int lane, int n) { st_du1(I, lane, n); });
      ex.step([&](int lane, int n) { st_qt(I, lane, n, I.at(L.du), true); });
      ex.step([&](int lane, int n) { st_residuals(I, lane, n); });
      ex.step([&](int lane, int n) { st_qt(I, lane, n, I.at(L.t2), false); });
      ex.step([&](int lane, int n) { st_cird(I, lane, n); });
      ex.step([&](int lane, int n) { st_rhs2(I, lane, n); });
      ex.step([&](int lane, int) { st_schur(I, lane, E); });
      ex.step([&](int lane, int n) { st_du2(I, lane, n); });
    }
    ex.step([&](int lane, int n) { st_post(I, lane, n); });
    ex.step([&](int lane, int n) { st_merit(I, lane, n); });
    // Armijo search over alpha = 1, 1/2, ..., L.P trials at a time; a
    // failed QP takes no step, so its trials are not evaluated.
    if (sc.qp_ok != T(0))
      for (int t0 = 0; t0 < a.n_ls && sc.found == T(0); t0 += L.P) {
        const int nq = a.n_ls - t0 < L.P ? a.n_ls - t0 : L.P;
        ex.step([&](int lane, int n) { st_trial_retract(I, lane, n, t0, nq); });
        ex.step([&](int lane, int n) { st_trial_rollout(I, lane, n, nq); });
        ex.step([&](int lane, int n) { st_trial_merit(I, lane, n, t0, nq); });
        ex.step([&](int lane, int) { st_trial_select(I, lane, t0, nq); });
      }
    ex.step([&](int lane, int) { st_finish(t, I, lane, o); });
    if (sc.any_accept != T(0))
      ex.step([&](int lane, int n) { st_accept(I, lane, n); });
  }
  ex.mark(PROFILE_NONE);
  ex.step([&](int lane, int n) { store_instance(t, I, b, lane, n); });
}
};

}  // namespace fused
