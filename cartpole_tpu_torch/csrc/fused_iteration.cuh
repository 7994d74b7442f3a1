// Fused damped Gauss-Newton iteration of the condensed lanes MPC solver.
//
// Replaces cartpole_tpu/ops/fused.py::make_fused_iteration (the Pallas TPU
// megakernel; tile body at ops/fused.py:214-743). Plain PyTorch version:
// cartpole_tpu_torch/ops/fused.py::fused_iteration_reference, which this
// file mirrors step by step.
//
// Design: ONE INSTANCE PER THREAD. The work of one instance is a long chain
// of dependent scalar arithmetic, tiny triangular solves and per-instance
// control flow (line search, termination), so it is neither an elementwise
// pass nor a reduction. Each thread keeps its whole working set (~1.3k
// reals at the bench point: M, CiA, the Schur columns, Jx, Ju, the carry)
// in thread-local arrays, which spill to local memory that L1/L2 cache. The
// kernel is therefore bound by latency and local-memory traffic, not by
// FLOPs (~50k FMAs per instance per iteration). The block-shared statics
// (eigenbasis Q, eigenvalues, u-cost Jacobian) sit in shared memory and are
// read by all threads of a warp at the same address (broadcast). Whole
// solves run in one launch: the carry stays in the thread for all n_iter
// iterations (the reference's single_launch semantics).
//
// Stage 1 (the segment rollout with chain-ruled Jacobians) is kernel 2's
// arithmetic, shared through segment_jac.cuh. Every function here is
// __host__ __device__ and templated on the real type T, so host_check.cc
// compiles the same body with g++ for T=double.
#pragma once

#include "segment_jac.cuh"

namespace fused {

constexpr int SD = cartpole_gen::STATE_DIM;
constexpr int NP = cartpole_gen::N_PARAMS;
// Compile-time maxima; the Python wrapper raises on anything larger.
constexpr int KMAX = 64;            // window length (controls)
constexpr int NMAX = 17;            // shooting states
constexpr int SMAX = NMAX - 1;      // segments
constexpr int ALLMAX = 4;           // terminal rows (costs + equalities)
constexpr int LSMAX = 8;            // line-search trials
constexpr int NUMAX = 2 * KMAX;     // u-cost residual rows
constexpr int TMAX = KMAX + ALLMAX; // rows of the stacked Schur factor

// Configuration passed by value (mirrored by ops/fused.py::_Args).
template <typename T>
struct FusedArgs {
  int B, K, N, S, sp, n_u, n_tc, n_t, n_ls, n_iter, angle_mask;
  // Terminal rows: soft costs first, then hard equalities.
  int row_coord[ALLMAX];
  int row_is_angle[ALLMAX];
  int row_is_setpoint[ALLMAX];
  T row_target[ALLMAX];
  T w_costs[ALLMAX];
  T D_diag[ALLMAX];
  T sqrtD[ALLMAX];
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

// One RK4 step (no Jacobians) followed by the angle wrap; x updated in place.
template <typename T>
__host__ __device__ inline void rk4_step(const FusedArgs<T>& a, const T* p,
                                         T* x, T u) {
  T k1[SD], k2[SD], k3[SD], k4[SD], xt[SD];
  cartpole_gen::single_dynamics_core(p, x, u, k1);
  for (int i = 0; i < SD; ++i) xt[i] = x[i] + a.h_half * k1[i];
  cartpole_gen::single_dynamics_core(p, xt, u, k2);
  for (int i = 0; i < SD; ++i) xt[i] = x[i] + a.h_half * k2[i];
  cartpole_gen::single_dynamics_core(p, xt, u, k3);
  for (int i = 0; i < SD; ++i) xt[i] = x[i] + a.dt * k3[i];
  cartpole_gen::single_dynamics_core(p, xt, u, k4);
  for (int i = 0; i < SD; ++i)
    x[i] = wrap(a, i, x[i] + a.h_sixth * (k1[i] + T(2) * k2[i] +
                                          T(2) * k3[i] + k4[i]));
}

// Per-instance iteration carry, held in the thread across iterations.
template <typename T>
struct Carry {
  T xs[SD][NMAX];
  T u[KMAX];
  T lam, mu, merit, fo;
  int done, term;
};

template <typename T>
struct Trace {
  T cost, viol, lam, alpha, first;
  int applied;
};

// out = Q @ (s .* (Q^T @ x)) for the static (K, K) eigenbasis Q.
template <typename T>
__host__ __device__ inline void eig_apply(const T* Q, int K, const T* x,
                                          const T* s, T* y, T* out) {
  for (int k = 0; k < K; ++k) {
    T acc = T(0);
    for (int j = 0; j < K; ++j) acc += Q[j * K + k] * x[j];
    y[k] = acc * s[k];
  }
  for (int k = 0; k < K; ++k) {
    T acc = T(0);
    for (int j = 0; j < K; ++j) acc += Q[k * K + j] * y[j];
    out[k] = acc;
  }
}

// (T^T T)^{-1} b via the R factor: R^T y = b, then R x = y.
template <typename T>
__host__ __device__ inline void schur_solve(const T R[ALLMAX][ALLMAX], int n,
                                            const T* b, T* x) {
  T y[ALLMAX];
  for (int i = 0; i < n; ++i) {
    T acc = b[i];
    for (int k = 0; k < i; ++k) acc = acc - R[k][i] * y[k];
    y[i] = acc / R[i][i];
  }
  for (int i = n - 1; i >= 0; --i) {
    T acc = y[i];
    for (int k = i + 1; k < n; ++k) acc = acc - R[i][k] * x[k];
    x[i] = acc / R[i][i];
  }
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

// u-cost residual rows (difference rows, continuity row, magnitude rows).
template <typename T>
__host__ __device__ inline int cost_rows_u(const FusedArgs<T>& a, const T* u,
                                           T up, T* ru) {
  int n = 0;
  if (a.w_du > T(0)) {
    for (int k = 0; k + 1 < a.K; ++k) ru[n++] = a.w_du * (u[k] - u[k + 1]);
    ru[n++] = a.w_du * (u[0] - up);
  }
  if (a.w_u > T(0))
    for (int k = 0; k < a.K; ++k) ru[n++] = a.w_u * u[k];
  return n;
}

// One damped GN iteration of one instance (ops/fused.py::body).
template <typename T>
__host__ __device__ inline void fused_iteration(
    const FusedArgs<T>& a, const T* p, const T* xc, T spt, T up, const T* Q,
    const T* eigs, const T* Juc, Carry<T>& c, Trace<T>& tr) {
  const int K = a.K, N = a.N, S = a.S, sp = a.sp, n_u = a.n_u;
  const int n_tc = a.n_tc, n_t = a.n_t, n_all = a.n_tc + a.n_t;
  const T lam = c.lam;
  if (c.done) {  // frozen: the carry stays, the traces are masked
    tr.cost = tr.viol = tr.lam = tr.first = T(NAN);
    tr.alpha = T(0);
    tr.applied = 0;
    return;
  }

  // ---- segment linearization, defects and pins
  T Jx[SMAX][SD * SD];
  T Ju[KMAX][SD];
  T defect[SMAX][SD];
  T pin[SD];
  for (int s = 0; s < S; ++s) {
    T x0[SD], xe[SD];
    for (int i = 0; i < SD; ++i) x0[i] = c.xs[i][s];
    segjac::segment_rollout_with_jac<segjac::SingleCartPole>(
        p, x0, &c.u[s * sp], sp, a.dt, a.h_half, a.h_sixth, a.angle_mask, xe,
        Jx[s], &Ju[s * sp][0]);
    for (int i = 0; i < SD; ++i)
      defect[s][i] = wrap(a, i, xe[i] - c.xs[i][s + 1]);
  }
  for (int i = 0; i < SD; ++i) pin[i] = wrap(a, i, c.xs[i][0] - xc[i]);

  // ---- forward condensation dx_s = M_s du + m_s. Columns of later
  // segments are still zero at segment s and are set at their own segment.
  T M[SD][KMAX];
  T m[SD];
  for (int i = 0; i < SD; ++i) m[i] = -pin[i];
  for (int s = 0; s < S; ++s) {
    const T* J = Jx[s];
    for (int k = 0; k < s * sp; ++k) {
      T col[SD];
      for (int i = 0; i < SD; ++i) col[i] = M[i][k];
      for (int i = 0; i < SD; ++i) {
        T acc = T(0);
        for (int j = 0; j < SD; ++j) acc += J[i * SD + j] * col[j];
        M[i][k] = acc;
      }
    }
    for (int t = 0; t < sp; ++t)
      for (int i = 0; i < SD; ++i) M[i][s * sp + t] = Ju[s * sp + t][i];
    T mn[SD];
    for (int i = 0; i < SD; ++i) {
      T acc = T(0);
      for (int j = 0; j < SD; ++j) acc += J[i * SD + j] * m[j];
      mn[i] = acc + defect[s][i];
    }
    for (int i = 0; i < SD; ++i) m[i] = mn[i];
  }

  // ---- residual rows and the gradient g = Ju^T r_u
  T xl[SD];
  for (int i = 0; i < SD; ++i) xl[i] = c.xs[i][N - 1];
  T r_term[ALLMAX], term_aff[ALLMAX], b_all[ALLMAX], c_term[ALLMAX];
  for (int t = 0; t < n_tc; ++t) {
    r_term[t] = a.w_costs[t] * row_diff(a, t, xl, spt);
    term_aff[t] = a.w_costs[t] * m[a.row_coord[t]];
    b_all[t] = (r_term[t] + term_aff[t]) / a.w_costs[t];
  }
  for (int j = 0; j < n_t; ++j) {
    const int r = n_tc + j;
    c_term[j] = row_diff(a, r, xl, spt);
    b_all[r] = c_term[j] + m[a.row_coord[r]];
  }
  T ru[NUMAX];
  cost_rows_u(a, c.u, up, ru);
  T g[KMAX];
  for (int k = 0; k < K; ++k) {
    T acc = T(0);
    for (int r = 0; r < n_u; ++r) acc += Juc[r * K + k] * ru[r];
    g[k] = acc;
  }

  // ---- spectral solves C^{-1} X and C^{-1/2} A in the static eigenbasis
  T dinv[KMAX], sdinv[KMAX], y[KMAX];
  for (int k = 0; k < K; ++k) {
    dinv[k] = T(1) / (eigs[k] + lam);
    sdinv[k] = sqrt_t(dinv[k]);
  }
  T CiA[ALLMAX][KMAX], Cig[KMAX];
  T Gc[ALLMAX][TMAX];  // Schur factor columns [C^{-1/2} A_r ; sqrt(D) e_r]
  for (int r = 0; r < n_all; ++r) {
    const T* X = M[a.row_coord[r]];
    T yd[KMAX];
    for (int k = 0; k < K; ++k) {
      T acc = T(0);
      for (int j = 0; j < K; ++j) acc += Q[j * K + k] * X[j];
      y[k] = acc;
      yd[k] = acc * dinv[k];
    }
    for (int k = 0; k < K; ++k) {
      T acc = T(0), acc2 = T(0);
      for (int j = 0; j < K; ++j) {
        acc += Q[k * K + j] * yd[j];
        acc2 += Q[k * K + j] * (y[j] * sdinv[j]);
      }
      CiA[r][k] = acc;
      Gc[r][k] = acc2;
    }
    for (int q = 0; q < n_all; ++q) Gc[r][K + q] = (q == r) ? a.sqrtD[r] : T(0);
  }
  eig_apply(Q, K, g, dinv, y, Cig);

  T mu[ALLMAX], du[KMAX];
  if (n_all) {
    // 2-pass MGS QR of the stacked factor; only R enters the solve.
    const int rows = K + n_all;
    T R[ALLMAX][ALLMAX];
    for (int j = 0; j < n_all; ++j) {
      T* v = Gc[j];
      T acc = T(0);
      for (int q = 0; q < rows; ++q) acc += v[q] * v[q];
      const T orig = sqrt_t(acc);
      T rj[ALLMAX];
      for (int i = 0; i < j; ++i) rj[i] = T(0);
      for (int pass = 0; pass < 2; ++pass)
        for (int i = 0; i < j; ++i) {
          T h = T(0);
          for (int q = 0; q < rows; ++q) h += Gc[i][q] * v[q];
          for (int q = 0; q < rows; ++q) v[q] = v[q] - h * Gc[i][q];
          rj[i] = rj[i] + h;
        }
      acc = T(0);
      for (int q = 0; q < rows; ++q) acc += v[q] * v[q];
      const T nrm = dyn_max(sqrt_t(acc), qr_eps<T>() * orig + T(1.0e-30));
      for (int i = 0; i < j; ++i) R[i][j] = rj[i];
      R[j][j] = nrm;
      for (int q = 0; q < rows; ++q) v[q] = v[q] / nrm;
    }
    T rhs[ALLMAX];
    for (int r = 0; r < n_all; ++r) {
      const T* A = M[a.row_coord[r]];
      T acc = T(0);
      for (int k = 0; k < K; ++k) acc += A[k] * Cig[k];
      rhs[r] = b_all[r] - acc;
    }
    schur_solve(R, n_all, rhs, mu);
    for (int k = 0; k < K; ++k) {
      T acc = T(0);
      for (int r = 0; r < n_all; ++r) acc += CiA[r][k] * mu[r];
      du[k] = -(Cig[k] + acc);
    }
    // One refinement step on the augmented system.
    T t1[KMAX], t2[KMAX], ceig[KMAX];
    for (int k = 0; k < K; ++k) {
      T acc = T(0);
      for (int r = 0; r < n_all; ++r) acc += M[a.row_coord[r]][k] * mu[r];
      t1[k] = acc;  // A^T mu
      ceig[k] = eigs[k] + lam;
    }
    eig_apply(Q, K, du, ceig, y, t2);  // C du
    for (int k = 0; k < K; ++k) t2[k] = -g[k] - (t2[k] + t1[k]);  // res_d
    T res_c[ALLMAX];
    for (int r = 0; r < n_all; ++r) {
      const T* A = M[a.row_coord[r]];
      T acc = T(0);
      for (int k = 0; k < K; ++k) acc += A[k] * du[k];
      res_c[r] = -b_all[r] - (acc - a.D_diag[r] * mu[r]);
    }
    eig_apply(Q, K, t2, dinv, y, t1);  // Ci_rd
    for (int r = 0; r < n_all; ++r) {
      const T* A = M[a.row_coord[r]];
      T acc = T(0);
      for (int k = 0; k < K; ++k) acc += A[k] * t1[k];
      rhs[r] = acc - res_c[r];
    }
    T e[ALLMAX];
    schur_solve(R, n_all, rhs, e);
    for (int k = 0; k < K; ++k) {
      T acc = T(0);
      for (int r = 0; r < n_all; ++r) acc += CiA[r][k] * e[r];
      du[k] = du[k] + t1[k] - acc;
    }
    for (int r = 0; r < n_all; ++r) mu[r] = mu[r] + e[r];
  } else {
    for (int k = 0; k < K; ++k) du[k] = -Cig[k];
  }
  const T* nu = mu + n_tc;

  // ---- state-step expansion
  T dxs[NMAX][SD];
  for (int i = 0; i < SD; ++i) dxs[0][i] = -pin[i];
  for (int s = 0; s < S; ++s)
    for (int i = 0; i < SD; ++i) {
      T acc = T(0);
      for (int j = 0; j < SD; ++j) acc += Jx[s][i * SD + j] * dxs[s][j];
      for (int t = 0; t < sp; ++t) acc += Ju[s * sp + t][i] * du[s * sp + t];
      dxs[s + 1][i] = acc + defect[s][i];
    }

  // ---- exact directional derivative (J^T r) . dz
  T jr_dz = T(0);
  for (int t = 0; t < n_tc; ++t) {
    const T* Mc = M[a.row_coord[t]];
    T acc = T(0);
    for (int k = 0; k < K; ++k) acc += (a.w_costs[t] * Mc[k]) * du[k];
    jr_dz += r_term[t] * (acc + term_aff[t]);
  }
  {
    T acc = T(0);
    for (int r = 0; r < n_u; ++r) {
      T jd = T(0);
      for (int k = 0; k < K; ++k) jd += Juc[r * K + k] * du[k];
      acc += ru[r] * jd;
    }
    jr_dz = jr_dz + acc;
  }

  // ---- post-step multiplier estimate nu_inf (adjoint pass)
  T pi[SD], pn[SD];
  for (int i = 0; i < SD; ++i) pi[i] = T(0);
  for (int r = 0; r < n_all; ++r) pi[a.row_coord[r]] += mu[r];
  T pi_max = T(0);
  for (int s = S - 1; s >= 0; --s) {
    T mags = abs_t(pi[0]);
    for (int i = 1; i < SD; ++i) mags = dyn_max(mags, abs_t(pi[i]));
    pi_max = dyn_max(pi_max, mags);
    for (int j = 0; j < SD; ++j) {
      T acc = T(0);
      for (int i = 0; i < SD; ++i) acc += Jx[s][i * SD + j] * pi[i];
      pn[j] = acc;
    }
    for (int i = 0; i < SD; ++i) pi[i] = pn[i];
  }
  T sigma = abs_t(pi[0]);
  for (int i = 1; i < SD; ++i) sigma = dyn_max(sigma, abs_t(pi[i]));
  T nu_abs = T(0);
  if (n_t) {
    nu_abs = abs_t(nu[0]);
    for (int j = 1; j < n_t; ++j) nu_abs = dyn_max(nu_abs, abs_t(nu[j]));
  }
  const T nu_inf = dyn_max(nu_abs, dyn_max(pi_max, sigma));

  // ---- first-order diagnostic with the pre-step residual multipliers
  for (int i = 0; i < SD; ++i) pi[i] = T(0);
  for (int t = 0; t < n_tc; ++t) pi[a.row_coord[t]] += a.w_costs[t] * r_term[t];
  for (int j = 0; j < n_t; ++j) pi[a.row_coord[n_tc + j]] += nu[j];
  T first = T(0);
  for (int s = S - 1; s >= 0; --s) {
    for (int t = 0; t < sp; ++t) {
      const int k = s * sp + t;
      T acc = T(0);
      for (int i = 0; i < SD; ++i) acc += Ju[k][i] * pi[i];
      first = dyn_max(first, abs_t(g[k] + acc));
    }
    for (int j = 0; j < SD; ++j) {
      T acc = T(0);
      for (int i = 0; i < SD; ++i) acc += Jx[s][i * SD + j] * pi[i];
      pn[j] = acc;
    }
    for (int i = 0; i < SD; ++i) pi[i] = pn[i];
  }

  bool qp_ok = true;
  for (int k = 0; k < K; ++k) qp_ok = qp_ok && finite_t(du[k]);
  for (int n = 0; n < N; ++n)
    for (int i = 0; i < SD; ++i) qp_ok = qp_ok && finite_t(dxs[n][i]);
  for (int r = 0; r < n_all; ++r) qp_ok = qp_ok && finite_t(mu[r]);

  // ---- merit
  T cost_t = T(0), cost_u = T(0);
  for (int t = 0; t < n_tc; ++t) cost_t += r_term[t] * r_term[t];
  for (int r = 0; r < n_u; ++r) cost_u += ru[r] * ru[r];
  const T cost = T(0.5) * (cost_t + cost_u);
  T viol1 = T(0), violmax = T(0);
  for (int i = 0; i < SD; ++i) {
    T acc = T(0), mx = T(0);
    for (int s = 0; s < S; ++s) {
      acc += abs_t(defect[s][i]);
      mx = dyn_max(mx, abs_t(defect[s][i]));
    }
    viol1 = viol1 + acc;
    viol1 = viol1 + abs_t(pin[i]);
    violmax = dyn_max(dyn_max(violmax, mx), abs_t(pin[i]));
  }
  for (int j = 0; j < n_t; ++j) {
    viol1 = viol1 + abs_t(c_term[j]);
    violmax = dyn_max(violmax, abs_t(c_term[j]));
  }
  if (!qp_ok) {  // zero the step where the QP failed (fail_qp is terminal)
    for (int k = 0; k < K; ++k) du[k] = T(0);
    for (int n = 0; n < N; ++n)
      for (int i = 0; i < SD; ++i) dxs[n][i] = T(0);
  }
  const T mu_new = dyn_max(c.mu, a.penalty_margin * nu_inf);
  const T phi0 = cost + mu_new * viol1;
  const T dphi = jr_dz - mu_new * viol1;
  const T slack = a.slack_coef * abs_t(phi0);

  // ---- Armijo search over alpha = 1, 1/2, ...: the first accepted trial
  // in alpha order wins, so the search stops there.
  T alpha_used = T(0), phi_sel = T(0);
  bool found = false;
  T alpha = T(1);
  for (int trial = 0; trial < a.n_ls && !found; ++trial, alpha *= T(0.5)) {
    T xt[NMAX][SD];
    for (int n = 0; n < N; ++n)
      for (int i = 0; i < SD; ++i) {
        T v = wrap(a, i, c.xs[i][n] + alpha * dxs[n][i]);
        xt[n][i] = (i == 0) ? clip_t(v, -a.b_x_limit, a.b_x_limit) : v;
      }
    T ua[KMAX];
    for (int k = 0; k < K; ++k)
      ua[k] = clip_t(c.u[k] + alpha * du[k], -a.u_limit, a.u_limit);
    T dsum[SD];
    for (int i = 0; i < SD; ++i) dsum[i] = T(0);
    for (int s = 0; s < S; ++s) {
      T x[SD];
      for (int i = 0; i < SD; ++i) x[i] = xt[s][i];
      for (int t = 0; t < sp; ++t) rk4_step(a, p, x, ua[s * sp + t]);
      for (int i = 0; i < SD; ++i)
        dsum[i] += abs_t(wrap(a, i, x[i] - xt[s + 1][i]));
    }
    T viol = T(0);
    for (int i = 0; i < SD; ++i) {
      viol = viol + dsum[i];
      viol = viol + abs_t(wrap(a, i, xt[0][i] - xc[i]));
    }
    T cost_a = T(0);
    for (int t = 0; t < n_tc; ++t) {
      const T rt = a.w_costs[t] * row_diff(a, t, xt[N - 1], spt);
      cost_a = cost_a + T(0.5) * (rt * rt);
    }
    T rua[NUMAX];
    cost_rows_u(a, ua, up, rua);
    T su = T(0);
    for (int r = 0; r < n_u; ++r) su += rua[r] * rua[r];
    cost_a = cost_a + T(0.5) * su;
    for (int j = 0; j < n_t; ++j)
      viol = viol + abs_t(row_diff(a, n_tc + j, xt[N - 1], spt));
    T phi = cost_a + mu_new * viol;
    if (!finite_t(phi)) phi = T(INFINITY);
    if (phi <= phi0 + a.armijo_c1 * (alpha * dphi) + slack) {
      found = true;
      alpha_used = alpha;
      phi_sel = phi;
    }
  }
  const bool any_accept = found && qp_ok;
  if (!any_accept) alpha_used = T(0);
  const T phi_new = any_accept ? phi_sel : phi0;
  const T lam_next = any_accept
                         ? lam * a.lambda_decrease
                         : dyn_max(lam * a.lambda_increase,
                                   a.lambda_failure_floor);

  const bool prev_ok = finite_t(c.merit);
  const T mp = prev_ok ? c.merit : T(0);
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

  tr.cost = cost;
  tr.viol = violmax;
  tr.lam = lam;
  tr.alpha = alpha_used;
  tr.first = first;
  tr.applied = 1;

  if (any_accept) {  // re-retract at the accepted alpha
    for (int k = 0; k < K; ++k)
      c.u[k] = clip_t(c.u[k] + alpha_used * du[k], -a.u_limit, a.u_limit);
    for (int n = 0; n < N; ++n)
      for (int i = 0; i < SD; ++i) {
        T v = wrap(a, i, c.xs[i][n] + alpha_used * dxs[n][i]);
        c.xs[i][n] = (i == 0) ? clip_t(v, -a.b_x_limit, a.b_x_limit) : v;
      }
  }
  c.lam = lam_next;
  c.mu = mu_new;
  c.merit = phi_new;
  c.term = new_term;
  c.fo = first;
  c.done = now_done ? 1 : 0;
}

// n_iter iterations of instance b, reading and writing the batch-last
// tensors of `t`; Q/eigs/Juc may point at shared memory.
template <typename T>
__host__ __device__ inline void fused_solve_instance(
    const FusedTensors<T>& t, const FusedArgs<T>& a, const T* Q,
    const T* eigs, const T* Juc, int b) {
  const int B = a.B, N = a.N, K = a.K;
  T p[NP], xc[SD];
  for (int j = 0; j < NP; ++j) p[j] = t.params[j * B + b];
  for (int i = 0; i < SD; ++i) xc[i] = t.xc[i * B + b];
  const T spt = t.spt[b], up = t.up[b];
  Carry<T> c;
  for (int i = 0; i < SD; ++i)
    for (int n = 0; n < N; ++n) c.xs[i][n] = t.xs[(i * N + n) * B + b];
  for (int k = 0; k < K; ++k) c.u[k] = t.u[k * B + b];
  c.lam = t.lam[b];
  c.mu = t.mu[b];
  c.merit = t.merit[b];
  c.fo = t.fo[b];
  c.done = t.done[b];
  c.term = t.term[b];
  for (int it = 0; it < a.n_iter; ++it) {
    Trace<T> tr;
    fused_iteration(a, p, xc, spt, up, Q, eigs, Juc, c, tr);
    const int o = it * B + b;
    t.tr_cost[o] = tr.cost;
    t.tr_viol[o] = tr.viol;
    t.tr_lam[o] = tr.lam;
    t.tr_alpha[o] = tr.alpha;
    t.tr_first[o] = tr.first;
    t.tr_applied[o] = tr.applied;
  }
  for (int i = 0; i < SD; ++i)
    for (int n = 0; n < N; ++n) t.xs_o[(i * N + n) * B + b] = c.xs[i][n];
  for (int k = 0; k < K; ++k) t.u_o[k * B + b] = c.u[k];
  t.lam_o[b] = c.lam;
  t.mu_o[b] = c.mu;
  t.merit_o[b] = c.merit;
  t.fo_o[b] = c.fo;
  t.done_o[b] = c.done;
  t.term_o[b] = c.term;
}

}  // namespace fused
