// Shooting-segment rollout with chain-ruled Jacobians: the arithmetic that
// both kernels of the port share.
//
// Kernel 2 (segment_jac.cu) runs segment_jac_column for one column per
// thread, templated on the steps per segment. It replaces
// cartpole_tpu/ops/pallas_kernels.py::segment_jac_batch_last (the Pallas
// kernel of _make_kernel and _rk4_jac_components). Kernel 1
// (fused_iteration.cuh) shares the model, stage_jac and wrap. Plain
// PyTorch version: ops/pallas_kernels.py::segment_jac_batch_last_reference.
//
// The dynamics model is a compile-time parameter (the reference passes the
// generated function gen_jac): the single, double and triple cart-pole, each
// a struct of its state and parameter counts and its generated cores. Step
// constants and the angle mask are plain arguments. Every function is
// __host__ __device__ and templated on the real type T, so host_check.cc
// compiles the same body with g++.
#pragma once

#include "double_dynamics.cuh"
#include "single_dynamics.cuh"
#include "triple_dynamics.cuh"

namespace segjac {

// The single cart-pole of models/_single_gen.py.
struct SingleCartPole {
  // The model's id in the C interface, and its name: ops/_build.py lists
  // the names in id order (KERNEL_MODELS) and checks them against
  // model_name() when it loads a library.
  static constexpr int ID = 0;
  static constexpr const char* NAME = "single";
  static constexpr int SD = cartpole_gen::STATE_DIM;
  static constexpr int NP = cartpole_gen::N_PARAMS;
  template <typename T>
  __host__ __device__ static void core(const T* p, const T* x, T u, T* xdot) {
    cartpole_gen::single_dynamics_core(p, x, u, xdot);
  }
  template <typename T>
  __host__ __device__ static void jac(const T* p, const T* x, T u, T* xdot,
                                      T* Jx, T* Ju) {
    cartpole_gen::single_dynamics_jac_core(p, x, u, xdot, Jx, Ju);
  }
};

// The double cart-pole of models/_double_gen.py.
struct DoubleCartPole {
  static constexpr int ID = 1;
  static constexpr const char* NAME = "double";
  static constexpr int SD = cartpole_gen::double_pole::STATE_DIM;
  static constexpr int NP = cartpole_gen::double_pole::N_PARAMS;
  template <typename T>
  __host__ __device__ static void core(const T* p, const T* x, T u, T* xdot) {
    cartpole_gen::double_pole::double_dynamics_core(p, x, u, xdot);
  }
  template <typename T>
  __host__ __device__ static void jac(const T* p, const T* x, T u, T* xdot,
                                      T* Jx, T* Ju) {
    cartpole_gen::double_pole::double_dynamics_jac_core(p, x, u, xdot, Jx,
                                                        Ju);
  }
};

// The triple cart-pole of models/_triple_gen.py.
struct TripleCartPole {
  static constexpr int ID = 2;
  static constexpr const char* NAME = "triple";
  static constexpr int SD = cartpole_gen::triple_pole::STATE_DIM;
  static constexpr int NP = cartpole_gen::triple_pole::N_PARAMS;
  template <typename T>
  __host__ __device__ static void core(const T* p, const T* x, T u, T* xdot) {
    cartpole_gen::triple_pole::triple_dynamics_core(p, x, u, xdot);
  }
  template <typename T>
  __host__ __device__ static void jac(const T* p, const T* x, T u, T* xdot,
                                      T* Jx, T* Ju) {
    cartpole_gen::triple_pole::triple_dynamics_jac_core(p, x, u, xdot, Jx,
                                                        Ju);
  }
};

// The largest state dimension of a compiled model.
constexpr int SD_MAX = TripleCartPole::SD;

// The name of the model with id `model`; nullptr past the last.
inline const char* model_name(int model) {
  switch (model) {
    case SingleCartPole::ID: return SingleCartPole::NAME;
    case DoubleCartPole::ID: return DoubleCartPole::NAME;
    case TripleCartPole::ID: return TripleCartPole::NAME;
    default: return nullptr;
  }
}

// Compile-time maximum of the steps per segment; the wrapper raises beyond.
constexpr int SPMAX = 16;

__host__ __device__ inline float fmod_t(float a, float b) { return fmodf(a, b); }
__host__ __device__ inline double fmod_t(double a, double b) { return fmod(a, b); }

// Wrap to (-pi, pi]: pi - mod(pi - a, 2 pi) with jnp.mod's sign rule.
template <typename T>
__host__ __device__ inline T mod_pi(T a) {
  const T pi = T(3.14159265358979323846);
  const T two_pi = T(6.28318530717958647692);
  T r = fmod_t(pi - a, two_pi);
  if (r < T(0)) r += two_pi;
  return pi - r;
}

// mod_pi the coordinates whose bit is set in angle_mask.
template <typename T>
__host__ __device__ inline T wrap(int angle_mask, int i, T v) {
  return ((angle_mask >> i) & 1) ? mod_pi(v) : v;
}

// dk_dx = Aj @ (I + c * Aprev); dk_du = Aj @ (c * Bprev) + Bj.
template <int SD, typename T>
__host__ __device__ inline void stage_jac(const T* Aj, const T* Bj,
                                          const T* Aprev, const T* Bprev,
                                          T c, T* dk_dx, T* dk_du) {
  for (int i = 0; i < SD; ++i) {
    for (int j = 0; j < SD; ++j) {
      T acc = T(0);
      for (int k = 0; k < SD; ++k)
        acc += Aj[i * SD + k] * ((k == j ? T(1) : T(0)) + c * Aprev[k * SD + j]);
      dk_dx[i * SD + j] = acc;
    }
    T acc = T(0);
    for (int k = 0; k < SD; ++k) acc += Aj[i * SD + k] * (c * Bprev[k]);
    dk_du[i] = acc + Bj[i];
  }
}

// One RK4 step of size h (h_half = h/2, h_sixth = h/6) with its chain-ruled
// step Jacobians A = dx'/dx (row-major), Bv = dx'/du (integration.hpp:13-49);
// x updated in place and wrapped (the wrap has unit derivative).
template <typename Model, typename T>
__host__ __device__ inline void rk4_step_jac(const T* p, T* x, T u, T h,
                                             T h_half, T h_sixth,
                                             int angle_mask, T* A, T* Bv) {
  constexpr int SD = Model::SD;
  T k1[SD], k2[SD], k3[SD], k4[SD], xt[SD];
  T A1[SD * SD], A2[SD * SD], A3[SD * SD], A4[SD * SD];
  T B1[SD], B2[SD], B3[SD], B4[SD];
  T d2[SD * SD], d3[SD * SD], d4[SD * SD], d2u[SD], d3u[SD], d4u[SD];
  Model::jac(p, x, u, k1, A1, B1);
  for (int i = 0; i < SD; ++i) xt[i] = x[i] + h_half * k1[i];
  Model::jac(p, xt, u, k2, A2, B2);
  stage_jac<SD>(A2, B2, A1, B1, h_half, d2, d2u);
  for (int i = 0; i < SD; ++i) xt[i] = x[i] + h_half * k2[i];
  Model::jac(p, xt, u, k3, A3, B3);
  stage_jac<SD>(A3, B3, d2, d2u, h_half, d3, d3u);
  for (int i = 0; i < SD; ++i) xt[i] = x[i] + h * k3[i];
  Model::jac(p, xt, u, k4, A4, B4);
  stage_jac<SD>(A4, B4, d3, d3u, h, d4, d4u);
  for (int i = 0; i < SD; ++i) {
    x[i] = wrap(angle_mask, i, x[i] + h_sixth * (k1[i] + T(2) * k2[i] +
                                                 T(2) * k3[i] + k4[i]));
    for (int j = 0; j < SD; ++j) {
      const int e = i * SD + j;
      A[e] = (i == j ? T(1) : T(0)) +
             h_sixth * (A1[e] + T(2) * d2[e] + T(2) * d3[e] + d4[e]);
    }
    Bv[i] = h_sixth * (B1[i] + T(2) * d2u[i] + T(2) * d3u[i] + d4u[i]);
  }
}

// One shooting segment of SP RK4 steps from x0 with the accumulated
// Jacobians Jx = dx_end/dx0 (row-major SD x SD) and
// Ju[t * SD + i] = d x_end[i] / d us[t * u_stride]. SP is a compile-time
// constant so that Ju stays in registers: the step loop is not unrolled
// (one copy of the RK4 body), and the loop over Ju's columns is, each
// column updated while it is an earlier step's (c < k) and set at its own.
template <int SP, typename Model, typename T>
__host__ __device__ inline void segment_rollout_with_jac(
    const T* p, const T* x0, const T* us, size_t u_stride, T h, T h_half,
    T h_sixth, int angle_mask, T* x_end, T* Jx, T* Ju) {
  constexpr int SD = Model::SD;
  T x[SD];
  for (int i = 0; i < SD; ++i) {
    x[i] = x0[i];
    for (int j = 0; j < SD; ++j) Jx[i * SD + j] = (i == j) ? T(1) : T(0);
  }
#pragma unroll 1
  for (int k = 0; k < SP; ++k) {
    T A[SD * SD], Bv[SD], tmp[SD * SD];
    rk4_step_jac<Model>(p, x, us[k * u_stride], h, h_half, h_sixth,
                        angle_mask, A, Bv);
    for (int i = 0; i < SD; ++i)
      for (int j = 0; j < SD; ++j) {
        T acc = T(0);
        for (int q = 0; q < SD; ++q) acc += A[i * SD + q] * Jx[q * SD + j];
        tmp[i * SD + j] = acc;
      }
    for (int e = 0; e < SD * SD; ++e) Jx[e] = tmp[e];
#pragma unroll
    for (int c = 0; c < SP; ++c) {
      if (c < k) {
        T col[SD];
        for (int i = 0; i < SD; ++i) col[i] = Ju[c * SD + i];
        for (int i = 0; i < SD; ++i) {
          T acc = T(0);
          for (int q = 0; q < SD; ++q) acc += A[i * SD + q] * col[q];
          Ju[c * SD + i] = acc;
        }
      } else if (c == k) {
        for (int i = 0; i < SD; ++i) Ju[c * SD + i] = Bv[i];
      }
    }
  }
  for (int i = 0; i < SD; ++i) x_end[i] = x[i];
}

// Column r of kernel 2, batch-last in and out (the reference's contract):
// params (NP, R), xs (SD, R), us (SP, R) -> xe (SD, R), jx (SD, SD, R),
// ju (SD, SP, R).
template <int SP, typename Model, typename T>
__host__ __device__ inline void segment_jac_column(
    const T* params, const T* xs, const T* us, T* xe, T* jx, T* ju, int R,
    T h, T h_half, T h_sixth, int angle_mask, int r) {
  constexpr int SD = Model::SD, NP = Model::NP;
  const size_t n = (size_t)R;
  T p[NP], x0[SD], x_end[SD], Jx[SD * SD], Ju[SP * SD];
  for (int j = 0; j < NP; ++j) p[j] = params[j * n + r];
  for (int i = 0; i < SD; ++i) x0[i] = xs[i * n + r];
  segment_rollout_with_jac<SP, Model>(p, x0, us + r, n, h, h_half, h_sixth,
                                      angle_mask, x_end, Jx, Ju);
  for (int i = 0; i < SD; ++i) {
    xe[i * n + r] = x_end[i];
    for (int j = 0; j < SD; ++j) jx[(i * SD + j) * n + r] = Jx[i * SD + j];
    for (int k = 0; k < SP; ++k) ju[((size_t)i * SP + k) * n + r] = Ju[k * SD + i];
  }
}

}  // namespace segjac
