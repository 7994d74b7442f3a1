// Machine-generated cart-pole dynamics for CUDA C++ -- do not edit.
//
// Generated by `python -m cartpole_tpu_torch.symbolic.generate` from the SymPy
// Euler-Lagrange derivation in symbolic/lagrangian.py; the same
// CSE feeds models/_single_gen.py. Templated on the real type T. The dyn_*
// helpers call the precise library functions of T (sinf for float, sin for
// double), never the __sinf-style fast intrinsics.
#pragma once

#ifndef __CUDACC__
#ifndef __host__
#define __host__
#endif
#ifndef __device__
#define __device__
#endif
#endif

#include <math.h>

namespace cartpole_gen {

constexpr int N_Q = 2;
constexpr int STATE_DIM = 4;
constexpr int N_PARAMS = 9;

__host__ __device__ inline float dyn_sin(float x) { return sinf(x); }
__host__ __device__ inline double dyn_sin(double x) { return sin(x); }
__host__ __device__ inline float dyn_cos(float x) { return cosf(x); }
__host__ __device__ inline double dyn_cos(double x) { return cos(x); }
__host__ __device__ inline float dyn_tanh(float x) { return tanhf(x); }
__host__ __device__ inline double dyn_tanh(double x) { return tanh(x); }
__host__ __device__ inline float dyn_sqrt(float x) { return sqrtf(x); }
__host__ __device__ inline double dyn_sqrt(double x) { return sqrt(x); }
// NaN-propagating max (jnp.maximum / torch.maximum semantics).
template <typename T>
__host__ __device__ inline T dyn_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__host__ __device__ inline void single_dynamics_core(const T* p, const T* x, T u, T* xdot) {
  const T m_b = p[0];
  const T m_1 = p[1];
  const T l_1 = p[2];
  const T g = p[3];
  const T mu_b = p[4];
  const T v_mu_b = p[5];
  const T c_d_1 = p[6];
  const T x_s = p[7];
  const T k_s = p[8];
  const T b_x = x[0];
  const T th_1 = x[1];
  const T b_v = x[2];
  const T th_1_v = x[3];
  const T f_b_x = T(0);
  const T f_b_y = T(0);
  const T f_m_x = T(0);
  const T f_m_y = T(0);
  const T x0 = dyn_sin(th_1);
  const T x1 = l_1*x0;
  const T x2 = dyn_cos(th_1);
  const T x3 = l_1*m_1*x2;
  const T x4 = ((x0)*(x0));
  const T x5 = ((th_1_v)*(th_1_v));
  const T x6 = ((l_1)*(l_1));
  const T x7 = x5*x6;
  const T x8 = ((x2)*(x2));
  const T x9 = ((b_v)*(b_v)) - T(2)*b_v*th_1_v*x1 + x4*x7 + x7*x8;
  const T x10 = dyn_sqrt((x9 > T(0)) ? x9 : T(1));
  const T x11 = (T(0.5))*c_d_1*x10;
  const T x12 = th_1_v*x11*x6;
  const T x13 = (x9 > T(0));
  const T x14 = -f_m_x*x1 + f_m_y*l_1*x2 - g*x3 + (x13 ? (T(0.5))*b_v*c_d_1*l_1*x0*x10 - x12*x4 - x12*x8 : T(0));
  const T x15 = m_1*x8;
  const T x16 = x0/(l_1*m_b + l_1*x15);
  const T x17 = m_1*m_b;
  const T x18 = ((m_1)*(m_1))*x8;
  const T x19 = g*mu_b*dyn_tanh(b_v/dyn_max(T(1e-06), v_mu_b));
  const T x20 = f_b_x + f_m_x + k_s*dyn_max(T(0), -b_x - x_s) - k_s*dyn_max(T(0), b_x - x_s) - m_1*x19 - m_b*x19 + u + x3*x5 + (x13 ? -b_v*x11 + (T(0.5))*c_d_1*l_1*th_1_v*x0*x10 : T(0));
  xdot[0] = b_v;
  xdot[1] = th_1_v;
  xdot[2] = x14*x16 + x20*(m_1*x4 + m_b + x15)/(((m_b)*(m_b)) + x17*x8 + x17 + x18);
  xdot[3] = x14*(m_1 + m_b)/(x17*x6 + x18*x6) + x16*x20;
}

template <typename T>
__host__ __device__ inline void single_dynamics_jac_core(const T* p, const T* x, T u, T* xdot, T* Jx, T* Ju) {
  const T m_b = p[0];
  const T m_1 = p[1];
  const T l_1 = p[2];
  const T g = p[3];
  const T mu_b = p[4];
  const T v_mu_b = p[5];
  const T c_d_1 = p[6];
  const T x_s = p[7];
  const T k_s = p[8];
  const T b_x = x[0];
  const T th_1 = x[1];
  const T b_v = x[2];
  const T th_1_v = x[3];
  const T f_b_x = T(0);
  const T f_b_y = T(0);
  const T f_m_x = T(0);
  const T f_m_y = T(0);
  const T x0 = dyn_sin(th_1);
  const T x1 = l_1*x0;
  const T x2 = dyn_cos(th_1);
  const T x3 = l_1*x2;
  const T x4 = m_1*x3;
  const T x5 = ((b_v)*(b_v));
  const T x6 = th_1_v*x1;
  const T x7 = ((x0)*(x0));
  const T x8 = ((th_1_v)*(th_1_v));
  const T x9 = ((l_1)*(l_1));
  const T x10 = x8*x9;
  const T x11 = ((x2)*(x2));
  const T x12 = -T(2)*b_v*x6 + x10*x11 + x10*x7 + x5;
  const T x13 = dyn_sqrt((x12 > T(0)) ? x12 : T(1));
  const T x14 = (T(0.5))*c_d_1;
  const T x15 = x13*x14;
  const T x16 = th_1_v*x9;
  const T x17 = x16*x7;
  const T x18 = x11*x16;
  const T x19 = (x12 > T(0));
  const T x20 = -f_m_x*x1 + f_m_y*l_1*x2 - g*x4 + (x19 ? (T(0.5))*b_v*c_d_1*l_1*x0*x13 - x15*x17 - x15*x18 : T(0));
  const T x21 = m_1*x11;
  const T x22 = l_1*m_b + l_1*x21;
  const T x23 = (T(1)/((x22)));
  const T x24 = x0*x23;
  const T x25 = b_x - x_s;
  const T x26 = -b_x - x_s;
  const T x27 = g*m_1;
  const T x28 = (T(1)/((dyn_max(T(1e-06), v_mu_b))));
  const T x29 = dyn_tanh(b_v*x28);
  const T x30 = mu_b*x29;
  const T x31 = g*m_b;
  const T x32 = b_v*x15;
  const T x33 = f_b_x + f_m_x - k_s*dyn_max(T(0), x25) + k_s*dyn_max(T(0), x26) + u - x27*x30 - x30*x31 + x4*x8 + (x19 ? (T(0.5))*c_d_1*l_1*th_1_v*x0*x13 - x32 : T(0));
  const T x34 = m_1*x7;
  const T x35 = m_b + x21 + x34;
  const T x36 = m_1*m_b;
  const T x37 = ((m_1)*(m_1));
  const T x38 = x11*x37;
  const T x39 = ((m_b)*(m_b)) + x11*x36 + x36 + x38;
  const T x40 = x35/x39;
  const T x41 = x36*x9 + x38*x9;
  const T x42 = m_1 + m_b;
  const T x43 = x42/x41;
  const T x44 = -k_s*((x25 < T(0)) ? T(0) : ((x25 == T(0)) ? T(0.5) : T(1))) - k_s*((x26 < T(0)) ? T(0) : ((x26 == T(0)) ? T(0.5) : T(1)));
  const T x45 = x2*x23;
  const T x46 = T(2)*x3*x34/((x22)*(x22));
  const T x47 = th_1_v*x3;
  const T x48 = (T(1)/((x13)));
  const T x49 = x14*x48;
  const T x50 = x49*x5;
  const T x51 = x0*x2;
  const T x52 = b_v*x49;
  const T x53 = -m_1*x1*x8 + (x19 ? -x10*x51*x52 + x15*x47 + x47*x50 : T(0));
  const T x54 = T(2)*x51;
  const T x55 = x37*x54;
  const T x56 = ((l_1)*(l_1)*(l_1))*x52*x8;
  const T x57 = -f_m_x*x3 - f_m_y*x1 + g*l_1*m_1*x0 + (x19 ? -x16*x50*x51 + ((x2)*(x2)*(x2))*x56 + x2*x56*x7 + x3*x32 : T(0));
  const T x58 = x1*x15;
  const T x59 = b_v*x1;
  const T x60 = b_v - x6;
  const T x61 = x49*x60;
  const T x62 = (x19 ? -x17*x61 - x18*x61 + x58 + x59*x61 : T(0));
  const T x63 = mu_b*x28*(T(1) - ((x29)*(x29)));
  const T x64 = -x27*x63 - x31*x63 + (x19 ? (T(0.5))*c_d_1*l_1*th_1_v*x0*x48*x60 - x15 - x52*x60 : T(0));
  const T x65 = x17 + x18 - x59;
  const T x66 = x49*x65;
  const T x67 = T(2)*th_1_v*x4 + (x19 ? -x52*x65 + x58 + x6*x66 : T(0));
  const T x68 = x15*x9;
  const T x69 = (x19 ? (T(0.5))*b_v*c_d_1*l_1*x0*x48*x65 - x11*x68 - x17*x66 - x18*x66 - x68*x7 : T(0));
  xdot[0] = b_v;
  xdot[1] = th_1_v;
  xdot[2] = x20*x24 + x33*x40;
  xdot[3] = x20*x43 + x24*x33;
  Jx[0] = T(0);
  Jx[1] = T(0);
  Jx[2] = T(1);
  Jx[3] = T(0);
  Ju[0] = T(0);
  Jx[4] = T(0);
  Jx[5] = T(0);
  Jx[6] = T(0);
  Jx[7] = T(1);
  Ju[1] = T(0);
  Jx[8] = x40*x44;
  Jx[9] = x20*x45 + x20*x46 + x24*x57 + x33*x35*(x36*x54 + x55)/((x39)*(x39)) + x40*x53;
  Jx[10] = x24*x62 + x40*x64;
  Jx[11] = x24*x69 + x40*x67;
  Ju[2] = x40;
  Jx[12] = x24*x44;
  Jx[13] = x20*x42*x55*x9/((x41)*(x41)) + x24*x53 + x33*x45 + x33*x46 + x43*x57;
  Jx[14] = x24*x64 + x43*x62;
  Jx[15] = x24*x67 + x43*x69;
  Ju[3] = x24;
}

}  // namespace cartpole_gen
