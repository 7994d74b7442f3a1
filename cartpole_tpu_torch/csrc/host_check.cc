// Host build of the kernel bodies, for checking them on a CPU.
//
// Compiles fused_iteration.cuh and segment_jac.cuh with a plain C++ compiler
// (the __host__/__device__ qualifiers are defined away) and loops the
// per-instance solve over the batch and the per-column segment Jacobian over
// the columns. The tests build it with
//   g++ -O2 -std=c++17 -shared -fPIC -o libkernels_host.so host_check.cc
// and hold it against ops/fused.py::fused_iteration_reference and
// ops/pallas_kernels.py::segment_jac_batch_last_reference in f64.
#include "fused_iteration.cuh"

extern "C" int fused_iteration_host_f64(fused::FusedTensors<double> t,
                                        fused::FusedArgs<double> a) {
  for (int b = 0; b < a.B; ++b)
    fused::fused_solve_instance(t, a, t.Q, t.eigs, t.Juc, b);
  return 0;
}

extern "C" int fused_iteration_host_f32(fused::FusedTensors<float> t,
                                        fused::FusedArgs<float> a) {
  for (int b = 0; b < a.B; ++b)
    fused::fused_solve_instance(t, a, t.Q, t.eigs, t.Juc, b);
  return 0;
}

extern "C" int segment_jac_host_f64(const double* params, const double* xs,
                                    const double* us, double* xe, double* jx,
                                    double* ju, int R, int sp, double h,
                                    double h_half, double h_sixth,
                                    int angle_mask) {
  if (R < 1 || sp < 1 || sp > segjac::SPMAX) return 1;
  for (int r = 0; r < R; ++r)
    segjac::segment_jac_column<segjac::SingleCartPole>(
        params, xs, us, xe, jx, ju, R, sp, h, h_half, h_sixth, angle_mask, r);
  return 0;
}
