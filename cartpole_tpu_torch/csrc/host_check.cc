// Host build of the fused GN iteration body, for checking it on a CPU.
//
// Compiles fused_iteration.cuh with a plain C++ compiler (the
// __host__/__device__ qualifiers are defined away) and loops the
// per-instance solve over the batch. The tests build it with
//   g++ -O2 -std=c++17 -shared -fPIC -o libfused_host.so host_check.cc
// and hold it against ops/fused.py::fused_iteration_reference in f64.
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
