// Host build of the kernel bodies, for checking them on a CPU.
//
// Compiles fused_iteration.cuh and segment_jac.cuh with a plain C++ compiler
// (the __host__/__device__ qualifiers are defined away). Kernel 1 runs as
// the card runs it: blocks of `instances` instances, each block staging its
// statics into a buffer laid out as the card's shared memory, a ragged last
// block masking whole instances, and every instance's stages run lane by
// lane, one stage after another, over `lanes` lanes. Kernel 2 loops the
// per-column segment Jacobian, templated on the steps per segment as the
// card's launcher dispatches it, over the columns. The tests build it with
//   g++ -O2 -std=c++17 -shared -fPIC -o libkernels_host.so host_check.cc
// and hold it against ops/fused.py::fused_iteration_reference and
// ops/pallas_kernels.py::segment_jac_batch_last_reference in f64.
#include <vector>

#include "fused_iteration.cuh"

namespace {

// Runs a stage on every lane in turn: what a barrier between stages gives.
struct HostExec {
  int lanes;
  void mark(int) {}
  template <typename F>
  void step(F&& f) {
    for (int lane = 0; lane < lanes; ++lane) f(lane, lanes);
  }
};

template <typename T>
int solve_host(const fused::FusedTensors<T>& t, const fused::FusedArgs<T>& a,
               int lanes, int instances) {
  if (lanes < 1 || instances < 1 || a.B < 1 ||
      a.n_tc + a.n_t > fused::ALLMAX)
    return 1;
  const fused::Layout L = fused::make_layout(
      a.K, a.N, a.S, a.n_u, a.n_tc + a.n_t, a.n_ls, lanes);
  const int n_statics = fused::statics_reals(a.K);
  std::vector<T> smem(n_statics + (size_t)instances * L.total);
  for (int block = 0; block * instances < a.B; ++block) {
    const int threads = instances * lanes;
    fused::Statics<T> st{};
    for (int tid = 0; tid < threads; ++tid)
      st = fused::stage_statics(t, a, smem.data(), tid, threads);
    for (int slot = 0; slot < instances; ++slot) {
      const int b = block * instances + slot;
      if (b >= a.B) break;
      HostExec ex{lanes};
      fused::solve_instance(t, a, st, L,
                            smem.data() + n_statics + (size_t)slot * L.total,
                            b, ex);
    }
  }
  return 0;
}

}  // namespace

extern "C" int fused_iteration_host_f64(fused::FusedTensors<double> t,
                                        fused::FusedArgs<double> a, int lanes,
                                        int instances) {
  return solve_host(t, a, lanes, instances);
}

// Reals of one instance's workspace (fused::make_layout) and of a block's
// statics, for the shape checks of ops/fused.py.
extern "C" int fused_workspace_reals(int K, int N, int S, int n_u, int n_all,
                                     int n_ls, int lanes) {
  return fused::make_layout(K, N, S, n_u, n_all, n_ls, lanes).total;
}

extern "C" int fused_statics_reals(int K) { return fused::statics_reals(K); }

// Kernel 2's column body for SP = sp steps, over every column.
template <int SP = 1>
int segment_jac_host(const double* params, const double* xs,
                     const double* us, double* xe, double* jx, double* ju,
                     int R, int sp, double h, double h_half, double h_sixth,
                     int angle_mask) {
  if constexpr (SP > segjac::SPMAX) {
    return 1;
  } else {
    if (sp != SP)
      return segment_jac_host<SP + 1>(params, xs, us, xe, jx, ju, R, sp, h,
                                      h_half, h_sixth, angle_mask);
    for (int r = 0; r < R; ++r)
      segjac::segment_jac_column<SP, segjac::SingleCartPole>(
          params, xs, us, xe, jx, ju, R, h, h_half, h_sixth, angle_mask, r);
    return 0;
  }
}

extern "C" int segment_jac_host_f64(const double* params, const double* xs,
                                    const double* us, double* xe, double* jx,
                                    double* ju, int R, int sp, double h,
                                    double h_half, double h_sixth,
                                    int angle_mask) {
  if (R < 1) return 1;
  return segment_jac_host(params, xs, us, xe, jx, ju, R, sp, h, h_half,
                          h_sixth, angle_mask);
}
