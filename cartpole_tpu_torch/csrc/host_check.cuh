// Host build of the kernel bodies, for checking them on a CPU.
//
// Compiles fused_iteration.cuh and segment_jac.cuh with a plain C++ compiler
// (the __host__/__device__ qualifiers are defined away). Kernel 1 runs as
// the card runs it: blocks of `instances` instances, each block staging its
// statics into a buffer laid out as the card's shared memory, a ragged last
// block masking whole instances, and every instance's stages run lane by
// lane, one stage after another, over `lanes` lanes. Kernel 2 loops the
// per-column segment Jacobian, templated on the steps per segment as the
// card's launcher dispatches it, over the columns. ops/_build.py compiles
// this header once per model, each a translation unit of its own defining
// one table of bodies (HOST_INSTANCE, below), and host_check.cc dispatches
// the C interface on the model id, as the card's launchers do. ops/_build.py::build_host_library builds them with g++ for
// the tests, which hold them against ops/fused.py::fused_iteration_reference
// and ops/pallas_kernels.py::segment_jac_batch_last_reference in f64.
#pragma once

#include <vector>

#include "fused_iteration.cuh"

namespace host_check {

// Runs a stage on every lane in turn: what a barrier between stages gives.
struct HostExec {
  int lanes;
  void mark(int) {}
  template <typename F>
  void step(F&& f) {
    for (int lane = 0; lane < lanes; ++lane) f(lane, lanes);
  }
};

template <typename Model, typename T>
int solve_host(fused::FusedTensors<T> t, fused::FusedArgs<T> a, int lanes,
               int instances) {
  using Body = fused::Body<Model>;
  if (lanes < 1 || instances < 1 || a.B < 1 ||
      a.n_tc + a.n_t > Body::ALLMAX)
    return 1;
  const fused::Layout L = Body::make_layout(
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
      Body::solve_instance(t, a, st, L,
                           smem.data() + n_statics + (size_t)slot * L.total,
                           b, ex);
    }
  }
  return 0;
}

template <typename Model>
int workspace_reals(int K, int N, int S, int n_u, int n_all, int n_ls,
                    int lanes) {
  return fused::Body<Model>::make_layout(K, N, S, n_u, n_all, n_ls, lanes)
      .total;
}

// Kernel 2's column body for SP = sp steps, over every column.
template <typename Model, int SP = 1>
int segment_jac_host(const double* params, const double* xs,
                     const double* us, double* xe, double* jx, double* ju,
                     int R, int sp, double h, double h_half, double h_sixth,
                     int angle_mask) {
  if constexpr (SP > segjac::SPMAX) {
    return 1;
  } else {
    if (sp != SP)
      return segment_jac_host<Model, SP + 1>(params, xs, us, xe, jx, ju, R,
                                             sp, h, h_half, h_sixth,
                                             angle_mask);
    for (int r = 0; r < R; ++r)
      segjac::segment_jac_column<SP, Model>(params, xs, us, xe, jx, ju, R, h,
                                            h_half, h_sixth, angle_mask, r);
    return 0;
  }
}

// One model's host bodies.
struct Bodies {
  int (*solve)(fused::FusedTensors<double>, fused::FusedArgs<double>, int,
               int);
  int (*workspace_reals)(int, int, int, int, int, int, int);
  int (*segment_jac)(const double*, const double*, const double*, double*,
                     double*, double*, int, int, double, double, double, int);
};

template <typename Model>
constexpr Bodies bodies_of() {
  return {&solve_host<Model, double>, &workspace_reals<Model>,
          &segment_jac_host<Model>};
}

// Each defined by the translation unit built with -DHOST_INSTANCE=<it>.
extern const Bodies single_bodies, double_bodies, triple_bodies;

#ifdef HOST_INSTANCE
// -DHOST_INSTANCE=<table> -DHOST_MODEL=<model struct>: this unit's bodies.
const Bodies HOST_INSTANCE = bodies_of<HOST_MODEL>();
#endif

}  // namespace host_check
