// C interface of kernel 2, the segment rollout with Jacobians (sm_90a).
//
// Replaces cartpole_tpu/ops/pallas_kernels.py::segment_jac_batch_last (the
// gridless Pallas kernel of _make_kernel, chunked by PALLAS_CHUNK to bound
// TPU VMEM). Here one launch covers all R columns, one thread per column
// (segment_jac_launch.cuh, built once per model and real type), and these
// entry points dispatch on the model id (segment_jac.cuh;
// cartpole_kernel_model names each id for the check at load).
//
// What bounds it on an H100, for the single model at R = 32768: per column
// it reads 18 reals and writes 40 (232 bytes in f32: ~7.6 MB, ~2.3 us at
// 3.35 TB/s) and does ~8.6k f32 operations (4 dynamics-Jacobian evaluations
// with sin, cos, tanh and sqrt, and three 4x4 chain-rule products per RK4
// step; ~0.28 GFLOP, ~4.2 us at 67 TFLOP/s). What holds it at about five
// times that is one column's dependent chain: at R = 32768 the grid is
// 1,024 warps, all resident at once, so a launch lasts about one thread's
// chain. A team of lanes per column was measured slower (PERF.md, kernel
// 2): the stage evaluations are a chain through each stage's x_dot, and
// splitting them over lanes repeats the x_dot's work or hands it through
// shared memory. The double and triple models run the same body; their
// SD x SD Jacobians grow the per-thread state with SD^2 (PERF.md has their
// registers, spills and times). Built by ops/_build.py with nvcc (no
// PyTorch headers), called via ctypes.
#include "segment_jac_launch.cuh"

namespace {

const segjac::Launchers<float>* launchers_f32(int model) {
  switch (model) {
    case segjac::SingleCartPole::ID: return &segjac::single_f32;
    case segjac::DoubleCartPole::ID: return &segjac::double_f32;
    case segjac::TripleCartPole::ID: return &segjac::triple_f32;
    default: return nullptr;
  }
}

const segjac::Launchers<double>* launchers_f64(int model) {
  switch (model) {
    case segjac::SingleCartPole::ID: return &segjac::single_f64;
    case segjac::DoubleCartPole::ID: return &segjac::double_f64;
    case segjac::TripleCartPole::ID: return &segjac::triple_f64;
    default: return nullptr;
  }
}

}  // namespace

// The name of model id `model` (nullptr past the last). ops/_build.py
// checks that the ids name the models of its KERNEL_MODELS, in order.
extern "C" const char* cartpole_kernel_model(int model) {
  return segjac::model_name(model);
}

// Launch model `model`'s kernel on `stream`; return the launch's CUDA error
// as an int (0 = launched).
extern "C" int segment_jac_launch_f32(int model, const float* params,
                                      const float* xs, const float* us,
                                      float* xe, float* jx, float* ju, int R,
                                      int sp, float h, float h_half,
                                      float h_sixth, int angle_mask,
                                      int threads, void* stream) {
  const segjac::Launchers<float>* l = launchers_f32(model);
  if (!l) return (int)cudaErrorInvalidValue;
  return l->launch(params, xs, us, xe, jx, ju, R, sp, h, h_half, h_sixth,
                   angle_mask, threads, stream);
}

extern "C" int segment_jac_launch_f64(int model, const double* params,
                                      const double* xs, const double* us,
                                      double* xe, double* jx, double* ju,
                                      int R, int sp, double h, double h_half,
                                      double h_sixth, int angle_mask,
                                      int threads, void* stream) {
  const segjac::Launchers<double>* l = launchers_f64(model);
  if (!l) return (int)cudaErrorInvalidValue;
  return l->launch(params, xs, us, xe, jx, ju, R, sp, h, h_half, h_sixth,
                   angle_mask, threads, stream);
}

// What a launch of model `model`'s f32 kernel for `sp` steps in blocks of
// `threads` gets on the current device: out = {registers per thread, local
// bytes per thread, resident blocks per SM}. Returns a CUDA error as an int.
extern "C" int segment_jac_occupancy_f32(int model, int sp, int threads,
                                         int* out) {
  const segjac::Launchers<float>* l = launchers_f32(model);
  if (!l) return (int)cudaErrorInvalidValue;
  return l->occupancy(sp, threads, out);
}
