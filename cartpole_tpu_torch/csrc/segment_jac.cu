// CUDA kernel and C launchers of the segment rollout with Jacobians (sm_90a).
//
// Replaces cartpole_tpu/ops/pallas_kernels.py::segment_jac_batch_last (the
// gridless Pallas kernel of _make_kernel, chunked by PALLAS_CHUNK to bound
// TPU VMEM). Here one launch covers all R columns: one thread per column,
// blocks of 128 threads, so every (., R) row is read and written by
// neighbouring threads at neighbouring addresses and the accesses coalesce.
//
// What bounds it on an H100: per column it reads 18 reals and writes 40
// (232 bytes in f32: ~7.6 MB at R = 32768, ~2.3 us at 3.35 TB/s) and does
// ~8.6k f32 operations (4 dynamics-Jacobian evaluations with sin, cos, tanh
// and sqrt, and three 4x4 chain-rule products per RK4 step; ~0.28 GFLOP,
// ~4.2 us at 67 TFLOP/s). What holds it at about five times that is one
// column's dependent chain: at R = 32768 the grid is 1,024 warps, all
// resident at once, so a launch lasts about one thread's chain. A team of
// lanes per column was measured slower (PERF.md, kernel 2): the stage
// evaluations are a chain through each stage's x_dot, and splitting them
// over lanes repeats the x_dot's work or hands it through shared memory.
// The body is templated on the steps per segment (1..SPMAX, dispatched
// here), so the control Jacobians stay in registers instead of a stack
// frame. Built by ops/_build.py with nvcc (no PyTorch headers), called via
// ctypes.
#include <cuda_runtime.h>

#include "segment_jac.cuh"

namespace {

using Model = segjac::SingleCartPole;
constexpr int MAX_THREADS = 128;

template <int SP, typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    segment_jac_kernel(const T* __restrict__ params, const T* __restrict__ xs,
                       const T* __restrict__ us, T* __restrict__ xe,
                       T* __restrict__ jx, T* __restrict__ ju, int R, T h,
                       T h_half, T h_sixth, int angle_mask) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < R)
    segjac::segment_jac_column<SP, Model>(params, xs, us, xe, jx, ju, R, h,
                                          h_half, h_sixth, angle_mask, r);
}

// segment_jac_kernel<sp, T>, or nullptr where sp is out of 1..SPMAX.
template <typename T, int SP = 1>
const void* kernel_for(int sp) {
  if constexpr (SP > segjac::SPMAX) {
    return nullptr;
  } else {
    return sp == SP ? reinterpret_cast<const void*>(&segment_jac_kernel<SP, T>)
                    : kernel_for<T, SP + 1>(sp);
  }
}

template <typename T>
int launch(const T* params, const T* xs, const T* us, T* xe, T* jx, T* ju,
           int R, int sp, T h, T h_half, T h_sixth, int angle_mask,
           int threads, void* stream) {
  const void* kernel = kernel_for<T>(sp);
  if (threads < 1 || threads > MAX_THREADS || R < 1 || !kernel)
    return (int)cudaErrorInvalidValue;
  const int blocks = (R + threads - 1) / threads;
  void* args[] = {&params, &xs, &us, &xe, &jx, &ju, &R,
                  &h, &h_half, &h_sixth, &angle_mask};
  return (int)cudaLaunchKernel(kernel, dim3(blocks), dim3(threads), args, 0,
                               static_cast<cudaStream_t>(stream));
}

}  // namespace

// Launch on `stream`; return the launch's CUDA error as an int (0 =
// launched).
extern "C" int segment_jac_launch_f32(const float* params, const float* xs,
                                      const float* us, float* xe, float* jx,
                                      float* ju, int R, int sp, float h,
                                      float h_half, float h_sixth,
                                      int angle_mask, int threads,
                                      void* stream) {
  return launch<float>(params, xs, us, xe, jx, ju, R, sp, h, h_half, h_sixth,
                       angle_mask, threads, stream);
}

extern "C" int segment_jac_launch_f64(const double* params, const double* xs,
                                      const double* us, double* xe,
                                      double* jx, double* ju, int R, int sp,
                                      double h, double h_half, double h_sixth,
                                      int angle_mask, int threads,
                                      void* stream) {
  return launch<double>(params, xs, us, xe, jx, ju, R, sp, h, h_half,
                        h_sixth, angle_mask, threads, stream);
}

// What a launch of the f32 kernel for `sp` steps in blocks of `threads`
// gets on the current device: out = {registers per thread, local bytes per
// thread, resident blocks per SM}. Returns a CUDA error as an int.
extern "C" int segment_jac_occupancy_f32(int sp, int threads, int* out) {
  const void* kernel = kernel_for<float>(sp);
  if (!kernel || threads < 1 || threads > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, 0);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  return (int)err;
}
