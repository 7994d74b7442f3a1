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
// ~9k f32 operations (4 dynamics-Jacobian evaluations with sin, cos, tanh and
// sqrt, and three 4x4 chain-rule products per RK4 step; ~0.3 GFLOP, a few us
// at 67 TFLOP/s). Either bound is about one launch. The working set (four
// 4x4 stage Jacobians and their chain products) stays in registers or
// local memory; no shared memory is needed since columns share nothing.
// Built by ops/_build.py with nvcc (no PyTorch headers), called via ctypes.
#include <cuda_runtime.h>

#include "segment_jac.cuh"

namespace {

template <typename Model, typename T>
__global__ void __launch_bounds__(128)
    segment_jac_kernel(const T* __restrict__ params, const T* __restrict__ xs,
                       const T* __restrict__ us, T* __restrict__ xe,
                       T* __restrict__ jx, T* __restrict__ ju, int R, int sp,
                       T h, T h_half, T h_sixth, int angle_mask) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < R)
    segjac::segment_jac_column<Model>(params, xs, us, xe, jx, ju, R, sp, h,
                                      h_half, h_sixth, angle_mask, r);
}

template <typename T>
int launch(const T* params, const T* xs, const T* us, T* xe, T* jx, T* ju,
           int R, int sp, T h, T h_half, T h_sixth, int angle_mask,
           int threads, void* stream) {
  if (threads < 1 || threads > 128 || R < 1 || sp < 1 || sp > segjac::SPMAX)
    return (int)cudaErrorInvalidValue;
  const int blocks = (R + threads - 1) / threads;
  segment_jac_kernel<segjac::SingleCartPole, T>
      <<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
          params, xs, us, xe, jx, ju, R, sp, h, h_half, h_sixth, angle_mask);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() as an int (0 = launched).
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
