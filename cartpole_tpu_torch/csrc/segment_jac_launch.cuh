// Kernel 2's CUDA kernel and launchers, templated on the model and the real
// type. ops/_build.py compiles this header once per model and real type,
// each a translation unit of its own defining one launcher table
// (SEGJAC_INSTANCE, below; the 16 step counts of the double's and triple's
// spilling bodies take ptxas a minute or more per model), so nvcc builds
// them in parallel, and segment_jac.cu dispatches the C interface on a model
// id.
//
// One thread per column, blocks of up to MAX_THREADS threads, so every
// (., R) row is read and written by neighbouring threads at neighbouring
// addresses and the accesses coalesce. The body is templated on the steps
// per segment (1..SPMAX, dispatched by kernel_for), so the control
// Jacobians stay in registers instead of a stack frame.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "segment_jac.cuh"

namespace segjac {

constexpr int MAX_THREADS = 128;

template <int SP, typename Model, typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    segment_jac_kernel(const T* __restrict__ params, const T* __restrict__ xs,
                       const T* __restrict__ us, T* __restrict__ xe,
                       T* __restrict__ jx, T* __restrict__ ju, int R, T h,
                       T h_half, T h_sixth, int angle_mask) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < R)
    segment_jac_column<SP, Model>(params, xs, us, xe, jx, ju, R, h, h_half,
                                  h_sixth, angle_mask, r);
}

// segment_jac_kernel<sp, Model, T>, or nullptr where sp is out of 1..SPMAX.
template <typename Model, typename T, int SP = 1>
const void* kernel_for(int sp) {
  if constexpr (SP > SPMAX) {
    return nullptr;
  } else {
    return sp == SP
               ? reinterpret_cast<const void*>(&segment_jac_kernel<SP, Model, T>)
               : kernel_for<Model, T, SP + 1>(sp);
  }
}

// Launch on `stream`; return the launch's CUDA error as an int (0 =
// launched).
template <typename Model, typename T>
int launch(const T* params, const T* xs, const T* us, T* xe, T* jx, T* ju,
           int R, int sp, T h, T h_half, T h_sixth, int angle_mask,
           int threads, void* stream) {
  const void* kernel = kernel_for<Model, T>(sp);
  if (threads < 1 || threads > MAX_THREADS || R < 1 || !kernel)
    return (int)cudaErrorInvalidValue;
  const int blocks = (R + threads - 1) / threads;
  void* args[] = {&params, &xs, &us, &xe, &jx, &ju, &R,
                  &h, &h_half, &h_sixth, &angle_mask};
  return (int)cudaLaunchKernel(kernel, dim3(blocks), dim3(threads), args, 0,
                               static_cast<cudaStream_t>(stream));
}

// What a launch of the f32 kernel for `sp` steps in blocks of `threads`
// gets on the current device: out = {registers per thread, local bytes per
// thread, resident blocks per SM}. Returns a CUDA error as an int.
template <typename Model>
int occupancy_f32(int sp, int threads, int* out) {
  const void* kernel = kernel_for<Model, float>(sp);
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

// One model's launcher in one real type, and in f32 its occupancy query.
template <typename T>
struct Launchers {
  int (*launch)(const T*, const T*, const T*, T*, T*, T*, int, int, T, T, T,
                int, int, void*);
  int (*occupancy)(int, int, int*);  // nullptr in f64
};

template <typename Model, typename T>
constexpr Launchers<T> launchers_of() {
  if constexpr (std::is_same_v<T, float>)
    return {&launch<Model, T>, &occupancy_f32<Model>};
  else
    return {&launch<Model, T>, nullptr};
}

// Each defined by the translation unit built with -DSEGJAC_INSTANCE=<it>.
extern const Launchers<float> single_f32, double_f32, triple_f32;
extern const Launchers<double> single_f64, double_f64, triple_f64;

#ifdef SEGJAC_INSTANCE
// -DSEGJAC_INSTANCE=<table> -DSEGJAC_MODEL=<model struct>
// -DSEGJAC_REAL=<float|double>: this unit's launcher table.
const Launchers<SEGJAC_REAL> SEGJAC_INSTANCE =
    launchers_of<SEGJAC_MODEL, SEGJAC_REAL>();
#endif

}  // namespace segjac
