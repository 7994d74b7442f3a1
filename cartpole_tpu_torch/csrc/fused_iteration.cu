// CUDA kernel and C launcher of the fused GN iteration (sm_90a).
//
// Replaces cartpole_tpu/ops/fused.py::make_fused_iteration. One thread per
// instance runs all n_iter iterations (fused_iteration.cuh holds the
// per-instance body and the design note); a block first stages the statics
// (Q, eigenvalues, u-cost Jacobian) in shared memory. Bound by latency and
// local-memory traffic, not FLOPs. Built by ops/_build.py with nvcc
// (no PyTorch headers) and called through ctypes.
#include <cuda_runtime.h>

#include "fused_iteration.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(64)
    fused_iteration_kernel(fused::FusedTensors<T> t, fused::FusedArgs<T> a) {
  extern __shared__ unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sE = sQ + a.K * a.K;
  T* sJ = sE + a.K;
  for (int i = threadIdx.x; i < a.K * a.K; i += blockDim.x) sQ[i] = t.Q[i];
  for (int i = threadIdx.x; i < a.K; i += blockDim.x) sE[i] = t.eigs[i];
  for (int i = threadIdx.x; i < a.n_u * a.K; i += blockDim.x) sJ[i] = t.Juc[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.B) fused::fused_solve_instance(t, a, sQ, sE, sJ, b);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() as an int (0 = launched).
extern "C" int fused_iteration_launch_f32(fused::FusedTensors<float> t,
                                          fused::FusedArgs<float> a,
                                          int threads, void* stream) {
  if (threads < 1 || threads > 64) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)a.K * a.K + a.K + (size_t)a.n_u * a.K);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_iteration_kernel<float>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (a.B + threads - 1) / threads;
  fused_iteration_kernel<float><<<blocks, threads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(t, a);
  return (int)cudaGetLastError();
}
