// CUDA kernel and C launcher of kernel 1, the fused GN solve (sm_90a).
//
// Replaces cartpole_tpu/ops/fused.py::make_fused_iteration. A block holds
// W instances of FUSED_LANES lanes each (fused_iteration.cuh holds the
// stages and the design note): it stages the statics in dynamic shared
// memory, then every instance runs all n_iter iterations out of its own
// shared workspace, its lanes synchronised by __syncwarp between stages. A
// ragged last block masks whole instances. Built by ops/_build.py with nvcc
// (no PyTorch headers) and called through ctypes.
#include <cuda_runtime.h>

#include "fused_iteration.cuh"

// Lanes per instance: 16 (half a warp) or 32 (a warp), and 8 for a layout
// sweep; ops/fused.py mirrors it.
#ifndef FUSED_LANES
#define FUSED_LANES 16
#endif
static_assert(FUSED_LANES == 8 || FUSED_LANES == 16 || FUSED_LANES == 32,
              "lanes per instance must divide a warp");

namespace {

constexpr int LANES = FUSED_LANES;

#ifdef FUSED_PROFILE
// Built with -DFUSED_PROFILE: per profile index of a step (see
// solve_instance's ex.mark), the cycles lane 0 of each instance spent in
// the step and its barrier, and the calls.
__device__ unsigned long long* g_stage_cycles;
#endif

// Runs a stage on this thread's lane, then waits for the instance's lanes.
struct WarpExec {
  int lane;
  unsigned mask;
  int stage;  // profile index of the next step
  __host__ __device__ void mark(int index) { stage = index; }
  template <typename F>
  __host__ __device__ void step(F&& f) {
#if defined(__CUDA_ARCH__) && defined(FUSED_PROFILE)
    const long long t0 = clock64();
#endif
    f(lane, LANES);
#ifdef __CUDA_ARCH__
    __syncwarp(mask);
#endif
#if defined(__CUDA_ARCH__) && defined(FUSED_PROFILE)
    if (lane == 0 && g_stage_cycles && stage < fused::PROFILE_NONE) {
      atomicAdd(&g_stage_cycles[2 * stage],
                (unsigned long long)(clock64() - t0));
      atomicAdd(&g_stage_cycles[2 * stage + 1], 1ull);
    }
    ++stage;
#endif
  }
};

fused::Layout layout_of(const fused::FusedArgs<float>& a) {
  return fused::make_layout(a.K, a.N, a.S, a.n_u, a.n_tc + a.n_t, a.n_ls,
                            LANES);
}

size_t smem_bytes(const fused::FusedArgs<float>& a, const fused::Layout& L,
                  int instances) {
  return sizeof(float) * ((size_t)fused::statics_reals(a.K) +
                          (size_t)instances * L.total);
}

template <typename T>
__global__ void fused_iteration_kernel(fused::FusedTensors<T> t,
                                       fused::FusedArgs<T> a,
                                       fused::Layout L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const fused::Statics<T> st =
      fused::stage_statics(t, a, sm, threadIdx.x, blockDim.x);
  __syncthreads();
  const int slot = threadIdx.x / LANES;
  const int b = blockIdx.x * (blockDim.x / LANES) + slot;
  if (b >= a.B) return;
  const int lane = threadIdx.x % LANES;
  const unsigned mask =
      LANES == 32 ? 0xffffffffu
                  : ((1u << LANES) - 1u) << (threadIdx.x % 32 - lane);
  WarpExec ex{lane, mask, fused::PROFILE_NONE};
  T* w = sm + fused::statics_reals(a.K) + (size_t)slot * L.total;
  fused::solve_instance(t, a, st, L, w, b, ex);
}

// Set the kernel's dynamic shared memory limit when a block needs more than
// the default 48 KB.
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fused_iteration_kernel<float>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// Launch on `stream` with `instances` instances per block; `lanes` must be
// the compiled FUSED_LANES. Returns a cudaError_t as an int (0 = launched).
extern "C" int fused_iteration_launch_f32(fused::FusedTensors<float> t,
                                          fused::FusedArgs<float> a,
                                          int lanes, int instances,
                                          void* stream) {
  if (lanes != LANES || instances < 1 || instances * LANES > 1024 ||
      a.B < 1 || a.n_tc + a.n_t > fused::ALLMAX)
    return (int)cudaErrorInvalidValue;
  const fused::Layout L = layout_of(a);
  const size_t smem = smem_bytes(a, L, instances);
  const cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (a.B + instances - 1) / instances;
  fused_iteration_kernel<float><<<blocks, instances * LANES, smem,
                                  static_cast<cudaStream_t>(stream)>>>(t, a,
                                                                       L);
  return (int)cudaGetLastError();
}

// What a launch with `instances` instances per block gets on this card:
// out = {lanes, workspace reals per instance, shared bytes per block,
// resident blocks per SM, registers per thread, local bytes per thread}.
extern "C" int fused_iteration_occupancy_f32(fused::FusedArgs<float> a,
                                             int instances, int* out) {
  const fused::Layout L = layout_of(a);
  const size_t smem = smem_bytes(a, L, instances);
  cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fused_iteration_kernel<float>, instances * LANES, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fused_iteration_kernel<float>);
  if (e != cudaSuccess) return (int)e;
  out[0] = LANES;
  out[1] = L.total;
  out[2] = (int)smem;
  out[3] = blocks;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  return 0;
}

#ifdef FUSED_PROFILE
// Point the stage counters at `buf` (2 * PROFILE_NONE uint64, zeroed by
// the caller), or switch them off with a null pointer.
extern "C" int fused_iteration_profile(void* buf) {
  return (int)cudaMemcpyToSymbol(g_stage_cycles, &buf, sizeof(buf));
}
#endif
