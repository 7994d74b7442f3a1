// Kernel 1's CUDA kernel and launchers, templated on the model.
// ops/_build.py compiles this header once per model, each a translation
// unit of its own defining one launcher table (FUSED_INSTANCE, below), so
// nvcc builds the models in parallel, and fused_iteration.cu dispatches the
// C interface on a model id.
//
// A block holds W instances of FUSED_LANES lanes each (fused_iteration.cuh
// holds the stages and the design note): it stages the statics in dynamic
// shared memory, then every instance runs all n_iter iterations out of its
// own shared workspace, its lanes synchronised by __syncwarp between
// stages. A ragged last block masks whole instances.
#pragma once

#include <cuda_runtime.h>

#include "fused_iteration.cuh"

// Lanes per instance: 16 (half a warp) or 32 (a warp), and 8 for a layout
// sweep; ops/fused.py mirrors it.
#ifndef FUSED_LANES
#define FUSED_LANES 16
#endif
static_assert(FUSED_LANES == 8 || FUSED_LANES == 16 || FUSED_LANES == 32,
              "lanes per instance must divide a warp");

namespace fused {

constexpr int LANES = FUSED_LANES;

#ifdef FUSED_PROFILE
// Built with -DFUSED_PROFILE: per profile index of a step (see
// solve_instance's ex.mark), the cycles lane 0 of each instance spent in
// the step and its barrier, and the calls. One per translation unit, so one
// per model.
static __device__ unsigned long long* g_stage_cycles;
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
    if (lane == 0 && g_stage_cycles && stage < PROFILE_NONE) {
      atomicAdd(&g_stage_cycles[2 * stage],
                (unsigned long long)(clock64() - t0));
      atomicAdd(&g_stage_cycles[2 * stage + 1], 1ull);
    }
    ++stage;
#endif
  }
};

template <typename Model>
Layout layout_of(const FusedArgs<float>& a) {
  return Body<Model>::make_layout(a.K, a.N, a.S, a.n_u, a.n_tc + a.n_t,
                                  a.n_ls, LANES);
}

inline size_t smem_bytes(const FusedArgs<float>& a, const Layout& L,
                         int instances) {
  return sizeof(float) *
         ((size_t)statics_reals(a.K) + (size_t)instances * L.total);
}

template <typename Model, typename T>
__global__ void fused_iteration_kernel(FusedTensors<T> t, FusedArgs<T> a,
                                       Layout L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Statics<T> st = stage_statics(t, a, sm, threadIdx.x, blockDim.x);
  __syncthreads();
  const int slot = threadIdx.x / LANES;
  const int b = blockIdx.x * (blockDim.x / LANES) + slot;
  if (b >= a.B) return;
  const int lane = threadIdx.x % LANES;
  const unsigned mask =
      LANES == 32 ? 0xffffffffu
                  : ((1u << LANES) - 1u) << (threadIdx.x % 32 - lane);
  WarpExec ex{lane, mask, PROFILE_NONE};
  T* w = sm + statics_reals(a.K) + (size_t)slot * L.total;
  Body<Model>::solve_instance(t, a, st, L, w, b, ex);
}

// Set the kernel's dynamic shared memory limit when a block needs more than
// the default 48 KB.
template <typename Model>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fused_iteration_kernel<Model, float>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Launch on `stream` with `instances` instances per block; `lanes` must be
// the compiled FUSED_LANES. Returns a cudaError_t as an int (0 = launched).
template <typename Model>
int launch_f32(FusedTensors<float> t, FusedArgs<float> a, int lanes,
               int instances, void* stream) {
  if (lanes != LANES || instances < 1 || instances * LANES > 1024 ||
      a.B < 1 || a.n_tc + a.n_t > Body<Model>::ALLMAX)
    return (int)cudaErrorInvalidValue;
  const Layout L = layout_of<Model>(a);
  const size_t smem = smem_bytes(a, L, instances);
  const cudaError_t e = allow_smem<Model>(smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (a.B + instances - 1) / instances;
  fused_iteration_kernel<Model, float><<<blocks, instances * LANES, smem,
                                         static_cast<cudaStream_t>(stream)>>>(
      t, a, L);
  return (int)cudaGetLastError();
}

// What a launch with `instances` instances per block gets on this card:
// out = {lanes, workspace reals per instance, shared bytes per block,
// resident blocks per SM, registers per thread, local bytes per thread}.
template <typename Model>
int occupancy_f32(FusedArgs<float> a, int instances, int* out) {
  const Layout L = layout_of<Model>(a);
  const size_t smem = smem_bytes(a, L, instances);
  cudaError_t e = allow_smem<Model>(smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fused_iteration_kernel<Model, float>, instances * LANES, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fused_iteration_kernel<Model, float>);
  if (e != cudaSuccess) return (int)e;
  out[0] = LANES;
  out[1] = L.total;
  out[2] = (int)smem;
  out[3] = blocks;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  return 0;
}

// Point this translation unit's (this model's) stage counters at `buf`
// (2 * PROFILE_NONE uint64, zeroed by the caller), or switch them off with
// a null pointer; cudaErrorInvalidValue in a build without -DFUSED_PROFILE.
static inline int set_profile(void* buf) {
#ifdef FUSED_PROFILE
  return (int)cudaMemcpyToSymbol(g_stage_cycles, &buf, sizeof(buf));
#else
  (void)buf;
  return (int)cudaErrorInvalidValue;
#endif
}

// One model's launchers.
struct Launchers {
  int (*launch_f32)(FusedTensors<float>, FusedArgs<float>, int, int, void*);
  int (*occupancy_f32)(FusedArgs<float>, int, int*);
  int (*profile)(void*);
};

template <typename Model>
constexpr Launchers launchers_of() {
  return {&launch_f32<Model>, &occupancy_f32<Model>, &set_profile};
}

// Each defined by the translation unit built with -DFUSED_INSTANCE=<it>.
extern const Launchers single_launchers, double_launchers, triple_launchers;

#ifdef FUSED_INSTANCE
// -DFUSED_INSTANCE=<table> -DFUSED_MODEL=<model struct>: this unit's
// launcher table.
const Launchers FUSED_INSTANCE = launchers_of<FUSED_MODEL>();
#endif

}  // namespace fused
