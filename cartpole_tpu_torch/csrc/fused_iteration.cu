// C interface of kernel 1, the fused GN solve (sm_90a).
//
// Replaces cartpole_tpu/ops/fused.py::make_fused_iteration. The kernel and
// its launchers are fused_iteration_launch.cuh's, built once per model, and
// these entry points dispatch on the model id (segment_jac.cuh).
// Built by ops/_build.py with nvcc (no PyTorch headers) and called through
// ctypes.
#include "fused_iteration_launch.cuh"

namespace {

const fused::Launchers* launchers(int model) {
  switch (model) {
    case segjac::SingleCartPole::ID: return &fused::single_launchers;
    case segjac::DoubleCartPole::ID: return &fused::double_launchers;
    case segjac::TripleCartPole::ID: return &fused::triple_launchers;
    default: return nullptr;
  }
}

}  // namespace

// Launch model `model`'s kernel on `stream` with `instances` instances per
// block; `lanes` must be the compiled FUSED_LANES. Returns a cudaError_t as
// an int (0 = launched).
extern "C" int fused_iteration_launch_f32(int model,
                                          fused::FusedTensors<float> t,
                                          fused::FusedArgs<float> a,
                                          int lanes, int instances,
                                          void* stream) {
  const fused::Launchers* l = launchers(model);
  if (!l) return (int)cudaErrorInvalidValue;
  return l->launch_f32(t, a, lanes, instances, stream);
}

// What a launch of model `model`'s kernel with `instances` instances per
// block gets on this card: out = {lanes, workspace reals per instance,
// shared bytes per block, resident blocks per SM, registers per thread,
// local bytes per thread}.
extern "C" int fused_iteration_occupancy_f32(int model,
                                             fused::FusedArgs<float> a,
                                             int instances, int* out) {
  const fused::Launchers* l = launchers(model);
  if (!l) return (int)cudaErrorInvalidValue;
  return l->occupancy_f32(a, instances, out);
}

#ifdef FUSED_PROFILE
// Point model `model`'s stage counters at `buf` (2 * PROFILE_NONE uint64,
// zeroed by the caller), or switch them off with a null pointer.
extern "C" int fused_iteration_profile(int model, void* buf) {
  const fused::Launchers* l = launchers(model);
  if (!l) return (int)cudaErrorInvalidValue;
  return l->profile(buf);
}
#endif
