// C interface of the host build of the kernel bodies (host_check.cuh),
// dispatched on the model id (segment_jac.cuh).
#include "host_check.cuh"

namespace {

const host_check::Bodies* bodies(int model) {
  switch (model) {
    case segjac::SingleCartPole::ID: return &host_check::single_bodies;
    case segjac::DoubleCartPole::ID: return &host_check::double_bodies;
    case segjac::TripleCartPole::ID: return &host_check::triple_bodies;
    default: return nullptr;
  }
}

}  // namespace

// The name of model id `model` (nullptr past the last), as the card's
// library gives it (segment_jac.cu).
extern "C" const char* cartpole_kernel_model(int model) {
  return segjac::model_name(model);
}

extern "C" int fused_iteration_host_f64(int model,
                                        fused::FusedTensors<double> t,
                                        fused::FusedArgs<double> a, int lanes,
                                        int instances) {
  const host_check::Bodies* m = bodies(model);
  return m ? m->solve(t, a, lanes, instances) : 1;
}

// Reals of one instance's workspace (fused::Body::make_layout) and of a
// block's statics, for the shape checks of ops/fused.py; -1 for an unknown
// model.
extern "C" int fused_workspace_reals(int model, int K, int N, int S, int n_u,
                                     int n_all, int n_ls, int lanes) {
  const host_check::Bodies* m = bodies(model);
  return m ? m->workspace_reals(K, N, S, n_u, n_all, n_ls, lanes) : -1;
}

extern "C" int fused_statics_reals(int K) { return fused::statics_reals(K); }

extern "C" int segment_jac_host_f64(int model, const double* params,
                                    const double* xs, const double* us,
                                    double* xe, double* jx, double* ju, int R,
                                    int sp, double h, double h_half,
                                    double h_sixth, int angle_mask) {
  const host_check::Bodies* m = bodies(model);
  if (!m || R < 1) return 1;
  return m->segment_jac(params, xs, us, xe, jx, ju, R, sp, h, h_half, h_sixth,
                        angle_mask);
}
