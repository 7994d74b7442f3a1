"""The Armijo decision of iteration 2 of ``awkward_dim_83``, in both packages.

``tests/test_torch_solver.py::test_solve_matches_reference[awkward_dim_83-*]``
solves a linear least-squares problem of 83 unknowns (90 residuals, seeded
data) with both solvers. Iteration 1's full Gauss-Newton step lands on the
optimum, so iteration 2's step is rounding noise and its Armijo test

    phi_trials[0] <= phi0 + c1 * alpha * dphi + slack,
    slack = merit_slack_ulps * eps * |phi0|,

compares numbers that differ by a few ulps of ``phi0``. This probe prints,
for iteration 2 of each package, ``phi0``, ``phi_trials[0]``, ``dphi``, the
right-hand side, and the two sides' gap in ulps of ``phi0``, as each solver
computed them: the values are tapped out of the solves themselves (the JAX
package's ``_merit`` and ``jnp.vdot`` through ``jax.debug.callback``, the
port's ``_merit``, trial ``vmap`` and ``torch.dot`` by wrapping them in this
process only). With no argument it runs itself under 1, 6 and the default
number of BLAS threads (``OMP_NUM_THREADS`` / ``MKL_NUM_THREADS``), one
process each; ``--child`` runs one.

Run: python scripts/probe_awkward_dim_83.py   (CPU, ~30 s)
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child():
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch

    from cartpole_tpu.ops import solver as ref_solver
    import cartpole_tpu_torch as pt
    from cartpole_tpu_torch.ops import solver as port_solver

    # tests/test_torch_solver.py's data, drawn in its order.
    rng = np.random.default_rng(0)
    rng.normal(size=(6, 3)), rng.normal(size=(6,))
    A, b = rng.normal(size=(90, 83)), rng.normal(size=(90,))
    eps = float(np.finfo(np.float64).eps)
    out = {"threads": os.environ.get("OMP_NUM_THREADS", "default"),
           "torch_threads": torch.get_num_threads()}

    # ---- the JAX package: tap _merit outside vmap (phi0), the trials'
    # jax.vmap and the first jnp.vdot of an iteration (jr_dz) at run time.
    from jax._src.interpreters.batching import BatchTracer

    taps = {"phi0": [], "trials": [], "vdot": []}
    real_merit, real_vdot, real_vmap = ref_solver._merit, jnp.vdot, jax.vmap

    def tap(key, v):
        if not isinstance(v, BatchTracer):
            jax.debug.callback(lambda x: taps[key].append(np.asarray(x)), v,
                               ordered=True)

    def merit(cost, c_l1, mu):
        phi = real_merit(cost, c_l1, mu)
        tap("phi0", phi)
        return phi

    def vdot(a, b_):
        v = real_vdot(a, b_)
        tap("vdot", v)
        return v

    def vmap(f, *a, **k):
        def run(*args):
            zs, phis = real_vmap(f, *a, **k)(*args)
            tap("trials", phis)
            return zs, phis
        return run

    ref_solver._merit, jnp.vdot, jax.vmap = merit, vdot, vmap
    try:
        Aj, bj = jnp.asarray(A), jnp.asarray(b)
        res = lambda z: Aj @ z - bj  # noqa: E731
        prob = ref_solver.NLSProblem(
            linearize=lambda z: (res(z), jax.jacfwd(res)(z), None, None),
            evaluate=lambda z: (res(z), None),
            retract=lambda z, dz, alpha: z + alpha * dz)
        _, o = ref_solver.solve_nls(prob, jnp.zeros(83), ref_solver.NLSConfig(
            max_iterations=5, kkt_method="lu"))
        jax.block_until_ready(o)
    finally:
        ref_solver._merit, jnp.vdot = real_merit, real_vdot
        jax.vmap = real_vmap
    # Per iteration, vdot gives jr_dz, then the cost.
    out["jax"] = dict(phi0=float(taps["phi0"][1]),
                      phi_trial0=float(taps["trials"][1][0]),
                      dphi=float(taps["vdot"][2]),
                      iter_step_size=np.asarray(o.iter_step_size).tolist(),
                      iter_cost_2=float(o.iter_cost[1]))

    # ---- the port: tap _merit outside vmap (phi0), the trials' vmap, and
    # the first torch.dot of an iteration (jr_dz).
    ptaps = {"phi0": [], "trials": [], "dot": []}
    real_pmerit, real_pvmap = port_solver._merit, port_solver.vmap
    real_dot = torch.dot

    def pmerit(cost, c_l1, mu):
        phi = real_pmerit(cost, c_l1, mu)
        if not torch._C._functorch.is_batchedtensor(phi):
            ptaps["phi0"].append(float(phi))
        return phi

    def pvmap(f):
        def run(*args):
            zs, phis = real_pvmap(f)(*args)
            ptaps["trials"].append(phis.clone())
            return zs, phis
        return run

    def pdot(a, b_):
        v = real_dot(a, b_)
        if not torch._C._functorch.is_batchedtensor(v):
            ptaps["dot"].append(float(v))
        return v

    port_solver._merit, port_solver.vmap, torch.dot = pmerit, pvmap, pdot
    try:
        At, bt = torch.as_tensor(A), torch.as_tensor(b)
        res = lambda z: At @ z - bt  # noqa: E731
        prob = pt.NLSProblem(
            linearize=lambda z: (res(z), torch.func.jacfwd(res)(z), None,
                                 None),
            evaluate=lambda z: (res(z), None),
            retract=lambda z, dz, alpha: z + alpha * dz)
        _, po = pt.solve_nls(prob, torch.zeros(83, dtype=torch.float64),
                             pt.NLSConfig(max_iterations=5, kkt_method="lu"))
    finally:
        port_solver._merit, port_solver.vmap = real_pmerit, real_pvmap
        torch.dot = real_dot
    # Per iteration, torch.dot gives jr_dz, then the cost.
    out["port"] = dict(phi0=ptaps["phi0"][1],
                       phi_trial0=float(ptaps["trials"][1][0]),
                       dphi=ptaps["dot"][2],
                       iter_step_size=po.iter_step_size.tolist(),
                       iter_cost_2=float(po.iter_cost[1]))

    cfg = port_solver.NLSConfig()
    for side in ("jax", "port"):
        s = out[side]
        slack = cfg.merit_slack_ulps * eps * abs(s["phi0"])
        s["rhs"] = s["phi0"] + cfg.armijo_c1 * 1.0 * s["dphi"] + slack
        s["accepts"] = s["phi_trial0"] <= s["rhs"]
        s["gap_ulps_of_phi0"] = (s["phi_trial0"] - s["rhs"]) / (
            eps * abs(s["phi0"]))
    out["phi0_gap_ulps"] = (out["port"]["phi0"] - out["jax"]["phi0"]) / (
        eps * abs(out["jax"]["phi0"]))
    out["lstsq_cost"] = float(0.5 * np.sum(
        (A @ np.linalg.lstsq(A, b, rcond=None)[0] - b) ** 2))
    print(json.dumps(out))


def main():
    for n in ("1", "6", None):
        env = dict(os.environ)
        for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
            if n is None:
                env.pop(k, None)
            else:
                env[k] = n
        env["JAX_PLATFORMS"] = "cpu"
        proc = subprocess.run([sys.executable, __file__, "--child"], env=env,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    if "--child" in sys.argv:
        child()
    else:
        sys.exit(main())
