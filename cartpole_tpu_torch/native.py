"""ctypes binding of the native C++ parity oracle, ``native/oracle.cc``
(the port's own counterpart of ``cartpole_tpu/native.py``).

A host implementation of the dynamics, RK4, the 1 kHz plant and the
closed-loop MPC (its KKT solve factors the full system as the ``lu`` path
does) that the port is tested against. Built on first use with ``g++ -O2``
into ``cartpole_tpu_torch/_build/liboracle-<hash of the source>.so`` and
reused while the source is unchanged. Every function takes and returns
numpy arrays; the dynamics params may hold Python numbers or 0-d tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

from .mpc.config import OptimizationParams
from .ops._build import BUILD_DIR

__all__ = [
    "is_available",
    "oracle_dynamics",
    "oracle_rk4",
    "oracle_sim_step",
    "oracle_double_dynamics",
    "oracle_double_sim_step",
    "oracle_closed_loop",
]

SRC = pathlib.Path(__file__).resolve().parent.parent / "native" / "oracle.cc"

_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None


def _build() -> str:
    """The library for the source as it is, compiled if it is not there.
    The compiler writes to a temporary name that is then renamed, so
    processes that build at once never load a half-written file."""
    src_hash = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"liboracle-{src_hash}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                        "-o", tmp, str(SRC)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _get_lib() -> ctypes.CDLL:
    global _lib, _lib_error
    if _lib is not None:
        return _lib
    if _lib_error is not None:
        raise RuntimeError(f"native oracle unavailable: {_lib_error}")
    try:
        lib = ctypes.CDLL(_build())
    except (subprocess.CalledProcessError, OSError) as e:
        _lib_error = getattr(e, "stderr", None) or str(e)
        raise RuntimeError(f"native oracle build failed: {_lib_error}") from e

    dp = ctypes.POINTER(ctypes.c_double)
    d, i = ctypes.c_double, ctypes.c_int
    signatures = {
        "co_single_dynamics": ([dp, dp, d, dp, dp, dp], None),
        "co_single_rk4": ([dp, dp, d, d, dp], None),
        "co_single_sim_step": ([dp, dp, d, d, dp, dp, dp], None),
        "co_single_closed_loop": ([dp, dp, d, dp, i, dp, dp], ctypes.c_int),
        "co_double_dynamics": ([dp, dp, d, dp, dp, dp, dp], None),
        "co_double_sim_step": ([dp, dp, d, d, dp], None),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    _lib = lib
    return lib


def is_available() -> bool:
    """True if the toolchain is present and the oracle builds."""
    try:
        _get_lib()
        return True
    except RuntimeError:
        return False


def _as_c(a):
    """A contiguous f64 copy of ``a`` and its pointer (the caller keeps the
    array alive while the pointer is used)."""
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.float64))
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _opt_as_c(a):
    """``_as_c`` of an optional force, ``(None, None)`` when absent."""
    return (None, None) if a is None else _as_c(a)


def _params_vec(params) -> np.ndarray:
    return np.array([float(v) for v in params.as_dict().values()],
                    dtype=np.float64)


def _opt_vec(p: OptimizationParams) -> np.ndarray:
    """The oracle's 17 optimization parameters, in its order."""
    return np.array(
        [
            p.control_dt, p.window_length, p.state_spacing, p.max_iterations,
            p.relative_exit_tol, p.absolute_first_derivative_tol,
            p.equality_penalty_initial, p.u_guess_sinusoid_amplitude,
            p.u_cost_weight, p.u_derivative_cost_weight,
            p.b_x_final_cost_weight, p.th_final_cost_weight,
            p.b_x_dot_final_cost_weight, p.th_dot_final_cost_weight,
            p.b_x_limit, p.u_limit, p.max_line_search_iterations,
        ],
        dtype=np.float64,
    )


def _out(n):
    arr = np.zeros(n)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def oracle_dynamics(params, x, u, f_base=None, f_mass=None) -> np.ndarray:
    """Native ``x_dot = f(x, u)`` for the single cart-pole."""
    lib = _get_lib()
    p, x, fb, fm = (_as_c(_params_vec(params)), _as_c(x), _opt_as_c(f_base),
                    _opt_as_c(f_mass))
    out, op = _out(4)
    lib.co_single_dynamics(p[1], x[1], float(u), fb[1], fm[1], op)
    return out


def oracle_rk4(params, x, u, h) -> np.ndarray:
    """Native single RK4 step (no angle wrap)."""
    lib = _get_lib()
    p, x = _as_c(_params_vec(params)), _as_c(x)
    out, op = _out(4)
    lib.co_single_rk4(p[1], x[1], float(u), float(h), op)
    return out


def oracle_sim_step(params, x, dt, u, f_base=None, f_mass=None) -> np.ndarray:
    """Native 1 kHz-substep plant integration."""
    lib = _get_lib()
    p, x, fb, fm = (_as_c(_params_vec(params)), _as_c(x), _opt_as_c(f_base),
                    _opt_as_c(f_mass))
    out, op = _out(4)
    lib.co_single_sim_step(p[1], x[1], float(dt), float(u), fb[1], fm[1], op)
    return out


def oracle_double_dynamics(params, x, u, f_base=None, f_mass=None,
                           f_mass_2=None) -> np.ndarray:
    """Native ``x_dot = f(x, u)`` for the double cart-pole."""
    lib = _get_lib()
    p, x = _as_c(_params_vec(params)), _as_c(x)
    fb, f1, f2 = _opt_as_c(f_base), _opt_as_c(f_mass), _opt_as_c(f_mass_2)
    out, op = _out(6)
    lib.co_double_dynamics(p[1], x[1], float(u), fb[1], f1[1], f2[1], op)
    return out


def oracle_double_sim_step(params, x, dt, u) -> np.ndarray:
    """Native 1 kHz-substep plant integration for the double cart-pole."""
    lib = _get_lib()
    p, x = _as_c(_params_vec(params)), _as_c(x)
    out, op = _out(6)
    lib.co_double_sim_step(p[1], x[1], float(dt), float(u), op)
    return out


def oracle_closed_loop(params, opt_params: OptimizationParams, x0,
                       num_steps: int, set_point: float = 0.0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Native receding-horizon run of the single cart-pole. Returns ``(u
    (steps,), states (steps, 4))``, each state recorded before its tick."""
    lib = _get_lib()
    p, o, x = (_as_c(_params_vec(params)), _as_c(_opt_vec(opt_params)),
               _as_c(x0))
    u_out, up = _out(num_steps)
    states_out = np.zeros((num_steps, 4))
    rc = lib.co_single_closed_loop(
        p[1], o[1], float(set_point), x[1], int(num_steps), up,
        states_out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise RuntimeError(f"native closed loop failed with code {rc}")
    return u_out, states_out
