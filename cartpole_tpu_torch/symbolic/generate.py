"""Code generation: emit the torch dynamics module and the CUDA header.

Counterpart of ``cartpole_tpu/symbolic/generate.py``. For each model
version (``single``, ``double``, ``triple``) both outputs come from ONE
common-subexpression elimination of the SymPy Euler-Lagrange derivation
``derive_<version>_cartpole`` (``symbolic/lagrangian.py``), so the
plain PyTorch path and the hand-written kernels evaluate the same
expression DAG:

* ``models/_<version>_gen.py``: ``<version>_dynamics_core`` and
  ``<version>_dynamics_jac_core`` over per-coordinate tensors (rows form),
  with the structural ``0.0``/``1.0`` Jacobian entries kept as Python
  literals so the rows-form chain rule (``ops/lanes.py``) folds them;
* ``csrc/<version>_dynamics.cuh``: the same two functions as
  ``__host__ __device__`` templates on the real type ``T``. Transcendentals
  go through ``dyn_sin``/``dyn_cos``/``dyn_tanh``/``dyn_sqrt``, which pick the
  precise single- or double-precision library function for ``T`` (never the
  ``__sinf``-style intrinsics). The single header defines them and the
  ``cartpole_gen`` constants of the single model; the double and triple
  headers include it and put their constants and functions in
  ``cartpole_gen::double_pole`` and ``cartpole_gen::triple_pole``, so all
  three compile together in one translation unit.

The derivation is the port's own copy, ``symbolic/lagrangian.py``; it
imports only sympy and typing.

Usage (rewrites both outputs of one version, ``single`` by default;
``tests/test_torch_dynamics.py`` and ``tests/test_torch_codegen_multilink.py``
check that the committed ones are current)::

    python -m cartpole_tpu_torch.symbolic.generate [--version double]
"""

from __future__ import annotations

import argparse
import os
import sys

from . import lagrangian

__all__ = ["VERSIONS", "outputs", "generate_torch_module",
           "generate_cuda_header", "main"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Model version -> its derivation.
VERSIONS = {
    "single": lagrangian.derive_single_cartpole,
    "double": lagrangian.derive_double_cartpole,
    "triple": lagrangian.derive_triple_cartpole,
}


def outputs(version: str = "single") -> tuple[str, str]:
    """``(torch module, CUDA header)`` paths of one model version."""
    return (os.path.join(_PKG, "models", f"_{version}_gen.py"),
            os.path.join(_PKG, "csrc", f"{version}_dynamics.cuh"))


TORCH_OUT, CUDA_OUT = outputs("single")


def _cse(model):
    """The two CSE'd expression lists: plain dynamics, and dynamics plus
    d(qdd)/d(state, u) (the qd half of x_dot has constant selector rows)."""
    import sympy as sym

    plain = sym.cse(list(model.qdd_exprs))
    exprs = list(model.qdd_exprs)
    for e in model.qdd_exprs:
        for s_ in model.state_syms:
            exprs.append(sym.diff(e, s_))
        exprs.append(sym.diff(e, model.u_sym))
    return plain, sym.cse(exprs)


def _printers():
    import sympy as sym
    from sympy.printing.c import C99CodePrinter
    from sympy.printing.pycode import PythonCodePrinter

    def is_num(e):
        return e.is_Number

    class TorchPrinter(PythonCodePrinter):
        """Scalar expressions over torch tensors (or Python floats)."""

        def _print_Function(self, expr):
            name = type(expr).__name__
            if name in ("sin", "cos", "tanh"):
                return f"torch.{name}({self._print(expr.args[0])})"
            return super()._print_Function(expr)

        _print_sin = _print_cos = _print_tanh = _print_Function

        def _print_Relational(self, expr):
            return (f"({self._print(expr.lhs)} {expr.rel_op} "
                    f"{self._print(expr.rhs)})")

        def _print_Piecewise(self, expr):
            # Nested torch.where; an all-number piecewise (the Heaviside of
            # a Max derivative) gets its last branch as a tensor shaped like
            # the condition's left side so the result keeps its dtype.
            last = expr.args[-1].expr
            result = self._print(last)
            if all(is_num(a.expr) for a in expr.args):
                ref = self._print(expr.args[0].cond.lhs)
                result = f"torch.full_like({ref}, {float(last)!r})"
            for arg in reversed(expr.args[:-1]):
                val = (repr(float(arg.expr)) if is_num(arg.expr)
                       else self._print(arg.expr))
                result = (f"torch.where({self._print(arg.cond)}, {val}, "
                          f"{result})")
            return result

        def _print_Heaviside(self, expr):
            return self._print(expr.rewrite(sym.Piecewise))

        def _print_Max(self, expr):
            args = list(expr.args)
            nums = [a for a in args if is_num(a)]
            rest = [a for a in args if not is_num(a)]
            out = self._print(rest[0])
            for a in rest[1:]:
                out = f"torch.maximum({out}, {self._print(a)})"
            for c in nums:
                out = f"torch.clamp_min({out}, {float(c)!r})"
            return out

        def _print_Pow(self, expr, rational=False):
            if expr.exp == sym.S.Half or expr.exp == -sym.S.Half:
                # Safe sqrt (models/_single_gen.py:44 of the JAX package):
                # the clamp keeps the value wherever it is consumed and the
                # derivative finite at zero speed.
                base = self._print(expr.base)
                root = f"torch.sqrt(torch.where({base} > 0, {base}, 1.0))"
                return root if expr.exp == sym.S.Half else f"(1.0/{root})"
            if expr.exp.is_Integer and expr.exp < 0:
                base = self.parenthesize(expr.base, 0)
                n = -int(expr.exp)
                denom = base if n == 1 else f"{base}**{n}"
                return f"(1.0/({denom}))"
            return super()._print_Pow(expr, rational=rational)

    class CudaPrinter(C99CodePrinter):
        """Scalar expressions over the template type ``T``."""

        def _print_Float(self, expr):
            return f"T({float(expr)!r})"

        def _print_Integer(self, expr):
            return f"T({int(expr)})"

        def _print_Rational(self, expr):
            return f"T({float(expr.p) / float(expr.q)!r})"

        def _print_Half(self, expr):
            return "T(0.5)"

        def _print_Zero(self, expr):
            return "T(0)"

        def _print_One(self, expr):
            return "T(1)"

        def _print_NegativeOne(self, expr):
            return "T(-1)"

        def _print_Function(self, expr):
            name = type(expr).__name__
            if name in ("sin", "cos", "tanh"):
                return f"dyn_{name}({self._print(expr.args[0])})"
            return super()._print_Function(expr)

        _print_sin = _print_cos = _print_tanh = _print_Function

        def _print_Relational(self, expr):
            return (f"({self._print(expr.lhs)} {expr.rel_op} "
                    f"{self._print(expr.rhs)})")

        def _print_Piecewise(self, expr):
            result = self._print(expr.args[-1].expr)
            for arg in reversed(expr.args[:-1]):
                result = (f"({self._print(arg.cond)} ? "
                          f"{self._print(arg.expr)} : {result})")
            return result

        def _print_Heaviside(self, expr):
            return self._print(expr.rewrite(sym.Piecewise))

        def _print_Max(self, expr):
            args = [self._print(a) for a in expr.args]
            out = args[0]
            for a in args[1:]:
                out = f"dyn_max({out}, {a})"
            return out

        def _print_Pow(self, expr, rational=False):
            if expr.exp == sym.S.Half or expr.exp == -sym.S.Half:
                base = self._print(expr.base)
                root = f"dyn_sqrt(({base} > T(0)) ? {base} : T(1))"
                return root if expr.exp == sym.S.Half else f"(T(1)/{root})"
            if expr.exp.is_Integer:
                n = int(expr.exp)
                base = self.parenthesize(expr.base, 1000)
                prod = "*".join([base] * abs(n))
                return f"({prod})" if n > 0 else f"(T(1)/({prod}))"
            raise NotImplementedError(f"pow {expr}")

    return TorchPrinter(), CudaPrinter()


_TORCH_HEADER = '''"""Machine-generated cart-pole dynamics for PyTorch — do not edit.

Generated by ``python -m cartpole_tpu_torch.symbolic.generate{flag}`` from the
SymPy Euler-Lagrange derivation in ``symbolic/lagrangian.py``;
the same CSE feeds ``csrc/{version}_dynamics.cuh``. Counterpart of
``cartpole_tpu/models/_{version}_gen.py``.
"""

import torch


N_Q = {n_q}
STATE_DIM = {sd}

'''

_CUDA_HEADER = '''// Machine-generated cart-pole dynamics for CUDA C++ -- do not edit.
//
// Generated by `python -m cartpole_tpu_torch.symbolic.generate` from the SymPy
// Euler-Lagrange derivation in symbolic/lagrangian.py; the same
// CSE feeds models/_single_gen.py. Templated on the real type T. The dyn_*
// helpers call the precise library functions of T (sinf for float, sin for
// double), never the __sinf-style fast intrinsics.
#pragma once

#ifndef __CUDACC__
#ifndef __host__
#define __host__
#endif
#ifndef __device__
#define __device__
#endif
#endif

#include <math.h>

namespace cartpole_gen {{

constexpr int N_Q = {n_q};
constexpr int STATE_DIM = {sd};
constexpr int N_PARAMS = {n_p};

__host__ __device__ inline float dyn_sin(float x) {{ return sinf(x); }}
__host__ __device__ inline double dyn_sin(double x) {{ return sin(x); }}
__host__ __device__ inline float dyn_cos(float x) {{ return cosf(x); }}
__host__ __device__ inline double dyn_cos(double x) {{ return cos(x); }}
__host__ __device__ inline float dyn_tanh(float x) {{ return tanhf(x); }}
__host__ __device__ inline double dyn_tanh(double x) {{ return tanh(x); }}
__host__ __device__ inline float dyn_sqrt(float x) {{ return sqrtf(x); }}
__host__ __device__ inline double dyn_sqrt(double x) {{ return sqrt(x); }}
// NaN-propagating max (jnp.maximum / torch.maximum semantics).
template <typename T>
__host__ __device__ inline T dyn_max(T a, T b) {{
  return (a > b || a != a) ? a : b;
}}

'''

#: The header of the double and triple models: the dyn_* helpers come from
#: the single header, the constants and functions live in a namespace of
#: the model's own.
_CUDA_HEADER_MULTILINK = '''// Machine-generated cart-pole dynamics for CUDA C++ -- do not edit.
//
// Generated by `python -m cartpole_tpu_torch.symbolic.generate --version
// {version}` from the SymPy Euler-Lagrange derivation in
// symbolic/lagrangian.py; the same CSE feeds models/_{version}_gen.py.
// Templated on the real type T. The dyn_* helpers are single_dynamics.cuh's
// (the precise library functions of T, never the __sinf-style fast
// intrinsics).
#pragma once

#include "single_dynamics.cuh"

namespace cartpole_gen {{
namespace {version}_pole {{

constexpr int N_Q = {n_q};
constexpr int STATE_DIM = {sd};
constexpr int N_PARAMS = {n_p};

'''


def _emit_torch_prologue(lines, model, fname, doc):
    param_names = ", ".join(str(s) for s in model.param_syms)
    state_names = ", ".join(str(s) for s in model.state_syms)
    force_names = ", ".join(str(s) for s in model.force_syms)
    zeros = ", ".join(["0.0"] * len(model.force_syms))
    lines.append(f"def {fname}(params, x, u, forces=None):\n")
    lines.append(f'    """{doc}\n\n')
    lines.append(
        f"    x = [{state_names}]; params = ({param_names});\n"
        f"    forces = ({force_names}) or None.\"\"\"\n"
    )
    lines.append(f"    {param_names} = params\n")
    for i, s in enumerate(model.state_syms):
        lines.append(f"    {s} = x[{i}]\n")
    lines.append("    if forces is None:\n")
    lines.append(f"        {force_names} = {zeros}\n")
    lines.append("    else:\n")
    for i, s in enumerate(model.force_syms):
        lines.append(f"        {s} = forces[{i}]\n")


def _flag(version: str) -> str:
    return "" if version == "single" else f" --version {version}"


def generate_torch_module(model, version: str = "single") -> str:
    """Render ``<version>_dynamics_core`` and ``<version>_dynamics_jac_core``
    as torch source (counterpart of the JAX emitter's rows-form
    functions)."""
    tp, _ = _printers()
    (rep_p, red_p), (rep_j, red_j) = _cse(model)
    n_q = len(model.qdd_exprs)
    sd = 2 * n_q
    lines = [_TORCH_HEADER.format(n_q=n_q, sd=sd, version=version,
                                  flag=_flag(version))]
    vel = ", ".join(str(model.state_syms[n_q + i]) for i in range(n_q))
    acc = ", ".join(f"qdd_{i}" for i in range(n_q))

    _emit_torch_prologue(
        lines, model, f"{version}_dynamics_core",
        "Continuous-time dynamics, rows-out: returns the tuple "
        "(qd_0, ..., qdd_0, ...).",
    )
    for lhs, rhs in rep_p:
        lines.append(f"    {lhs} = {tp.doprint(rhs)}\n")
    for i, e in enumerate(red_p):
        lines.append(f"    qdd_{i} = {tp.doprint(e)}\n")
    lines.append(f"    return ({vel}, {acc})\n\n\n")

    _emit_torch_prologue(
        lines, model, f"{version}_dynamics_jac_core",
        "Rows-out dynamics + analytic Jacobians: returns "
        "(x_dot_rows, J_x_rows, J_u_rows) as nested tuples. Constant "
        "entries are Python literals 0.0/1.0 so downstream chain-rule "
        "products fold them.",
    )
    for lhs, rhs in rep_j:
        lines.append(f"    {lhs} = {tp.doprint(rhs)}\n")
    idx = n_q
    for i in range(n_q):
        lines.append(f"    qdd_{i} = {tp.doprint(red_j[i])}\n")
    for i in range(n_q):
        for j in range(sd):
            lines.append(f"    dq{i}_x{j} = {tp.doprint(red_j[idx])}\n")
            idx += 1
        lines.append(f"    dq{i}_u = {tp.doprint(red_j[idx])}\n")
        idx += 1
    lines.append(f"    x_dot = ({vel}, {acc})\n")
    lines.append("    J_x = (\n")
    for i in range(n_q):
        ents = ["1.0" if j == n_q + i else "0.0" for j in range(sd)]
        lines.append("        (" + ", ".join(ents) + "),\n")
    for i in range(n_q):
        ents = [f"dq{i}_x{j}" for j in range(sd)]
        lines.append("        (" + ", ".join(ents) + "),\n")
    lines.append("    )\n")
    ju = ["0.0"] * n_q + [f"dq{i}_u" for i in range(n_q)]
    lines.append("    J_u = (" + ", ".join(ju) + ")\n")
    lines.append("    return x_dot, J_x, J_u\n")
    return "".join(lines)


def _emit_cuda_prologue(lines, model, fname, outs):
    lines.append("template <typename T>\n")
    lines.append(
        f"__host__ __device__ inline void {fname}(const T* p, const T* x, "
        f"T u, {outs}) {{\n"
    )
    for i, s in enumerate(model.param_syms):
        lines.append(f"  const T {s} = p[{i}];\n")
    for i, s in enumerate(model.state_syms):
        lines.append(f"  const T {s} = x[{i}];\n")
    # The fused path never applies external forces: they are zeros, kept
    # as named values so the expressions read like the derivation.
    for s in model.force_syms:
        lines.append(f"  const T {s} = T(0);\n")


def generate_cuda_header(model, version: str = "single") -> str:
    """Render the same two functions as ``__host__ __device__`` templates:
    ``<version>_dynamics_core(p, x, u, xdot)`` and
    ``<version>_dynamics_jac_core(p, x, u, xdot, Jx, Ju)`` (dense
    ``Jx[sd*sd]`` row-major, ``Ju[sd]``)."""
    _, cp = _printers()
    (rep_p, red_p), (rep_j, red_j) = _cse(model)
    n_q = len(model.qdd_exprs)
    sd = 2 * n_q
    header = _CUDA_HEADER if version == "single" else _CUDA_HEADER_MULTILINK
    lines = [header.format(n_q=n_q, sd=sd, n_p=len(model.param_syms),
                           version=version)]

    _emit_cuda_prologue(lines, model, f"{version}_dynamics_core", "T* xdot")
    for lhs, rhs in rep_p:
        lines.append(f"  const T {lhs} = {cp.doprint(rhs)};\n")
    for i in range(n_q):
        lines.append(f"  xdot[{i}] = {model.state_syms[n_q + i]};\n")
    for i, e in enumerate(red_p):
        lines.append(f"  xdot[{n_q + i}] = {cp.doprint(e)};\n")
    lines.append("}\n\n")

    _emit_cuda_prologue(lines, model, f"{version}_dynamics_jac_core",
                        "T* xdot, T* Jx, T* Ju")
    for lhs, rhs in rep_j:
        lines.append(f"  const T {lhs} = {cp.doprint(rhs)};\n")
    for i in range(n_q):
        lines.append(f"  xdot[{i}] = {model.state_syms[n_q + i]};\n")
    for i in range(n_q):
        lines.append(f"  xdot[{n_q + i}] = {cp.doprint(red_j[i])};\n")
    for i in range(n_q):  # selector rows
        for j in range(sd):
            v = "T(1)" if j == n_q + i else "T(0)"
            lines.append(f"  Jx[{i * sd + j}] = {v};\n")
        lines.append(f"  Ju[{i}] = T(0);\n")
    idx = n_q
    for i in range(n_q):
        r = n_q + i
        for j in range(sd):
            lines.append(f"  Jx[{r * sd + j}] = {cp.doprint(red_j[idx])};\n")
            idx += 1
        lines.append(f"  Ju[{r}] = {cp.doprint(red_j[idx])};\n")
        idx += 1
    lines.append("}\n\n")
    if version != "single":
        lines.append(f"}}  // namespace {version}_pole\n")
    lines.append("}  // namespace cartpole_gen\n")
    return "".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--version", choices=tuple(VERSIONS), default="single")
    version = ap.parse_args(argv).version
    model = VERSIONS[version]()
    torch_out, cuda_out = outputs(version)
    for path, src in ((torch_out, generate_torch_module(model, version)),
                      (cuda_out, generate_cuda_header(model, version))):
        with open(path, "w") as f:
            f.write(src)
        print(f"wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
