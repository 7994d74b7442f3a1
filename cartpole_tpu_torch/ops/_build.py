"""Build and load the port's CUDA kernels.

``nvcc`` compiles each ``csrc/*.cu`` to an object, all sources at once in
parallel, and links them into one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), which is loaded with
``ctypes``. The library lands in ``cartpole_tpu_torch/_build/`` under a name
keyed by a hash of the sources and flags, so it is rebuilt whenever a source
changes. Nothing is built at import: the first launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

__all__ = ["NVCC_FLAGS", "build_library", "open_library", "load_library"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: No fast math: IEEE division and sqrt and denormals stay (qp_ok and the
#: merit depend on inf and isfinite). ``-Xptxas -v`` reports registers and
#: spills.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels")
    return path


def _run(procs):
    """Wait for every ``(name, Popen)``; raise on the first failure."""
    logs = []
    for name, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            for _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):"
                               f"\n{out}")
        logs.append(f"== {name}\n{out}")
    return "".join(logs)


def build_library(extra_flags=()) -> tuple[str, str]:
    """Compile the kernels if the library for the current sources and
    ``NVCC_FLAGS`` plus ``extra_flags`` is missing. Returns ``(path,
    compiler output)``; the output is empty when the library was already
    built."""
    flags = [*NVCC_FLAGS, *extra_flags]
    h = hashlib.sha256(" ".join(flags).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    key = h.hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libcartpole_kernels_{key}.so")
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{key}.{os.getpid()}"
    objs, procs = [], []
    for src in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        obj = os.path.join(
            BUILD_DIR, f"{os.path.basename(src)[:-3]}.{tag}.o")
        objs.append(obj)
        procs.append((os.path.basename(src), subprocess.Popen(
            [nvcc, *flags, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = _run(procs)
    tmp = f"{path}.{tag}.tmp"
    log += _run([("link", subprocess.Popen(
        [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))])
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, path)
    return path, log


def open_library(path: str) -> ctypes.CDLL:
    """Load a built library and declare the launchers' C signatures."""
    from .fused import _ArgsF, _Tensors

    lib = ctypes.CDLL(path)
    fn = lib.fused_iteration_launch_f32
    fn.argtypes = [_Tensors, _ArgsF, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fused_iteration_occupancy_f32
    fn.argtypes = [_ArgsF, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    for name, real in (("segment_jac_launch_f32", ctypes.c_float),
                       ("segment_jac_launch_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                       + [real] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    fn = lib.segment_jac_occupancy_f32
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build the kernels with the default flags if needed, and load them."""
    return open_library(build_library()[0])
