"""Build and load the port's CUDA kernels.

``nvcc`` compiles each ``csrc/*.cu`` to an object, all sources at once in
parallel, and links them into one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), which is loaded with
``ctypes``. The library lands in ``cartpole_tpu_torch/_build/`` under a name
keyed by a hash of the sources and flags, so it is rebuilt whenever a source
changes. Nothing is built at import: the first launch builds. Each kernel's
launch header is compiled once per model (and kernel 2's once per real type
as well), each a translation unit of its own (:func:`device_units`), so the
models build in parallel.

:func:`build_host_library` builds the kernels' bodies with the host's C++
compiler instead (``csrc/host_check.cc`` and ``csrc/host_check.cuh`` once
per model), for the CPU tests.

``KERNEL_MODELS`` names the compiled models in the order of their ids in
the C interface; a library is checked against it when it is loaded.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["KERNEL_MODELS", "NVCC_FLAGS", "build_library", "open_library",
           "load_library", "build_host_library"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: Models compiled into both kernels, in the order of their ids: each
#: model struct's ``ID`` and ``NAME`` in csrc/segment_jac.cuh.
KERNEL_MODELS = ("single", "double", "triple")

#: No fast math: IEEE division and sqrt and denormals stay (qp_ok and the
#: merit depend on inf and isfinite). ``-Xptxas -v`` reports registers and
#: spills.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _sources(csrc=CSRC):
    return sorted(glob.glob(os.path.join(csrc, "*.cu"))
                  + glob.glob(os.path.join(csrc, "*.cuh")))


def _struct(model: str) -> str:
    return f"segjac::{model.capitalize()}CartPole"


def device_units(csrc=CSRC):
    """``(name, source, flags)`` of every nvcc translation unit: the C entry
    points (``csrc/*.cu``), kernel 1's launch header once per model, and
    kernel 2's once per model and real type."""
    units = [(os.path.basename(s), s, [])
             for s in sorted(glob.glob(os.path.join(csrc, "*.cu")))]
    k1 = os.path.join(csrc, "fused_iteration_launch.cuh")
    k2 = os.path.join(csrc, "segment_jac_launch.cuh")
    for m in KERNEL_MODELS:
        units.append((f"fused_iteration_launch.cuh[{m}]", k1, [
            "-x", "cu", f"-DFUSED_INSTANCE={m}_launchers",
            f"-DFUSED_MODEL={_struct(m)}"]))
        for real, tag in (("float", "f32"), ("double", "f64")):
            units.append((f"segment_jac_launch.cuh[{m},{tag}]", k2, [
                "-x", "cu", f"-DSEGJAC_INSTANCE={m}_{tag}",
                f"-DSEGJAC_MODEL={_struct(m)}", f"-DSEGJAC_REAL={real}"]))
    return units


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels")
    return path


def _run(procs):
    """Wait for every ``(name, Popen)``, started together; raise on the
    first failure. Returns their outputs, each headed by its name and the
    seconds it took from the first wait."""
    t0 = time.perf_counter()
    results = {}

    def wait(name, proc):
        out, _ = proc.communicate()
        results[name] = (out, time.perf_counter() - t0)

    threads = [threading.Thread(target=wait, args=p) for p in procs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, proc in procs:
        if proc.returncode != 0:
            raise RuntimeError(f"build failed on {name} ({proc.returncode}):"
                               f"\n{results[name][0]}")
    return "".join(f"== {name} ({results[name][1]:.1f} s)\n"
                   f"{results[name][0]}" for name, _ in procs)


def build_library(extra_flags=(), csrc=CSRC,
                  prefix="") -> tuple[str, str]:
    """Compile the kernels of ``csrc`` (those of :func:`device_units` whose
    name starts with ``prefix``) if the library for those sources and
    ``NVCC_FLAGS`` plus ``extra_flags`` is missing. Returns ``(path,
    compiler output)``; the output is empty when the library was already
    built."""
    flags = [*NVCC_FLAGS, *extra_flags]
    units = [u for u in device_units(csrc) if u[0].startswith(prefix)]
    h = hashlib.sha256(" ".join(flags).encode())
    for name, _, unit_flags in units:
        h.update(" ".join([name, *unit_flags]).encode())
    for src in _sources(csrc):
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
    for i, (name, src, unit_flags) in enumerate(units):
        obj = os.path.join(BUILD_DIR, f"unit{i}.{tag}.o")
        objs.append(obj)
        procs.append((name, subprocess.Popen(
            [nvcc, *flags, *unit_flags, "-c", "-o", obj, src],
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


def check_models(lib: ctypes.CDLL) -> None:
    """Raise unless the library's model ids name ``KERNEL_MODELS``, in
    order, and nothing past them."""
    fn = lib.cartpole_kernel_model
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    names = []
    while (name := fn(len(names))) is not None:
        names.append(name.decode())
    if tuple(names) != KERNEL_MODELS:
        raise RuntimeError(f"the kernel library's model ids name {names}, "
                           f"not KERNEL_MODELS {list(KERNEL_MODELS)}")


def open_library(path: str) -> ctypes.CDLL:
    """Load a built library and declare the launchers' C signatures."""
    from .fused import _ArgsF, _Tensors

    lib = ctypes.CDLL(path)
    check_models(lib)
    # Each launcher's first argument is the model id.
    fn = lib.fused_iteration_launch_f32
    fn.argtypes = [ctypes.c_int, _Tensors, _ArgsF, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fused_iteration_occupancy_f32
    fn.argtypes = [ctypes.c_int, _ArgsF, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    for name, real in (("segment_jac_launch_f32", ctypes.c_float),
                       ("segment_jac_launch_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 2 + [real] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    fn = lib.segment_jac_occupancy_f32
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build the kernels with the default flags if needed, and load them."""
    return open_library(build_library()[0])


def build_host_library(out_dir: str, cxx: str = "g++") -> str:
    """Compile ``csrc/host_check.cc`` and ``csrc/host_check.cuh`` once per
    model (in parallel) with ``cxx`` into ``out_dir/libkernels_host.so``,
    check its model ids, and return its path."""
    units = [("host_check.cc", os.path.join(CSRC, "host_check.cc"), [])]
    units += [(f"host_check.cuh[{m}]", os.path.join(CSRC, "host_check.cuh"),
               ["-x", "c++", f"-DHOST_INSTANCE={m}_bodies",
                f"-DHOST_MODEL={_struct(m)}"]) for m in KERNEL_MODELS]
    objs, procs = [], []
    for i, (name, src, unit_flags) in enumerate(units):
        obj = os.path.join(out_dir, f"unit{i}.o")
        objs.append(obj)
        procs.append((name, subprocess.Popen(
            [cxx, "-O2", "-std=c++17", "-fPIC", *unit_flags, "-c", "-o", obj,
             src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    _run(procs)
    path = os.path.join(out_dir, "libkernels_host.so")
    _run([("link", subprocess.Popen(
        [cxx, "-shared", "-o", path, *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))])
    check_models(ctypes.CDLL(path))
    return path
