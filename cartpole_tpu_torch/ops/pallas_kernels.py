"""The segment rollout with Jacobians over batch-last columns: plain PyTorch
version and the wrapper of its Hopper kernel.

Replaces ``cartpole_tpu/ops/pallas_kernels.py::segment_jac_batch_last``
(the gridless Pallas kernel; the module name mirrors the reference's). Per
column it takes ``sp`` RK4 steps of the generated dynamics Jacobians with
the four-stage chain rule, accumulates ``Jx = dx_end/dx0`` and the columns
``Ju[:, k] = dx_end/du_k``, and wraps the angles. It is the linearization of
the ``fused=False`` lanes solve (``mpc/lanes.py::_LanesProblem.
condensed_step``), one launch per Gauss-Newton iteration.

* :func:`segment_jac_batch_last_reference` is the plain version, on the
  rows chain rule of ``ops/lanes.py::segment_rollout_with_jac_scan``.
* :func:`segment_jac_batch_last` dispatches on the device of its tensors:
  CPU tensors take the plain version; CUDA tensors launch the kernel of
  ``csrc/segment_jac.cu`` (one thread per column, one launch for all R
  columns: the reference's ``PALLAS_CHUNK`` bounded TPU VMEM and has no
  counterpart here) or raise. ``segment_jac_batch_last.launches`` counts
  kernel launches.
* :func:`kernel_occupancy` reports what a launch gets on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from ..models.base import SINGLE_CARTPOLE
from ._build import KERNEL_MODELS
from .lanes import segment_rollout_with_jac_scan

__all__ = ["segment_jac_batch_last", "segment_jac_batch_last_reference",
           "kernel_occupancy"]

#: Compile-time maximum of the steps per segment (csrc/segment_jac.cuh).
SPMAX = 16
THREADS_PER_BLOCK = 128


def _unpack(params_cols, xs_cols, us_cols):
    n_p, R = params_cols.shape
    return n_p, R, xs_cols.shape[0], us_cols.shape[0]


def segment_jac_batch_last_reference(params_cols, xs_cols, us_cols, h: float,
                                     angle_indices: Tuple[int, ...],
                                     model=SINGLE_CARTPOLE):
    """Plain version. ``params_cols (n_p, R)`` (rows in the model's params
    field order), ``xs_cols (sd, R)``, ``us_cols (sp, R)``. Returns
    ``(x_end (sd, R), Jx (sd, sd, R), Ju (sd, sp, R))``."""
    params = model.params_type(*params_cols)
    return segment_rollout_with_jac_scan(
        lambda xr, u: model.dynamics_jac_core(params, xr, u),
        tuple(xs_cols), us_cols, h, angle_indices,
    )


def check_kernel_inputs(params_cols, xs_cols, us_cols, angle_indices,
                        model=SINGLE_CARTPOLE):
    """Raise on anything the kernel does not take: a model without a
    compiled instantiation, a dtype other than f32/f64, mixed dtypes or
    devices, shapes other than the model's parameter and state counts,
    non-contiguous tensors, ``sp`` beyond ``SPMAX`` or a column count beyond
    int32 offsets. Returns the angle bit mask."""
    if model.name not in KERNEL_MODELS:
        raise ValueError(f"segment_jac kernel has no compiled dynamics for "
                         f"model {model.name!r} (compiled: {KERNEL_MODELS})")
    ts = (params_cols, xs_cols, us_cols)
    dtype, dev = xs_cols.dtype, xs_cols.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segment_jac kernel takes f32 or f64, got {dtype}")
    if any(t.dtype != dtype or t.device != dev for t in ts):
        raise TypeError("segment_jac kernel inputs must share one dtype and "
                        "device")
    if any(t.dim() != 2 for t in ts):
        raise ValueError("segment_jac kernel inputs must be 2-D (rows, R)")
    n_p, R, sd, sp = _unpack(*ts)
    want = (len(dataclasses.fields(model.params_type)), model.state_dim)
    if (n_p, sd) != want or xs_cols.shape[1] != R or us_cols.shape[1] != R:
        raise ValueError(
            f"segment_jac kernel expects params ({want[0]}, R), xs "
            f"({want[1]}, R), us (sp, R); got {tuple(params_cols.shape)}, "
            f"{tuple(xs_cols.shape)}, {tuple(us_cols.shape)}")
    if not 1 <= sp <= SPMAX:
        raise ValueError(f"segment_jac kernel takes 1 <= sp <= {SPMAX}, "
                         f"got {sp}")
    if R < 1 or R * sd * max(sd, sp) >= 2**31:
        raise ValueError(f"segment_jac kernel: column count {R} out of range")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("segment_jac kernel inputs must be contiguous")
    if any(not 0 <= a < sd for a in angle_indices):
        raise ValueError(f"angle indices {angle_indices} out of range")
    return sum(1 << a for a in set(angle_indices))


def _launch_cuda(params_cols, xs_cols, us_cols, h, angle_indices, model):
    from ._build import load_library

    mask = check_kernel_inputs(params_cols, xs_cols, us_cols, angle_indices,
                               model)
    _, R, sd, sp = _unpack(params_cols, xs_cols, us_cols)
    x_end = torch.empty_like(xs_cols)
    Jx = xs_cols.new_empty((sd, sd, R))
    Ju = xs_cols.new_empty((sd, sp, R))
    lib = load_library()
    fn = (lib.segment_jac_launch_f32 if xs_cols.dtype == torch.float32
          else lib.segment_jac_launch_f64)
    dev = xs_cols.device
    with torch.cuda.device(dev):
        rc = fn(KERNEL_MODELS.index(model.name), params_cols.data_ptr(),
                xs_cols.data_ptr(), us_cols.data_ptr(), x_end.data_ptr(),
                Jx.data_ptr(), Ju.data_ptr(), R, sp, h, h * 0.5, h / 6.0, mask,
                THREADS_PER_BLOCK, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_jac kernel launch failed: CUDA error "
                           f"{rc}")
    segment_jac_batch_last.launches += 1
    return x_end, Jx, Ju


def kernel_occupancy(R: int, sp: int, threads: int = THREADS_PER_BLOCK,
                     model=SINGLE_CARTPOLE):
    """What an f32 launch of ``model``'s kernel over ``R`` columns of ``sp``
    steps in blocks of ``threads`` gets on the current card, as the CUDA
    runtime reports it: registers and local (stack) bytes per thread,
    resident blocks and warps per SM, warps of work per SM and the waves the
    grid takes."""
    from ._build import load_library

    out = (ctypes.c_int * 3)()
    rc = load_library().segment_jac_occupancy_f32(
        KERNEL_MODELS.index(model.name), sp, threads, out)
    if rc != 0:
        raise RuntimeError(f"segment_jac occupancy query failed: CUDA error "
                           f"{rc}")
    registers, local_bytes, blocks = out
    n_sm = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    warps_per_block = -(-threads // 32)
    return dict(threads_per_block=threads, registers=registers,
                local_bytes=local_bytes, blocks_per_sm=blocks,
                resident_warps_per_sm=blocks * warps_per_block,
                warps_of_work_per_sm=-(-R // threads) * warps_per_block
                / n_sm,
                waves=-(-R // max(1, blocks * threads * n_sm)))


def segment_jac_batch_last(params_cols, xs_cols, us_cols, h: float,
                           angle_indices: Tuple[int, ...],
                           model=SINGLE_CARTPOLE):
    """Fused segment rollout + Jacobians, batch-last (the reference's
    contract): ``params_cols (n_p, R)``, ``xs_cols (sd, R)``, ``us_cols
    (sp, R)`` -> ``(x_end (sd, R), Jx (sd, sd, R), Ju (sd, sp, R))``.

    CPU tensors run :func:`segment_jac_batch_last_reference`; CUDA tensors
    launch the kernel or raise."""
    dev = xs_cols.device
    if dev.type == "cuda":
        return _launch_cuda(params_cols, xs_cols, us_cols, h, angle_indices,
                            model)
    if dev.type != "cpu":
        raise ValueError(f"segment_jac_batch_last: unsupported device {dev}")
    return segment_jac_batch_last_reference(params_cols, xs_cols, us_cols, h,
                                            angle_indices, model)


segment_jac_batch_last.launches = 0
