"""The par engine's CUDA kernel: wrapper and row launcher (backend ``"cuda"``).

:func:`par_sweep` is the port of ``repro/kernels/faas_event_step.py::
par_sweep_pallas``, the concurrency-value platform (Knative / Cloud Run
style): each instance serves up to ``concurrency`` requests, held as
``finish[M, c]`` request finish times.  The kernel is
``csrc/par_event_step.cu`` (one warp per row, ``finish`` in shared memory,
each instance's busy and free-by clocks in registers, the integrals accrued
per state span; its header says what bounds it and why it is built the way
it is).  It
keeps exactly ``slots`` slots and runs exactly K arrivals: the reference's
lane padding of the slot axis and ``1e30`` padding of K are TPU layout.

For CUDA tensors the wrapper checks device, dtype, shape and contiguity,
launches the kernel on the current stream and counts the launch in
``LAUNCH_COUNTS["par_sweep"]``; for CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.faas_par_sweep_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.execution import register_backend
from repro_torch.kernels import _build
from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS, MAX_SLOTS
from repro_torch.kernels.ref import PAR_ACC_COLS, _rows, faas_par_sweep_ref

# one row's finish[M, c] must fit one block's shared memory on sm_90
# (227 KB): csrc/par_event_step.cu MAX_FINISH
MAX_FINISH = 232448 // 4


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry ``par_sweep_f32``, built and loaded on first use."""
    fn = _build.load("par_event_step").par_sweep_f32
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def par_sweep(
    t_exp,  # f32 [R] per-row expiration threshold
    dts,  # f32 [R, K] inter-arrival gaps, or absolute times if prestamped
    warms,  # f32 [R, K]
    colds,  # f32 [R, K]
    *,
    t_end,  # f32 [R] or scalar — per-row horizon
    skip,  # f32 [R] or scalar — per-row warm-up exclusion
    max_concurrency: int,
    concurrency: int,
    slots: int,
    prestamped: bool = False,
):
    """Run K arrivals of the concurrency-value platform against each row's
    empty pool; returns ``(alive, creation, finish[R, c, M], t,
    acc[R, 9])`` as :func:`~repro_torch.kernels.ref.faas_par_sweep_ref`
    defines them."""
    if dts.dim() != 2:
        raise ValueError(f"dts must be [R, K], got shape {tuple(dts.shape)}")
    R, K = dts.shape
    M, c = int(slots), int(concurrency)
    dev = dts.device
    if dev.type == "cpu":
        return faas_par_sweep_ref(
            t_exp, dts, warms, colds, t_end=t_end, skip=skip,
            max_concurrency=max_concurrency, concurrency=c, slots=M,
            prestamped=prestamped,
        )
    if dev.type != "cuda":
        raise ValueError(f"par_sweep runs on CUDA or CPU tensors, got {dev}")
    t_exp, t_end, skip = (_rows(x, R, dev) for x in (t_exp, t_end, skip))
    shapes = dict(
        t_exp=(t_exp, (R,)), t_end=(t_end, (R,)), skip=(skip, (R,)),
        dts=(dts, (R, K)), warms=(warms, (R, K)), colds=(colds, (R, K)),
    )
    for name, (x, shape) in shapes.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, dts on {dev}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if R < 1 or not 1 <= M <= MAX_SLOTS or c < 1:
        raise ValueError(
            f"par_sweep needs R >= 1 rows, 1 <= M <= {MAX_SLOTS} slots and "
            f"c >= 1, got R={R}, M={M}, c={c}"
        )
    if M * c > MAX_FINISH:
        raise ValueError(
            f"par_sweep keeps a row's finish[M, c] in one block's shared "
            f"memory: M*c must be <= {MAX_FINISH}, got {M}*{c} = {M * c}"
        )
    if not 1 <= int(max_concurrency) <= 1 << 24:
        raise ValueError("max_concurrency must be in [1, 2**24] (exact in f32)")
    f32 = dict(dtype=torch.float32, device=dev)
    alive = torch.empty((R, M), **f32)
    creation = torch.empty((R, M), **f32)
    finish = torch.empty((R, c, M), **f32)
    t = torch.empty((R,), **f32)
    acc = torch.empty((R, PAR_ACC_COLS), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(
        t_exp.data_ptr(), t_end.data_ptr(), skip.data_ptr(), dts.data_ptr(),
        warms.data_ptr(), colds.data_ptr(), alive.data_ptr(),
        creation.data_ptr(), finish.data_ptr(), t.data_ptr(), acc.data_ptr(),
        R, M, c, K, int(max_concurrency), int(bool(prestamped)),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"par_sweep kernel launch failed: CUDA error {err}")
    LAUNCH_COUNTS["par_sweep"] += 1
    return alive, creation, finish, t, acc


@register_backend("cuda", engines=("par",))
def _cuda_par_rows(
    t_exp, t_end, skip, dts, warms, colds,
    *, max_concurrency, concurrency, slots, prestamped,
):
    """Backend ``"cuda"``'s par row launcher: the ``[C, 9]`` accumulator."""
    return par_sweep(
        t_exp, dts, warms, colds, t_end=t_end, skip=skip,
        max_concurrency=max_concurrency, concurrency=concurrency,
        slots=slots, prestamped=prestamped,
    )[4]
