"""The fleet engine's CUDA kernel: wrapper and row launcher (backend
``"cuda"``).

:func:`fleet_sweep` is the port of ``repro/kernels/faas_event_step.py::
fleet_sweep_pallas`` (and its launcher ``_pallas_fleet_rows``) for the base
path, the gap and prestamped stream modes and FIFO queues: F <= 8 function
pools under one shared cluster capacity.  The kernel is
``csrc/fleet_event_step.cu`` (one warp per fleet, all F*M slots in
registers; its header says what bounds it and why it is built the way it
is).  Unlike the reference's 8-row blocks, each fleet reads its replica's
row of one ``[replicas, K]`` merged stream through the per-fleet index
``stream``, so the cells of a sweep share the stream instead of copying it.

For CUDA tensors the wrapper checks device, dtype, shape and contiguity,
launches the kernel on the current stream and counts the launch in
``LAUNCH_COUNTS["fleet_sweep"]``; for CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.fleet_sweep_ref`.  The reference kernel's
platform-fault inputs are a later slice and raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.execution import register_backend
from repro_torch.kernels import _build
from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS
from repro_torch.kernels.ref import (
    FLEET_ACC_COLS,
    MAX_FUNCTIONS,
    _rows,
    fleet_sweep_ref,
    refuse_fleet_faults,
)

# slots per lane of one warp (csrc/fleet_event_step.cu): F rounded up to a
# power of two times M rounded up to a power-of-two multiple of 32 must fit
MAX_FLEET_SLOTS = 1024
# queue entries per function (three [8, Q] planes per warp in shared memory)
MAX_QUEUE = 128


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def fleet_slots(F: int, M: int) -> int:
    """The slots one fleet's warp holds: F and M/32 rounded up to powers of
    two (the kernel's template instance), times 32."""
    return _pow2(F) * _pow2(-(-int(M) // 32)) * 32


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry ``fleet_sweep_f32``, built and loaded on first use."""
    fn = _build.load("fleet_event_step").fleet_sweep_f32
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fleet_sweep(
    t_exp,  # f32 [N, F] per-function expiration threshold
    limit,  # f32 [N, F] per-function concurrency limit
    ncl,  # f32 [N] or scalar — shared cluster capacity (1e30 = unbounded)
    t_end,  # f32 [N] or scalar — per-fleet horizon
    skip,  # f32 [N] or scalar — per-fleet warm-up exclusion
    stream,  # int64 [N] the stream row each fleet reads
    times,  # f32 [S, K] merged stream: gaps, or absolute times if prestamped
    fids,  # uint8 [S, K] acting function of each event
    warms,  # f32 [S, K]
    colds,  # f32 [S, K]
    *,
    slots: int,
    queue_depth: int = 0,
    prestamped: bool = False,
    **faults,
):
    """Run each fleet's stream row against its F pools; returns
    ``(acc[N, F, 13], qleft[N, F])`` as
    :func:`~repro_torch.kernels.ref.fleet_sweep_ref` defines them.

    Every fleet value (thresholds, limits, capacity, horizon, warm-up) is a
    per-fleet input, so a whole fleet sweep is one launch.  The launch
    reads nothing back from the card: on CUDA tensors a fleet whose
    ``stream`` row lies outside ``[0, S)`` gets NaN outputs instead of an
    error.  ``faults``
    names the reference kernel's fault inputs, which raise
    ``NotImplementedError`` when given.
    """
    refuse_fleet_faults("fleet_sweep", faults)
    if times.dim() != 2 or t_exp.dim() != 2:
        raise ValueError(
            f"times must be [S, K] and t_exp [N, F], got {tuple(times.shape)} "
            f"and {tuple(t_exp.shape)}"
        )
    dev = times.device
    if dev.type == "cpu":
        return fleet_sweep_ref(
            t_exp, limit, ncl, t_end, skip, stream, times, fids, warms, colds,
            slots=slots, queue_depth=queue_depth, prestamped=prestamped,
        )
    if dev.type != "cuda":
        raise ValueError(f"fleet_sweep runs on CUDA or CPU tensors, got {dev}")
    (N, F), (S, K) = t_exp.shape, times.shape
    M, Q = int(slots), int(queue_depth)
    ncl, t_end, skip = (_rows(x, N, dev) for x in (ncl, t_end, skip))
    shapes = dict(
        t_exp=(t_exp, (N, F), torch.float32), limit=(limit, (N, F), torch.float32),
        ncl=(ncl, (N,), torch.float32), t_end=(t_end, (N,), torch.float32),
        skip=(skip, (N,), torch.float32), stream=(stream, (N,), torch.int64),
        times=(times, (S, K), torch.float32), fids=(fids, (S, K), torch.uint8),
        warms=(warms, (S, K), torch.float32), colds=(colds, (S, K), torch.float32),
    )
    for name, (x, shape, dtype) in shapes.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, times on {dev}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if N < 1 or not 1 <= F <= MAX_FUNCTIONS or M < 1:
        raise ValueError(
            f"fleet_sweep needs N >= 1 fleets of 1 <= F <= {MAX_FUNCTIONS} "
            f"functions and M >= 1 slots, got N={N}, F={F}, M={M}"
        )
    if fleet_slots(F, M) > MAX_FLEET_SLOTS:
        raise ValueError(
            f"fleet_sweep keeps a fleet's slots in one warp's registers: F "
            f"and M/32 rounded up to powers of two must give at most "
            f"{MAX_FLEET_SLOTS} slots, got F={F}, M={M} -> {fleet_slots(F, M)}"
        )
    if not 0 <= Q <= MAX_QUEUE:
        raise ValueError(f"queue_depth must be in [0, {MAX_QUEUE}], got {Q}")
    if K >= 1 << 31:
        raise ValueError(f"fleet_sweep takes fewer than 2**31 events, got K={K}")
    acc = torch.empty((N, F, FLEET_ACC_COLS), dtype=torch.float32, device=dev)
    qleft = torch.empty((N, F), dtype=torch.float32, device=dev)
    err = _kernel()(
        t_exp.data_ptr(), limit.data_ptr(), ncl.data_ptr(), t_end.data_ptr(),
        skip.data_ptr(), stream.data_ptr(), times.data_ptr(), fids.data_ptr(),
        warms.data_ptr(), colds.data_ptr(), acc.data_ptr(), qleft.data_ptr(),
        N, F, M, S, K, Q, int(bool(prestamped)),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fleet_sweep kernel launch failed: CUDA error {err}")
    LAUNCH_COUNTS["fleet_sweep"] += 1
    return acc, qleft


@register_backend("cuda", engines=("fleet",))
def _cuda_fleet_rows(
    t_exp, limit, ncl, t_end, skip, stream, times, fids, warms, colds,
    *, slots, queue_depth, prestamped,
):
    """Backend ``"cuda"``'s fleet launcher: ``(acc[N, F, 13], qleft[N, F])``."""
    return fleet_sweep(
        t_exp, limit, ncl, t_end, skip, stream, times, fids, warms, colds,
        slots=slots, queue_depth=queue_depth, prestamped=prestamped,
    )
