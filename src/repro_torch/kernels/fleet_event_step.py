"""The fleet engine's CUDA kernel: wrapper and row launcher (backend
``"cuda"``).

:func:`fleet_sweep` is the port of ``repro/kernels/faas_event_step.py::
fleet_sweep_pallas`` (and its launcher ``_pallas_fleet_rows``) for the base
path, the gap and prestamped stream modes, FIFO queues and platform faults
(crashes and capacity churn, not with queues): F <= 8 function pools under
one shared cluster capacity.  The kernel is
``csrc/fleet_event_step.cu`` (one warp per fleet: an alive bitmap of
the F*M slots and a compact table of the live instances in registers, the
integrals accrued per state span; its header says what bounds it and why
it is built the way it is).  Unlike the reference's 8-row blocks, each fleet reads its replica's
row of one ``[replicas, K]`` merged stream through the per-fleet index
``stream``, so the cells of a sweep share the stream instead of copying it.

For CUDA tensors the wrapper checks device, dtype, shape and contiguity,
launches the kernel on the current stream and counts the launch in
``LAUNCH_COUNTS["fleet_sweep"]`` (``"fleet_sweep_fault"`` with faults); for
CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.fleet_sweep_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.execution import register_backend
from repro_torch.kernels import _build
from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS
from repro_torch.kernels.ref import (
    FAULT_COLS,
    FLEET_ACC_COLS,
    MAX_FUNCTIONS,
    _rows,
    check_fault_inputs,
    fleet_sweep_ref,
)

# the alive bitmap of one warp (csrc/fleet_event_step.cu), one unsigned a
# lane: F rounded up to a power of two times M rounded up to a power-of-two
# multiple of 32 must fit
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
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def table_entries(F: int, M: int, live_bound=None) -> int:
    """Entries a lane of the live table that :func:`fleet_sweep` launches
    the kernel with for ``live_bound`` (None: F*M), as the kernel's launch
    chooses them (builds the kernel on first use)."""
    live = F * M if live_bound is None else int(live_bound)
    return int(_build.load("fleet_event_step").fleet_table_entries(min(live, F * M)))


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
    crash_rate=None,  # f32 [N] or scalar — crash hazard (faults)
    crash_u=None,  # f32 [S, K] per-event crash-lifetime uniforms (faults)
    cap_edges=None,  # f32 [N, E] capacity-profile step times (faults)
    cap_values=None,  # f32 [N, E+1] per-segment capacity ceilings (faults)
    live_bound=None,  # int: no fleet ever holds more live instances (None: F*M)
):
    """Run each fleet's stream row against its F pools; returns
    ``(acc[N, F, 13], qleft[N, F])``, with faults ``acc[N, F, 16]`` and
    with crashes the crash clocks ``doom[N, F, M]`` third, as
    :func:`~repro_torch.kernels.ref.fleet_sweep_ref` defines them.

    Every fleet value (thresholds, limits, capacity, horizon, warm-up) is a
    per-fleet input, so a whole fleet sweep is one launch.  The launch
    reads nothing back from the card: on CUDA tensors a fleet whose
    ``stream`` row lies outside ``[0, S)`` gets NaN outputs instead of an
    error.

    ``live_bound`` sizes the kernel's table of live instances: the host
    knows it without reading the card
    (:func:`repro_torch.core.fleet.live_bound`), and a fleet
    that outgrows it gets NaN outputs.
    """
    crashes, capped = check_fault_inputs(crash_rate, crash_u, cap_edges, cap_values)
    if (crashes or capped) and int(queue_depth) > 0:
        raise ValueError(
            "platform faults do not serve fleet FIFO queues yet (eviction would "
            "have to reconcile queued work); set queue_depth=0 or drop the faults"
        )
    faults = dict(crash_rate=crash_rate, crash_u=crash_u, cap_edges=cap_edges,
                  cap_values=cap_values)
    if times.dim() != 2 or t_exp.dim() != 2:
        raise ValueError(
            f"times must be [S, K] and t_exp [N, F], got {tuple(times.shape)} "
            f"and {tuple(t_exp.shape)}"
        )
    dev = times.device
    if dev.type == "cpu":
        return fleet_sweep_ref(
            t_exp, limit, ncl, t_end, skip, stream, times, fids, warms, colds,
            slots=slots, queue_depth=queue_depth, prestamped=prestamped, **faults,
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
    E = 0
    if crashes:
        crash_rate = _rows(crash_rate, N, dev)
        shapes.update(crash_rate=(crash_rate, (N,), torch.float32),
                      crash_u=(crash_u, (S, K), torch.float32))
    if capped:
        E = cap_values.shape[1] - 1 if cap_values.dim() == 2 else -1
        shapes.update(cap_edges=(cap_edges, (N, E), torch.float32),
                      cap_values=(cap_values, (N, E + 1), torch.float32))
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
            f"fleet_sweep keeps a fleet's alive bitmap in one warp's registers: F "
            f"and M/32 rounded up to powers of two must give at most "
            f"{MAX_FLEET_SLOTS} slots, got F={F}, M={M} -> {fleet_slots(F, M)}"
        )
    if not 0 <= Q <= MAX_QUEUE:
        raise ValueError(f"queue_depth must be in [0, {MAX_QUEUE}], got {Q}")
    if K >= 1 << 31:
        raise ValueError(f"fleet_sweep takes fewer than 2**31 events, got K={K}")
    live = F * M if live_bound is None else int(live_bound)
    if live < 1:
        raise ValueError(f"live_bound must be >= 1, got {live_bound}")
    cols = FLEET_ACC_COLS + (FAULT_COLS if crashes or capped else 0)
    acc = torch.empty((N, F, cols), dtype=torch.float32, device=dev)
    qleft = torch.empty((N, F), dtype=torch.float32, device=dev)
    doom = torch.empty((N, F, M), dtype=torch.float32, device=dev) if crashes else None
    ptr = lambda x: None if x is None else x.data_ptr()
    err = _kernel()(
        t_exp.data_ptr(), limit.data_ptr(), ncl.data_ptr(), t_end.data_ptr(),
        skip.data_ptr(), stream.data_ptr(), times.data_ptr(), fids.data_ptr(),
        warms.data_ptr(), colds.data_ptr(), ptr(crash_rate if crashes else None),
        ptr(crash_u), ptr(cap_edges if capped and E else None), ptr(cap_values),
        acc.data_ptr(), qleft.data_ptr(), ptr(doom), N, F, M, S, K, Q, E,
        int(bool(prestamped)), min(live, F * M),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fleet_sweep kernel launch failed: CUDA error {err}")
    LAUNCH_COUNTS["fleet_sweep_fault" if crashes or capped else "fleet_sweep"] += 1
    return (acc, qleft, doom) if crashes else (acc, qleft)


@register_backend("cuda", engines=("fleet",))
def _cuda_fleet_rows(
    t_exp, limit, ncl, t_end, skip, stream, times, fids, warms, colds, **kw,
):
    """Backend ``"cuda"``'s fleet launcher: ``(acc[N, F, 13 or 16], qleft[N,
    F])`` (``kw`` as :func:`fleet_sweep` takes them)."""
    return fleet_sweep(
        t_exp, limit, ncl, t_end, skip, stream, times, fids, warms, colds, **kw,
    )[:2]
