"""The f64 fleet scan's CUDA kernel: wrapper, launch count and fleet
launcher (backend ``"scan"``, fleets).

:func:`fleet_scan_sweep` runs the reference's f64 fleet scan
(``repro/core/fleet.py::_make_fleet_step`` with ``_fleet_flush``; a
``lax.scan``, no Pallas kernel) on the card for any number of functions:
the kernel ``csrc/fleet_scan_event_step.cu`` (one warp per fleet, a compact
table of the live instances in registers with each entry's integrals, each
function's columns in its owning lane's registers up to 32 functions, the
alive bitmap and queues in shared memory; its header says how it is built),
with every
path of the plain version :func:`repro_torch.kernels.ref64.
fleet_scan_sweep_ref`: gap and prestamped streams, FIFO queues, crashes
and capacity churn.  Each fleet reads its replica's row of one ``[S, K]``
merged stream through ``stream``, so the cells of a sweep share it.

For CUDA tensors the wrapper checks device, dtype, shape and contiguity,
launches the kernel on the current stream and counts the launch in
``LAUNCH_COUNTS["fleet_scan_sweep"]`` (``"fleet_scan_sweep_fault"`` with
faults); a failed build or launch raises.  For CPU tensors it runs the
plain version.  :func:`resources` reports the instance a launch of given
sizes runs (registers, local memory, blocks an SM).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.execution import register_backend
from repro_torch.kernels import _build
from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS, _check_tensor
from repro_torch.kernels.ref64 import (
    FAULT64_COLS,
    FLEET64_COLS,
    FleetScanOut,
    _col,
    fleet_scan_sweep_ref,
)

# slots a function (32 bitmap words a warp) and the shared memory of a block
MAX_SLOTS = 1024
MAX_BLOCK_SMEM = 232448
FLEETS_PER_BLOCK = 4


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("fleet_scan_event_step")
    lib.fleet_scan_f64.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                   ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    lib.fleet_scan_f64.restype = ctypes.c_int
    lib.fleet_scan_warp_smem.argtypes = [ctypes.c_int] * 5
    lib.fleet_scan_warp_smem.restype = ctypes.c_longlong
    lib.fleet_scan_resources.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)]
    lib.fleet_scan_resources.restype = ctypes.c_int
    return lib


def _fleets_per_block(F: int, Q: int, M: int, faults: bool, live: int) -> int:
    """The fleets a block a launch of F functions, queue depth Q, M slots
    and a live bound ``live`` (at most F*M) runs with, as many as its
    warps' shared memory lets up to ``FLEETS_PER_BLOCK``; raises where one
    fleet does not fit a block."""
    per_warp = int(_lib().fleet_scan_warp_smem(F, Q, M, int(faults), live))
    warps = min(FLEETS_PER_BLOCK, MAX_BLOCK_SMEM // per_warp)
    if warps < 1:
        raise ValueError(
            f"a fleet of F={F} functions with queue_depth={Q} and M={M} slots needs "
            f"{per_warp} bytes of shared memory (its bitmap, queues and, past 32 functions or "
            f"a live bound of 256, its accumulators and integrals), "
            f"more than a block has ({MAX_BLOCK_SMEM}); split the fleet or shorten the queues")
    return warps


def resources(N: int, F: int, M: int, live: int, *, queue_depth: int = 0,
              faults: bool = False) -> dict:
    """The kernel instance a launch of N fleets of F functions, M slots, a
    live bound ``live``, the queue depth and faults runs on the current
    card, and what the card gives it: ``registers`` and ``local_bytes`` a
    thread, ``fleets_per_block``, ``blocks_per_sm``, its table's
    ``entries`` a lane, whether the per-function columns are in shared
    memory and whether it is the instance ``pinned`` at 6 blocks an SM."""
    F, M, Q = int(F), int(M), int(queue_depth)
    live = min(int(live), F * M)
    warps = _fleets_per_block(F, Q, M, bool(faults), live)
    out = (ctypes.c_int * 6)()
    err = _lib().fleet_scan_resources(int(N), F, Q, M, int(bool(faults)), live, warps,
                                      torch.cuda.current_device(), out)
    if err != 0:
        raise RuntimeError(f"fleet_scan_resources failed: CUDA error {err}")
    return dict(registers=out[0], local_bytes=out[1], fleets_per_block=warps,
                blocks_per_sm=out[2], entries=out[3], shared_columns=bool(out[4]),
                pinned=bool(out[5]))


def fleet_scan_sweep(
    t_exp, limit, ncl, t_end, skip, stream, times, fids, warms, colds, *, slots: int,
    queue_depth: int = 0, prestamped: bool = False, crash_rate=None, crash_u=None,
    cap_edges=None, cap_values=None, live_bound=None,
) -> FleetScanOut:
    """Run each fleet's stream row against its F pools and flush the tail,
    as :func:`~repro_torch.kernels.ref64.fleet_scan_sweep_ref` defines it
    (the arguments are its own): ``t_exp``/``limit`` f64 ``[N, F]``,
    ``ncl``/``t_end``/``skip``/``crash_rate`` f64 ``[N]`` (scalars
    broadcast), ``stream`` int64 ``[N]``, ``times`` f32 gaps or f64 times,
    ``fids`` uint8, ``warms``/``colds``/``crash_u`` f32 ``[S, K]``,
    ``cap_edges``/``cap_values`` f64 ``[N, E]``/``[N, E+1]``.
    ``live_bound`` bounds every fleet's live count (:func:`repro_torch.core.
    fleet.live_bound`; None: F*M) and sizes the kernel's table; a fleet
    that outgrows it, or whose ``stream`` row lies outside ``[0, S)``, gets
    NaN outputs.  Returns a :class:`FleetScanOut`."""
    faults = dict(crash_rate=crash_rate, crash_u=crash_u, cap_edges=cap_edges,
                  cap_values=cap_values)
    if times.dim() != 2 or t_exp.dim() != 2:
        raise ValueError(f"times must be [S, K] and t_exp [N, F], got {tuple(times.shape)} "
                         f"and {tuple(t_exp.shape)}")
    dev = times.device
    if dev.type == "cpu":
        return fleet_scan_sweep_ref(
            t_exp, limit, ncl, t_end, skip, stream, times, fids, warms, colds, slots=slots,
            queue_depth=queue_depth, prestamped=prestamped, **faults)
    if dev.type != "cuda":
        raise ValueError(f"fleet_scan_sweep runs on CUDA or CPU tensors, got {dev}")
    crashes, capped = crash_u is not None, cap_values is not None
    if (crash_rate is None) == crashes or (cap_edges is None) == capped:
        raise ValueError("crash_rate/crash_u and cap_edges/cap_values come together")
    (N, F), (S, K) = t_exp.shape, times.shape
    M, Q = int(slots), int(queue_depth)
    if Q and (crashes or capped):
        raise ValueError("fleet faults are incompatible with queue_depth > 0")
    f64 = torch.float64
    ncl, t_end, skip = (_col(x, N, dev) for x in (ncl, t_end, skip))
    checks = dict(
        t_exp=(t_exp, f64, (N, F)), limit=(limit, f64, (N, F)), ncl=(ncl, f64, (N,)),
        t_end=(t_end, f64, (N,)), skip=(skip, f64, (N,)),
        stream=(stream, torch.int64, (N,)),
        times=(times, f64 if times.dtype == f64 else torch.float32, (S, K)),
        fids=(fids, torch.uint8, (S, K)), warms=(warms, torch.float32, (S, K)),
        colds=(colds, torch.float32, (S, K)),
    )
    E = 0
    if crashes:
        crash_rate = _col(crash_rate, N, dev)
        checks.update(crash_rate=(crash_rate, f64, (N,)),
                      crash_u=(crash_u, torch.float32, (S, K)))
    if capped:
        E = cap_values.shape[-1] - 1
        checks.update(cap_edges=(cap_edges, f64, (N, E)),
                      cap_values=(cap_values, f64, (N, E + 1)))
    for name, (x, dtype, shape) in checks.items():
        _check_tensor(name, x, dev, dtype, shape)
    if N < 1 or F < 1 or not 1 <= M <= MAX_SLOTS or S < 1 or Q < 0:
        raise ValueError(f"fleet_scan_sweep needs N, F, S >= 1, 1 <= M <= {MAX_SLOTS} and "
                         f"Q >= 0, got N={N}, F={F}, M={M}, S={S}, Q={Q}")
    if K >= 1 << 31 or F > 32767:
        raise ValueError(f"fleet_scan_sweep takes K < 2**31 and F <= 32767, got {K}, {F}")
    live = F * M if live_bound is None else int(live_bound)
    if live < 1:
        raise ValueError(f"live_bound must be >= 1, got {live_bound}")
    warps = _fleets_per_block(F, Q, M, crashes or capped, min(live, F * M))
    cols = FLEET64_COLS + (FAULT64_COLS if crashes or capped else 0)
    out = FleetScanOut(
        alive=torch.empty((N, F, M), dtype=torch.bool, device=dev),
        creation=torch.empty((N, F, M), dtype=f64, device=dev),
        busy=torch.empty((N, F, M), dtype=f64, device=dev),
        t=torch.empty((N,), dtype=f64, device=dev),
        acc=torch.empty((N, F, cols), dtype=f64, device=dev),
        qleft=torch.empty((N, F), dtype=f64, device=dev),
        queue=torch.empty((N, F, Q, 3), dtype=f64, device=dev) if Q else None,
        doom=torch.empty((N, F, M), dtype=f64, device=dev) if crashes else None,
    )
    ptr = lambda x: None if x is None else x.data_ptr()
    ptrs = (ctypes.c_void_p * 22)(
        t_exp.data_ptr(), limit.data_ptr(), ncl.data_ptr(), t_end.data_ptr(),
        skip.data_ptr(), stream.data_ptr(), times.data_ptr(), fids.data_ptr(),
        warms.data_ptr(), colds.data_ptr(), ptr(crash_rate if crashes else None),
        ptr(crash_u), ptr(cap_edges if capped and E else None), ptr(cap_values),
        out.alive.data_ptr(), out.creation.data_ptr(), out.busy.data_ptr(), ptr(out.doom),
        out.t.data_ptr(), out.acc.data_ptr(), out.qleft.data_ptr(), ptr(out.queue),
    )
    ints = (ctypes.c_int * 12)(
        N, F, M, K, Q, E, S, int(bool(prestamped)), int(times.dtype == f64),
        min(live, F * M), warps,
        dev.index if dev.index is not None else torch.cuda.current_device(),
    )
    err = _lib().fleet_scan_f64(ptrs, ints, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fleet_scan_sweep kernel launch failed: CUDA error {err}")
    LAUNCH_COUNTS["fleet_scan_sweep_fault" if crashes or capped else "fleet_scan_sweep"] += 1
    return out


@register_backend("scan", engines=("fleet",), f64=True)
def _scan_fleet_rows(*args, **kw) -> FleetScanOut:
    """Backend ``"scan"``'s fleet launcher (``kw`` as :func:`fleet_scan_sweep`
    takes them)."""
    return fleet_scan_sweep(*args, **kw)
