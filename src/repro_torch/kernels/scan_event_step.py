"""The f64 engine's pool-scan CUDA kernel: wrapper, launch count and row
launcher (backend ``"scan"``, engines ``"scan"`` and ``"temporal"``).

:func:`scan_sweep` runs the reference's f64 ``lax.scan`` step
(``repro/core/simulator.py::_make_scan_fn`` with ``_flush``; no Pallas
kernel) on the card: the kernel ``csrc/scan_event_step.cu`` (one warp per
row, the pool in registers, integrals accrued per state span, an exit
bound and an inert tail past the horizon; its header says how it is
built), with every path of the plain version
:func:`repro_torch.kernels.ref64.scan_sweep_ref`.  For CUDA tensors the wrapper checks device, dtype,
shape and contiguity, launches the kernel on the current stream and counts
the launch in ``LAUNCH_COUNTS["scan_sweep"]`` (``["scan_sweep_fused"]``
with fused draws); a failed build or launch raises.  For CPU tensors it
runs the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import drawplan as dp
from repro_torch.core.execution import register_backend
from repro_torch.kernels import _build
from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS, _check_tensor
from repro_torch.kernels.ref64 import (
    ScanLayout,
    ScanOut,
    _col,
    check_scan_inputs,
    scan_sweep_ref,
)

# slots a row: 16 a lane in registers (csrc/scan_event_step.cu)
MAX_SLOTS = 512


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry ``scan_sweep_f64``, built and loaded on first use."""
    fn = _build.load("scan_event_step").scan_sweep_f64
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def scan_sweep(
    alive, creation, busy, arr, warms, colds, *, t_exp, t_end, skip, max_concurrency: int,
    prestamped: bool = False, routing: str = "newest", doom=None, hist_bins: int = 0,
    window_bounds=None, grid_times=None, t_timeout=None, p_fail=None, fail_u=None,
    is_first=None, child_pos=None, crash_rate=None, crash_u=None, cap_edges=None,
    cap_values=None, fused_keys=None, fused_params=None, fused_dists=None, fused_k=None,
    fused_fail_keys=None, fused_profile=None,
) -> ScanOut:
    """Run K events against each row's ``[M]`` pool and flush the tail, as
    :func:`~repro_torch.kernels.ref64.scan_sweep_ref` defines it (the
    arguments are its own): ``alive`` bool, ``creation``/``busy``/``doom``
    f64 ``[R, M]``; ``arr`` f32 gaps or f64 timestamps, ``warms``,
    ``colds``, ``fail_u``, ``crash_u`` f32, ``is_first`` bool and
    ``child_pos`` int32 ``[R, K]``; per-row values f64 (scalars
    broadcast); ``window_bounds``, ``grid_times``, ``cap_edges``,
    ``cap_values`` f64 matrices.  With fused draws ``arr``, ``warms`` and
    ``colds`` are None and ``fused_keys`` (3 uint32 ``[R, 2]``),
    ``fused_params`` (3 f64 ``[R, 2]``), ``fused_dists``, ``fused_k``,
    ``fused_fail_keys`` (reliability) and ``fused_profile`` (a profile block,
    a tuple of floats, NHPP: :meth:`~repro_torch.core.processes.RateProfile.
    block`) stand for them.  Returns a :class:`ScanOut`."""
    opt = dict(
        routing=routing, doom=doom, hist_bins=hist_bins, window_bounds=window_bounds,
        grid_times=grid_times, t_timeout=t_timeout, p_fail=p_fail, fail_u=fail_u,
        is_first=is_first, child_pos=child_pos, crash_rate=crash_rate, crash_u=crash_u,
        cap_edges=cap_edges, cap_values=cap_values, fused_keys=fused_keys,
        fused_params=fused_params, fused_dists=fused_dists, fused_k=fused_k,
        fused_fail_keys=fused_fail_keys, fused_profile=fused_profile,
    )
    check_scan_inputs(dict(opt, arr=arr, prestamped=prestamped))
    fused = fused_keys is not None
    if alive.dim() != 2 or (not fused and arr.dim() != 2):
        raise ValueError(
            f"alive must be [R, M] and arr [R, K], got {tuple(alive.shape)}, "
            f"{None if arr is None else tuple(arr.shape)}"
        )
    R, M = alive.shape
    K = int(fused_k) if fused else arr.shape[1]
    dev = alive.device
    if dev.type == "cpu":
        return scan_sweep_ref(alive, creation, busy, arr, warms, colds, t_exp=t_exp,
                              t_end=t_end, skip=skip, max_concurrency=max_concurrency,
                              prestamped=prestamped, **opt)
    if dev.type != "cuda":
        raise ValueError(f"scan_sweep runs on CUDA or CPU tensors, got {dev}")
    f64, f32 = torch.float64, torch.float32
    rely, retries = t_timeout is not None, is_first is not None
    crashes, capped = crash_u is not None, cap_values is not None
    W = 0 if window_bounds is None else window_bounds.shape[1] - 1
    G = 0 if grid_times is None else grid_times.shape[1]
    H = int(hist_bins)
    E = 0 if cap_edges is None else cap_edges.shape[1]
    rows = {n: _col(x, R, dev) for n, x in
            dict(t_exp=t_exp, t_end=t_end, skip=skip, t_timeout=t_timeout, p_fail=p_fail,
                 crash_rate=crash_rate).items() if x is not None}
    checks = dict(
        alive=(alive, torch.bool, (R, M)), creation=(creation, f64, (R, M)),
        busy=(busy, f64, (R, M)),
    )
    if fused:
        names = ("arrival", "warm", "cold")
        for i, n in enumerate(names):
            checks[f"fused_keys[{n}]"] = (fused_keys[i], torch.uint32, (R, 2))
            checks[f"fused_params[{n}]"] = (fused_params[i], f64, (R, 2))
        if fused_fail_keys is not None:
            checks["fused_fail_keys"] = (fused_fail_keys, torch.uint32, (R, 2))

    else:
        checks.update(
            warms=(warms, f32, (R, K)), colds=(colds, f32, (R, K)),
            arr=(arr, arr.dtype if arr.dtype in (f32, f64) else f64, (R, K)),
        )
    checks.update({n: (x, f64, (R,)) for n, x in rows.items()})
    optional = dict(
        doom=(doom, f64, (R, M)), fail_u=(fail_u, f32, (R, K)),
        is_first=(is_first, torch.bool, (R, K)), child_pos=(child_pos, torch.int32, (R, K)),
        crash_u=(crash_u, f32, (R, K)), window_bounds=(window_bounds, f64, (R, W + 1)),
        grid_times=(grid_times, f64, (R, G)), cap_edges=(cap_edges, f64, (R, E)),
        cap_values=(cap_values, f64, (R, E + 1)),
    )
    checks.update({n: v for n, v in optional.items() if v[0] is not None})
    for name, (x, dtype, shape) in checks.items():
        _check_tensor(name, x, dev, dtype, shape)
    if R < 1 or not 1 <= M <= MAX_SLOTS:
        raise ValueError(
            f"scan_sweep needs R >= 1 rows and 1 <= M <= {MAX_SLOTS} slots (one "
            f"warp per row), got R={R}, M={M}"
        )
    if window_bounds is not None and W < 1:
        raise ValueError("window_bounds needs at least 2 bounds a row")
    if not 1 <= int(max_concurrency) < 1 << 31 or K >= 1 << 31:
        raise ValueError("max_concurrency and K must fit the kernel's int")
    lay = ScanLayout(W=W, H=H, G=G, rely=rely, faults=crashes or capped)
    out = ScanOut(
        alive=torch.empty((R, M), dtype=torch.bool, device=dev),
        creation=torch.empty((R, M), dtype=f64, device=dev),
        busy=torch.empty((R, M), dtype=f64, device=dev),
        t=torch.empty((R,), dtype=f64, device=dev),
        acc=torch.zeros((R, lay.cols), dtype=f64, device=dev),
        act=torch.empty((R, K), dtype=torch.bool, device=dev) if retries else None,
        doom=torch.empty((R, M), dtype=f64, device=dev) if crashes else None,
    )
    ptr = lambda x: None if x is None else x.data_ptr()
    keys = tuple(fused_keys) + (fused_fail_keys,) if fused else (None,) * 4
    if fused_profile is not None:
        fused_profile = torch.tensor([float(x) for x in fused_profile], dtype=f64, device=dev)
    params = tuple(fused_params) if fused else (None,) * 3
    dists = ([dp.FUSED_DISTS.index("exp" if d == dp.NHPP else d) for d in fused_dists]
             if fused else [0, 0, 0])
    ptrs = (ctypes.c_void_p * 36)(
        alive.data_ptr(), creation.data_ptr(), busy.data_ptr(), ptr(doom), ptr(arr),
        ptr(warms), ptr(colds), ptr(fail_u), ptr(is_first), ptr(child_pos),
        ptr(crash_u), rows["t_exp"].data_ptr(), rows["t_end"].data_ptr(),
        rows["skip"].data_ptr(), ptr(rows.get("t_timeout")), ptr(rows.get("p_fail")),
        ptr(rows.get("crash_rate")), ptr(window_bounds), ptr(grid_times), ptr(cap_edges),
        ptr(cap_values), out.alive.data_ptr(), out.creation.data_ptr(),
        out.busy.data_ptr(), ptr(out.doom), out.t.data_ptr(), out.acc.data_ptr(),
        ptr(out.act), *(ptr(k) for k in keys), *(ptr(p) for p in params), ptr(fused_profile),
    )
    ints = (ctypes.c_int * 21)(
        R, M, K, W, H, G, E, int(max_concurrency), int(bool(prestamped)),
        int(not fused and arr.dtype == f64), int(routing == "oldest"), lay.rely_at,
        lay.fault_at, lay.win_at, lay.hist_at, lay.grid_at, lay.cols,
        dev.index if dev.index is not None else torch.cuda.current_device(), *dists,
    )
    err = _kernel()(ptrs, ints, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scan_sweep kernel launch failed: CUDA error {err}")
    LAUNCH_COUNTS["scan_sweep_fused" if fused else "scan_sweep"] += 1
    return out


@register_backend(
    "scan",
    description="hand-written f64 Hopper kernels of the reference's scan (sm_90a)",
    engines=("scan", "temporal"),
    f64=True,
    shardable=True,
)
def _scan_rows(alive0, creation0, busy0, arr, warms, colds, **kw) -> ScanOut:
    """Backend ``"scan"``'s pool-state launcher (``kw`` as
    :func:`scan_sweep` takes them)."""
    return scan_sweep(alive0, creation0, busy0, arr, warms, colds, **kw)
