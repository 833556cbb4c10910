"""The f64 engine's concurrency-value CUDA kernel: wrapper and row
launcher (backend ``"scan"``, engine ``"par"``).

:func:`par_scan_sweep` runs the reference's f64 ``_par_scan_fn``
(``repro/core/par_simulator.py``, under ``lax.scan``; no Pallas kernel)
on the card: the kernel ``csrc/par_scan_event_step.cu`` (one warp per row,
the rows of ``finish[M, c]`` touched only on an assignment; its header says
how it is built), with the histogram, reliability and retries as runtime
flags.  For CUDA tensors
the wrapper checks its inputs, launches the kernel on the current stream
and counts the launch in ``LAUNCH_COUNTS["par_scan_sweep"]``; a failed
build or launch raises.  For CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref64.par_scan_sweep_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.execution import register_backend
from repro_torch.kernels import _build
from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS, _check_tensor
from repro_torch.kernels.ref64 import (
    ParScanOut,
    ScanLayout,
    _col,
    check_scan_inputs,
    par_scan_sweep_ref,
)
from repro_torch.kernels.scan_event_step import MAX_SLOTS


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry ``par_scan_sweep_f64``, built and loaded on first use."""
    fn = _build.load("par_scan_event_step").par_scan_sweep_f64
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def par_scan_sweep(
    arr, warms, colds, *, t_exp, t_end, skip, max_concurrency: int, concurrency: int,
    slots: int, prestamped: bool = False, hist_bins: int = 0, t_timeout=None, p_fail=None,
    fail_u=None, is_first=None, child_pos=None,
) -> ParScanOut:
    """The concurrency-value platform's f64 scan over K events from empty
    pools, as :func:`~repro_torch.kernels.ref64.par_scan_sweep_ref` defines
    it (its arguments and dtypes; ``arr`` f32 gaps or f64 timestamps).
    Returns a :class:`ParScanOut`."""
    opt = dict(hist_bins=hist_bins, t_timeout=t_timeout, p_fail=p_fail, fail_u=fail_u,
               is_first=is_first, child_pos=child_pos)
    check_scan_inputs(opt)
    if arr.dim() != 2:
        raise ValueError(f"arr must be [R, K], got shape {tuple(arr.shape)}")
    R, K = arr.shape
    M, c, H = int(slots), int(concurrency), int(hist_bins)
    dev = arr.device
    if dev.type == "cpu":
        return par_scan_sweep_ref(arr, warms, colds, t_exp=t_exp, t_end=t_end, skip=skip,
                                  max_concurrency=max_concurrency, concurrency=c, slots=M,
                                  prestamped=prestamped, **opt)
    if dev.type != "cuda":
        raise ValueError(f"par_scan_sweep runs on CUDA or CPU tensors, got {dev}")
    f64, f32 = torch.float64, torch.float32
    rely, retries = t_timeout is not None, is_first is not None
    rows = {n: _col(x, R, dev) for n, x in
            dict(t_exp=t_exp, t_end=t_end, skip=skip, t_timeout=t_timeout,
                 p_fail=p_fail).items() if x is not None}
    checks = dict(warms=(warms, f32, (R, K)), colds=(colds, f32, (R, K)),
                  arr=(arr, arr.dtype if arr.dtype in (f32, f64) else f64, (R, K)))
    checks.update({n: (x, f64, (R,)) for n, x in rows.items()})
    optional = dict(fail_u=(fail_u, f32, (R, K)), is_first=(is_first, torch.bool, (R, K)),
                    child_pos=(child_pos, torch.int32, (R, K)))
    checks.update({n: v for n, v in optional.items() if v[0] is not None})
    for name, (x, dtype, shape) in checks.items():
        _check_tensor(name, x, dev, dtype, shape)
    if R < 1 or not 1 <= M <= MAX_SLOTS or c < 1:
        raise ValueError(
            f"par_scan_sweep needs R >= 1 rows, 1 <= M <= {MAX_SLOTS} slots and c >= 1, "
            f"got R={R}, M={M}, c={c}"
        )
    if not 1 <= int(max_concurrency) < 1 << 31 or K >= 1 << 31:
        raise ValueError("max_concurrency and K must fit the kernel's int")
    lay = ScanLayout(H=H, rely=rely, par=True)
    out = ParScanOut(
        alive=torch.empty((R, M), dtype=torch.bool, device=dev),
        creation=torch.empty((R, M), dtype=f64, device=dev),
        finish=torch.empty((R, M, c), dtype=f64, device=dev),
        t=torch.empty((R,), dtype=f64, device=dev),
        acc=torch.zeros((R, lay.cols), dtype=f64, device=dev),
        act=torch.empty((R, K), dtype=torch.bool, device=dev) if retries else None,
    )
    ptr = lambda x: None if x is None else x.data_ptr()
    ptrs = (ctypes.c_void_p * 17)(
        arr.data_ptr(), warms.data_ptr(), colds.data_ptr(), ptr(fail_u), ptr(is_first),
        ptr(child_pos), rows["t_exp"].data_ptr(), rows["t_end"].data_ptr(),
        rows["skip"].data_ptr(), ptr(rows.get("t_timeout")), ptr(rows.get("p_fail")),
        out.alive.data_ptr(), out.creation.data_ptr(), out.finish.data_ptr(),
        out.t.data_ptr(), out.acc.data_ptr(), ptr(out.act),
    )
    ints = (ctypes.c_int * 12)(
        R, M, c, K, H, int(max_concurrency), int(bool(prestamped)), int(arr.dtype == f64),
        lay.rely_at, lay.hist_at, lay.cols,
        dev.index if dev.index is not None else torch.cuda.current_device(),
    )
    err = _kernel()(ptrs, ints, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"par_scan_sweep kernel launch failed: CUDA error {err}")
    LAUNCH_COUNTS["par_scan_sweep"] += 1
    return out


@register_backend("scan", engines=("par",), f64=True)
def _par_scan_rows(arr, warms, colds, **kw) -> ParScanOut:
    """Backend ``"scan"``'s par launcher."""
    return par_scan_sweep(arr, warms, colds, **kw)
