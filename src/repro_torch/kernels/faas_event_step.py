"""The f32 block engine's CUDA kernel: wrapper, launch count and row
launcher (backend ``"cuda"``).

:func:`faas_sweep` is the port of ``repro/kernels/faas_event_step.py::
faas_sweep_pallas`` for the base staged path, the ``prestamped`` mode, the
transient grid-curve columns (``grid_times``, the temporal engine), the
metric windows (``window_bounds``), the reliability layer (``t_timeout``,
``p_fail``, ``fail_u``), client retries (``is_first``, ``child_pos``,
with the activation plane as output ``act``), fused threefry draws
(``fused_keys``, ``fused_params``, ``fused_dists``, ``fused_k``, and
``fused_fail_keys`` with reliability: the kernel draws every sample from
per-row keys, :mod:`repro_torch.core.drawplan`) and platform faults
(``crash_rate``, ``crash_u``: instance crashes, with the crash clocks as
output ``doom``; ``cap_edges``, ``cap_values``: capacity churn).
The kernel itself is ``csrc/faas_event_step.cu`` (one warp per row, the
pool in registers; its header says what bounds it and why it is built the
way it is).  For CUDA tensors the wrapper checks device, dtype, shape and
contiguity, launches the kernel on the current stream and counts the
launch in ``LAUNCH_COUNTS`` under its path's key (:func:`launch_key`);
for CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.faas_sweep_ref`.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.core.drawplan import FUSED_DISTS
from repro_torch.core.execution import register_backend
from repro_torch.kernels import _build
from repro_torch.kernels.ref64 import check_increasing
# NEG (the dead-slot sentinel) and the acc layout are shared with the plain
# version
from repro_torch.kernels.ref import (  # noqa: F401
    ACC_COLS,
    FAULT_COLS,
    GRID_COLS,
    NEG,
    RELY_COLS,
    WINDOW_COLS,
    SweepOut,
    _rows,
    check_fault_inputs,
    faas_sweep_ref,
)

# the largest pool one warp holds in registers (32 slots per lane)
MAX_SLOTS = 1024
# the most grid points per row (csrc/faas_event_step.cu MAX_GRID)
MAX_GRID = 1024
# the most metric windows per row (csrc/faas_event_step.cu MAX_WINDOWS): the
# 5W window columns live in the row's acc in global memory and each row's
# warp zeroes them before its first event, so W is bounded only to keep
# that prologue and a row's 5W + 8 columns (1.3 MB at the cap) modest
MAX_WINDOWS = 1 << 16
# attempt positions ride in f32 (child_pos); exact up to 2^24
MAX_RETRY_EVENTS = 1 << 24
# fused draws count events in the kernel's int (the threefry counter is
# the event index)
MAX_FUSED_EVENTS = (1 << 31) - 1

# kernel launches by wrapper name, bumped once per launch and nowhere else.
# faas_sweep counts each of its paths under its own key: "faas_sweep" (the
# base scan path), "faas_sweep_grid" (grid columns, the temporal engine),
# "faas_sweep_win" (metric windows), "faas_sweep_rely" (reliability without
# retries), "faas_sweep_retry" (retries) and "faas_sweep_win_rely" /
# "faas_sweep_win_retry" (windows with either), each with "_fused" appended
# when the kernel draws its samples (e.g. "faas_sweep_fused",
# "faas_sweep_win_rely_fused") or "_fault" with platform faults
# ("faas_sweep_fault", "faas_sweep_rely_fault", "faas_sweep_retry_fault");
# beside them "par_sweep", "fleet_sweep" (and "fleet_sweep_fault"),
# "flash_attention", "decode_attention", "ssd_scan" and "rglru_scan"
LAUNCH_COUNTS: collections.Counter = collections.Counter()


def launch_key(grid: bool, windows: bool, reliability: bool, retries: bool,
               fused: bool = False, faults: bool = False) -> str:
    """The ``LAUNCH_COUNTS`` key of a faas_sweep launch with these paths."""
    if grid:
        return "faas_sweep_grid"
    tail = "_retry" if retries else "_rely" if reliability else ""
    return ("faas_sweep" + ("_win" if windows else "") + tail + ("_fused" if fused else "")
            + ("_fault" if faults else ""))


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry ``faas_sweep_f32``, built and loaded on first use."""
    fn = _build.load("faas_event_step").faas_sweep_f32
    fn.argtypes = [ctypes.c_void_p] * 35 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def faas_sweep(
    alive,  # f32 [R, M] 0/1
    creation,  # f32 [R, M]
    busy,  # f32 [R, M]
    t0,  # f32 [R]
    t_exp,  # f32 [R] per-row expiration threshold
    dts,  # f32 [R, K] inter-arrival gaps, or absolute times if prestamped
    warms,  # f32 [R, K]
    colds,  # f32 [R, K]
    *,
    t_end=float("inf"),  # f32 [R] or scalar — per-row horizon
    skip=0.0,  # f32 [R] or scalar — per-row warm-up exclusion
    max_concurrency: int,
    prestamped: bool = False,
    window_bounds=None,  # f32 [R, W+1] metric-window boundaries
    grid_times=None,  # f32 [R, G] transient-curve query times
    t_timeout=None,  # f32 [R] or scalar — execution timeout (reliability)
    p_fail=None,  # f32 [R] or scalar — failure probability (reliability)
    fail_u=None,  # f32 [R, K] per-event failure uniforms (reliability)
    is_first=None,  # f32 [R, K] 0/1 first-attempt flags (retries)
    child_pos=None,  # f32 [R, K] retry-successor positions (retries)
    fused_keys=None,  # uint32 [R, 2] x3 (arrival, warm, cold) stream keys
    fused_params=None,  # f32 [R, 2] x3 per-row (p0, p1) distribution params
    fused_fail_keys=None,  # uint32 [R, 2] failure-stream keys (reliability)
    fused_dists=None,  # 3 names of drawplan.FUSED_DISTS
    fused_k: int = 0,  # events to run with fused draws
    crash_rate=None,  # f32 [R] or scalar — crash hazard (faults)
    crash_u=None,  # f32 [R, K] per-event crash-lifetime uniforms (faults)
    cap_edges=None,  # f32 [R, E] capacity-profile step times (faults)
    cap_values=None,  # f32 [R, E+1] per-segment capacity ceilings (faults)
):
    """Run K arrivals against each row's ``[M]`` pool; returns a
    :class:`~repro_torch.kernels.ref.SweepOut`: ``(alive, creation, busy,
    t, acc)``, the activation plane ``act [R, K]`` with retries and the
    crash clocks ``doom [R, M]`` with crashes (None otherwise), as
    :func:`~repro_torch.kernels.ref.faas_sweep_ref` defines them.  (The
    reference launcher drops the doom plane; it is returned here so that
    the kernel can be held to its plain version on it.)

    Rows are independent (replica × grid cell) and ``t_exp``, ``t_end``,
    ``skip``, the window bounds, ``t_timeout`` and ``p_fail`` vary per row,
    so a whole grid over them is one launch.  The kernel runs grid columns
    alone (the temporal engine) or any of windows and reliability, with or
    without retries (the scan engine).  With fused draws (``dts``,
    ``warms``, ``colds`` and ``fail_u`` None) it draws ``fused_k`` events
    from the keys, with windows and reliability but not with retries (the
    attempt table is sorted over the whole stream) nor grid columns.
    Platform faults run alone, with reliability or with retries, on staged
    draws: not with windows, grid columns or fused draws, as in the
    reference.
    """
    if alive.dim() != 2:
        raise ValueError(f"alive must be [R, M], got shape {tuple(alive.shape)}")
    R, M = alive.shape
    dev = alive.device
    reliability = t_timeout is not None
    retries = is_first is not None
    fused = fused_dists is not None
    fail_in = fused_fail_keys if fused else fail_u
    if len({x is None for x in (t_timeout, p_fail, fail_in)}) > 1:
        raise ValueError(
            "t_timeout, p_fail and "
            + ("fused_fail_keys" if fused else "fail_u")
            + " come together (reliability)"
        )
    if (child_pos is None) != (not retries):
        raise ValueError("is_first and child_pos come together (retries)")
    if retries and not reliability:
        raise ValueError("retries need the reliability inputs t_timeout, p_fail, fail_u")
    if fused:
        _check_fused(dts, warms, colds, fail_u, fused_keys, fused_params, fused_dists,
                     fused_k, retries, grid_times, prestamped)
    elif any(x is not None for x in (fused_keys, fused_params, fused_fail_keys)):
        raise ValueError("fused_keys, fused_params and fused_fail_keys need fused_dists")
    crashes, capped = check_fault_inputs(crash_rate, crash_u, cap_edges, cap_values)
    if crashes or capped:
        _check_fault_paths(window_bounds, grid_times, fused)
    opt = dict(
        window_bounds=window_bounds, grid_times=grid_times, t_timeout=t_timeout,
        p_fail=p_fail, fail_u=fail_u, is_first=is_first, child_pos=child_pos,
        crash_rate=crash_rate, crash_u=crash_u, cap_edges=cap_edges, cap_values=cap_values,
    )
    if fused:
        opt.update(fused_keys=fused_keys, fused_params=fused_params,
                   fused_fail_keys=fused_fail_keys, fused_dists=tuple(fused_dists),
                   fused_k=int(fused_k))
    if dev.type == "cpu":
        return faas_sweep_ref(
            alive, creation, busy, t0, t_exp, dts, warms, colds,
            t_end=t_end, skip=skip, max_concurrency=max_concurrency,
            prestamped=prestamped, **opt,
        )
    if dev.type != "cuda":
        raise ValueError(f"faas_sweep runs on CUDA or CPU tensors, got {dev}")
    if fused:
        K = int(fused_k)
    else:
        K = dts.shape[1] if dts.dim() == 2 else -1
    t_exp, t_end, skip = (_rows(x, R, dev) for x in (t_exp, t_end, skip))
    shapes = dict(
        alive=(alive, (R, M)), creation=(creation, (R, M)), busy=(busy, (R, M)),
        t0=(t0, (R,)), t_exp=(t_exp, (R,)), t_end=(t_end, (R,)), skip=(skip, (R,)),
    )
    if fused:
        shapes.update({f"fused_params[{i}]": (x, (R, 2)) for i, x in enumerate(fused_params)})
    else:
        shapes.update(dts=(dts, (R, K)), warms=(warms, (R, K)), colds=(colds, (R, K)))
    G = W = 0
    if grid_times is not None:
        G = grid_times.shape[1] if grid_times.dim() == 2 else -1
        shapes["grid_times"] = (grid_times, (R, G))
    if window_bounds is not None:
        W = window_bounds.shape[1] - 1 if window_bounds.dim() == 2 else -1
        shapes["window_bounds"] = (window_bounds, (R, W + 1))
    if reliability:
        t_timeout, p_fail = _rows(t_timeout, R, dev), _rows(p_fail, R, dev)
        shapes.update(t_timeout=(t_timeout, (R,)), p_fail=(p_fail, (R,)))
        if not fused:
            shapes["fail_u"] = (fail_u, (R, K))
    if retries:
        shapes.update(is_first=(is_first, (R, K)), child_pos=(child_pos, (R, K)))
    E = 0
    if crashes:
        crash_rate = _rows(crash_rate, R, dev)
        shapes.update(crash_rate=(crash_rate, (R,)), crash_u=(crash_u, (R, K)))
    if capped:
        E = cap_values.shape[1] - 1 if cap_values.dim() == 2 else -1
        shapes.update(cap_edges=(cap_edges, (R, E)), cap_values=(cap_values, (R, E + 1)))
    keys = {}
    if fused:
        keys = {f"fused_keys[{i}]": x for i, x in enumerate(fused_keys)}
        if reliability:
            keys["fused_fail_keys"] = fused_fail_keys
    for name, x in keys.items():
        _check_tensor(name, x, dev, torch.uint32, (R, 2))
    for name, (x, shape) in shapes.items():
        _check_tensor(name, x, dev, torch.float32, shape)
    if R < 1 or not 1 <= M <= MAX_SLOTS:
        raise ValueError(
            f"faas_sweep needs R >= 1 rows and 1 <= M <= {MAX_SLOTS} slots "
            f"(one warp per row), got R={R}, M={M}"
        )
    if G > MAX_GRID:
        raise ValueError(
            f"faas_sweep takes at most {MAX_GRID} grid points per row, got {G}"
        )
    if window_bounds is not None:
        if not 1 <= W <= MAX_WINDOWS:
            raise ValueError(
                f"faas_sweep takes 1 to {MAX_WINDOWS} windows per row, got {W}"
            )
        check_increasing(window_bounds)
    if G and (W or reliability):
        raise ValueError(
            "faas_sweep runs grid columns alone (the temporal engine); "
            "windows and reliability belong to the scan engine"
        )
    if retries and K > MAX_RETRY_EVENTS:
        raise ValueError(
            f"with retries K must be <= {MAX_RETRY_EVENTS} (child_pos is exact "
            f"in f32 only up to 2^24), got K={K}"
        )
    if not 1 <= int(max_concurrency) <= 1 << 24:
        raise ValueError("max_concurrency must be in [1, 2**24] (exact in f32)")
    alive_o = torch.empty_like(alive)
    creation_o = torch.empty_like(creation)
    busy_o = torch.empty_like(busy)
    t_o = torch.empty_like(t0)
    faults = crashes or capped
    cols = (ACC_COLS + WINDOW_COLS * W + GRID_COLS * G + (RELY_COLS if reliability else 0)
            + (FAULT_COLS if faults else 0))
    acc = torch.empty((R, cols), dtype=torch.float32, device=dev)
    act = torch.empty((R, K), dtype=torch.float32, device=dev) if retries else None
    doom = torch.empty_like(alive) if crashes else None
    ptr = lambda x: None if x is None else x.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    fk = tuple(fused_keys) + (fused_fail_keys,) if fused else (None,) * 4
    fp = tuple(fused_params) if fused else (None,) * 3
    ids = [FUSED_DISTS.index(d) for d in fused_dists] if fused else [0, 0, 0]
    err = _kernel()(
        alive.data_ptr(), creation.data_ptr(), busy.data_ptr(), t0.data_ptr(),
        t_exp.data_ptr(), t_end.data_ptr(), skip.data_ptr(), ptr(dts),
        ptr(warms), ptr(colds), ptr(grid_times), ptr(window_bounds),
        ptr(t_timeout), ptr(p_fail), ptr(fail_u), ptr(is_first), ptr(child_pos),
        *(ptr(x) for x in fk), *(ptr(x) for x in fp), ptr(crash_rate if crashes else None),
        ptr(crash_u), ptr(cap_edges if capped and E else None), ptr(cap_values),
        alive_o.data_ptr(), creation_o.data_ptr(), busy_o.data_ptr(),
        t_o.data_ptr(), acc.data_ptr(), ptr(act), ptr(doom), R, M, K, G, W, E,
        int(max_concurrency), int(bool(prestamped)), *ids,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"faas_sweep kernel launch failed: CUDA error {err}")
    LAUNCH_COUNTS[launch_key(bool(G), bool(W), reliability, retries, fused, faults)] += 1
    return SweepOut(alive_o, creation_o, busy_o, t_o, acc, act, doom)


def _check_tensor(name, x, dev, dtype, shape):
    if not isinstance(x, torch.Tensor):
        raise ValueError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, alive on {dev}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {str(dtype).replace('torch.', '')}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_fault_paths(window_bounds, grid_times, fused):
    """The paths platform faults run with, on any device."""
    if fused:
        raise ValueError(
            "fused draws do not serve platform faults (the crash stream is "
            "staged); use staged draws"
        )
    if window_bounds is not None:
        raise ValueError("platform faults do not serve windowed metrics")
    if grid_times is not None:
        raise ValueError("platform faults serve the scan engine; grid columns run without them")


def _check_fused(dts, warms, colds, fail_u, keys, params, dists, k, retries, grid_times,
                 prestamped):
    """The fused inputs' structure, on any device (the tensors themselves
    are checked before a launch)."""
    if any(x is not None for x in (dts, warms, colds, fail_u)):
        raise ValueError(
            "fused draws take no staged samples: pass dts, warms, colds (and "
            "fail_u) as None with fused_dists"
        )
    if retries:
        raise ValueError(
            "fused draws do not serve retry streams (the attempt table is "
            "sorted over the whole stream); use staged draws"
        )
    if grid_times is not None:
        raise ValueError("fused draws serve the scan engine; grid columns take staged draws")
    if prestamped:
        raise ValueError("fused draws are inter-arrival gaps; prestamped must be False")
    if keys is None or params is None or len(keys) != 3 or len(params) != 3:
        raise ValueError("fused draws need fused_keys and fused_params, three each "
                         "(arrival, warm, cold)")
    if len(dists) != 3 or any(d not in FUSED_DISTS for d in dists):
        raise ValueError(
            f"fused_dists must name 3 distributions of {FUSED_DISTS}, got {tuple(dists)}"
        )
    if not 0 <= int(k) <= MAX_FUSED_EVENTS:
        raise ValueError(f"fused_k must be in [0, {MAX_FUSED_EVENTS}], got {k}")


@register_backend(
    "cuda",
    description="hand-written Hopper kernels, one warp per row (sm_90a)",
    engines=("scan", "temporal"),
    shardable=True,
)
def _cuda_sweep_rows(
    alive0, creation0, busy0, t0, t_exp, t_end, skip, dts, warms, colds, **kw,
):
    """Backend ``"cuda"``'s pool-state row launcher: the accumulator, and
    with fused draws ``(acc, t)`` for the caller's coverage guard (``kw``
    as :func:`faas_sweep` takes them; the kernel's other outputs are
    dropped, as in the reference launcher)."""
    out = faas_sweep(
        alive0, creation0, busy0, t0, t_exp, dts, warms, colds,
        t_end=t_end, skip=skip, **kw,
    )
    return (out.acc, out.t) if kw.get("fused_dists") is not None else out.acc
