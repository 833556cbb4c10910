"""The f32 block engine's CUDA kernel: wrapper, launch count and row
launcher (backend ``"cuda"``).

:func:`faas_sweep` is the port of ``repro/kernels/faas_event_step.py::
faas_sweep_pallas`` for the base staged path, the ``prestamped`` mode and
the transient grid-curve columns (``grid_times``, the temporal engine).
The kernel itself is ``csrc/faas_event_step.cu`` (one warp per row, the
pool in registers; its header says what bounds it and why it is built the
way it is).  For CUDA tensors the wrapper checks device, dtype, shape and
contiguity, launches the kernel on the current stream and counts the
launch in ``LAUNCH_COUNTS["faas_sweep"]`` (``"faas_sweep_grid"`` for a
launch with grid columns); for CPU tensors it runs the
plain version :func:`repro_torch.kernels.ref.faas_sweep_ref`.

The reference kernel's other optional layers (metric windows,
reliability, retries, fused draws, platform faults) are later slices, in
the order ROADMAP Queue B gives; the wrapper refuses them.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.core.execution import register_backend
from repro_torch.kernels import _build
# NEG (the dead-slot sentinel) and ACC_COLS are shared with the plain version
from repro_torch.kernels.ref import ACC_COLS, NEG, _rows, faas_sweep_ref  # noqa: F401

# windowed columns per window: cold, served, arrivals, ∫running, ∫idle
WINDOW_COLS = 5
# transient-curve columns per grid point: running, idle, no_idle indicator
GRID_COLS = 3
# reliability columns: timeout, fail, retry, abandon
RELY_COLS = 4
# platform-fault columns: crashes, evictions, interrupted attempts
FAULT_COLS = 3
# the largest pool one warp holds in registers (32 slots per lane)
MAX_SLOTS = 1024
# the most grid points per row (csrc/faas_event_step.cu MAX_GRID)
MAX_GRID = 1024

# kernel launches by wrapper name ("faas_sweep", "faas_sweep_grid" for a
# launch with grid columns, "par_sweep", "fleet_sweep"): bumped once per
# launch, nowhere else
LAUNCH_COUNTS: collections.Counter = collections.Counter()

_LATER = {
    "window_bounds": "metric windows",
    "t_timeout": "reliability",
    "p_fail": "reliability",
    "fail_u": "reliability",
    "is_first": "retries",
    "child_pos": "retries",
    "fused_keys": "fused threefry draws",
    "fused_params": "fused threefry draws",
    "fused_fail_keys": "fused threefry draws",
    "crash_rate": "platform faults",
    "crash_u": "platform faults",
    "cap_edges": "platform faults",
    "cap_values": "platform faults",
}


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry ``faas_sweep_f32``, built and loaded on first use."""
    fn = _build.load("faas_event_step").faas_sweep_f32
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
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
    grid_times=None,  # f32 [R, G] transient-curve query times
    **later,
):
    """Run K arrivals against each row's ``[M]`` pool; returns
    ``(alive, creation, busy, t, acc[R, 8 + 3G])`` as
    :func:`~repro_torch.kernels.ref.faas_sweep_ref` defines them.

    Rows are independent (replica × grid cell) and ``t_exp``, ``t_end``,
    ``skip`` vary per row, so a whole threshold × rate × horizon grid is
    one launch.  ``later`` names the reference kernel's optional inputs,
    which raise ``NotImplementedError`` when given.
    """
    for name, value in later.items():
        if name not in _LATER:
            raise TypeError(f"faas_sweep() got an unexpected keyword {name!r}")
        if value is not None:
            raise NotImplementedError(
                f"faas_sweep: {name}= ({_LATER[name]}) is not ported yet; "
                "see ROADMAP.md Queue B item 1"
            )
    if alive.dim() != 2:
        raise ValueError(f"alive must be [R, M], got shape {tuple(alive.shape)}")
    R, M = alive.shape
    dev = alive.device
    if dev.type == "cpu":
        return faas_sweep_ref(
            alive, creation, busy, t0, t_exp, dts, warms, colds,
            t_end=t_end, skip=skip, max_concurrency=max_concurrency,
            prestamped=prestamped, grid_times=grid_times,
        )
    if dev.type != "cuda":
        raise ValueError(f"faas_sweep runs on CUDA or CPU tensors, got {dev}")
    K = dts.shape[1] if dts.dim() == 2 else -1
    t_exp, t_end, skip = (_rows(x, R, dev) for x in (t_exp, t_end, skip))
    shapes = dict(
        alive=(alive, (R, M)), creation=(creation, (R, M)), busy=(busy, (R, M)),
        t0=(t0, (R,)), t_exp=(t_exp, (R,)), t_end=(t_end, (R,)),
        skip=(skip, (R,)), dts=(dts, (R, K)), warms=(warms, (R, K)),
        colds=(colds, (R, K)),
    )
    G = 0
    if grid_times is not None:
        G = grid_times.shape[1] if grid_times.dim() == 2 else -1
        shapes["grid_times"] = (grid_times, (R, G))
    for name, (x, shape) in shapes.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, alive on {dev}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if R < 1 or not 1 <= M <= MAX_SLOTS:
        raise ValueError(
            f"faas_sweep needs R >= 1 rows and 1 <= M <= {MAX_SLOTS} slots "
            f"(one warp per row), got R={R}, M={M}"
        )
    if G > MAX_GRID:
        raise ValueError(
            f"faas_sweep takes at most {MAX_GRID} grid points per row, got {G}"
        )
    if not 1 <= int(max_concurrency) <= 1 << 24:
        raise ValueError("max_concurrency must be in [1, 2**24] (exact in f32)")
    alive_o = torch.empty_like(alive)
    creation_o = torch.empty_like(creation)
    busy_o = torch.empty_like(busy)
    t_o = torch.empty_like(t0)
    acc = torch.empty((R, ACC_COLS + GRID_COLS * G), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(
        alive.data_ptr(), creation.data_ptr(), busy.data_ptr(), t0.data_ptr(),
        t_exp.data_ptr(), t_end.data_ptr(), skip.data_ptr(), dts.data_ptr(),
        warms.data_ptr(), colds.data_ptr(), grid_times.data_ptr() if G else None,
        alive_o.data_ptr(), creation_o.data_ptr(), busy_o.data_ptr(),
        t_o.data_ptr(), acc.data_ptr(), R, M, K, G, int(max_concurrency),
        int(bool(prestamped)),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"faas_sweep kernel launch failed: CUDA error {err}")
    # launches with grid columns (the temporal path) count apart
    LAUNCH_COUNTS["faas_sweep_grid" if G else "faas_sweep"] += 1
    return alive_o, creation_o, busy_o, t_o, acc


@register_backend(
    "cuda",
    description="hand-written Hopper kernels, one warp per row (sm_90a)",
    engines=("scan", "temporal"),
)
def _cuda_sweep_rows(
    alive0, creation0, busy0, t0, t_exp, t_end, skip, dts, warms, colds,
    *, max_concurrency, prestamped, grid_times=None,
):
    """Backend ``"cuda"``'s pool-state row launcher: the ``[C, 8 + 3G]``
    accumulator."""
    return faas_sweep(
        alive0, creation0, busy0, t0, t_exp, dts, warms, colds,
        t_end=t_end, skip=skip, max_concurrency=max_concurrency,
        prestamped=prestamped, grid_times=grid_times,
    )[4]
