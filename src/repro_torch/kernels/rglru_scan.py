"""The RG-LRU scan kernel: wrapper and launch count.

:func:`rglru_scan` is the port of ``repro/kernels/rglru_scan.py::
rglru_scan_pallas``: the linear recurrence ``h_t = a_t h_{t-1} + b_t`` over
``a, b [B, L, W]`` f32 from ``h0 [B, W]`` (zeros when None), returning
``(y [B, L, W], y[:, -1])``.  The kernel is ``csrc/rglru_scan.cu`` (one
warp per 32 channels of a batch row walking L in order, a and b streamed
through a ring of shared-memory stages by TMA, or by 4-byte ``cp.async``
where TMA refuses the row stride or a pointer; its header says what bounds
it).  :func:`launch_plan` picks the load path.  Unlike the Pallas launcher
it takes any L and W.

For CUDA tensors the wrapper checks device, dtype, shape and contiguity,
launches the kernel on the current stream and counts the launch in
``LAUNCH_COUNTS["rglru_scan"]``; for CPU tensors it runs the plain version
:func:`repro_torch.models.scans.rglru_scan_ref`, with which the kernel
agrees bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS
from repro_torch.kernels.flash_attention import device_index
from repro_torch.models.scans import rglru_scan_ref

CHANNELS_PER_WARP = 32  # csrc/rglru_scan.cu: one warp a block


class LaunchPlan(NamedTuple):
    path: str  # "tma" or "cp.async"
    grid: tuple  # (blocks over W, blocks over B)


def launch_plan(B: int, W: int, dtype: torch.dtype, a_ptr: int, b_ptr: int) -> LaunchPlan:
    """The kernel's load path and grid for a, b [B, ., W] of ``dtype`` at
    addresses ``a_ptr``, ``b_ptr``.  TMA needs a 16-byte aligned base and a
    row stride (W elements) that is a multiple of 16 bytes; anything else
    takes the kernel's 4-byte ``cp.async`` path.  One block of one warp per
    32 channels of a batch row."""
    tma = (W * dtype.itemsize) % 16 == 0 and a_ptr % 16 == 0 and b_ptr % 16 == 0
    return LaunchPlan("tma" if tma else "cp.async", (-(-W // CHANNELS_PER_WARP), B))


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry ``rglru_scan_fwd``, built and loaded on first use."""
    fn = _build.load("rglru_scan").rglru_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0=None):
    """a, b: [B, L, W] f32, h0: [B, W] f32 or None. Returns (y [B, L, W],
    y[:, -1])."""
    if a.dim() != 3 or tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"rglru_scan takes a and b [B, L, W] of one shape, got "
                         f"{list(a.shape)} and {list(b.shape)}")
    B, L, W = a.shape
    if h0 is not None and tuple(h0.shape) != (B, W):
        raise ValueError(f"h0 must be {[B, W]}, got {list(h0.shape)}")
    dev = a.device
    if dev.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if dev.type != "cuda":
        raise ValueError(f"rglru_scan runs on CUDA or CPU tensors, got {dev}")
    named = dict(a=a, b=b) if h0 is None else dict(a=a, b=b, h0=h0)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"rglru_scan takes float32 tensors, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B > 65535:
        raise ValueError("rglru_scan takes B up to 65535")
    plan = launch_plan(B, W, a.dtype, a.data_ptr(), b.data_ptr())
    y = torch.empty_like(a)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
                    y.data_ptr(), B, L, W, int(plan.path == "tma"), device_index(dev), stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error {err}")
    LAUNCH_COUNTS["rglru_scan"] += 1
    return y, y[:, -1]
