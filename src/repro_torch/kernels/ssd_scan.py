"""The Mamba-2 SSD scan kernel: wrapper and launch count.

:func:`ssd_scan` is the port of ``repro/kernels/ssd_scan.py::
ssd_scan_pallas``: the chunked SSD of ``x [B, L, H, P]`` with step sizes
``dt [B, L, H]``, decay rates ``A [H]`` and per-group ``Bm, Cm [B, L, G,
N]``, returning ``y [B, L, H, P]`` and the final state ``[B, H, P, N]``,
all f32.  The kernel is ``csrc/ssd_scan.cu`` (one block per (b, head, 32
head-dimension columns) looping over 64-token chunks with the state slice
in shared memory, the scores C Bᵀ shared by the group's blocks in a thread
block cluster; its header says what bounds it and why it is built the way
it is).  Unlike the Pallas launcher it folds ``x * dt`` and ``dt * A``
itself, reads B and C per group instead of broadcast to heads, and takes
any L.

For CUDA tensors the wrapper checks device, dtype, shape and contiguity,
launches the kernel on the current stream and counts the launch in
``LAUNCH_COUNTS["ssd_scan"]``; for CPU tensors it runs the plain version
:func:`repro_torch.models.scans.ssd_chunked_ref` at ``chunk`` (the kernel's
own chunk is 64 whatever ``chunk`` says; the two differ by rounding only).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS
from repro_torch.kernels.flash_attention import device_index
from repro_torch.models.scans import ssd_chunked_ref

# head dims and state sizes the kernel is instantiated for (csrc/ssd_scan.cu)
HEAD_DIMS = (32, 64, 128)
STATE_DIMS = (16, 32, 64, 128)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry ``ssd_scan_fwd``, built and loaded on first use."""
    fn = _build.load("ssd_scan").ssd_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_scan(
    x: torch.Tensor,  # [B, L, H, P]
    dt: torch.Tensor,  # [B, L, H]
    A: torch.Tensor,  # [H]
    Bm: torch.Tensor,  # [B, L, G, N]
    Cm: torch.Tensor,  # [B, L, G, N]
    *,
    chunk: int = 256,
):
    """Returns (y [B, L, H, P], final_state [B, H, P, N]), f32."""
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError("ssd_scan takes x [B, L, H, P], dt [B, L, H], A [H], "
                         "Bm and Cm [B, L, G, N]")
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    shapes = dict(dt=(B, L, H), A=(H,), Bm=(B, L, G, N), Cm=(B, L, G, N))
    for (name, want), t in zip(shapes.items(), (dt, A, Bm, Cm)):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {list(want)}, got {list(t.shape)}")
    if G < 1 or H % G:
        raise ValueError(f"ssd_scan: H={H} must be a multiple of G={G}")
    dev = x.device
    if dev.type == "cpu":
        return ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA or CPU tensors, got {dev}")
    for name, t in dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm).items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_scan takes float32 tensors, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"ssd_scan takes head_dim P in {HEAD_DIMS} and state size N in "
                         f"{STATE_DIMS}, got P={P}, N={N}")
    if B > 65535:
        raise ValueError("ssd_scan takes B up to 65535")
    # the kernel reads x, B and C 16 bytes at a time: a view that starts off
    # that alignment is copied
    x, Bm, Cm = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, Bm, Cm))
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), state.data_ptr(), B, L, H, G, P, N, device_index(dev), stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    LAUNCH_COUNTS["ssd_scan"] += 1
    return y, state
