"""The prefill attention kernel: wrapper and launch count.

:func:`flash_attention` is the port of ``repro/kernels/flash_attention.py::
flash_attention_pallas``: ``q [B, S, Hq, D]`` against ``k, v [B, T, Hkv,
D]`` with the options causal, window, prefix_len, softcap and scale.  The
kernel is ``csrc/flash_attention.cu``: for bf16 one block per (b, head,
192- or 128-query tile) of three or two wgmma warpgroups fed by a TMA
producer warpgroup through a ring of K/V tiles, for f32 one block per (b,
head, 64-query tile) of scalar FMAs; its header says what bounds it and why it is built the way it is.
:func:`kernel_tiles` gives the query and key tiles each walks, the chunks
at which the plain version keeps the same running maxima.  Unlike the Pallas
launcher it takes any S and T (the ragged tiles are masked); D must be a
multiple of 32 up to 256.

For CUDA tensors the wrapper checks device, dtype, shape and contiguity,
launches the kernel on the current stream and counts the launch in
``LAUNCH_COUNTS["flash_attention"]``; for CPU tensors it runs the plain
version :func:`repro_torch.models.attention.flash_attention_ref`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS
from repro_torch.models.attention import flash_attention_ref

# csrc/*.cu dtype codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims the kernels are instantiated for (csrc/flash_attention.cu)
HEAD_DIMS = tuple(range(32, 257, 32))


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry ``flash_attention_fwd``, built and loaded on first use."""
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def kernel_tiles(D: int, dtype: torch.dtype) -> tuple:
    """(query rows, keys) of the tiles ``csrc/flash_attention.cu`` walks for
    head_dim D in ``dtype``: the ``q_chunk``/``kv_chunk`` at which
    :func:`flash_attention_ref` keeps the kernel's running maxima."""
    if dtype == torch.bfloat16:
        return (192 if D <= 64 else 128), (128 if D <= 128 else 64)
    return 64, 64


def check_attention_inputs(what: str, dev: torch.device, named: dict, D: int, Hq: int, Hkv: int):
    """The checks both attention wrappers make before a launch."""
    dtype = next(iter(named.values())).dtype
    if dtype not in DTYPES:
        raise ValueError(f"{what} takes float32 or bfloat16, got {dtype}")
    for name, x in named.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if x.dtype != dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what} takes head_dim in {HEAD_DIMS}, got {D}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{what}: Hq={Hq} must be a multiple of Hkv={Hkv}")


def device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def flash_attention(
    q: torch.Tensor,  # [B, S, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,  # [B, T, Hkv, D]
    *,
    causal: bool = True,
    window: int = 0,
    prefix_len: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Attention of every query row over its keys; ``[B, S, Hq, D]`` in q's
    dtype.  ``q_chunk``/``kv_chunk`` tile the plain version only."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q [B, S, Hq, D], k and v [B, T, Hkv, D]")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, T, Hkv, D) or tuple(v.shape) != (B, T, Hkv, D):
        raise ValueError(
            f"k and v must be [B, T, Hkv, D] = [{B}, T, Hkv, {D}], got "
            f"{tuple(k.shape)} and {tuple(v.shape)}"
        )
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(
            q, k, v, causal=causal, window=window, prefix_len=prefix_len,
            softcap=softcap, q_chunk=q_chunk, kv_chunk=kv_chunk, scale=scale,
        )
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {dev}")
    check_attention_inputs("flash_attention", dev, dict(q=q, k=k, v=v), D, Hq, Hkv)
    if B > 65535 or Hq > 65535:
        raise ValueError("flash_attention takes B and Hq up to 65535")
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention reads bf16 rows in 16-byte vectors: q, k and v "
                         "must start on a 16-byte boundary")
    scale = scale if scale is not None else D**-0.5
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T, Hq,
        Hkv, D, DTYPES[q.dtype], int(bool(causal)), int(window), int(prefix_len),
        float(softcap), float(scale), device_index(dev), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    LAUNCH_COUNTS["flash_attention"] += 1
    return out
