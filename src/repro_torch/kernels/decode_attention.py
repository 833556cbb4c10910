"""The decode attention kernel: wrapper and launch count.

:func:`decode_attention` is the port of ``repro/kernels/decode_attention.py::
decode_attention_pallas``: one query token per sequence, ``q [B, Hq, D]``,
against ``k_cache, v_cache [B, T, Hkv, D]`` whose positions at and past
``cache_len [B]`` are invalid, with the options window, softcap and scale.
The kernel is ``csrc/decode_attention.cu``: a split kernel (bf16: one block
per (split, kv head x 16 of its G query heads, b), the split's share of the
valid 64-key tiles through a cp.async ring onto the tensor cores; f32: one
block per (b, kv head, split of T) of scalar FMAs), then a combine pass over
(64-column slice, query head, b) blocks; its header says what bounds it and
why it is built the way it is.  Unlike the Pallas launcher it takes any T.

For CUDA tensors the wrapper checks device, dtype, shape and contiguity,
launches on the current stream and counts the launch in
``LAUNCH_COUNTS["decode_attention"]``; for CPU tensors it runs the plain
version :func:`repro_torch.models.attention.decode_attention_ref`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS
from repro_torch.kernels.flash_attention import DTYPES, check_attention_inputs, device_index
from repro_torch.models.attention import decode_attention_ref

BK = 64  # keys per tile (csrc/decode_attention.cu)
ROWS = 16  # query rows of a bf16 split block (one mma.sync m16 tile)
# blocks to aim for when splitting T: two per SM of an H100
TARGET_BLOCKS = 264
MAX_SMEM = 232448


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry ``decode_attention_fwd``, built and loaded on first use."""
    fn = _build.load("decode_attention").decode_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def n_splits(B: int, Hkv: int, T: int, G: int = 1) -> int:
    """Splits of the T axis: enough (b, kv head, group of up to 16 of its G
    query heads, split) blocks to fill the card, at most one split per
    64-key tile."""
    n_tiles = -(-T // BK)
    want = max(1, -(-TARGET_BLOCKS // (B * Hkv * -(-G // ROWS))))
    tps = -(-n_tiles // min(n_tiles, want))
    return -(-n_tiles // tps)


def decode_attention(
    q: torch.Tensor,  # [B, Hq, D]
    k_cache: torch.Tensor,  # [B, T, Hkv, D]
    v_cache: torch.Tensor,  # [B, T, Hkv, D]
    cache_len: torch.Tensor,  # [B] int32
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of each sequence's new query over its cache; ``[B, Hq, D]``
    in q's dtype.  ``cache_len`` must be at least 1 (the new token's own
    key is at ``cache_len - 1``)."""
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError("decode_attention takes q [B, Hq, D], caches [B, T, Hkv, D]")
    B, Hq, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if tuple(x.shape) != (B, T, Hkv, D):
            raise ValueError(f"{name} must be [{B}, T, Hkv, {D}], got {tuple(x.shape)}")
    if tuple(cache_len.shape) != (B,):
        raise ValueError(f"cache_len must be [{B}], got {tuple(cache_len.shape)}")
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_ref(
            q, k_cache, v_cache, cache_len, window=window, softcap=softcap, scale=scale,
        )
    if dev.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA or CPU tensors, got {dev}")
    check_attention_inputs(
        "decode_attention", dev, dict(q=q, k_cache=k_cache, v_cache=v_cache), D, Hq, Hkv)
    if cache_len.device != dev or cache_len.dtype != torch.int32:
        raise ValueError(f"cache_len must be int32 on {dev}")
    G = Hq // Hkv
    if q.dtype == torch.float32:  # the f32 kernel holds all G query rows a block
        smem = 4 * (2 * G * D + 2 * BK * (D + 1) + G * BK + 3 * G)
        if smem > MAX_SMEM:
            raise ValueError(
                f"decode_attention holds G*D = {G * D} query values per block: "
                f"{smem} bytes of shared memory, more than {MAX_SMEM}"
            )
    elif any(x.data_ptr() % 16 for x in (q, k_cache, v_cache)):
        raise ValueError("decode_attention reads bf16 rows in 16-byte vectors: q, k_cache "
                         "and v_cache must start on a 16-byte boundary")
    if B > 65535 or Hkv * -(-G // ROWS) > 65535:
        raise ValueError("decode_attention takes B and Hkv * ceil(G / 16) up to 65535")
    scale = scale if scale is not None else D**-0.5
    nsplit = n_splits(B, Hkv, T, G)
    lens = cache_len.contiguous()
    out = torch.empty_like(q)
    scratch = torch.empty(B * Hkv * nsplit * G * (D + 2), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), B, T, Hq, Hkv, D, DTYPES[q.dtype],
        int(window), float(softcap), float(scale), nsplit, device_index(dev), stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    LAUNCH_COUNTS["decode_attention"] += 1
    return out
