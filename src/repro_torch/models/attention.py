"""Attention: the plain PyTorch versions of the two attention kernels.

:func:`flash_attention_ref` is the port of ``repro/models/attention.py::
flash_attention_ref``, the tiled online softmax that the prefill kernel
``kernels/csrc/flash_attention.cu`` computes; :func:`decode_attention_ref`
is the port of ``decode_attention_ref``, one new query per sequence against
a KV cache, computed by ``kernels/csrc/decode_attention.cu``.  The model
calls them through :mod:`repro_torch.kernels.ops`, which picks the kernel
or the plain version.

The arithmetic is the reference's: scores in f32, scaled, soft-capped with
``tanh``, then masked with the finite ``NEG_INF`` (not ``-inf``: a tile
whose keys are all masked then gives ``p = 1`` that the next tile's
correction ``exp(NEG_INF - m) = 0`` wipes out); ``p`` is cast to v's dtype
before the P·V product, which accumulates in f32.  Unlike the reference,
sequence lengths need not be multiples of the tile: the last tile is short.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.3819763e38  # large negative for masked logits (bf16-safe)


def _mask_block(q_pos, k_pos, causal: bool, window: int, prefix_len: int):
    """Boolean [qc, kc] allow-mask for one tile."""
    q = q_pos[:, None]
    k = k_pos[None, :]
    if causal:
        allow = k <= q
    else:
        allow = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                           device=q_pos.device)
    if prefix_len > 0:
        allow = allow | ((q < prefix_len) & (k < prefix_len))
    if window > 0:
        allow = allow & (k > q - window)
    return allow


def flash_attention_ref(
    q: torch.Tensor,  # [B, S, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,  # [B, T, Hkv, D]
    *,
    causal: bool = True,
    window: int = 0,
    prefix_len: int = 0,
    softcap: float = 0.0,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D**-0.5
    q_chunk = max(1, min(q_chunk, S))
    kv_chunk = max(1, min(kv_chunk, T))
    dev = q.device
    qg = q.reshape(B, S, Hkv, G, D)

    out_chunks = []
    for q_start in range(0, S, q_chunk):
        q_end = min(q_start + q_chunk, S)
        qc = q_end - q_start
        q_pos = torch.arange(q_start, q_end, device=dev)
        q_blk = qg[:, q_start:q_end].float()  # [B, qc, Hkv, G, D]
        m = torch.full((B, Hkv, G, qc), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hkv, G, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, G, qc, D), dtype=torch.float32, device=dev)
        for k_start in range(0, T, kv_chunk):
            k_end = min(k_start + kv_chunk, T)
            # tile skipping: strictly-future tiles (unless reachable through
            # the bidirectional prefix) and out-of-window tiles
            if causal and k_start > q_end - 1 and k_start >= prefix_len:
                continue
            if window > 0 and k_end - 1 <= q_start - window:
                continue
            k_pos = torch.arange(k_start, k_end, device=dev)
            k_blk = k[:, k_start:k_end]
            v_blk = v[:, k_start:k_end]
            s = torch.einsum("bqngd,bknd->bngqk", q_blk, k_blk.float()) * scale
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            allow = _mask_block(q_pos, k_pos, causal, window, prefix_len)
            s = torch.where(allow, s, torch.tensor(NEG_INF, device=dev))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum(
                "bngqk,bknd->bngqd", p.to(v_blk.dtype).float(), v_blk.float()
            )
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-37)[..., None]
        out_chunks.append(out.to(q.dtype))  # [B, Hkv, G, qc, D]
    out = torch.cat(out_chunks, dim=3)  # [B, Hkv, G, S, D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D)


def decode_attention_ref(
    q: torch.Tensor,  # [B, Hq, D] — one new token per sequence
    k_cache: torch.Tensor,  # [B, T, Hkv, D]
    v_cache: torch.Tensor,  # [B, T, Hkv, D]
    cache_len: torch.Tensor,  # [B] valid prefix length (new token at len-1)
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, Hq, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D**-0.5
    dev = q.device
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bngd,btnd->bngt", qg, k_cache.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    t_pos = torch.arange(T, device=dev)[None, :]  # [1, T]
    lens = cache_len.to(dev).long()[:, None]
    valid = t_pos < lens
    if window > 0:
        valid = valid & (t_pos > lens - 1 - window)
    s = torch.where(valid[:, None, None, :], s, torch.tensor(NEG_INF, device=dev))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngt,btnd->bngd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, Hq, D).to(q.dtype)
