"""Shared blocks of the port: RMSNorm, rotary embeddings, GLU FFNs, the
short causal convolution of the recurrent blocks, embedding and unembedding
(``repro/models/layers.py`` without its sharding annotations, which have no
counterpart on one GPU; ``causal_conv1d`` is ``repro/models/ssm.py``'s)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: statistics in f32, application in the compute dtype (as the
    reference, so that no f32 ``[tokens, d_model]`` activation is made)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, partial: float = 1.0, device=None):
    rot_dim = int(head_dim * partial) // 2 * 2
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / max(rot_dim, 1)
    inv_freq = 1.0 / (theta ** exponent)
    return inv_freq, rot_dim


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, partial: float = 1.0):
    """x: [..., seq, heads, head_dim]; positions: [..., seq].

    Rotates **interleaved pairs** ``(x[..., 2i], x[..., 2i+1])``, as the
    reference does, not the half-split of Hugging Face's checkpoints."""
    head_dim = x.shape[-1]
    inv_freq, rot_dim = rope_frequencies(head_dim, theta, partial, x.device)
    if rot_dim == 0:
        return x
    angles = positions[..., :, None].float() * inv_freq  # [..., S, rd/2]
    angles = angles[..., None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot[..., ::2], x_rot[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def glu_ffn(params, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    dtype = x.dtype
    act = F.silu if activation == "silu" else gelu_tanh
    up = x @ params["w_up"].to(dtype)
    if "w_gate" in params:  # GLU variant (SwiGLU / GeGLU)
        h = act(x @ params["w_gate"].to(dtype)) * up
    else:  # plain 2-layer MLP
        h = act(up)
    return h @ params["w_down"].to(dtype)


def causal_conv1d(x, w, b):
    """Depthwise causal conv: x [B, L, C], w [K, C] -> [B, L, C]; the K taps
    summed in the reference's order, each product and sum rounded to x's
    dtype."""
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):  # K is tiny (4)
        out = out + pad[:, i : i + x.shape[1]] * w[i]
    return out + b


def embed(params, tokens: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    return params["table"].to(compute_dtype)[tokens]


def unembed(params, x: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    logits = (x @ params["table"].to(x.dtype).T).float()
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def linear_head(params, x: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    logits = (x @ params["w"].to(x.dtype)).float()
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
