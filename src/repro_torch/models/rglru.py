"""RG-LRU recurrent block of the port (Griffin / RecurrentGemma,
arXiv:2402.19427).

The port of ``repro/models/rglru.py``.  Per channel:

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    a_t = a^(c * r_t),  a = sigmoid(Lambda) (learned decay, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the linear recurrence ``h = a*h + b`` through
:func:`repro_torch.kernels.ops.rglru_scan`, the hand-written CUDA kernel
``kernels/csrc/rglru_scan.cu`` or its plain version
:func:`repro_torch.models.scans.rglru_scan_ref`; decode is the single step
:func:`rglru_step`.  The recurrent block wraps the RG-LRU in the Griffin
layout: linear in, short causal depthwise conv, gated branch, linear out.
The gate weights and biases and ``lambda_p`` are built f32 whatever the
compute dtype: the gates are computed in f32, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import causal_conv1d, gelu_tanh


def rglru_step(a_t, b_t, h_prev):
    """Single decode step."""
    h = a_t * h_prev + b_t
    return h, h


def _gates(params, x, c_constant):
    """Compute (a, gated_input) in f32. x: [B, L, W]."""
    xf = x.float()
    r = torch.sigmoid(xf @ params["w_a"].float() + params["b_a"])
    i = torch.sigmoid(xf @ params["w_x"].float() + params["b_x"])
    log_a = -c_constant * F.softplus(params["lambda_p"]) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) in a numerically safe form
    multiplier = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, multiplier * i * xf


def build_rglru(b, cfg: ModelConfig):
    w = cfg.rglru.lru_width or cfg.d_model
    f32 = torch.float32
    return {
        "w_a": b.param((w, w), scale=0.02, dtype=f32),
        "b_a": b.param((w,), init="zeros", dtype=f32),
        "w_x": b.param((w, w), scale=0.02, dtype=f32),
        "b_x": b.param((w,), init="zeros", dtype=f32),
        "lambda_p": b.param((w,), init="uniform_dt", dtype=f32),
    }


def rglru(params, x, cfg: ModelConfig, h0=None):
    a, bb = _gates(params, x, cfg.rglru.c_constant)
    h, h_last = kops.rglru_scan(a, bb, h0)
    return h.to(x.dtype), h_last


def rglru_decode(params, x_t, cfg: ModelConfig, h_prev):
    """x_t: [B, 1, W]; h_prev: [B, W] (f32)."""
    a, bb = _gates(params, x_t, cfg.rglru.c_constant)
    h, _ = rglru_step(a[:, 0], bb[:, 0], h_prev)
    return h[:, None, :].to(x_t.dtype), h


# ---------------------------------------------------------------------------
# Griffin recurrent block (linear -> conv -> RG-LRU, gated, linear out)
# ---------------------------------------------------------------------------


def build_recurrent_block(b, cfg: ModelConfig):
    d = cfg.d_model
    w = cfg.rglru.lru_width or d
    return {
        "in_proj": b.param((d, w)),
        "gate_proj": b.param((d, w)),
        "conv_w": b.param((cfg.rglru.d_conv, w), scale=0.5),
        "conv_b": b.param((w,), init="zeros"),
        "lru": build_rglru(b, cfg),
        "out_proj": b.param((w, d)),
    }


def recurrent_block(params, x, cfg: ModelConfig):
    """Prefill. x: [B, L, d] -> ([B, L, d], (h_last, conv_tail))."""
    dtype = x.dtype
    u_raw = x @ params["in_proj"].to(dtype)
    gate = gelu_tanh(x @ params["gate_proj"].to(dtype))
    u = causal_conv1d(u_raw, params["conv_w"].to(dtype), params["conv_b"].to(dtype))
    h, h_last = rglru(params["lru"], u, cfg)
    y = (h * gate) @ params["out_proj"].to(dtype)
    conv_tail = u_raw[:, -(cfg.rglru.d_conv - 1) :, :]  # raw conv window for decode
    return y, (h_last, conv_tail)


def recurrent_block_decode(params, x_t, cfg: ModelConfig, h_prev, conv_state):
    """Decode one token. conv_state: [B, K-1, W] raw in_proj outputs.
    Returns (out [B, 1, d], (h [B, W] f32, new conv state))."""
    dtype = x_t.dtype
    u_t = x_t @ params["in_proj"].to(dtype)  # [B, 1, W]
    gate = gelu_tanh(x_t @ params["gate_proj"].to(dtype))
    window = torch.cat([conv_state, u_t], dim=1)  # [B, K, W]
    w = params["conv_w"].to(dtype)
    u = (window * w[None]).sum(dim=1, keepdim=True) + params["conv_b"].to(dtype)
    new_conv_state = window[:, 1:]
    h, h_new = rglru_decode(params["lru"], u, cfg, h_prev)
    y = (h * gate) @ params["out_proj"].to(dtype)
    return y, (h_new, new_conv_state)
