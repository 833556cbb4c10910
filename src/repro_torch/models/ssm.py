"""Mamba-2 (SSD, state-space duality) block of the port.

The port of ``repro/models/ssm.py``.  Prefill runs the chunked SSD scan
through :func:`repro_torch.kernels.ops.ssd_scan`, the hand-written CUDA
kernel ``kernels/csrc/ssd_scan.cu`` or its plain version
:func:`repro_torch.models.scans.ssd_chunked_ref`.  Decode is the one-token
recurrence :func:`ssd_decode_step`, which is no kernel in the reference
either.

Block structure: in_proj -> (z, x, B, C, dt); short causal depthwise conv
over (x, B, C) (:func:`~repro_torch.models.layers.causal_conv1d`, which the
RG-LRU block shares); SSD; gated RMSNorm; out_proj.  ``A_log``, ``D`` and
``dt_bias`` are built f32 whatever the compute dtype, as the reference
reads them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import causal_conv1d, rms_norm


def ssd_decode_step(
    state: torch.Tensor,  # [B, H, P, N]
    x_t: torch.Tensor,  # [B, H, P]
    dt_t: torch.Tensor,  # [B, H]
    A: torch.Tensor,  # [H]
    B_t: torch.Tensor,  # [B, G, N]
    C_t: torch.Tensor,  # [B, G, N]
):
    """Single-token recurrent update: O(1) per token."""
    H = x_t.shape[1]
    G = B_t.shape[1]
    hpg = H // G
    dA = torch.exp(dt_t * A[None, :])  # [B, H]
    Bh = B_t.repeat_interleave(hpg, dim=1)  # [B, H, N]
    Ch = C_t.repeat_interleave(hpg, dim=1)
    new_state = state * dA[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", x_t * dt_t[..., None], Bh
    )
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y, new_state


# ---------------------------------------------------------------------------
# Full mamba2 block
# ---------------------------------------------------------------------------


def mamba2_dims(cfg: ModelConfig):
    """(d_inner, H, G, N, P, conv_dim) of the config's Mamba-2 blocks."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, H, s.n_groups, s.d_state, s.head_dim, conv_dim


def build_mamba2_block(b, cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    d_inner, H, G, N, _, conv_dim = mamba2_dims(cfg)
    f32 = torch.float32
    return {
        "in_proj": b.param((d, 2 * d_inner + 2 * G * N + H)),
        "conv_w": b.param((s.d_conv, conv_dim), scale=0.5),
        "conv_b": b.param((conv_dim,), init="zeros"),
        "A_log": b.param((H,), init="uniform_dt", dtype=f32),
        "D": b.param((H,), init="ones", dtype=f32),
        "dt_bias": b.param((H,), init="uniform_dt", dtype=f32),
        "norm": {"scale": b.param((d_inner,), init="ones")},
        "out_proj": b.param((d_inner, d)),
    }


def _split_in_proj(zxbcdt, d_inner, G, N, H):
    z = zxbcdt[..., :d_inner]
    x = zxbcdt[..., d_inner : 2 * d_inner]
    Bm = zxbcdt[..., 2 * d_inner : 2 * d_inner + G * N]
    Cm = zxbcdt[..., 2 * d_inner + G * N : 2 * d_inner + 2 * G * N]
    dt = zxbcdt[..., 2 * d_inner + 2 * G * N :]
    return z, x, Bm, Cm, dt


def _ssm_inputs(params, dt):
    """(dt, A) in f32: softplus(dt + dt_bias) and -exp(A_log)."""
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    return dt, A


def mamba2_block(params, x, cfg: ModelConfig):
    """Prefill. x: [B, L, d] -> ([B, L, d], (final_state, conv_tail))."""
    s = cfg.ssm
    d_inner, H, G, N, P, _ = mamba2_dims(cfg)
    dtype = x.dtype
    zxbcdt = x @ params["in_proj"].to(dtype)
    z, xs, Bm, Cm, dt = _split_in_proj(zxbcdt, d_inner, G, N, H)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out = F.silu(
        causal_conv1d(conv_in, params["conv_w"].to(dtype), params["conv_b"].to(dtype))
    )
    xs = conv_out[..., :d_inner]
    Bm = conv_out[..., d_inner : d_inner + G * N]
    Cm = conv_out[..., d_inner + G * N :]
    B_, L = x.shape[0], x.shape[1]
    dt, A = _ssm_inputs(params, dt)
    xs4 = xs.reshape(B_, L, H, P).float().contiguous()
    y, state = kops.ssd_scan(
        xs4, dt, A,
        Bm.reshape(B_, L, G, N).float().contiguous(),
        Cm.reshape(B_, L, G, N).float().contiguous(),
        chunk=min(s.chunk_size, L),
    )
    y = y + xs4 * params["D"].float()[None, None, :, None]
    y = y.reshape(B_, L, d_inner).to(dtype)
    y = rms_norm(params["norm"]["scale"], y * F.silu(z), cfg.norm_eps)
    conv_tail = conv_in[:, -(s.d_conv - 1) :, :]  # raw window for decode
    return y @ params["out_proj"].to(dtype), (state, conv_tail)


def mamba2_decode(params, x_t, cfg: ModelConfig, ssm_state, conv_state):
    """Single-token decode. x_t: [B, 1, d]; conv_state: [B, K-1, conv_dim].
    Returns (out [B, 1, d], new ssm state, new conv state)."""
    d_inner, H, G, N, P, _ = mamba2_dims(cfg)
    dtype = x_t.dtype
    zxbcdt = x_t @ params["in_proj"].to(dtype)
    z, xs, Bm, Cm, dt = _split_in_proj(zxbcdt, d_inner, G, N, H)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)  # [B, 1, conv_dim]
    window = torch.cat([conv_state, conv_in], dim=1)  # [B, K, conv_dim]
    w = params["conv_w"].to(dtype)
    conv_out = F.silu(
        (window * w[None]).sum(dim=1, keepdim=True) + params["conv_b"].to(dtype)
    )
    new_conv_state = window[:, 1:]
    xs = conv_out[..., :d_inner]
    Bm = conv_out[..., d_inner : d_inner + G * N]
    Cm = conv_out[..., d_inner + G * N :]
    B_ = x_t.shape[0]
    dt, A = _ssm_inputs(params, dt[:, 0])
    x3 = xs[:, 0].reshape(B_, H, P).float()
    y, new_state = ssd_decode_step(
        ssm_state, x3, dt, A,
        Bm[:, 0].reshape(B_, G, N).float(),
        Cm[:, 0].reshape(B_, G, N).float(),
    )
    y = y + x3 * params["D"].float()[None, :, None]
    y = y.reshape(B_, 1, d_inner).to(dtype)
    y = rms_norm(params["norm"]["scale"], y * F.silu(z), cfg.norm_eps)
    return y @ params["out_proj"].to(dtype), new_state, new_conv_state
