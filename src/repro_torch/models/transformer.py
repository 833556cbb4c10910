"""Layer assembly of the port: mixer blocks with a dense FFN.

The port of ``repro/models/transformer.py`` for block kinds ``"attn"`` (GQA
attention), ``"local"`` (sliding-window attention over a ring cache),
``"ssm"`` (Mamba-2, no FFN) and ``"rglru"`` (Griffin's recurrent block).
The reference stacks each segment's parameters and ``lax.scan``s over them;
here a layer is a dict of tensors and the stack is a Python loop over the
layers in order, which is what eager PyTorch runs anyway.  Prefill
attention goes through :func:`repro_torch.kernels.ops.flash_attention`,
decode attention through :func:`~repro_torch.kernels.ops.decode_attention`,
the Mamba-2 and RG-LRU prefill scans through ``ops.ssd_scan`` and
``ops.rglru_scan``.  Kind ``mla`` and MoE FFNs raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import apply_rope, glu_ffn, rms_norm

LATER = "ROADMAP.md Queue A item 9b"
SERVED_KINDS = ("attn", "local", "ssm", "rglru")


def check_served(cfg: ModelConfig):
    """Raise on what the port's model stack does not serve yet."""
    kinds = {k for pattern, _ in cfg.segments for k in pattern}
    if kinds - set(SERVED_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(kinds - set(SERVED_KINDS))} are not ported "
            f"yet (the port serves {list(SERVED_KINDS)}); see {LATER}"
        )
    for what, on in (
        ("MoE FFNs", cfg.moe.n_experts > 0),
        ("MLA attention", cfg.mla is not None),
        ("multimodal prefixes", cfg.n_prefix_embeds or cfg.n_cond_embeds or cfg.prefix_len),
        ("multi-codebook audio tokens", cfg.n_codebooks > 0),
    ):
        if on:
            raise NotImplementedError(f"{cfg.name}: {what} are not ported yet; see {LATER}")


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------


def build_attention(b, cfg: ModelConfig):
    d, H, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": b.param((d, H, D)),
        "wk": b.param((d, Hkv, D)),
        "wv": b.param((d, Hkv, D)),
        "wo": b.param((H, D, d)),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": b.param((D,), init="ones")}
        p["k_norm"] = {"scale": b.param((D,), init="ones")}
    return p


def _proj(x, w):
    """x [B, S, d] @ w [d, H, D] -> [B, S, H, D], contiguous."""
    d, H, D = w.shape
    return (x @ w.to(x.dtype).reshape(d, H * D)).view(*x.shape[:-1], H, D)


def _qkv(params, x, cfg: ModelConfig, positions):
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(params["q_norm"]["scale"], q, cfg.norm_eps)
        k = rms_norm(params["k_norm"]["scale"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary)
    return q, k, v


def _out_proj(out, wo):
    """out [..., H, D] @ wo [H, D, d] -> [..., d]."""
    H, D, d = wo.shape
    return out.reshape(*out.shape[:-2], H * D) @ wo.to(out.dtype).reshape(H * D, d)


def _ref_tiles(S: int) -> int:
    """q/kv tile size of the plain flash version (the reference's choice)."""
    return max(min(S // 8, 1024), 128)


def attention_block(params, x, cfg: ModelConfig, positions, *, window=0):
    """Prefill self-attention. Returns (out, (k, v) for caching)."""
    q, k, v = _qkv(params, x, cfg, positions)
    tile = _ref_tiles(x.shape[1])
    out = kops.flash_attention(
        q, k, v, causal=True, window=window, prefix_len=cfg.prefix_len,
        softcap=cfg.attn_logit_softcap, q_chunk=tile, kv_chunk=tile,
    )
    return _out_proj(out, params["wo"]), (k, v)


def attention_decode(params, x_t, cfg: ModelConfig, cache, cache_len, *, window=0):
    """Decode one token. cache: dict(k, v) [B, T, Hkv, D], written in place
    (the reference returns new arrays; updating in place keeps one cache).
    With a window the cache is a ring: position p lives in slot p % T."""
    B = x_t.shape[0]
    positions = cache_len[:, None]  # the new token's position
    q, k_new, v_new = _qkv(params, x_t, cfg, positions)
    k_cache, v_cache = cache["k"], cache["v"]
    T = k_cache.shape[1]
    if window > 0:
        slot = (cache_len % T).long()  # ring slot
    else:
        # a full cache overwrites its last slot, as the reference does
        slot = torch.clamp(cache_len, max=T - 1).long()
    bidx = torch.arange(B, device=x_t.device)
    k_cache[bidx, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v_new[:, 0].to(v_cache.dtype)
    valid_len = torch.clamp(cache_len + 1, max=T).to(torch.int32)
    out = kops.decode_attention(
        q[:, 0].contiguous(), k_cache, v_cache, valid_len,
        window=0,  # the ring already bounds the window
        softcap=cfg.attn_logit_softcap,
    )
    return _out_proj(out, params["wo"])[:, None], {"k": k_cache, "v": v_cache}


# ---------------------------------------------------------------------------
# Layer = norm -> mixer -> residual; norm -> ffn -> residual
# ---------------------------------------------------------------------------


def _check_layer(kind: str, use_moe: bool):
    if kind not in SERVED_KINDS or use_moe:
        raise NotImplementedError(
            f"layer kind {kind!r}{' with MoE' if use_moe else ''} is not ported yet; see {LATER}"
        )


def build_layer(b, cfg: ModelConfig, kind: str, use_moe: bool):
    _check_layer(kind, use_moe)
    p = {"ln1": {"scale": b.param((cfg.d_model,), init="ones")}}
    if kind == "ssm":  # mamba2 blocks have no separate FFN
        p["mixer"] = ssm_mod.build_mamba2_block(b, cfg)
        return p
    p["ln2"] = {"scale": b.param((cfg.d_model,), init="ones")}
    if kind == "rglru":
        p["mixer"] = rglru_mod.build_recurrent_block(b, cfg)
    else:
        p["mixer"] = build_attention(b, cfg)
    ffn = {"w_up": b.param((cfg.d_model, cfg.d_ff)), "w_down": b.param((cfg.d_ff, cfg.d_model))}
    if cfg.ffn_type == "glu":
        ffn["w_gate"] = b.param((cfg.d_model, cfg.d_ff))
    p["ffn"] = ffn
    return p


def _ffn_residual(params, x, cfg: ModelConfig, kind: str):
    if kind == "ssm":
        return x
    h2 = rms_norm(params["ln2"]["scale"], x, cfg.norm_eps)
    return x + glu_ffn(params["ffn"], h2, cfg.activation)


def apply_layer(params, x, cfg: ModelConfig, kind: str, use_moe: bool, positions):
    """Prefill. Returns (x, cache_entry): (k, v) for attention, (state,
    conv_tail) for ssm, (h_last, conv_tail) for rglru."""
    _check_layer(kind, use_moe)
    h = rms_norm(params["ln1"]["scale"], x, cfg.norm_eps)
    if kind == "ssm":
        mixed, cache = ssm_mod.mamba2_block(params["mixer"], h, cfg)
    elif kind == "rglru":
        mixed, cache = rglru_mod.recurrent_block(params["mixer"], h, cfg)
    else:
        window = cfg.window if kind == "local" else 0
        mixed, cache = attention_block(params["mixer"], h, cfg, positions, window=window)
    return _ffn_residual(params, x + mixed, cfg, kind), cache


def apply_layer_decode(params, x_t, cfg, kind, use_moe, cache, cache_len):
    _check_layer(kind, use_moe)
    h = rms_norm(params["ln1"]["scale"], x_t, cfg.norm_eps)
    if kind == "ssm":
        mixed, state, conv = ssm_mod.mamba2_decode(
            params["mixer"], h, cfg, cache["state"], cache["conv"])
        new_cache = {"state": state, "conv": conv}
    elif kind == "rglru":
        mixed, (h_new, conv) = rglru_mod.recurrent_block_decode(
            params["mixer"], h, cfg, cache["h"], cache["conv"])
        new_cache = {"h": h_new, "conv": conv}
    else:
        window = cfg.window if kind == "local" else 0
        mixed, new_cache = attention_decode(params["mixer"], h, cfg, cache, cache_len,
                                            window=window)
    return _ffn_residual(params, x_t + mixed, cfg, kind), new_cache


# ---------------------------------------------------------------------------
# The layer stack
# ---------------------------------------------------------------------------


def segment_layout(cfg: ModelConfig):
    """[(pattern, count, [use_moe per elem])], MoE flags checked uniform
    across a segment's repetitions (as the reference's scan needs)."""
    out = []
    layer = 0
    for pattern, count in cfg.segments:
        flags = []
        for e, kind in enumerate(pattern):
            moes = {cfg.is_moe_layer(layer + r * len(pattern) + e) for r in range(count)}
            if len(moes) != 1:
                raise ValueError(f"{cfg.name}: MoE layers not scan-uniform in segment {pattern}")
            flags.append(moes.pop())
        out.append((pattern, count, flags))
        layer += len(pattern) * count
    return out


def layer_kinds(cfg: ModelConfig):
    """[(kind, use_moe)] of every layer, in the order the stack runs them."""
    return [
        (kind, use_moe)
        for pattern, count, flags in segment_layout(cfg)
        for _ in range(count)
        for kind, use_moe in zip(pattern, flags)
    ]


def build_blocks(b, cfg: ModelConfig):
    """One parameter dict per layer, in order."""
    return [build_layer(b, cfg, kind, use_moe) for kind, use_moe in layer_kinds(cfg)]


def apply_blocks(block_params, x, cfg: ModelConfig, positions):
    """Prefill over all layers. Returns (x, [cache entry per layer])."""
    caches = []
    for params, (kind, use_moe) in zip(block_params, layer_kinds(cfg)):
        x, cache = apply_layer(params, x, cfg, kind, use_moe, positions)
        caches.append(cache)
    return x, caches


def apply_blocks_decode(block_params, x_t, cfg: ModelConfig, caches, cache_len):
    new_caches = []
    for params, (kind, use_moe), cache in zip(block_params, layer_kinds(cfg), caches):
        x_t, nc = apply_layer_decode(params, x_t, cfg, kind, use_moe, cache, cache_len)
        new_caches.append(nc)
    return x_t, new_caches
