"""The port's model handle: parameters, prefill and greedy-decode steps.

The port of ``repro/models/model.py`` for the serving path of plain
language models (token ids in, logits out): :func:`build_params`,
:func:`prefill`, :func:`decode_step`, :func:`build_cache` and
:func:`_prefill_to_decode_cache`, and :class:`BuiltModel`, an
``nn.Module`` that holds the parameters on an explicit device.  The
parameters live in the compute dtype (the reference keeps f32 parameters
and casts them at every use; the cast is the same round-to-nearest-even,
so the values are the same).  The training loss and the multi-token
prediction head come with the training slice (ROADMAP Queue A item 9b).

Parameters are nested dicts of tensors: ``embed.table [V, d]`` (and
``head.w [d, V]`` when untied), ``blocks`` a list with one dict per layer
(``ln1``, ``ln2``, ``mixer.wq [d, H, D]``, ``wk/wv [d, Hkv, D]``, ``wo [H,
D, d]``, ``ffn.w_up/w_gate [d, ff]``, ``w_down [ff, d]``) and
``final_norm.scale``.  Caches are a list with one ``{"k", "v"}`` dict of
``[B, T, Hkv, D]`` tensors per layer.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import embed, linear_head, rms_norm, unembed
from repro_torch.models.param import ParamBuilder


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def build_params(b: ParamBuilder, cfg: ModelConfig) -> dict:
    tf.check_served(cfg)
    p: dict[str, Any] = {
        "embed": {"table": b.param((cfg.vocab_size, cfg.d_model), init="embed")}
    }
    if not cfg.tie_embeddings:
        p["head"] = {"w": b.param((cfg.d_model, cfg.vocab_size))}
    p["blocks"] = tf.build_blocks(b, cfg)
    p["final_norm"] = {"scale": b.param((cfg.d_model,), init="ones")}
    return p


def _logits(params, h, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return unembed(params["embed"], h, cfg.logit_softcap)
    return linear_head(params["head"], h, cfg.logit_softcap)


def _embed_tokens(params, tokens, cfg: ModelConfig):
    x = embed(params["embed"], tokens, dtype_of(cfg.compute_dtype))
    if cfg.embedding_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def build_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> list:
    """Zeroed decode caches, one ``{"k", "v"}`` per layer."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cdt = dtype_of(cfg.compute_dtype)
    return [
        {"k": torch.zeros(shape, dtype=cdt, device=device),
         "v": torch.zeros(shape, dtype=cdt, device=device)}
        for _ in tf.layer_kinds(cfg)
    ]


def _prefill_to_decode_cache(prefill_caches, cfg: ModelConfig, max_len: int) -> list:
    """Pad each layer's prefill ``(k, v) [B, S, Hkv, D]`` to ``max_len``."""
    cdt = dtype_of(cfg.compute_dtype)
    out = []
    for k, v in prefill_caches:
        B, S, Hkv, D = k.shape
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens does not fit max_len={max_len}")
        entry = {}
        for name, x in (("k", k), ("v", v)):
            buf = torch.zeros((B, max_len, Hkv, D), dtype=cdt, device=x.device)
            buf[:, :S] = x
            entry[name] = buf
        out.append(entry)
    return out


def prefill(params, batch: dict, cfg: ModelConfig, max_len: int):
    """Returns (last-token logits [B, 1, V], decode caches, cache_len [B])."""
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens, cfg)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    h, caches = tf.apply_blocks(params["blocks"], x, cfg, positions)
    h = rms_norm(params["final_norm"]["scale"], h, cfg.norm_eps)
    logits = _logits(params, h[:, -1:], cfg)
    caches = _prefill_to_decode_cache(caches, cfg, max_len)
    cache_len = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, caches, cache_len


def decode_step(params, tokens_t, caches, cache_len, cfg: ModelConfig):
    """tokens_t: [B, 1]. Returns (logits [B, 1, V], caches, cache_len + 1);
    the caches are updated in place."""
    x = _embed_tokens(params, tokens_t, cfg)
    x, new_caches = tf.apply_blocks_decode(params["blocks"], x, cfg, caches, cache_len)
    x = rms_norm(params["final_norm"]["scale"], x, cfg.norm_eps)
    return _logits(params, x, cfg), new_caches, cache_len + 1


class ParamTree(nn.Module):
    """A parameter tree as modules: indexed (``tree["mixer"]["wq"]``) and
    tested (``"w_gate" in tree``) like the nested dict it holds; lists of
    layers become ``nn.ModuleList``s."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(key, nn.Parameter(value, requires_grad=False))
            elif isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            else:
                self.add_module(key, nn.ModuleList([ParamTree(v) for v in value]))

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules


class BuiltModel(nn.Module):
    """A served model on one device: its parameters and its steps.

    ``params`` (a tree as :func:`build_params` makes it) is taken as given
    and moved to ``device``; without it the parameters are drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``.  ``device=None``
    means the GPU.
    """

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device=None,
                 params: Optional[dict] = None):
        super().__init__()
        tf.check_served(cfg)
        self.cfg = cfg
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; the port serves on the GPU unless "
                "asked for the CPU (device='cpu')"
            )
        cdt = dtype_of(cfg.compute_dtype)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
            params = build_params(ParamBuilder(gen, cdt), cfg)
        else:
            params = _map(lambda x: x.to(self.device, cdt), params)
        self.params = ParamTree(params)

    def prefill(self, batch: dict, max_len: int):
        return prefill(self.params, batch, self.cfg, max_len)

    def decode_step(self, tokens_t, caches, cache_len):
        return decode_step(self.params, tokens_t, caches, cache_len, self.cfg)

    def init_cache(self, batch: int, max_len: int) -> list:
        return build_cache(self.cfg, batch, max_len, self.device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def build_model(cfg: ModelConfig, *, seed: int = 0, device=None,
                params: Optional[dict] = None) -> BuiltModel:
    return BuiltModel(cfg, seed=seed, device=device, params=params)
