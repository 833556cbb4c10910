"""The port's model handle: parameters, prefill and greedy-decode steps.

The port of ``repro/models/model.py`` for the serving path of plain
language models (token ids in, logits out): :func:`build_params`,
:func:`prefill`, :func:`decode_step`, :func:`build_cache` and
:func:`_prefill_to_decode_cache`, and :class:`BuiltModel`, an
``nn.Module`` that holds the parameters on an explicit device.  The
parameters live in the compute dtype (the reference keeps f32 parameters
and casts them at every use; the cast is the same round-to-nearest-even,
so the values are the same), except the leaves the reference reads in f32,
which the block builders build f32; :func:`cast_params` brings a tree made
elsewhere to the dtypes the builders give.  The training loss and the
multi-token prediction head come with the training slice (ROADMAP Queue A
item 9b).

Parameters are nested dicts of tensors: ``embed.table [V, d]`` (and
``head.w [d, V]`` when untied), ``blocks`` a list with one dict per layer
(``ln1``, ``ln2`` but for ``ssm``, ``mixer`` as the layer's kind builds it,
``ffn.w_up/w_gate [d, ff]``, ``w_down [ff, d]`` but for ``ssm``) and
``final_norm.scale``.  Caches are a list with one dict per layer, its keys
following the kind: ``{"k", "v"}`` of ``[B, T, Hkv, D]`` for attention
(``local``: a ring of ``T = min(max_len, window)`` slots), ``{"state",
"conv"}`` (f32 ``[B, H, P, N]``, ``[B, K-1, conv_dim]``) for ``ssm`` and
``{"h", "conv"}`` (f32 ``[B, W]``, ``[B, K-1, W]``) for ``rglru``.
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
from repro_torch.models.ssm import mamba2_dims


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


def cast_params(params: dict, cfg: ModelConfig, device) -> dict:
    """``params``, a tree shaped as :func:`build_params` builds it for
    ``cfg``, on ``device`` with each leaf in the dtype its builder gives it
    (read from a shape-only build); raises where the trees differ."""
    spec = build_params(ParamBuilder(None, dtype_of(cfg.compute_dtype)), cfg)

    def cast(tree, like, path):
        if isinstance(like, torch.Tensor):
            if tuple(tree.shape) != tuple(like.shape):
                raise ValueError(f"parameter {path} is {list(tree.shape)}, the config "
                                 f"builds {list(like.shape)}")
            return tree.to(device, like.dtype)
        if isinstance(like, dict):
            if set(tree) != set(like):
                raise ValueError(f"parameters {path or '<root>'} hold {sorted(tree)}, the "
                                 f"config builds {sorted(like)}")
            return {k: cast(tree[k], v, f"{path}.{k}".lstrip(".")) for k, v in like.items()}
        if len(tree) != len(like):
            raise ValueError(f"parameters {path} hold {len(tree)} layers, the config "
                             f"builds {len(like)}")
        return [cast(t, v, f"{path}[{i}]") for i, (t, v) in enumerate(zip(tree, like))]

    return cast(params, spec, "")


def _logits(params, h, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return unembed(params["embed"], h, cfg.logit_softcap)
    return linear_head(params["head"], h, cfg.logit_softcap)


def _embed_tokens(params, tokens, cfg: ModelConfig):
    x = embed(params["embed"], tokens, dtype_of(cfg.compute_dtype))
    if cfg.embedding_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def _cache_entry(cfg: ModelConfig, kind: str, batch: int, max_len: int, device) -> dict:
    """A zeroed decode cache for one layer of ``kind``."""
    cdt = dtype_of(cfg.compute_dtype)
    zeros = lambda shape, dt=cdt: torch.zeros(shape, dtype=dt, device=device)
    if kind == "ssm":
        _, H, _, N, P, conv_dim = mamba2_dims(cfg)
        return {"state": zeros((batch, H, P, N), torch.float32),
                "conv": zeros((batch, cfg.ssm.d_conv - 1, conv_dim))}
    if kind == "rglru":
        w = cfg.rglru.lru_width or cfg.d_model
        return {"h": zeros((batch, w), torch.float32),
                "conv": zeros((batch, cfg.rglru.d_conv - 1, w))}
    T = min(max_len, cfg.window) if kind == "local" else max_len
    shape = (batch, T, cfg.n_kv_heads, cfg.head_dim)
    return {"k": zeros(shape), "v": zeros(shape)}


def build_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> list:
    """Zeroed decode caches, one dict per layer (keys by the layer's kind)."""
    return [_cache_entry(cfg, kind, batch, max_len, device) for kind, _ in tf.layer_kinds(cfg)]


def _conv_window(tail, K: int):
    """The last K-1 raw conv inputs of a prefill as an owned ``[B, K-1, C]``
    tensor (a prompt shorter than K-1 is left-padded with the zeros the
    causal conv pads with)."""
    short = K - 1 - tail.shape[1]
    if short > 0:
        tail = torch.nn.functional.pad(tail, (0, 0, short, 0))
    return tail.clone(memory_format=torch.contiguous_format)


def _prefill_to_decode_cache(prefill_caches, cfg: ModelConfig, max_len: int) -> list:
    """Each layer's prefill cache entry in the decode layout: attention
    ``(k, v) [B, S, Hkv, D]`` padded to ``max_len``, or for ``local`` the last
    ``T = min(max_len, window)`` positions rolled so that position p sits in
    ring slot p % T; the recurrent states in f32 and the conv windows copied
    out of the prefill's activations."""
    cdt = dtype_of(cfg.compute_dtype)
    out = []
    for entry, (kind, _) in zip(prefill_caches, tf.layer_kinds(cfg)):
        if kind == "ssm":
            state, tail = entry
            out.append({"state": state.float(), "conv": _conv_window(tail.to(cdt), cfg.ssm.d_conv)})
            continue
        if kind == "rglru":
            h_last, tail = entry
            out.append({"h": h_last.float().clone(memory_format=torch.contiguous_format),
                        "conv": _conv_window(tail.to(cdt), cfg.rglru.d_conv)})
            continue
        k, v = entry
        B, S, Hkv, D = k.shape
        if kind == "local":
            w = min(max_len, cfg.window)
            if S >= w:
                out.append({name: torch.roll(x[:, S - w:], S % w, dims=1).to(cdt)
                            for name, x in (("k", k), ("v", v))})
                continue
            T = w
        else:
            if S > max_len:
                raise ValueError(f"prompt of {S} tokens does not fit max_len={max_len}")
            T = max_len
        entry = {}
        for name, x in (("k", k), ("v", v)):
            buf = torch.zeros((B, T, Hkv, D), dtype=cdt, device=x.device)
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
            params = cast_params(params, cfg, self.device)
        self.params = ParamTree(params)

    def prefill(self, batch: dict, max_len: int):
        return prefill(self.params, batch, self.cfg, max_len)

    def decode_step(self, tokens_t, caches, cache_len):
        return decode_step(self.params, tokens_t, caches, cache_len, self.cfg)

    def init_cache(self, batch: int, max_len: int) -> list:
        return build_cache(self.cfg, batch, max_len, self.device)


def build_model(cfg: ModelConfig, *, seed: int = 0, device=None,
                params: Optional[dict] = None) -> BuiltModel:
    return BuiltModel(cfg, seed=seed, device=device, params=params)
