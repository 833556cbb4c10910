"""Serving engine: a model replica with batched prefill and greedy decode.

The port of ``repro/serving/engine.py``.  One :class:`Replica` is a model's
parameters on one device (the GPU by default) with its prefill and decode
steps; :meth:`Replica.generate` runs batched greedy decoding.  Cold start =
weight initialisation on the device + the first prefill and decode step
(:meth:`Replica.warmup`); the reference's first-call compile has no
counterpart in eager PyTorch, and the CUDA kernels are built before a
replica exists (``kernels/_build.py``), timed apart.  Every time is read
after ``torch.cuda.synchronize()`` on a CUDA device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import build_model


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray  # [B, new_tokens]
    prefill_s: float
    decode_s: float


class Replica:
    def __init__(self, cfg: ModelConfig, max_len: int = 512, seed: int = 0,
                 device=None, params=None):
        self.device = torch.device("cuda" if device is None else device)
        self._sync()
        t0 = time.perf_counter()
        self.cfg = cfg
        self.max_len = max_len
        self.model = build_model(cfg, seed=seed, device=self.device, params=params)
        self._sync()
        self.init_seconds = time.perf_counter() - t0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def warmup(self, batch_size: int, prompt_len: int) -> float:
        """The first prefill and decode step: the rest of a cold start."""
        t0 = time.perf_counter()
        tokens = torch.zeros((batch_size, prompt_len), dtype=torch.long, device=self.device)
        logits, caches, cache_len = self.model.prefill({"tokens": tokens}, self.max_len)
        tok = logits[:, -1:].argmax(dim=-1)
        self.model.decode_step(tok, caches, cache_len)
        self._sync()
        return time.perf_counter() - t0

    @torch.inference_mode()
    def generate(self, tokens, new_tokens: int = 16) -> GenerationResult:
        """Greedy decode. tokens: [B, S] ids."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=self.device)
        self._sync()
        t0 = time.perf_counter()
        logits, caches, cache_len = self.model.prefill({"tokens": tokens}, self.max_len)
        self._sync()
        t1 = time.perf_counter()
        out = []
        tok = logits[:, -1].argmax(dim=-1)
        for _ in range(new_tokens):
            logits, caches, cache_len = self.model.decode_step(tok[:, None], caches, cache_len)
            tok = logits[:, -1].argmax(dim=-1)
            out.append(tok)
        arr = torch.stack(out, dim=1).cpu().numpy() if out else np.zeros(
            (tokens.shape[0], 0), np.int64)
        t2 = time.perf_counter()
        return GenerationResult(tokens=arr.astype(np.int32), prefill_s=t1 - t0,
                                decode_s=t2 - t1)
