"""Dispatch layer: the model's kernels or their plain versions.

The port of ``repro/kernels/ops.py``.  The model calls :func:`flash_attention`
and :func:`decode_attention` (attention blocks), :func:`ssd_scan` (Mamba-2
prefill) and :func:`rglru_scan` (RG-LRU prefill); the backend is chosen by
the :func:`kernel_backend` context:

* ``None`` (the default) follows the tensors' device: a CUDA tensor goes to
  the hand-written kernel, a CPU tensor to the plain version;
* ``"cuda"`` launches the kernel, and raises on a CPU tensor;
* ``"ref"`` runs the plain version on any device.

Nothing falls back: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rglru_scan as _rglru
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models.attention import decode_attention_ref, flash_attention_ref
from repro_torch.models.scans import rglru_scan_ref, ssd_chunked_ref

BACKENDS = ("cuda", "ref")

_BACKEND: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "repro_torch_kernel_backend", default=None
)


@contextlib.contextmanager
def kernel_backend(name: Optional[str]):
    if name is not None and name not in BACKENDS:
        raise ValueError(f"unknown kernel backend {name!r}; choose from {list(BACKENDS)} or None")
    token = _BACKEND.set(name)
    try:
        yield
    finally:
        _BACKEND.reset(token)


def current_backend() -> Optional[str]:
    return _BACKEND.get()


def _use_ref(what: str, x) -> bool:
    backend = _BACKEND.get()
    if backend == "cuda" and x.device.type != "cuda":
        raise ValueError(
            f"kernel_backend('cuda') launches the {what} kernel and needs CUDA "
            f"tensors, got a tensor on {x.device}; use kernel_backend('ref') "
            "for the plain version"
        )
    return backend == "ref"


def flash_attention(q, k, v, *, causal=True, window=0, prefix_len=0, softcap=0.0,
                    q_chunk=1024, kv_chunk=1024, scale=None):
    kw = dict(causal=causal, window=window, prefix_len=prefix_len, softcap=softcap,
              scale=scale)
    if _use_ref("flash_attention", q):
        return flash_attention_ref(q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk, **kw)
    return _flash.flash_attention(q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk, **kw)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=0, softcap=0.0,
                     scale=None):
    kw = dict(window=window, softcap=softcap, scale=scale)
    if _use_ref("decode_attention", q):
        return decode_attention_ref(q, k_cache, v_cache, cache_len, **kw)
    return _decode.decode_attention(q, k_cache, v_cache, cache_len, **kw)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk=256):
    if _use_ref("ssd_scan", x):
        return ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk)
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)


def rglru_scan(a, b, h0=None):
    if _use_ref("rglru_scan", a):
        return rglru_scan_ref(a, b, h0)
    return _rglru.rglru_scan(a, b, h0)
