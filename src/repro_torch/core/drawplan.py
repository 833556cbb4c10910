"""DrawPlan: per-event samples drawn from counter-based threefry keys (the
port of ``repro/core/drawplan.py``).

The staged pipeline fills ``[C, K]`` sample buffers on the device before a
launch; for large grids those buffers, not the kernel, set the memory a
sweep needs.  With ``Execution(draws="fused")`` every process lowers to a
:class:`DrawSpec` (a distribution id) and two per-row parameters (f32 on
the block engine, f64 on the f64 engine, which samples in the parameters'
dtype from the same f32 uniforms), and the kernel draws each event's
samples itself: the whole sample state of a row is one uint32 key pair per
stream.  An NHPP arrival process lowers to ``"nhpp"`` with its profile
(the f64 engine only): candidates come from the exponential envelope at
``max_rate`` and word 1 of the arrival draw is the acceptance uniform.

The bitstream is the reference's (pinned by the hex goldens of
``tests/test_drawplan.py``): draw ``i`` of a row with key ``(k0, k1)`` is
``threefry2x32(k0, k1, i, 0)``, 20 rounds with rotations
``(13, 15, 26, 6)`` / ``(17, 29, 16, 24)`` and parity ``0x1BD11BDA``; each
output word becomes a ``[0, 1)`` f32 uniform by filling the mantissa of
``1.0`` with its top 23 bits and subtracting 1; the uniforms become a
sample by inverse CDF or Box–Muller (:func:`sample_dist`), clamped at
``1e-9``.  Word 0 of the failure stream's draw is the event's failure
uniform.  torch's ``uint32`` dtype supports few operations, so the words
are carried in ``int64`` masked to 32 bits, with logical right shifts.

Key schedule (the port's own; the reference's ``jax.random.split`` /
``fold_in`` chain depends on JAX's ``jax_threefry_partitionable`` setting,
and staged draws are not a cross-package contract either).  The keys of
draw cell ``d`` of a grid drawn from ``seed``, stream ``s`` (0 arrival, 1
warm, 2 cold, 3 failure), are the words of
``numpy.random.SeedSequence(seed, spawn_key=(d, s))``, i.e. of
``SeedSequence(seed).spawn(D)[d].spawn(4)[s]``:
``generate_state(2 * replicas, uint32)`` read as ``[replicas, 2]``.  So

* a cell's keys do not depend on how many cells the grid has (the spawn
  key names the cell, not its count);
* asking for the failure stream leaves the three base streams' keys bit
  for bit (each stream has its own spawn key);
* replica ``r``'s key does not depend on the replica count
  (``generate_state`` keeps its first words when asked for more);
* they are independent of the staged draws of the same seed, which read
  ``SeedSequence(seed).spawn(D)[d].generate_state`` itself.

``run()``/``sweep()`` take ``fused_keys=`` in place of these (e.g. the
reference's, through :func:`repro_torch.interop.fused_keys_from_reference`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


# strictly positive clamp, as SimProcess.sample's _EPS
_EPS = 1e-9

# distribution ids a process can lower to, in the order the kernels number
# them; "nhpp" (thinning needs profile.rate(t) inside the event loop) is the
# f64 engine's only, as in the reference, and draws its candidates as "exp"
FUSED_DISTS = ("exp", "det", "gauss", "weibull", "lognorm", "pareto")
NHPP = "nhpp"
# the streams of one draw cell, in spawn-key order
STREAMS = ("arrival", "warm", "cold", "fail")

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF
# 2π rounded to f32, as the reference's jnp.asarray(2π, float32)
_TWO_PI_F32 = float(np.float32(2.0 * np.pi))
# events whose uniforms are drawn together (integer ops, exact in any
# layout); the float transforms run one event (one [R] column) at a time
DRAW_BLOCK = 256


def words(x, device=None) -> torch.Tensor:
    """32-bit words as an ``int64`` tensor: from a uint32 (or other integer)
    tensor, a numpy array or an int."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            x = x.view(torch.int32)
        return (x.to(torch.int64) & _MASK).to(device or x.device)
    a = np.asarray(x)
    if a.dtype.kind not in "ui":
        raise ValueError(f"threefry words must be integers, got {a.dtype}")
    return torch.as_tensor(a.astype(np.int64) & _MASK, device=device)


def threefry2x32(k0, k1, c0, c1):
    """20-round threefry-2x32 on 32-bit words carried in ``int64`` tensors
    (or ints); returns the two output words, as the reference's function
    computes them."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + k0) & _MASK
    x1 = (c1 + k1) & _MASK
    for block in range(5):
        for r in _ROT_A if block % 2 == 0 else _ROT_B:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & _MASK
    return x0, x1


def uniform_from_bits(bits) -> torch.Tensor:
    """A ``[0, 1)`` f32 uniform from 32-bit words (the mantissa fill)."""
    mant = (bits >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def event_uniforms(k0, k1, idx):
    """The two ``[0, 1)`` f32 uniforms of event ``idx`` (the global event
    index, the counter's first word; the second is 0) under key ``(k0,
    k1)``, all as 32-bit words in ``int64`` tensors or ints."""
    b0, b1 = threefry2x32(k0, k1, idx, 0)
    return uniform_from_bits(b0), uniform_from_bits(b1)


def block_uniforms(keys, start: int, n: int):
    """Both uniforms of events ``start .. start+n-1`` for every row of
    ``keys`` (``int64 [R, 2]`` words): two f32 ``[R, n]`` tensors."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=keys.device)
    return event_uniforms(keys[:, :1], keys[:, 1:], idx[None, :])


def sample_dist(kind: str, u0, u1, p0, p1):
    """One inverse-CDF (or Box–Muller) sample per element in the dtype of
    ``p0`` (the f32 uniforms cast up for f64 parameters), with the
    reference's operations in its order, clamped at ``1e-9``.  ``p0`` and
    ``p1`` are f32 or f64 tensors on the uniforms' device (a Python scalar
    could take another rounding path: division by a scalar may become a
    multiply by its reciprocal)."""
    u0, u1 = u0.to(p0.dtype), u1.to(p0.dtype)
    if kind == "exp":
        out = -torch.log(1.0 - u0) / p0
    elif kind == "det":
        out = p0.expand_as(u0).clone()
    elif kind == "gauss":
        out = p0 + p1 * _box_muller(u0, u1)
    elif kind == "weibull":
        out = p1 * torch.pow(-torch.log(1.0 - u0), torch.ones_like(p0) / p0)
    elif kind == "lognorm":
        out = torch.exp(p0 + p1 * _box_muller(u0, u1))
    elif kind == "pareto":
        out = p1 / torch.pow(1.0 - u0, torch.ones_like(p0) / p0)
    else:
        raise ValueError(f"unknown fused distribution {kind!r}; known: {FUSED_DISTS}")
    return torch.clamp_min(out, _EPS)


def _box_muller(u0, u1):
    r = torch.sqrt(-2.0 * torch.log(1.0 - u0))
    return r * torch.cos((_TWO_PI_F32 if u0.dtype == torch.float32 else 2.0 * np.pi) * u1)


class StreamDraws:
    """The per-event draws of one stream for every row, in event order:
    :meth:`take` returns event ``i``'s ``[R]`` samples in the parameters'
    dtype (``kind`` ``"uniform"``: word 0's f32 uniform; :meth:`take2`
    both words' uniforms).  Uniforms are drawn ``DRAW_BLOCK``
    events at a time; the float transform runs on one contiguous ``[R]``
    column per event, so every caller rounds the same way (torch's CPU
    ``pow`` rounds by memory layout)."""

    def __init__(self, kind: str, keys, p0=None, p1=None):
        if kind != "uniform" and kind not in FUSED_DISTS:
            raise ValueError(f"unknown fused distribution {kind!r}; known: {FUSED_DISTS}")
        self.kind, self.keys = kind, words(keys)
        self.p0, self.p1 = p0, p1
        self._start, self._u = None, None

    def take2(self, i: int) -> tuple:
        start = i - i % DRAW_BLOCK
        if start != self._start:
            self._start, self._u = start, block_uniforms(self.keys, start, DRAW_BLOCK)
        j = i - start
        return self._u[0][:, j].contiguous(), self._u[1][:, j].contiguous()

    def take(self, i: int) -> torch.Tensor:
        u0, u1 = self.take2(i)
        if self.kind == "uniform":
            return u0
        return sample_dist(self.kind, u0, u1, self.p0, self.p1)


def param_rows(params, rows: int, device, dtype=torch.float32) -> tuple:
    """``(p0, p1)`` as contiguous ``[rows]`` tensors of ``dtype`` on
    ``device``, from scalars, ``[rows]`` vectors or an ``[rows, 2]``
    matrix."""
    if isinstance(params, torch.Tensor) and params.dim() == 2:
        params = (params[:, 0], params[:, 1])
    return tuple(
        torch.as_tensor(p, dtype=dtype, device=device).expand(rows).contiguous()
        for p in params
    )


def materialize_stream(kind: str, keys, params, n: int, device=None,
                       dtype=torch.float32) -> torch.Tensor:
    """The ``[R, n]`` values of a fused stream in ``dtype`` (f32: the block
    engine's, f64: the f64 engine's): the numbers the fused paths draw
    inline, as staged buffers (the tests and the card's check hand them to
    the staged path).  ``keys`` is uint32 ``[R, 2]``; ``params`` is ``(p0,
    p1)`` (scalars or ``[R]``), ignored for ``kind="uniform"`` (word 0's
    f32 uniforms, the failure stream)."""
    kw = words(keys, device)
    R = kw.shape[0]
    p0 = p1 = None
    if kind != "uniform":
        p0, p1 = param_rows(params, R, kw.device, dtype)
    else:
        dtype = torch.float32
    draws = StreamDraws(kind, kw, p0, p1)
    out = torch.empty((R, n), dtype=dtype, device=kw.device)
    for i in range(n):
        out[:, i] = draws.take(i)
    return out


# ---------------------------------------------------------------------------
# Specs and lowering
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DrawSpec:
    """One stream's distribution id; its two parameters are per-row values
    that ride beside it (a threshold × rate grid is one launch).
    ``profile`` is the NHPP arrival's rate profile (``kind == "nhpp"``)."""

    kind: str
    profile: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class DrawPlan:
    """One spec per stream for a whole grid, and whether the reliability
    layer's failure stream is drawn."""

    arrival: DrawSpec
    warm: DrawSpec
    cold: DrawSpec
    fail: bool = False

    @property
    def dists(self) -> Tuple[str, str, str]:
        return (self.arrival.kind, self.warm.kind, self.cold.kind)


def lower_scenario(scn) -> Tuple[DrawPlan, dict]:
    """``(plan, params)`` for a scenario: ``params`` maps ``"arrival"``,
    ``"warm"`` and ``"cold"`` to ``(p0, p1)`` floats.  Raises
    ``ValueError`` pointing at ``draws="staged"`` for retry policies (the
    attempt table is a sort over the whole stream) and for processes with
    no per-event transform."""
    rel = scn.reliability
    if rel is not None and int(rel.retry.max_retries) > 0:
        raise ValueError(
            "fused draws cannot serve retry policies (the attempt table "
            "is sorted over the whole stream); use draws='staged'"
        )
    specs, params = [], {}
    for stream, p in (("arrival", scn.arrival_process), ("warm", scn.warm_service_process),
                      ("cold", scn.cold_service_process)):
        spec, params[stream] = _lower_process(p, stream)
        specs.append(spec)
    for name, spec in (("warm", specs[1]), ("cold", specs[2])):
        if spec.kind == NHPP:
            raise ValueError(f"{name} service process cannot be an arrival-time process")
    return DrawPlan(*specs, fail=rel is not None), params


def _lower_process(p, stream: str) -> Tuple[DrawSpec, Tuple[float, float]]:
    fn = getattr(p, "draw_spec", None)
    if fn is None:
        raise ValueError(
            f"{type(p).__name__} ({stream} stream) does not lower to a "
            "fused DrawSpec; use draws='staged'"
        )
    kind, params = fn()
    profile = p.profile if kind == NHPP else None
    if profile is not None:
        profile.block()  # a profile with no block raises here
    p0, p1 = (tuple(params) + (0.0, 0.0))[:2]
    return DrawSpec(kind=kind, profile=profile), (float(p0), float(p1))


# ---------------------------------------------------------------------------
# Key derivation (module docstring)
# ---------------------------------------------------------------------------


def stream_row_keys(seed: int, cell: int, replicas: int, *, fail: bool = False) -> dict:
    """uint32 ``[replicas, 2]`` numpy key pairs of draw cell ``cell`` for
    ``"arrival"``, ``"warm"``, ``"cold"`` (and ``"fail"`` when asked)."""
    out = {}
    for s, name in enumerate(STREAMS[:4 if fail else 3]):
        ss = np.random.SeedSequence(int(seed), spawn_key=(int(cell), s))
        out[name] = ss.generate_state(2 * int(replicas), np.uint32).reshape(-1, 2)
    return out
