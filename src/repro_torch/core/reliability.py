"""Reliability layer of the PyTorch port: invocation failures, timeouts and
client retries.

The port's copy of ``repro/core/reliability.py`` (it imports nothing of the
reference): the frozen policies wired as ``Scenario.reliability=``, with the
reference's defaults and validation messages, and
:func:`build_attempt_table`, which turns a base arrival stream into the
sorted per-attempt event table that a retry run replays.

* ``FailurePolicy`` — each served invocation fails with probability
  ``p_fail`` (after running to completion) and/or is cut off at
  ``t_timeout``: the instance is freed at ``min(departure, t_arrival +
  t_timeout)`` and the request counts as a timeout.
* ``RetryPolicy`` — a failed, timed-out or rejected request is re-enqueued
  after a client-anchored backoff ``b_j = base * mult**j * (1 + jitter *
  (2u_j - 1))`` (attempt ``j``, pre-drawn uniform ``u_j``), at most
  ``max_retries`` times.  Backoffs are anchored at the triggering
  attempt's arrival time, so every attempt time is known before the
  simulation runs and the whole table is built up front.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

#: Inert timeout sentinel: ``min(service, NO_TIMEOUT) == service`` in f32
#: and f64, so "no timeout" costs nothing on the kernel's path.
NO_TIMEOUT = 1.0e30

#: ``child_pos`` sentinel for a last attempt (no retry budget left): a power
#: of two, exact in f32 and beyond any stream width the kernel takes.
NO_CHILD = 1 << 30


@dataclasses.dataclass(frozen=True)
class FailurePolicy:
    """Per-invocation failure probability and/or execution timeout."""

    p_fail: float = 0.0
    t_timeout: Optional[float] = None

    def __post_init__(self):
        p = float(self.p_fail)
        if not 0.0 <= p < 1.0:
            raise ValueError(
                f"FailurePolicy.p_fail must be in [0, 1), got {self.p_fail}"
            )
        if self.t_timeout is not None and not float(self.t_timeout) > 0.0:
            raise ValueError(
                "FailurePolicy.t_timeout must be > 0 (or None for no "
                f"timeout), got {self.t_timeout}"
            )

    @property
    def timeout_or_inf(self) -> float:
        """The per-row timeout value: ``t_timeout`` or the inert sentinel."""
        return NO_TIMEOUT if self.t_timeout is None else float(self.t_timeout)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Client retry budget and backoff schedule.  ``max_retries`` sets the
    attempt table's width (a launch's static shape); the backoff
    parameters shape the pre-built attempt times."""

    max_retries: int = 0
    backoff_base: float = 1.0
    backoff_mult: float = 2.0
    backoff_jitter: float = 0.0

    def __post_init__(self):
        if int(self.max_retries) != self.max_retries or self.max_retries < 0:
            raise ValueError(
                "RetryPolicy.max_retries must be a non-negative integer, "
                f"got {self.max_retries}"
            )
        if not float(self.backoff_base) > 0.0:
            raise ValueError(
                f"RetryPolicy.backoff_base must be > 0, got {self.backoff_base}"
            )
        if not float(self.backoff_mult) > 0.0:
            raise ValueError(
                f"RetryPolicy.backoff_mult must be > 0, got {self.backoff_mult}"
            )
        j = float(self.backoff_jitter)
        if not 0.0 <= j < 1.0:
            raise ValueError(
                "RetryPolicy.backoff_jitter must be in [0, 1) so backoffs "
                f"stay strictly positive, got {self.backoff_jitter}"
            )


@dataclasses.dataclass(frozen=True)
class Reliability:
    """Container wired as ``Scenario.reliability=``."""

    failure: FailurePolicy = FailurePolicy()
    retry: RetryPolicy = RetryPolicy()

    def __post_init__(self):
        if not isinstance(self.failure, FailurePolicy):
            raise ValueError("Reliability.failure must be a FailurePolicy")
        if not isinstance(self.retry, RetryPolicy):
            raise ValueError("Reliability.retry must be a RetryPolicy")

    @property
    def enabled(self) -> bool:
        """True when any knob departs from the no-op defaults
        (``max_retries`` alone counts: rejections trigger retries)."""
        return (
            self.failure.p_fail > 0.0
            or self.failure.t_timeout is not None
            or self.retry.max_retries > 0
        )


def build_attempt_table(times0, warms_a, colds_a, fail_a, jitter_u, retry):
    """The sorted per-attempt event table of a retry stream.

    ``times0 [R, N]`` f64 absolute base arrival times; ``warms_a``,
    ``colds_a``, ``fail_a [R, N, J+1]`` per-attempt warm and cold service
    draws and failure uniforms (attempt 0 is the base draw, so a trivial
    policy replays the base stream); ``jitter_u [R, N, J]`` backoff
    jitter uniforms.  All on one device.

    Returns ``(times, warms, colds, fail_u, is_first, child_pos)``, each
    ``[R, N*(J+1)]``, sorted by attempt time with a stable sort (a parent
    precedes its child: backoffs are > 0).  ``times`` is f64, ``is_first``
    bool, ``child_pos`` int32: each event's retry successor as a sorted
    position, or :data:`NO_CHILD` for a last attempt.  The rank of a flat
    event is the inverse of the sorting permutation, which equals the
    reference's second stable argsort of that permutation.
    """
    R, N = times0.shape
    J = int(retry.max_retries)
    if J == 0:
        raise ValueError("build_attempt_table needs max_retries > 0")
    K = N * (J + 1)
    dev = times0.device
    f64 = torch.float64
    js = torch.arange(J, dtype=f64, device=dev)
    factor = float(retry.backoff_base) * (float(retry.backoff_mult) ** js)
    spread = 1.0 + float(retry.backoff_jitter) * (2.0 * jitter_u.to(f64) - 1.0)
    backoff = factor * spread  # [R, N, J], strictly > 0
    t0 = times0.to(f64)[:, :, None]
    times_f = torch.cat([t0, t0 + torch.cumsum(backoff, dim=2)], dim=2).reshape(R, K)
    order = torch.sort(times_f, dim=1, stable=True).indices
    iota = torch.arange(K, device=dev)
    rank = torch.empty_like(order).scatter_(1, order, iota.expand(R, K))
    attempt = iota % (J + 1)
    # the flat child of event i is i + 1 in the same chain (attempt < J)
    no_child = torch.full((R, 1), NO_CHILD, dtype=rank.dtype, device=dev)
    rank_next = torch.cat([rank[:, 1:], no_child], dim=1)
    child_f = torch.where(attempt < J, rank_next, no_child).to(torch.int32)
    first_f = (attempt == 0).expand(R, K)
    take = lambda x: torch.gather(x.reshape(R, K), 1, order)
    return (
        take(times_f),
        take(warms_a),
        take(colds_a),
        take(fail_a),
        take(first_f),
        take(child_f),
    )
