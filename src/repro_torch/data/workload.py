"""Request workloads for the serving platform and the simulator's trace
replay: a numpy-only copy of ``repro/data/workload.py`` (``Request``,
``poisson_arrivals``, ``deterministic_arrivals``, ``batch_arrivals`` and
``mmpp_arrivals``), so that the port and the reference replay the same
arrival times from the same seed.  Beyond Poisson: deterministic (cron),
batch arrivals and the bursty two-phase MMPP."""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class Request:
    arrival_time: float
    request_id: int
    prompt_tokens: int = 128
    decode_tokens: int = 32


def poisson_arrivals(rate: float, horizon: float, seed: int = 0) -> Iterator[Request]:
    rng = np.random.default_rng(seed)
    t, i = 0.0, 0
    while True:
        t += rng.exponential(1.0 / rate)
        if t > horizon:
            return
        yield Request(arrival_time=t, request_id=i)
        i += 1


def deterministic_arrivals(interval: float, horizon: float) -> Iterator[Request]:
    t, i = interval, 0
    while t <= horizon:
        yield Request(arrival_time=t, request_id=i)
        t += interval
        i += 1


def batch_arrivals(
    rate: float, batch_size: int, horizon: float, seed: int = 0
) -> Iterator[Request]:
    """Groups of ``batch_size`` requests arriving together (batch Poisson)."""
    rng = np.random.default_rng(seed)
    t, i = 0.0, 0
    while True:
        t += rng.exponential(batch_size / rate)
        if t > horizon:
            return
        for _ in range(batch_size):
            yield Request(arrival_time=t, request_id=i)
            i += 1


def mmpp_arrivals(
    rate_low: float,
    rate_high: float,
    switch_rate: float,
    horizon: float,
    seed: int = 0,
) -> Iterator[Request]:
    """Markov-modulated Poisson process: bursty two-phase arrivals, the
    canonical workload beyond closed-form Markovian models."""
    rng = np.random.default_rng(seed)
    t, i = 0.0, 0
    high = False
    next_switch = rng.exponential(1.0 / switch_rate)
    while True:
        rate = rate_high if high else rate_low
        dt = rng.exponential(1.0 / rate)
        if t + dt > next_switch:
            t = next_switch
            high = not high
            next_switch = t + rng.exponential(1.0 / switch_rate)
            continue
        t += dt
        if t > horizon:
            return
        yield Request(arrival_time=t, request_id=i)
        i += 1
