"""Request workloads for the serving platform: a numpy-only copy of
``Request`` and ``poisson_arrivals`` from ``repro/data/workload.py``, so
that the port and the reference replay the same arrival times from the
same seed."""

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
