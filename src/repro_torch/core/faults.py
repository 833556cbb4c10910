"""Platform fault models of the PyTorch port: instance crashes and capacity
churn (numpy only).

The port's copy of ``repro/core/faults.py`` (it imports nothing of the
reference).  The reliability layer models invocation-level faults
(timeouts, failures, retries); this module models the platform under
them:

* an instance-crash hazard: every provisioned instance (idle or running)
  dies after an Exp(``crash_rate``) lifetime, drawn once at its cold start
  from the draw cell's crash stream (the exponential is memoryless, so one
  lifetime draw is the same as a per-unit-time hazard);
* cluster capacity churn: a piecewise-constant :class:`CapacityProfile`
  ceiling on the live instance count.  A downward step evicts the newest
  idle instances first; while degraded, a cold start is admitted only
  below the current ceiling.

A default ``FaultModel()`` is inert: every engine runs without its fault
paths, bit for bit as with ``faults=None``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CapacityProfile:
    """A piecewise-constant cluster-capacity ceiling.

    ``values[i]`` instances are admissible on ``[edges[i-1], edges[i])``
    (with ``edges[-1] = 0`` and ``edges[len(edges)] = inf`` implied).  The
    kernels take edges and values as per-row inputs; only ``len(values)``
    fixes a launch's shape, so profiles of one step count share a launch.
    """

    edges: Tuple[float, ...]
    values: Tuple[float, ...]

    def __post_init__(self):
        edges = tuple(float(e) for e in self.edges)
        values = tuple(float(v) for v in self.values)
        object.__setattr__(self, "edges", edges)
        object.__setattr__(self, "values", values)
        if len(values) != len(edges) + 1:
            raise ValueError(
                f"need len(values) == len(edges) + 1 (one capacity per "
                f"segment); got {len(edges)} edges and {len(values)} values"
            )
        if any(e <= 0 for e in edges) or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(f"edges must be positive and strictly increasing; got {edges}")
        if any(v < 0 or not np.isfinite(v) for v in values):
            raise ValueError(f"capacity values must be finite and >= 0; got {values}")

    def value(self, t: float) -> float:
        """The capacity ceiling in effect at time ``t``."""
        return self.values[int(np.searchsorted(self.edges, t, side="right"))]

    @property
    def floor(self) -> float:
        """The lowest ceiling anywhere on the profile."""
        return min(self.values)


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Platform fault injection: crash hazard and capacity churn.

    ``crash_rate`` is the per-unit-time exponential crash hazard of every
    provisioned instance (0 disables crashes); ``capacity`` is an optional
    :class:`CapacityProfile` ceiling on the live instance count (``None``
    disables churn).  ``FaultModel()`` with both defaults is a no-op.
    """

    crash_rate: float = 0.0
    capacity: Optional[CapacityProfile] = None

    def __post_init__(self):
        rate = float(self.crash_rate)
        object.__setattr__(self, "crash_rate", rate)
        if not np.isfinite(rate) or rate < 0:
            raise ValueError(f"crash_rate must be finite and >= 0, got {self.crash_rate}")
        if self.capacity is not None and not isinstance(self.capacity, CapacityProfile):
            raise TypeError(
                "capacity must be a CapacityProfile (or None), got "
                f"{type(self.capacity).__name__}"
            )

    @property
    def crashes(self) -> bool:
        """Whether the crash hazard is active."""
        return self.crash_rate > 0.0

    @property
    def cap_steps(self) -> int:
        """Number of capacity segments (0 = churn off)."""
        return 0 if self.capacity is None else len(self.capacity.values)

    @property
    def enabled(self) -> bool:
        """Whether any fault channel is active (False = no-op)."""
        return self.crashes or self.capacity is not None
