"""Scale-per-request serving platform: a numpy-only copy of
``repro/serving/platform.py``.

A *function instance* is a model replica.  The platform applies the
lifecycle of the paper's §2: a request goes to the newest idle replica
(warm), or spins up a new one (cold) below the concurrency cap, or is
rejected; a replica idle for ``expiration_threshold`` is reaped and its
memory released.  Per-request records and instance-seconds by state are
the quantities the simulator predicts.  Time is a virtual clock driven by
the request trace; service times come from ``cold_time_fn`` and
``warm_time_fn``, which may be models or measurements of a real replica.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from repro_torch.data.workload import Request


@dataclasses.dataclass
class ReplicaStats:
    created_at: float
    busy_until: float
    served: int = 0


@dataclasses.dataclass
class ServeRecord:
    request_id: int
    arrival: float
    cold: bool
    rejected: bool
    response_time: float
    replica_id: Optional[int]


@dataclasses.dataclass
class PlatformMetrics:
    records: List[ServeRecord]
    instance_seconds_running: float
    instance_seconds_idle: float
    horizon: float
    replicas_created: int

    @property
    def cold_start_prob(self) -> float:
        served = [r for r in self.records if not r.rejected]
        return sum(r.cold for r in served) / max(len(served), 1)

    @property
    def rejection_prob(self) -> float:
        return sum(r.rejected for r in self.records) / max(len(self.records), 1)

    @property
    def avg_response_time(self) -> float:
        served = [r.response_time for r in self.records if not r.rejected]
        return float(np.mean(served)) if served else 0.0

    @property
    def avg_running_replicas(self) -> float:
        return self.instance_seconds_running / self.horizon

    @property
    def avg_total_replicas(self) -> float:
        return (
            self.instance_seconds_running + self.instance_seconds_idle
        ) / self.horizon

    @property
    def wasted_ratio(self) -> float:
        tot = self.instance_seconds_running + self.instance_seconds_idle
        return self.instance_seconds_idle / max(tot, 1e-12)


class ServerlessPlatform:
    """Event-driven platform executor (control plane).

    ``cold_time_fn``/``warm_time_fn`` map a Request to service seconds —
    either analytical models or closures that really execute a replica's
    prefill/decode and time it.
    """

    def __init__(
        self,
        cold_time_fn: Callable[[Request], float],
        warm_time_fn: Callable[[Request], float],
        expiration_threshold: float = 600.0,
        max_concurrency: int = 1000,
        replica_factory: Optional[Callable[[], object]] = None,
    ):
        self.cold_time_fn = cold_time_fn
        self.warm_time_fn = warm_time_fn
        self.expiration_threshold = expiration_threshold
        self.max_concurrency = max_concurrency
        self.replica_factory = replica_factory
        self.replicas: dict[int, ReplicaStats] = {}
        self._live_objects: dict[int, object] = {}
        self._next_id = 0

    def run(self, requests, horizon: float) -> PlatformMetrics:
        records: List[ServeRecord] = []
        run_secs = 0.0
        idle_secs = 0.0
        created = 0
        t_prev = 0.0
        t_exp = self.expiration_threshold

        def integrate(lo: float, hi: float):
            nonlocal run_secs, idle_secs
            if hi <= lo:
                return
            for st in self.replicas.values():
                run = min(st.busy_until, hi) - lo
                if run > 0:
                    run_secs += run
                idle = min(st.busy_until + t_exp, hi) - max(st.busy_until, lo)
                if idle > 0:
                    idle_secs += idle

        def expire(now: float):
            dead = [
                rid
                for rid, st in self.replicas.items()
                if st.busy_until + t_exp <= now
            ]
            for rid in dead:
                del self.replicas[rid]
                self._live_objects.pop(rid, None)  # release replica memory

        for req in requests:
            t = req.arrival_time
            integrate(t_prev, min(t, horizon))
            expire(t)
            idle = {
                rid: st
                for rid, st in self.replicas.items()
                if st.busy_until <= t
            }
            if idle:  # warm: newest-first routing
                rid = max(idle, key=lambda r: idle[r].created_at)
                dt = self.warm_time_fn(req)
                st = self.replicas[rid]
                st.busy_until = t + dt
                st.served += 1
                records.append(ServeRecord(req.request_id, t, False, False, dt, rid))
            elif len(self.replicas) < self.max_concurrency:
                rid = self._next_id
                self._next_id += 1
                created += 1
                if self.replica_factory is not None:
                    self._live_objects[rid] = self.replica_factory()
                dt = self.cold_time_fn(req)
                self.replicas[rid] = ReplicaStats(
                    created_at=t, busy_until=t + dt, served=1
                )
                records.append(ServeRecord(req.request_id, t, True, False, dt, rid))
            else:
                records.append(ServeRecord(req.request_id, t, False, True, 0.0, None))
            t_prev = t
        integrate(t_prev, horizon)
        return PlatformMetrics(
            records=records,
            instance_seconds_running=run_secs,
            instance_seconds_idle=idle_secs,
            horizon=horizon,
            replicas_created=created,
        )
