"""The par engine on the f32 block kernel: per-instance concurrency value > 1.

Paper §3.1: platforms that let one instance serve several requests at
once but scale like scale-per-request platforms — the Knative / Cloud Run
*concurrency value* pattern (Fig. 1).  Each instance holds up to
``concurrency_value`` in-flight requests with i.i.d. service times;
routing prefers the newest instance with spare capacity; a request that
finds none cold-starts a new instance below ``max_concurrency`` instances,
else it is rejected; an instance expires after ``expiration_threshold``
seconds fully idle.

Port of ``repro/core/par_simulator.py``'s block-backend path:
:class:`ParSimulationSummary` and :func:`run_par`, which drives the
backend's par row launcher (the ``finish[M, c]`` kernel) from an empty
pool.  The reference's f64 ``ParServerlessSimulator`` class arrives with
the f64 engine (ROADMAP Queue A item 2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.simulator import (
    SimulationSummary,
    host_acc,
    run_samples,
    summary_from_acc,
)


@dataclasses.dataclass
class ParSimulationSummary(SimulationSummary):
    """Adds the request-level concurrency integral."""

    time_in_flight: Optional[np.ndarray] = None  # ∫ #in-flight-requests dt

    @property
    def avg_in_flight(self) -> float:
        return float(self.time_in_flight.mean() / self.measured_time)

    @property
    def avg_instance_occupancy(self) -> float:
        """Mean in-flight requests per *running* instance-second."""
        return float(
            self.time_in_flight.sum() / np.maximum(self.time_running.sum(), 1e-12)
        )


def run_par(scn, seed: int, bspec, device, *, replicas: int, steps, staged):
    """The concurrency-value platform on the backend's par row launcher:
    ``replicas`` rows from an empty pool, one launch.  Lifespan metrics
    stay a capability of the f64 engine (zeros here)."""
    dts, warms, colds = run_samples(scn, seed, replicas, steps, staged, device)
    rows = lambda v: torch.full((replicas,), v, dtype=torch.float32, device=device)
    acc = host_acc(bspec.launch_for("par")(
        rows(scn.expiration_threshold),
        rows(scn.sim_time),
        rows(scn.skip_time),
        dts, warms, colds,
        max_concurrency=scn.max_concurrency,
        concurrency=scn.concurrency_value,
        slots=scn.slots,
        prestamped=scn.prestamped,
    ))
    return summary_from_acc(
        acc,
        scn.sim_time - scn.skip_time,
        cls=ParSimulationSummary,
        time_in_flight=acc[:, 8],
    )
