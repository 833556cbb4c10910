"""The par engine on the f32 block kernel: per-instance concurrency value > 1.

Paper §3.1: platforms that let one instance serve several requests at
once but scale like scale-per-request platforms — the Knative / Cloud Run
*concurrency value* pattern (Fig. 1).  Each instance holds up to
``concurrency_value`` in-flight requests with i.i.d. service times;
routing prefers the newest instance with spare capacity; a request that
finds none cold-starts a new instance below ``max_concurrency`` instances,
else it is rejected; an instance expires after ``expiration_threshold``
seconds fully idle.

Port of ``repro/core/par_simulator.py``: :class:`ParSimulationSummary`;
:func:`run_par`, which drives the f32 block backends' par row launcher
(the ``finish[M, c]`` kernel) from an empty pool; and
:class:`ParServerlessSimulator` (:func:`run_par64`) on the f64 engine
(backends ``"scan"``/``"scan_ref"``), which also serves lifespans, the
histogram and the reliability layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.simulator import (
    SimulationSummary,
    _f64_rows,
    host_acc,
    run_samples,
    scan_backend,
    scan_cell_summaries,
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


def run_par64(scn, seed: int, bspec, device, *, replicas: int, steps=None,
              staged=None) -> ParSimulationSummary:
    """The concurrency-value platform on the f64 engine: ``replicas`` rows
    from empty pools of ``scn.slots`` instances with
    ``scn.concurrency_value`` request sub-slots each, one launch, with the
    histogram and the reliability layer as ``scn`` sets them."""
    from repro_torch.kernels.ref64 import ScanLayout

    rel = scn.reliability
    samples = run_samples(scn, seed, replicas, steps, staged, device, f64=True)
    rows = lambda x: _f64_rows(x, replicas, device)
    kw = {}
    if rel is not None:
        kw.update(t_timeout=rows(rel.failure.timeout_or_inf), p_fail=rows(rel.failure.p_fail),
                  fail_u=samples[3])
    if len(samples) > 4:
        kw.update(is_first=samples[4], child_pos=samples[5])
    H = scn.hist_bins if scn.track_histogram else 0
    out = bspec.launch_for("par")(
        *samples[:3], t_exp=rows(scn.expiration_threshold), t_end=rows(scn.sim_time),
        skip=rows(scn.skip_time), max_concurrency=scn.max_concurrency,
        concurrency=scn.concurrency_value, slots=scn.slots,
        prestamped=scn.prestamped or scn.max_retries > 0, hist_bins=H, **kw,
    )
    acc = out.acc.cpu().numpy()
    t_last = out.t.cpu().numpy()
    if (t_last < scn.sim_time).any():
        raise RuntimeError("arrivals ended before sim_time; pass larger steps")
    if acc[:, 9].sum() > 0:
        raise RuntimeError("instance-pool overflow; raise Scenario.slots")
    return scan_cell_summaries(
        acc, replicas, [scn.sim_time - scn.skip_time],
        ScanLayout(H=H, rely=rel is not None, par=True), histogram=scn.track_histogram,
        cls=ParSimulationSummary, time_in_flight=10,
    )[0]


class ParServerlessSimulator:
    """Concurrency-value platform simulator on the f64 engine (the
    reference's class): ``backend`` is ``"scan"`` (default on a CUDA
    device) or ``"scan_ref"`` (default on the CPU)."""

    def __init__(self, config, concurrency_value: int = 1, *, device=None,
                 backend: Optional[str] = None):
        if concurrency_value < 1:
            raise ValueError("concurrency_value must be >= 1")
        self.config = dataclasses.replace(config, concurrency_value=int(concurrency_value))
        self.concurrency_value = int(concurrency_value)
        self.bspec, self.device = scan_backend("par", backend, device)

    def run(self, seed: int, replicas: int = 8, steps: Optional[int] = None,
            staged=None) -> ParSimulationSummary:
        return run_par64(self.config, seed, self.bspec, self.device, replicas=replicas,
                         steps=steps, staged=staged)
