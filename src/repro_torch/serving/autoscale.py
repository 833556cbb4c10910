"""Simulator-driven keep-alive planning (the paper's §4.3/§4.4 as a feature).

The port of ``repro/serving/autoscale.py``'s single-function planner: given a
measured workload (arrival rate, warm and cold service times), sweep the
candidate expiration thresholds through the port's :func:`~repro_torch.sweep`
and pick the smallest meeting a cold-start SLO.  ``execution=`` picks the
sweep's backend; the default is the reference's, the exact f64 scan (the
``scan_sweep`` CUDA kernel on the GPU, its plain version on the CPU), and
``Execution(backend="cuda")`` (``"ref"`` on the CPU) plans on the f32 block
engine.  Fleet plans and ``ThresholdGovernor`` are ROADMAP item 7.
``reliability=`` plans under a failure model (the reliability path).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.execution import Execution
from repro_torch.core.processes import ExpSimProcess
from repro_torch.core.scenario import Scenario
from repro_torch.core.scenario import sweep as scenario_sweep


@dataclasses.dataclass
class PlanResult:
    expiration_threshold: float
    predicted_cold_prob: float
    predicted_avg_replicas: float
    predicted_wasted_ratio: float
    predicted_goodput: Optional[float] = None  # set under a failure model
    cluster_headroom: Optional[float] = None  # n_cluster - sum(avg replicas)
    predicted_cost: Optional[float] = None  # developer cost at the choice


def select_threshold(result, cold_slo: float) -> PlanResult:
    """Pick the smallest threshold on a swept ``expiration_threshold`` axis
    whose predicted cold-start probability meets ``cold_slo`` (the largest
    candidate when none does) and read the cell's metrics into a
    :class:`PlanResult`."""
    thresholds = list(result.axis("expiration_threshold"))
    ok = np.asarray(result.cold_start_prob) <= cold_slo
    chosen = thresholds[int(np.argmax(ok))] if ok.any() else thresholds[-1]
    best = result.sel(expiration_threshold=chosen)
    return PlanResult(
        expiration_threshold=float(chosen),
        predicted_cold_prob=float(best.cold_start_prob),
        predicted_avg_replicas=float(best.avg_server_count),
        predicted_wasted_ratio=float(best.wasted_ratio),
        predicted_goodput=float(best.goodput),
        predicted_cost=float(best.developer_cost),
    )


def plan_expiration_threshold(
    arrival_rate: float,
    warm_time: float,
    cold_time: float,
    cold_slo: float,
    candidate_thresholds=(30.0, 60.0, 120.0, 300.0, 600.0, 1200.0),
    sim_time: float = 2e4,
    seed: int = 0,
    replicas: int = 4,
    execution: Optional[Execution] = None,
    reliability=None,
    device=None,
) -> PlanResult:
    """Plan the keep-alive threshold for exponential arrivals and service
    times.  ``execution`` picks the sweep's backend (default: the f64
    scan); ``device`` is the port's shorthand for the plan's device
    (``None``: the GPU, ``"cpu"``: the plain versions).

    ``reliability=`` (a :class:`repro_torch.core.reliability.Reliability`)
    plans under a failure model: the candidate sweep carries the timeout,
    failure and retry dynamics (retry-amplified load inflates the predicted
    replica counts) and the chosen threshold's goodput is reported on the
    result."""
    base = Scenario(
        arrival_process=ExpSimProcess(rate=arrival_rate),
        warm_service_process=ExpSimProcess(rate=1.0 / warm_time),
        cold_service_process=ExpSimProcess(rate=1.0 / cold_time),
        sim_time=sim_time,
        skip_time=min(100.0, sim_time / 100),
        reliability=reliability,
    )
    thresholds = [float(t) for t in candidate_thresholds]
    result = scenario_sweep(
        base, over={"expiration_threshold": thresholds}, seed=seed,
        replicas=replicas, device=device, execution=execution,
    )
    plan = select_threshold(result, cold_slo)
    if reliability is None:  # goodput is a failure-model metric here
        plan.predicted_goodput = None
    return plan
