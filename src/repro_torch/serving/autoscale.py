"""Simulator-driven keep-alive planning (the paper's §4.3/§4.4 as a feature).

The port of ``repro/serving/autoscale.py``'s single-function planner: given a
measured workload (arrival rate, warm and cold service times), sweep the
candidate expiration thresholds through the port's :func:`~repro_torch.sweep`
and pick the smallest meeting a cold-start SLO.  ``execution=`` picks the
sweep's backend; the default is the reference's, the exact f64 scan (the
``scan_sweep`` CUDA kernel on the GPU, its plain version on the CPU), and
``Execution(backend="cuda")`` (``"ref"`` on the CPU) plans on the f32 block
engine.  ``reliability=`` plans under a failure model (the reliability path).

:func:`plan_fleet_thresholds` plans a fleet's per-function thresholds under
its shared cluster budget (one single-function sweep per function, then a
greedy over the tables), and :class:`ThresholdGovernor` is the hysteresis
the online what-if service (:mod:`repro_torch.serving.online`) puts between
a tick's raw choice and the applied threshold.  Both are the reference's,
decision for decision; where the reference folds the function index into a
``jax.random`` key, the port spawns a child of ``numpy.random.SeedSequence``
(:func:`child_seed`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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


def child_seed(seq: np.random.SeedSequence) -> int:
    """An integer seed for :func:`~repro_torch.core.scenario.sweep` from a
    ``SeedSequence`` child: its first 64-bit word.  Children of one parent
    are independent streams, which is what the reference's
    ``fold_in``/``split`` of a key gives."""
    return int(seq.generate_state(1, np.uint64)[0])


@dataclasses.dataclass
class ThresholdGovernor:
    """Hysteresis between raw per-tick recommendations and the applied
    keep-alive threshold, so a noisy rate estimate cannot thrash the
    platform's configuration.

    Two filters compose: a proposal whose relative distance from the
    applied threshold is within ``deadband`` is ignored outright, and a
    proposal outside the deadband must repeat for ``patience``
    consecutive ticks before it is applied.  ``update`` returns the
    (possibly unchanged) applied threshold.
    """

    patience: int = 2
    deadband: float = 0.0
    applied: Optional[float] = None
    _candidate: Optional[float] = dataclasses.field(default=None, repr=False)
    _streak: int = dataclasses.field(default=0, repr=False)

    def __post_init__(self):
        if self.patience < 1:
            raise ValueError(f"patience must be >= 1, got {self.patience}")
        if self.deadband < 0:
            raise ValueError(f"deadband must be >= 0, got {self.deadband}")

    def update(self, proposed: float) -> float:
        proposed = float(proposed)
        if self.applied is None:  # the first proposal seeds the state
            self.applied = proposed
            return self.applied
        if abs(proposed - self.applied) <= self.deadband * abs(self.applied):
            self._candidate, self._streak = None, 0
            return self.applied
        if proposed == self._candidate:
            self._streak += 1
        else:
            self._candidate, self._streak = proposed, 1
        if self._streak >= self.patience:
            self.applied = self._candidate
            self._candidate, self._streak = None, 0
        return self.applied


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


@dataclasses.dataclass
class FleetPlan:
    """Per-function keep-alive plan under a shared cluster budget."""

    plans: Dict[str, PlanResult]  # function name -> chosen plan
    feasible: bool  # predicted total replicas fit in n_cluster
    n_cluster: float
    predicted_total_replicas: float
    cluster_headroom: float  # n_cluster - predicted_total (can be < 0)

    @property
    def thresholds(self) -> Dict[str, float]:
        return {n: p.expiration_threshold for n, p in self.plans.items()}


def plan_fleet_thresholds(
    fleet,
    cold_slo: float,
    candidate_thresholds=(30.0, 60.0, 120.0, 300.0, 600.0, 1200.0),
    sim_time: float = 2e4,
    seed: int = 0,
    replicas: int = 4,
    execution: Optional[Execution] = None,
    device=None,
) -> FleetPlan:
    """Plan per-function expiration thresholds for a fleet under the shared
    capacity of ``fleet.n_cluster``.

    Two-stage greedy: (1) per function, sweep the candidate thresholds
    through the single-function simulator (one launch each) and take the
    smallest one meeting ``cold_slo``; (2) while the summed predicted
    replica counts exceed the cluster budget, step *down* the threshold of
    the function whose step frees the most replicas (a lateral or worse
    step when no step frees any), until the plan fits or every function
    sits at the smallest candidate (then ``feasible=False``: the budget is
    too small for the SLO).  The sweeps all run first, so the greedy reads
    tables.  Function ``fi`` sweeps from seed :func:`child_seed` of
    ``SeedSequence(seed).spawn(F)[fi]``; ``execution``/``device`` as
    :func:`plan_expiration_threshold` takes them.
    """
    thresholds = sorted(float(t) for t in candidate_thresholds)
    names = list(fleet.names)
    children = np.random.SeedSequence(int(seed)).spawn(len(fleet.functions))
    tables: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    for fi, fn in enumerate(fleet.functions):
        base = fn.as_scenario(
            sim_time=sim_time, skip_time=min(100.0, sim_time / 100), slots=fleet.slots,
        )
        result = scenario_sweep(
            base, over={"expiration_threshold": thresholds}, seed=child_seed(children[fi]),
            replicas=replicas, device=device, execution=execution,
        )
        tables[fn.name] = (
            np.asarray(result.cold_start_prob, np.float64),
            np.asarray(result.avg_server_count, np.float64),
            np.asarray(result.wasted_ratio, np.float64),
        )

    # stage 1: the smallest threshold meeting the SLO (the largest otherwise)
    chosen = {}
    for name in names:
        ok = tables[name][0] <= cold_slo
        chosen[name] = int(np.argmax(ok)) if ok.any() else len(thresholds) - 1

    def total() -> float:
        return float(sum(tables[n][1][chosen[n]] for n in names))

    # stage 2: step down the function that frees the most replicas
    n_cluster = float(fleet.n_cluster)
    while total() > n_cluster:
        savings = {
            n: tables[n][1][chosen[n]] - tables[n][1][chosen[n] - 1]
            for n in names
            if chosen[n] > 0
        }
        movable = {n: v for n, v in savings.items() if v > 0}
        if movable:
            chosen[max(movable, key=movable.get)] -= 1
        elif savings:  # every remaining step is lateral or worse: take one
            chosen[max(savings, key=savings.get)] -= 1
        else:
            break  # everything at the floor: infeasible

    predicted_total = total()
    headroom = n_cluster - predicted_total
    plans = {}
    for name in names:
        i = chosen[name]
        cold, avg, wasted = tables[name]
        plans[name] = PlanResult(
            expiration_threshold=thresholds[i],
            predicted_cold_prob=float(cold[i]),
            predicted_avg_replicas=float(avg[i]),
            predicted_wasted_ratio=float(wasted[i]),
            cluster_headroom=headroom,
        )
    return FleetPlan(
        plans=plans,
        feasible=predicted_total <= n_cluster,
        n_cluster=n_cluster,
        predicted_total_replicas=predicted_total,
        cluster_headroom=headroom,
    )
