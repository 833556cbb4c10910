#!/usr/bin/env python3
"""Reference constants for the platform-fault phase of ``chip_smoke.py``.

Runs the JAX package's exact f64 scan (its default backend, on the CPU) on
the two fault workloads the phase drives, and prints them as JSON:

* ``REF_FAULT``: ``benchmarks/run.py::bench_fault_sweep``'s full grid.
  ``paper_cfg`` (Exp(0.9) arrivals, warm mean 1.991 s, cold mean 2.244 s,
  64 slots) at ``sim_time`` 4000 s, ``skip_time`` 50 s, ``max_concurrency``
  30, ``FaultModel(capacity=CapacityProfile(edges=(1600, 2800),
  values=(40, 2, 40)))``, over ``crash_rate`` [1e-4, 1e-3, 5e-3, 2e-2] x
  ``expiration_threshold`` [30, 120, 600], 5,400 steps.  For each cell:
  availability, cold-start probability (both pooled over replicas, as the
  summaries report them) and the average instance count (the replica
  mean), each with the standard error of its per-replica values.
* ``REF_FLEET_FAULT``: ``examples/chaos.py``'s capacity-dip fleet (``api``
  and ``batch``, ``n_cluster`` 40, ``crash_rate`` 2e-3, ceiling 40 -> 10
  -> 40 at 0.4 T and 0.7 T, T = 1000 s, ``skip_time`` 0) through
  ``fleet_run``: per function the availability and its standard error.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/fault_reference.py [--replicas 64]

Needs JAX; the port does not.
"""

import argparse
import json

import jax
import numpy as np

from repro.core import ExpSimProcess, Scenario, sweep
from repro.core.faults import CapacityProfile, FaultModel
from repro.core.fleet import FleetFunction, FleetScenario, fleet_run

CRASH_RATES = [1e-4, 1e-3, 5e-3, 2e-2]
THRESHOLDS = [30.0, 120.0, 600.0]
SIM_TIME = 4000.0
STEPS = 5400
DIP_T = 1000.0


def fault_scenario() -> Scenario:
    return Scenario(
        arrival_process=ExpSimProcess(rate=0.9),
        warm_service_process=ExpSimProcess(rate=1 / 1.991),
        cold_service_process=ExpSimProcess(rate=1 / 2.244),
        expiration_threshold=120.0,
        sim_time=SIM_TIME,
        skip_time=50.0,
        max_concurrency=30,
        slots=64,
        faults=FaultModel(
            crash_rate=CRASH_RATES[0],
            capacity=CapacityProfile(
                edges=(SIM_TIME * 0.4, SIM_TIME * 0.7), values=(40.0, 2.0, 40.0)
            ),
        ),
    )


def dip_fleet() -> FleetScenario:
    fn = lambda name, rate, warm, cold, thr, limit: FleetFunction(
        name=name,
        arrival_process=ExpSimProcess(rate=rate),
        warm_service_process=ExpSimProcess(rate=warm),
        cold_service_process=ExpSimProcess(rate=cold),
        expiration_threshold=thr,
        max_concurrency=limit,
    )
    return FleetScenario(
        functions=(fn("api", 0.8, 0.5, 0.25, 60.0, 25), fn("batch", 0.3, 0.2, 0.1, 120.0, 20)),
        n_cluster=40,
        sim_time=DIP_T,
        skip_time=0.0,
        faults=FaultModel(
            crash_rate=2e-3,
            capacity=CapacityProfile(edges=(0.4 * DIP_T, 0.7 * DIP_T), values=(40.0, 10.0, 40.0)),
        ),
    )


def se(x) -> float:
    x = np.asarray(x, np.float64)
    return float(x.std(ddof=1) / np.sqrt(x.size))


def availability_per_replica(s) -> np.ndarray:
    return 1.0 - s.n_interrupt / np.maximum(s.n_cold + s.n_warm, 1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    R = args.replicas
    grid = sweep(
        fault_scenario(), {"crash_rate": CRASH_RATES, "expiration_threshold": THRESHOLDS},
        jax.random.key(args.seed), replicas=R, steps=STEPS,
    )
    cells = {k: [] for k in ("availability", "cold_start_prob", "avg_server_count")}
    ses = {k: [] for k in cells}
    for s in grid.summaries.ravel():
        served = np.maximum(s.n_cold + s.n_warm, 1)
        cells["availability"].append(float(s.availability))
        ses["availability"].append(se(availability_per_replica(s)))
        cells["cold_start_prob"].append(float(s.cold_start_prob))
        ses["cold_start_prob"].append(se(s.n_cold / served))
        cells["avg_server_count"].append(float(s.avg_server_count))
        ses["avg_server_count"].append(se((s.time_running + s.time_idle) / s.measured_time))
    fault = dict(replicas=R, seed=args.seed, crash_rate=CRASH_RATES,
                 expiration_threshold=THRESHOLDS, **cells,
                 **{f"{k}_se": v for k, v in ses.items()})
    res = fleet_run(dip_fleet(), jax.random.key(args.seed + 1), replicas=R)
    fleet = dict(
        replicas=R, seed=args.seed + 1, functions=list(res.fleet.names),
        availability=[float(s.availability) for s in res.summary.summaries],
        availability_se=[se(availability_per_replica(s)) for s in res.summary.summaries],
        n_evict=[float(np.sum(s.n_evict)) / R for s in res.summary.summaries],
    )
    print(json.dumps(dict(REF_FAULT=fault, REF_FLEET_FAULT=fleet)))


if __name__ == "__main__":
    main()
