#!/usr/bin/env python3
"""Reference constants for the fleet phase of ``chip_smoke.py``.

Runs the JAX package's ``fleet_sweep(..., backend="ref")`` (the f32 block
mirror, on the CPU) on the full 8-function catalog fleet of
``benchmarks/run.py::bench_fleet_sweep`` (``n_cluster=24``,
``skip_time=20``, ``slots=64``) at ``FleetScenario``'s default
``sim_time`` of 1e5 s, at the threshold grid's first cell (60 s, the one
with the most cold starts), and prints per function the cold-start
probability and the cluster's average occupancy: the value pooled over
replicas (as ``FleetSummary`` reports it) and the standard error of the
per-replica values.  ``chip_smoke.py`` stores them as ``REF_FLEET``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/fleet_reference.py [--replicas 8]

Needs JAX; the port does not.
"""

import argparse
import json

import jax
import numpy as np

from repro.core.fleet import fleet_sweep
from repro.data.catalog import catalog_names, fleet_of


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threshold", type=float, default=60.0)
    args = ap.parse_args()
    fleet = fleet_of(list(catalog_names()), n_cluster=24, skip_time=20.0, slots=64)
    R = args.replicas
    grid = fleet_sweep(
        fleet, {"expiration_threshold": [args.threshold]}, jax.random.key(args.seed),
        replicas=R, backend="ref",
    )
    summaries = grid.summaries[0]  # [F] per-function summaries over replicas
    cold, cold_se = [], []
    occ_r = np.zeros(R)
    for s in summaries:
        served = s.n_cold + s.n_warm
        per_rep = s.n_cold / np.maximum(served, 1)
        cold.append(float(s.cold_start_prob))
        cold_se.append(float(per_rep.std(ddof=1) / np.sqrt(R)))
        occ_r += (s.time_running + s.time_idle) / s.measured_time
    out = dict(
        threshold=args.threshold,
        replicas=R,
        functions=list(fleet.names),
        cold_start_prob=cold,
        cold_start_prob_se=cold_se,
        avg_cluster_occupancy=float(occ_r.mean()),
        avg_cluster_occupancy_se=float(occ_r.std(ddof=1) / np.sqrt(R)),
        max_peak_cluster=float(np.asarray(grid.peak_cluster).max()),
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
