#!/usr/bin/env python3
"""Reference constants for the diurnal what-if sweep of ``chip_smoke.py``'s
non-stationary phase.

Runs the JAX package's ``sweep()`` (its default exact f64 scan backend, on
the CPU) on the scenario of ``examples/diurnal.py`` at the scale of a real
day: NHPP arrivals under ``SinusoidalRate(base=0.9, amplitude=a,
period=P)``, warm mean 1.991 s, cold mean 2.244 s, 64 slots, ``sim_time``
86,400 s, ``skip_time`` 0, over the ``profile`` axis (a in 0.1 .. 0.8,
P in 86,400 and 43,200 s: 16 profiles, amplitude-major) x
``expiration_threshold`` [60, 120, 300, 600].  For each cell it prints the
whole-day cold-start probability (pooled over replicas, as the summaries
report it) and the average instance count (the replica mean), each with
the standard error of its per-replica values.  ``chip_smoke.py`` stores
them as ``REF_NHPP``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/nhpp_reference.py [--replicas 64]

Needs JAX; the port does not.  It takes ~11 minutes at 64 replicas on 8
cores.
"""

import argparse
import json
import time

import jax
import numpy as np

from repro.core import ExpSimProcess, Scenario, SinusoidalRate, sweep

AMPLITUDES = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8]
PERIODS = [86400.0, 43200.0]
THRESHOLDS = [60.0, 120.0, 300.0, 600.0]
DAY = 86400.0


def profiles():
    return [SinusoidalRate(base=0.9, amplitude=a, period=p)
            for a in AMPLITUDES for p in PERIODS]


def scenario() -> Scenario:
    return Scenario(
        rate_profile=profiles()[0],
        warm_service_process=ExpSimProcess(rate=1 / 1.991),
        cold_service_process=ExpSimProcess(rate=1 / 2.244),
        expiration_threshold=THRESHOLDS[0],
        sim_time=DAY,
        skip_time=0.0,
        slots=64,
    )


def se(x) -> float:
    x = np.asarray(x, np.float64)
    return float(x.std(ddof=1) / np.sqrt(x.size))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    R = args.replicas
    t0 = time.perf_counter()
    grid = sweep(
        scenario(),
        {"profile": profiles(), "expiration_threshold": THRESHOLDS},
        jax.random.key(args.seed), replicas=R,
    )
    cells = {k: [] for k in ("cold_start_prob", "avg_server_count")}
    ses = {k: [] for k in cells}
    for s in grid.summaries.ravel():
        served = np.maximum(s.n_cold + s.n_warm, 1)
        cells["cold_start_prob"].append(float(s.cold_start_prob))
        ses["cold_start_prob"].append(se(s.n_cold / served))
        cells["avg_server_count"].append(float(s.avg_server_count))
        ses["avg_server_count"].append(se((s.time_running + s.time_idle) / s.measured_time))
    out = dict(replicas=R, seed=args.seed, sim_time=DAY, amplitude=AMPLITUDES,
               period=PERIODS, expiration_threshold=THRESHOLDS, **cells,
               **{f"{k}_se": v for k, v in ses.items()},
               seconds=round(time.perf_counter() - t0, 1))
    print(json.dumps(dict(REF_NHPP=out)))


if __name__ == "__main__":
    main()
