#!/usr/bin/env python3
"""Reference constants for the retry sweep of ``chip_smoke.py``'s
reliability phase.

Runs the JAX package's ``sweep()`` (its default exact f64 scan backend, on
the CPU) on the workload of ``benchmarks/run.py::bench_retry_sweep`` at
``paper_cfg``'s horizon: Exp(0.9) arrivals, warm mean 1.991 s, cold mean
2.244 s, 64 slots, ``sim_time`` 2e5 s, ``skip_time`` 50 s,
``Reliability(FailurePolicy(p_fail=0.05, t_timeout=8), RetryPolicy(
max_retries=2, backoff_base=2, backoff_mult=2, backoff_jitter=0.3))`` over
``t_timeout`` [2, 4, 8, 16] × ``expiration_threshold`` [30, 120, 480].  For
each cell it prints the goodput (completions per second, the replica mean)
and the cold-start probability (pooled over replicas, as the summaries
report it), each with the standard error of its per-replica values.
``chip_smoke.py`` stores them as ``REF_RETRY``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/retry_reference.py [--replicas 8]

Needs JAX; the port does not.
"""

import argparse
import json

import jax
import numpy as np

from repro.core import ExpSimProcess, Scenario, sweep
from repro.core.reliability import FailurePolicy, Reliability, RetryPolicy

TIMEOUTS = [2.0, 4.0, 8.0, 16.0]
THRESHOLDS = [30.0, 120.0, 480.0]
RELIABILITY = Reliability(
    failure=FailurePolicy(p_fail=0.05, t_timeout=8.0),
    retry=RetryPolicy(max_retries=2, backoff_base=2.0, backoff_mult=2.0, backoff_jitter=0.3),
)


def scenario() -> Scenario:
    return Scenario(
        arrival_process=ExpSimProcess(rate=0.9),
        warm_service_process=ExpSimProcess(rate=1 / 1.991),
        cold_service_process=ExpSimProcess(rate=1 / 2.244),
        expiration_threshold=120.0,
        sim_time=2e5,
        skip_time=50.0,
        slots=64,
        reliability=RELIABILITY,
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    R = args.replicas
    grid = sweep(
        scenario(), {"t_timeout": TIMEOUTS, "expiration_threshold": THRESHOLDS},
        jax.random.key(args.seed), replicas=R,
    )
    se = lambda x: float(np.std(x, ddof=1) / np.sqrt(len(x)))
    goodput, goodput_se, cold, cold_se = [], [], [], []
    for i in range(len(TIMEOUTS)):
        for j in range(len(THRESHOLDS)):
            s = grid.summaries[i, j]
            per_rep = np.asarray(s.n_completions, np.float64) / s.measured_time
            served = np.maximum(s.n_cold + s.n_warm, 1)
            goodput.append(float(s.goodput))
            goodput_se.append(se(per_rep))
            cold.append(float(s.cold_start_prob))
            cold_se.append(se(s.n_cold / served))
    print(json.dumps(dict(
        replicas=R, seed=args.seed, t_timeout=TIMEOUTS, expiration_threshold=THRESHOLDS,
        goodput=goodput, goodput_se=goodput_se,
        cold_start_prob=cold, cold_start_prob_se=cold_se,
        retry_amplification=[float(s.retry_amplification) for s in grid.summaries.ravel()],
    )))


if __name__ == "__main__":
    main()
