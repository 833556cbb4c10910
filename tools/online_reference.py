#!/usr/bin/env python3
"""Reference constants for the online what-if phase of ``chip_smoke.py``.

Feeds phase 15's stream (``chip_smoke.online_trace``: a numpy realisation
of ``SinusoidalRate(1.2, 0.6, 800)``, cut into the ticks' 120 s batches)
through the JAX package's ``OnlineWhatIfService`` with phase 15's config,
takes the last tick's EMA-blended profile (the port fits the same one, bit
for bit), and sweeps it with the JAX package's f64 scan on the CPU at the
service's pinned candidate width: per threshold, the cold-start
probability pooled over replicas and the standard error of the
per-replica values.  ``chip_smoke.py`` stores the output as
``REF_ONLINE``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/online_reference.py [--replicas 512]

Needs JAX; the port does not.
"""

import argparse
import json
import sys
from pathlib import Path

import jax
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (numpy only at import)
from repro.core.processes import ExpSimProcess, NHPPArrivalProcess  # noqa: E402
from repro.core.scenario import Scenario, sweep  # noqa: E402
from repro.serving.online import OnlineConfig, OnlineWhatIfService  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, default=chip_smoke.ONLINE_CONFIG["replicas"])
    ap.add_argument("--seed", type=int, default=0, help="the stream's seed (chip_smoke --seed)")
    ap.add_argument("--key", type=int, default=0, help="the sweep's jax.random key")
    args = ap.parse_args()
    base = Scenario(  # chip_smoke.table1
        arrival_process=ExpSimProcess(rate=0.9),
        warm_service_process=ExpSimProcess(rate=1 / 1.991),
        cold_service_process=ExpSimProcess(rate=1 / 2.244),
        expiration_threshold=600.0, max_concurrency=1000, sim_time=1e5, skip_time=100.0,
        slots=64,
    )
    cfg = OnlineConfig(**dict(chip_smoke.ONLINE_CONFIG, replicas=args.replicas))
    svc = OnlineWhatIfService(base, cfg)
    profile = None
    for batch in chip_smoke.online_batches(args.seed):
        svc.observe(batch)
        profile = svc.estimate()  # a tick's one estimate
    scn = Scenario.of(svc._base, arrival_process=NHPPArrivalProcess(profile=profile),
                      rate_profile=None, arrival_rate=None)
    R = args.replicas
    grid = sweep(scn, over={"expiration_threshold": list(cfg.thresholds)},
                 key=jax.random.key(args.key), replicas=R, steps=svc._steps)
    cold, cold_se = [], []
    for i in range(len(cfg.thresholds)):
        s = grid.summaries[i]
        per = s.n_cold / np.maximum(s.n_cold + s.n_warm, 1)
        cold.append(float(s.cold_start_prob))
        cold_se.append(float(per.std(ddof=1) / np.sqrt(R)))
    print(json.dumps(dict(
        seed=args.seed, replicas=R, steps=svc._steps, thresholds=list(cfg.thresholds),
        rates=[float(r) for r in profile.rates], cold_start_prob=cold,
        cold_start_prob_se=cold_se,
    )))


if __name__ == "__main__":
    main()
