#!/usr/bin/env python3
"""The fail-only ``run()`` of ``chip_smoke.py`` at several seeds, held to
its expected values, and a probe of the exponential sampler's tail.

Table 1's workload (Exp(0.9) arrivals, warm mean 1.991 s, cold mean
2.244 s, 64 slots, 1e5 s, 100 s warm-up) under
``FailurePolicy(p_fail=0.05, t_timeout=8)`` without retries.  An arrival's
service draw is independent of whether it lands warm or cold (that depends
on earlier draws only), so given the counts of warm and cold starts:

- the timeout share is ``(n_warm e^(-8/1.991) + n_cold e^(-8/2.244)) /
  served``;
- the failure share is 0.05 times the share that did not time out;
- the warm (cold) response sum is ``n_warm`` times ``E[min(X, 8)] =
  m (1 - e^(-8/m))`` for X ~ Exp(mean m).

Each is printed per seed with its distance in standard errors, then pooled
over the seeds.  The probe draws ``--probe-draws`` samples of each service
process as the port draws them (``ExpSimProcess.sample_into``, f32) and
holds the share above 8 s and the mean of ``min(X, 8)`` to their exact
values.

    PYTHONPATH=src python tools/fail_only_seeds.py                  # on the GPU
    PYTHONPATH=src python tools/fail_only_seeds.py --device cpu --replicas 8 \\
        --sim-time 2e4 --probe-draws 1e6                            # small, on the CPU
"""

import argparse
import json
import math
import time

import numpy as np
import torch

import repro_torch as rt

T_TO, P_FAIL = 8.0, 0.05
MEANS = {"warm": 1.991, "cold": 2.244}


def min_moments(m, c=T_TO):
    """Mean and variance of min(X, c) for X ~ Exp(mean m)."""
    e = math.exp(-c / m)
    mean = m * (1 - e)
    second = 2 * m * m * (1 - e * (1 + c / m))
    return mean, second - mean * mean


def expected(n_warm, n_cold):
    """Expected values and variances of the run's totals given its labels."""
    p = {k: math.exp(-T_TO / m) for k, m in MEANS.items()}
    n = {"warm": n_warm, "cold": n_cold}
    out = {
        "n_timeout": (sum(n[k] * p[k] for k in n), sum(n[k] * p[k] * (1 - p[k]) for k in n)),
        "n_fail": (sum(n[k] * P_FAIL * (1 - p[k]) for k in n),
                   sum(n[k] * P_FAIL * (1 - p[k]) * (1 - P_FAIL * (1 - p[k])) for k in n)),
    }
    for k, m in MEANS.items():
        mu, var = min_moments(m)
        out[f"sum_{k}_resp"] = (n[k] * mu, n[k] * var)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(5, 21)))
    ap.add_argument("--replicas", type=int, default=4096)
    ap.add_argument("--sim-time", type=float, default=1e5)
    ap.add_argument("--probe-draws", type=float, default=4e9)
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args()
    dev = torch.device(args.device or "cuda")
    scn = rt.Scenario(
        arrival_process=rt.ExpSimProcess(rate=0.9),
        warm_service_process=rt.ExpSimProcess(rate=1 / MEANS["warm"]),
        cold_service_process=rt.ExpSimProcess(rate=1 / MEANS["cold"]),
        expiration_threshold=600.0, max_concurrency=1000, sim_time=args.sim_time,
        skip_time=100.0, slots=64,
        reliability=rt.Reliability(rt.FailurePolicy(p_fail=P_FAIL, t_timeout=T_TO)),
    )
    pooled = {}
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        s = rt.run(scn, seed=seed, replicas=args.replicas, device=args.device).summary
        wall = time.perf_counter() - t0
        n_warm, n_cold = float(s.n_warm.sum()), float(s.n_cold.sum())
        got = {f: float(np.asarray(getattr(s, f), np.float64).sum())
               for f in ("n_timeout", "n_fail", "sum_warm_resp", "sum_cold_resp")}
        row = {"seed": seed, "served": n_warm + n_cold, "wall_s": wall}
        for f, (mu, var) in expected(n_warm, n_cold).items():
            z = (got[f] - mu) / math.sqrt(var)
            row[f] = {"got": got[f], "expected": mu, "z": z}
            g, m, v = pooled.get(f, (0.0, 0.0, 0.0))
            pooled[f] = (g + got[f], m + mu, v + var)
        rows.append(row)
        print(f"seed {seed}: served {row['served']:.0f}, " + ", ".join(
            f"{f} {row[f]['got']:.1f} vs {row[f]['expected']:.1f} ({row[f]['z']:+.2f} se)"
            for f in pooled) + f"; run() {wall:.2f} s", flush=True)
    pooled_z = {f: (g - m) / math.sqrt(v) for f, (g, m, v) in pooled.items()}
    print(f"pooled over {len(args.seeds)} seeds: " + ", ".join(
        f"{f} {z:+.2f} se" for f, z in pooled_z.items()), flush=True)
    zs = {f: [r[f]["z"] for r in rows] for f in pooled}
    print("per-seed z mean and sd: " + ", ".join(
        f"{f} {np.mean(v):+.3f}/{np.std(v, ddof=1) if len(v) > 1 else float('nan'):.3f}"
        for f, v in zs.items()), flush=True)

    probe = {}
    chunk = 1 << 27
    n_draws = int(args.probe_draws)
    buf = torch.empty(min(chunk, n_draws), dtype=torch.float32, device=dev)
    for k, m in MEANS.items():
        proc = rt.ExpSimProcess(rate=1 / m)
        g = torch.Generator(device=dev)
        g.manual_seed(1234 + len(probe))
        above, min_sum, done = 0, 0.0, 0
        while done < n_draws:
            b = buf[: min(chunk, n_draws - done)]
            proc.sample_into(b, g)
            above += int((b > T_TO).sum())
            min_sum += float(b.clamp(max=T_TO).double().sum())
            done += b.numel()
        p = math.exp(-T_TO / m)
        mu, var = min_moments(m)
        probe[k] = {
            "draws": done, "share_above": above / done, "expected": p,
            "z_share": (above / done - p) / math.sqrt(p * (1 - p) / done),
            "mean_min": min_sum / done, "expected_mean_min": mu,
            "z_mean_min": (min_sum / done - mu) / math.sqrt(var / done),
        }
        print(f"sampler probe {k} (mean {m} s, {done} f32 draws on {dev}): P(x > 8) "
              f"{above / done:.8f} vs {p:.8f} ({probe[k]['z_share']:+.2f} se), "
              f"E[min(x, 8)] {min_sum / done:.7f} vs {mu:.7f} "
              f"({probe[k]['z_mean_min']:+.2f} se)", flush=True)
    print(json.dumps({"seeds": rows, "pooled_z": pooled_z, "probe": probe}))


if __name__ == "__main__":
    main()
