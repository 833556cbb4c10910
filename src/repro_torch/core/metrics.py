"""Metric utilities of the PyTorch port: PDF/CDF estimation, CIs, error
metrics and the reliability report (numpy only).

The port's copy of ``repro/core/metrics.py`` (it imports nothing of the
reference).  Paper §3: "tools that can accept custom state encoding and
generate approximations for Probability Density Functions (PDF) and
Cumulative Distribution Functions (CDF) from the simulations, which can help
debug several parts of a given analytical performance model."
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np


def empirical_pdf(samples: np.ndarray, bins: int = 64, range_: Optional[tuple] = None):
    """Histogram-based PDF estimate → (bin_centers, density)."""
    density, edges = np.histogram(samples, bins=bins, range=range_, density=True)
    centers = 0.5 * (edges[1:] + edges[:-1])
    return centers, density


def empirical_cdf(samples: np.ndarray):
    """Exact empirical CDF → (sorted_x, F(x))."""
    x = np.sort(np.asarray(samples).ravel())
    f = np.arange(1, x.size + 1) / x.size
    return x, f


def compare_with_analytical_cdf(
    samples: np.ndarray, cdf_fn: Callable[[np.ndarray], np.ndarray]
) -> dict:
    """Kolmogorov–Smirnov distance + MAE between empirical and analytical
    CDFs (the paper's model-debugging workflow)."""
    x, f_emp = empirical_cdf(samples)
    f_ana = np.asarray(cdf_fn(x), dtype=np.float64)
    ks = float(np.max(np.abs(f_emp - f_ana)))
    mae = float(np.mean(np.abs(f_emp - f_ana)))
    return {"ks": ks, "mae": mae}


def histogram_to_distribution(hist: np.ndarray) -> np.ndarray:
    """Normalise an instance-count time-histogram (Fig. 3: portion of time
    with a specific number of instances)."""
    h = np.asarray(hist, dtype=np.float64)
    if h.ndim == 2:  # [replicas, bins] → pool replicas
        h = h.sum(0)
    total = h.sum()
    return h / total if total > 0 else h


def mean_confidence_interval(values: Sequence[float], z: float = 1.96):
    """(mean, half-width) normal-approximation CI across replicas/runs."""
    v = np.asarray(values, dtype=np.float64)
    if v.size < 2:
        return float(v.mean()), 0.0
    se = v.std(ddof=1) / np.sqrt(v.size)
    return float(v.mean()), float(z * se)


def mape(pred: Sequence[float], truth: Sequence[float]) -> float:
    """Mean Absolute Percentage Error — the paper's Figs 6-8 metric."""
    p = np.asarray(pred, dtype=np.float64)
    t = np.asarray(truth, dtype=np.float64)
    mask = np.abs(t) > 1e-12
    return float(np.mean(np.abs((p[mask] - t[mask]) / t[mask])) * 100.0)


def reliability_report(summary) -> dict:
    """Attempts-vs-completions view of a reliability or fault run.

    Takes a :class:`~repro_torch.core.simulator.SimulationSummary` from a
    run with ``Scenario.reliability=`` and/or ``Scenario.faults=`` set and
    flattens its derived metrics into one plain dict: served attempts (the
    retry-amplified load the platform carried), successful completions,
    per-outcome counts, goodput (completions per second of measured time)
    and the retry amplification factor (attempts per distinct request).
    Runs with a fault model also report instance crashes, capacity
    evictions, crash-interrupted attempts and availability; either layer
    alone is enough, and missing counters read as zero.
    """
    rely = summary.n_timeout is not None
    faults = summary.n_crash is not None
    if not (rely or faults):
        raise ValueError(
            "summary has no reliability or fault counters; run with "
            "Scenario.reliability= or Scenario.faults= set"
        )
    zero = np.zeros_like(np.asarray(summary.n_cold))
    rel = lambda x: x if x is not None else zero  # noqa: E731
    report = {
        "attempts": float(summary.n_attempts.sum()),
        "completions": float(summary.n_completions.sum()),
        "timeouts": float(rel(summary.n_timeout).sum()),
        "failures": float(rel(summary.n_fail).sum()),
        "retries": float(rel(summary.n_retry).sum()),
        "abandoned": float(rel(summary.n_abandon).sum()),
        "rejected": float(summary.n_reject.sum()),
        "timeout_prob": summary.timeout_prob,
        "failure_prob": summary.failure_prob,
        "goodput": summary.goodput,
        "retry_amplification": summary.retry_amplification,
    }
    if faults:
        report.update(
            crashes=float(summary.n_crash.sum()),
            evictions=float(summary.n_evict.sum()),
            interrupted=float(summary.n_interrupt.sum()),
            availability=summary.availability,
        )
    return report
