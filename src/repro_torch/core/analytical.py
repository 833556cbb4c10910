"""Closed-form performance results used to validate the simulator (a copy
of ``repro/core/analytical.py``: math only, so the port imports nothing of
the reference).

The paper positions SimFaaS as the tool for regimes analytical models can't
reach; conversely, where closed forms *do* exist they are exact oracles for
the simulator.  The tests hold the port's ``run()`` to them, as the
reference's tests hold its engines (Mahmoudi & Khazaei 2020a).
"""

from __future__ import annotations

import math


def littles_law_running(arrival_rate: float, mean_service: float) -> float:
    """E[# running instances] = λ·E[S] (Little's law; exact for any service
    distribution in a loss-free scale-per-request platform, since every
    accepted request occupies exactly one instance for its service time)."""
    return arrival_rate * mean_service


def mginf_busy_distribution(arrival_rate: float, mean_service: float, k: int) -> float:
    """P(#running = k) for the M/G/∞ busy-count: Poisson(λ·E[S]).

    Scale-per-request with no rejection is exactly M/G/∞ at the *running*
    level (each arrival gets its own server immediately); the warm pool only
    changes which server is used, not the busy count.  Insensitivity: only
    the mean service time matters.
    """
    rho = arrival_rate * mean_service
    return math.exp(-rho) * rho**k / math.factorial(k)


def deterministic_cold_start_prob(
    inter_arrival: float, expiration_threshold: float, service: float
) -> float:
    """Exact cold-start probability for D/D/∞ (deterministic arrivals and
    service, single request class).

    With inter-arrival d and service s:
    * if d > s + T_exp: every arrival finds the previous instance expired →
      all arrivals are cold (p → 1 asymptotically).
    * if s < d <= s + T_exp: one instance is reused forever → only the first
      arrival is cold (p → 0 asymptotically).
    * if d <= s: ceil(s/d) instances round-robin; after warm-up p → 0.
    """
    if inter_arrival > service + expiration_threshold:
        return 1.0
    return 0.0


def single_instance_renewal_cold_prob(
    arrival_rate: float, expiration_threshold: float
) -> float:
    """Cold-start probability in the light-traffic limit (λ·E[S] → 0) with
    Poisson arrivals: the pool almost always holds ≤1 instance, which
    expires iff an inter-arrival exceeds T_exp ⇒ p_cold ≈ P(A > T_exp)."""
    return math.exp(-arrival_rate * expiration_threshold)


def erlang_b(offered_load: float, servers: int) -> float:
    """Erlang-B loss probability: the rejection probability of the platform
    when T_exp → 0 (no warm pool ⇒ M/G/m/m loss system at the instance
    level, insensitive to the service distribution)."""
    b = 1.0
    for m in range(1, servers + 1):
        b = offered_load * b / (m + offered_load * b)
    return b


def utilization_bound(
    arrival_rate: float,
    mean_service: float,
    expiration_threshold: float,
) -> float:
    """Lower bound on wasted capacity: every served request is followed by
    ≥0 and ≤T_exp idle seconds on its instance; with reuse the idle tail is
    truncated by the next arrival.  Wasted ratio ≤ T_exp/(E[S]+T_exp)."""
    return expiration_threshold / (mean_service + expiration_threshold)
