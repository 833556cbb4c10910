"""Cost model (paper §4.4), numpy-only.

All serverless charges decompose into **per-request** charges and **runtime**
charges billed on execution time (memory·time).  The developer pays for the
*running* state only (idle is free to the developer); the provider's
infrastructure cost is proportional to *total* instance-time (running +
idle).
"""

from __future__ import annotations

import dataclasses

# AWS Lambda list prices (us-east-1, 2020-era, matching the paper's setup).
AWS_PER_REQUEST = 0.20 / 1e6  # $ per request
AWS_PER_GB_SECOND = 0.0000166667  # $ per GB-s


@dataclasses.dataclass(frozen=True)
class BillingModel:
    per_request: float = AWS_PER_REQUEST
    per_gb_second: float = AWS_PER_GB_SECOND
    memory_gb: float = 0.128  # paper experiments: 128 MB functions
    provider_instance_cost_per_hour: float = 0.0116  # infra $ proxy/instance-h


@dataclasses.dataclass
class CostEstimate:
    developer_request_cost: float
    developer_runtime_cost: float
    provider_infra_cost: float
    horizon: float

    @property
    def developer_total(self) -> float:
        return self.developer_request_cost + self.developer_runtime_cost

    @property
    def provider_margin_ratio(self) -> float:
        """Developer runtime revenue over provider infra cost."""
        if self.provider_infra_cost <= 0:
            return float("inf")
        return self.developer_runtime_cost / self.provider_infra_cost


def estimate_cost(summary, billing: BillingModel = BillingModel()) -> CostEstimate:
    """Costs over the measured window of a ``SimulationSummary``,
    normalised per replica.

    Retry-billed by construction: under a reliability policy every served
    attempt lands in ``n_cold``/``n_warm`` (and its cut-at-timeout runtime
    in ``time_running``), so failed and timed-out attempts are charged as
    the platforms charge them."""
    replicas = max(len(summary.n_cold), 1)
    served = float((summary.n_cold + summary.n_warm).sum()) / replicas
    running_time = float(summary.time_running.sum()) / replicas
    total_time = float((summary.time_running + summary.time_idle).sum()) / replicas
    return CostEstimate(
        developer_request_cost=served * billing.per_request,
        developer_runtime_cost=running_time * billing.memory_gb * billing.per_gb_second,
        provider_infra_cost=total_time / 3600.0 * billing.provider_instance_cost_per_hour,
        horizon=summary.measured_time,
    )


def cost_per_completion(summary, billing: BillingModel = BillingModel()) -> float:
    """Developer $ per successful completion: the numerator bills every
    attempt (see :func:`estimate_cost`), the denominator counts only the
    attempts that neither timed out nor failed.  On a run without
    reliability, completions are the served requests."""
    est = estimate_cost(summary, billing)
    replicas = max(len(summary.n_cold), 1)
    completions = float(summary.n_completions.sum()) / replicas
    return est.developer_total / max(completions, 1e-12)
