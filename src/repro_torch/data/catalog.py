"""SeBS-flavored workload catalog for fleet simulations.

Eight named function profiles loosely modeled on the SeBS serverless
benchmark suite (Copik et al.): each entry pins an arrival process, warm
and cold service processes, a memory footprint, and sensible defaults
for the keep-alive threshold and concurrency limit.  The catalog is the
input side of the fleet subsystem: ``fleet_of`` turns a list of names
into a ready-to-run :class:`~repro_torch.core.fleet.FleetScenario`.  The
port's copy of the reference catalog (the same entries, on the port's
samplers).

The numbers are synthetic but shaped like the public SeBS measurements:
interactive endpoints (thumbnailer, dynamic-html) are sub-second with
2-5x cold-start multipliers, batch-ish workloads (video transcode, DNA
visualization) run tens of seconds with modest relative cold overhead,
and ML inference sits in between with a large model-load cold penalty.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.fleet import FleetFunction, FleetScenario
from repro_torch.core.processes import (
    ExpSimProcess,
    GaussianSimProcess,
    LogNormalSimProcess,
)

__all__ = ["CATALOG", "catalog_names", "get_function", "fleet_of"]


def _fn(
    name: str,
    *,
    rate: float,
    warm_mean: float,
    cold_mean: float,
    memory_gb: float,
    expiration_threshold: float = 600.0,
    max_concurrency: int = 1000,
    warm_sigma: Optional[float] = None,
    cold_sigma: Optional[float] = None,
) -> FleetFunction:
    """Gaussian service times (clamped positive) around the given means;
    exponential arrivals.  Sigma defaults to 20% of the mean."""
    return FleetFunction(
        name=name,
        arrival_process=ExpSimProcess(rate=rate),
        warm_service_process=GaussianSimProcess(
            mu=warm_mean,
            sigma=warm_sigma if warm_sigma is not None else 0.2 * warm_mean,
        ),
        cold_service_process=GaussianSimProcess(
            mu=cold_mean,
            sigma=cold_sigma if cold_sigma is not None else 0.2 * cold_mean,
        ),
        expiration_threshold=expiration_threshold,
        max_concurrency=max_concurrency,
        memory_gb=memory_gb,
    )


CATALOG: Dict[str, FleetFunction] = {
    # Interactive, high-rate, tiny footprint.
    "thumbnail": _fn(
        "thumbnail",
        rate=0.9,
        warm_mean=0.25,
        cold_mean=1.2,
        memory_gb=0.128,
    ),
    "dynamic-html": _fn(
        "dynamic-html",
        rate=1.4,
        warm_mean=0.08,
        cold_mean=0.45,
        memory_gb=0.128,
    ),
    # CPU-bound medium jobs.
    "compression": _fn(
        "compression",
        rate=0.25,
        warm_mean=2.8,
        cold_mean=4.5,
        memory_gb=0.512,
    ),
    "crypto-sign": _fn(
        "crypto-sign",
        rate=0.6,
        warm_mean=0.6,
        cold_mean=1.8,
        memory_gb=0.256,
    ),
    # Long batch-ish workloads: low rate, long service, small relative
    # cold overhead, generous keep-alive.
    "video-transcode": _fn(
        "video-transcode",
        rate=0.04,
        warm_mean=28.0,
        cold_mean=33.0,
        memory_gb=2.048,
        expiration_threshold=900.0,
    ),
    "dna-visualization": _fn(
        "dna-visualization",
        rate=0.08,
        warm_mean=9.0,
        cold_mean=12.5,
        memory_gb=1.024,
    ),
    # Model-serving: heavy-tailed warm latency, big model-load cold hit.
    "ml-inference": FleetFunction(
        name="ml-inference",
        arrival_process=ExpSimProcess(rate=0.5),
        warm_service_process=LogNormalSimProcess(mu=0.1, sigma=0.45),
        cold_service_process=GaussianSimProcess(mu=8.0, sigma=1.2),
        expiration_threshold=600.0,
        max_concurrency=1000,
        memory_gb=3.008,
    ),
    # Graph analytics, bursty-ish medium jobs.
    "graph-bfs": _fn(
        "graph-bfs",
        rate=0.15,
        warm_mean=3.5,
        cold_mean=6.0,
        memory_gb=0.512,
    ),
}


def catalog_names() -> Tuple[str, ...]:
    return tuple(CATALOG)


def get_function(name: str, **overrides) -> FleetFunction:
    """Fetch a catalog profile, optionally overriding any field
    (``rate`` is accepted as shorthand for rescaling the arrival process)."""
    try:
        fn = CATALOG[name]
    except KeyError:
        raise KeyError(
            f"unknown catalog function {name!r}; available: "
            f"{', '.join(sorted(CATALOG))}"
        ) from None
    rate = overrides.pop("rate", None)
    if rate is not None:
        overrides["arrival_process"] = fn.arrival_process.with_rate(rate)
    return dataclasses.replace(fn, **overrides) if overrides else fn


def fleet_of(
    names: Sequence[str],
    *,
    n_cluster: float = float("inf"),
    queue_depth: int = 0,
    sim_time: float = 1e5,
    skip_time: float = 100.0,
    slots: int = 64,
    overrides: Optional[Dict[str, Dict]] = None,
) -> FleetScenario:
    """Build a :class:`FleetScenario` from catalog names.

    ``overrides`` maps a function name to keyword overrides passed to
    :func:`get_function` (e.g. ``{"thumbnail": {"rate": 2.0}}``).
    """
    overrides = overrides or {}
    unknown = set(overrides) - set(names)
    if unknown:
        raise KeyError(
            f"overrides for functions not in the fleet: {sorted(unknown)}"
        )
    functions = tuple(
        get_function(n, **overrides.get(n, {})) for n in names
    )
    return FleetScenario(
        functions=functions,
        n_cluster=n_cluster,
        queue_depth=queue_depth,
        sim_time=sim_time,
        skip_time=skip_time,
        slots=slots,
    )
