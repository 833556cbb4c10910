"""Serving of the port: model replicas on the GPU (:mod:`.engine`), the
scale-per-request platform (:mod:`.platform`), the simulator-driven
keep-alive planners (:mod:`.autoscale`) and the live what-if service
(:mod:`.online`)."""

from repro_torch.serving.autoscale import (  # noqa: F401
    FleetPlan,
    PlanResult,
    ThresholdGovernor,
    plan_expiration_threshold,
    plan_fleet_thresholds,
    select_threshold,
)
from repro_torch.serving.online import (  # noqa: F401
    FleetRecommendation,
    OnlineConfig,
    OnlineFleetWhatIfService,
    OnlineWhatIfService,
    Recommendation,
    replay_arrivals,
)
