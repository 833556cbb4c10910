"""SimFaaS core in PyTorch: the Scenario front door on the f64 engine (the
default, as in the reference) and the f32 block engines.

>>> from repro_torch.core import Scenario, ExpSimProcess, run, sweep
>>> scn = Scenario(arrival_process=ExpSimProcess(rate=0.9), ...)
>>> res = run(scn, seed=0, replicas=8)                # on the GPU, f64
>>> res = run(scn, seed=0, backend="cuda")            # the f32 block kernel
>>> res = run(scn, seed=0, engine="par")              # concurrency value
>>> res = run(scn, seed=0, engine="temporal", grid=[...],
...           initial_instances=[InstanceSnapshot(age=30.0, remaining=1.5)])
>>> grid = sweep(scn, over={"expiration_threshold": [...],
...                         "arrival_rate": [...]}, seed=0)
>>> grid = sweep(scn, over=..., seed=0, device="cpu")  # plain version
>>> day = Scenario.of(scn, arrival_process=None,
...                   rate_profile=SinusoidalRate(base=0.9, amplitude=0.5,
...                                               period=86400.0))
>>> grid = sweep(day, over={"profile": [...]}, seed=0)  # NHPP, prestamped
>>> rel = Reliability(FailurePolicy(p_fail=0.05, t_timeout=8.0),
...                   RetryPolicy(max_retries=2, backoff_base=2.0))
>>> grid = sweep(Scenario.of(scn, reliability=rel),
...              over={"t_timeout": [2.0, 8.0]}, seed=0)    # goodput grid
>>> from repro_torch.data.catalog import fleet_of
>>> fleet = fleet_of(["thumbnail", "ml-inference"], n_cluster=8)
>>> res = fleet_run(fleet, seed=0, replicas=16)       # shared capacity, any F
>>> grid = sweep(scn, over={...}, seed=0,
...              execution=Execution(draws="fused"))  # draws in the f64 kernel
>>> grid = fleet_sweep(fleet, {"expiration_threshold": [60.0, 600.0]}, seed=0)
"""

from repro_torch.core.cost import BillingModel, CostEstimate, estimate_cost
from repro_torch.core.execution import (
    Execution,
    plan_of,
    register_backend,
    resolve_backend,
)
from repro_torch.core.faults import CapacityProfile, FaultModel
from repro_torch.core.fleet import (
    FleetFunction,
    FleetGridResult,
    FleetResult,
    FleetScenario,
    FleetSummary,
    fleet_run,
    fleet_sweep,
)
from repro_torch.core.processes import (
    ArrivalTimeProcess,
    BatchArrivalProcess,
    CustomSimProcess,
    DeterministicSimProcess,
    EmpiricalSimProcess,
    ExpSimProcess,
    GammaSimProcess,
    GaussianSimProcess,
    LogNormalSimProcess,
    MMPPArrivalProcess,
    NHPPArrivalProcess,
    ParetoSimProcess,
    PiecewiseConstantRate,
    RateProfile,
    SimProcess,
    SinusoidalRate,
    TraceArrivalProcess,
    WeibullSimProcess,
)
from repro_torch.core.par_simulator import ParServerlessSimulator, ParSimulationSummary
from repro_torch.core.reliability import FailurePolicy, Reliability, RetryPolicy
from repro_torch.core.scenario import GridResult, Result, Scenario, run, sweep
from repro_torch.core.simulator import (
    ServerlessSimulator,
    SimulationSummary,
    WindowedMetrics,
)
from repro_torch.core.temporal import (
    InstanceSnapshot,
    ServerlessTemporalSimulator,
    TemporalSummary,
)

__all__ = [
    "BillingModel",
    "CostEstimate",
    "estimate_cost",
    "Execution",
    "plan_of",
    "register_backend",
    "resolve_backend",
    "SimProcess",
    "ArrivalTimeProcess",
    "ExpSimProcess",
    "DeterministicSimProcess",
    "GaussianSimProcess",
    "WeibullSimProcess",
    "GammaSimProcess",
    "LogNormalSimProcess",
    "ParetoSimProcess",
    "BatchArrivalProcess",
    "CustomSimProcess",
    "EmpiricalSimProcess",
    "MMPPArrivalProcess",
    "NHPPArrivalProcess",
    "TraceArrivalProcess",
    "RateProfile",
    "PiecewiseConstantRate",
    "SinusoidalRate",
    "Scenario",
    "Result",
    "GridResult",
    "SimulationSummary",
    "WindowedMetrics",
    "ParSimulationSummary",
    "ServerlessSimulator",
    "ServerlessTemporalSimulator",
    "ParServerlessSimulator",
    "FailurePolicy",
    "RetryPolicy",
    "Reliability",
    "CapacityProfile",
    "FaultModel",
    "InstanceSnapshot",
    "TemporalSummary",
    "run",
    "sweep",
    "FleetFunction",
    "FleetScenario",
    "FleetSummary",
    "FleetResult",
    "FleetGridResult",
    "fleet_run",
    "fleet_sweep",
]
