"""SimFaaS core in PyTorch: the Scenario front door on the f32 block engines.

>>> from repro_torch.core import Scenario, ExpSimProcess, run, sweep
>>> scn = Scenario(arrival_process=ExpSimProcess(rate=0.9), ...)
>>> res = run(scn, seed=0, replicas=8)                # on the GPU
>>> res = run(scn, seed=0, engine="par")              # concurrency value
>>> res = run(scn, seed=0, engine="temporal", grid=[...],
...           initial_instances=[InstanceSnapshot(age=30.0, remaining=1.5)])
>>> grid = sweep(scn, over={"expiration_threshold": [...],
...                         "arrival_rate": [...]}, seed=0)
>>> grid = sweep(scn, over=..., seed=0, device="cpu")  # plain version
>>> from repro_torch.data.catalog import fleet_of
>>> fleet = fleet_of(["thumbnail", "ml-inference"], n_cluster=8)
>>> res = fleet_run(fleet, seed=0, replicas=16)       # shared capacity
>>> grid = fleet_sweep(fleet, {"expiration_threshold": [60.0, 600.0]}, seed=0)
"""

from repro_torch.core.cost import BillingModel, CostEstimate, estimate_cost
from repro_torch.core.execution import (
    Execution,
    plan_of,
    register_backend,
    resolve_backend,
)
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
    DeterministicSimProcess,
    ExpSimProcess,
    GaussianSimProcess,
    LogNormalSimProcess,
    ParetoSimProcess,
    SimProcess,
    WeibullSimProcess,
)
from repro_torch.core.par_simulator import ParSimulationSummary
from repro_torch.core.scenario import GridResult, Result, Scenario, run, sweep
from repro_torch.core.simulator import SimulationSummary
from repro_torch.core.temporal import InstanceSnapshot, TemporalSummary

__all__ = [
    "BillingModel",
    "CostEstimate",
    "estimate_cost",
    "Execution",
    "plan_of",
    "register_backend",
    "resolve_backend",
    "SimProcess",
    "ExpSimProcess",
    "DeterministicSimProcess",
    "GaussianSimProcess",
    "WeibullSimProcess",
    "LogNormalSimProcess",
    "ParetoSimProcess",
    "Scenario",
    "Result",
    "GridResult",
    "SimulationSummary",
    "ParSimulationSummary",
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
