"""SimFaaS in PyTorch and CUDA: the port of the ``repro`` package's
simulator to an NVIDIA H100.

The front door is the same Scenario API: ``run``/``sweep`` on the f32
block engines, whose hot loops are the hand-written CUDA kernels
``kernels/csrc/faas_event_step.cu`` (engines ``scan`` and ``temporal``)
and ``kernels/csrc/par_event_step.cu`` (engine ``par``), and the fleet
front door ``fleet_run``/``fleet_sweep`` (function pools under a shared
cluster capacity) on ``kernels/csrc/fleet_event_step.cu``.  Entry points
run on the GPU unless called with ``device="cpu"``, which selects the
plain PyTorch versions of the kernels.  This package imports torch and
numpy only.
"""

from repro_torch.core import (  # noqa: F401
    BillingModel,
    DeterministicSimProcess,
    Execution,
    ExpSimProcess,
    FleetFunction,
    FleetGridResult,
    FleetResult,
    FleetScenario,
    FleetSummary,
    GaussianSimProcess,
    GridResult,
    InstanceSnapshot,
    LogNormalSimProcess,
    ParSimulationSummary,
    ParetoSimProcess,
    Result,
    Scenario,
    SimProcess,
    SimulationSummary,
    TemporalSummary,
    WeibullSimProcess,
    fleet_run,
    fleet_sweep,
    run,
    sweep,
)

__all__ = [
    "BillingModel",
    "Execution",
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
