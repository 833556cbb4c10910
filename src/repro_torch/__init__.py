"""SimFaaS in PyTorch and CUDA: the port of the ``repro`` package's
simulator to an NVIDIA H100.

The front door is the same Scenario API: ``run``/``sweep`` on the f64
engine, the reference's default substrate and the port's default too
(backend ``"scan"``: ``kernels/csrc/scan_event_step.cu``, with fused draws
and inline NHPP thinning, and ``par_scan_event_step.cu``, with the
``ServerlessSimulator``, ``ServerlessTemporalSimulator`` and
``ParServerlessSimulator`` classes) or, when named (backend ``"cuda"``), on
the f32 block engines, whose hot loops are the hand-written CUDA kernels
``kernels/csrc/faas_event_step.cu`` (engines ``scan`` and ``temporal``;
metric windows, timeouts, failures, client retries and platform faults on
``scan``) and ``kernels/csrc/par_event_step.cu`` (engine ``par``).  The
fleet front door ``fleet_run``/``fleet_sweep`` (function pools under a
shared cluster capacity, with queues and platform faults) runs on the f64
fleet scan ``kernels/csrc/fleet_scan_event_step.cu`` (any number of
functions) or on the f32 ``kernels/csrc/fleet_event_step.cu`` (up to 8).
Non-stationary workloads (rate profiles through NHPP thinning, MMPP,
trace replay) feed the kernels absolute timestamps (their ``prestamped``
mode).  Entry points run on the GPU unless called with ``device="cpu"``,
which selects the plain PyTorch versions of the kernels.  This package
imports torch and numpy only.
"""

from repro_torch.core import (  # noqa: F401
    ArrivalTimeProcess,
    BatchArrivalProcess,
    BillingModel,
    CapacityProfile,
    CustomSimProcess,
    DeterministicSimProcess,
    EmpiricalSimProcess,
    Execution,
    ExpSimProcess,
    FailurePolicy,
    FaultModel,
    fleet_run,
    fleet_sweep,
    FleetFunction,
    FleetGridResult,
    FleetResult,
    FleetScenario,
    FleetSummary,
    GammaSimProcess,
    GaussianSimProcess,
    GridResult,
    InstanceSnapshot,
    LogNormalSimProcess,
    MMPPArrivalProcess,
    NHPPArrivalProcess,
    ParetoSimProcess,
    ParServerlessSimulator,
    ParSimulationSummary,
    PiecewiseConstantRate,
    RateProfile,
    Reliability,
    Result,
    RetryPolicy,
    run,
    Scenario,
    ServerlessSimulator,
    ServerlessTemporalSimulator,
    SimProcess,
    SimulationSummary,
    SinusoidalRate,
    sweep,
    TemporalSummary,
    TraceArrivalProcess,
    WeibullSimProcess,
    WindowedMetrics,
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
    "GammaSimProcess",
    "BatchArrivalProcess",
    "CustomSimProcess",
    "EmpiricalSimProcess",
    "ArrivalTimeProcess",
    "NHPPArrivalProcess",
    "MMPPArrivalProcess",
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
