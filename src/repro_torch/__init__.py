"""SimFaaS in PyTorch and CUDA: the port of the ``repro`` package's
simulator to an NVIDIA H100.

The front door is the same Scenario API: ``run``/``sweep`` on the f32
block engines, whose hot loops are the hand-written CUDA kernels
``kernels/csrc/faas_event_step.cu`` (engines ``scan`` and ``temporal``)
and ``kernels/csrc/par_event_step.cu`` (engine ``par``).  Entry points
run on the GPU unless called with ``device="cpu"``, which selects the
plain PyTorch versions of the kernels.  This package imports torch and
numpy only.
"""

from repro_torch.core import (  # noqa: F401
    BillingModel,
    DeterministicSimProcess,
    Execution,
    ExpSimProcess,
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
]
