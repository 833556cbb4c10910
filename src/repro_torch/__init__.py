"""SimFaaS in PyTorch and CUDA: the port of the ``repro`` package's
simulator to an NVIDIA H100.

The front door is the same Scenario API: ``run``/``sweep`` on the f32
block engine, whose hot loop is the hand-written CUDA kernel
``kernels/csrc/faas_event_step.cu``.  Entry points run on the GPU unless
called with ``device="cpu"``, which selects the plain PyTorch version of
the kernel.  This package imports torch and numpy only.
"""

from repro_torch.core import (  # noqa: F401
    BillingModel,
    DeterministicSimProcess,
    Execution,
    ExpSimProcess,
    GaussianSimProcess,
    GridResult,
    LogNormalSimProcess,
    ParetoSimProcess,
    Result,
    Scenario,
    SimProcess,
    SimulationSummary,
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
    "run",
    "sweep",
]
