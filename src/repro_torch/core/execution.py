"""Execution plans and the backend registry of the PyTorch port.

A frozen :class:`Execution` names the engine (simulation semantics), the
backend (the row launcher that runs the f32 block engine) and the device.
Backends register their row launcher at import; the registry imports the
providing module on first resolution (``_PROVIDERS``), and unknown names
raise with the registered list.

* ``"cuda"`` — the hand-written Hopper kernel
  (:mod:`repro_torch.kernels.faas_event_step`); needs a CUDA device.
* ``"ref"`` — the plain PyTorch version of the same loop
  (:mod:`repro_torch.kernels.ref`); runs on any device.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and a CUDA request without a visible GPU
raises instead of falling back.  ``backend=None`` picks ``"cuda"`` on a
CUDA device and ``"ref"`` on the CPU.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Optional

import torch

# engines this slice serves; the f64 steady-state engine, temporal and par
# engines arrive in later slices (ROADMAP Queue A)
ENGINES = ("scan",)


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """A registered f32 block-engine substrate and its row launcher.

    ``launch(alive0, creation0, busy0, t0, t_exp, t_end, skip, dts, warms,
    colds, *, max_concurrency, prestamped)`` takes ``[C, ...]`` row tensors
    on one device and returns the ``[C, ACC_COLS]`` accumulator there.
    """

    name: str
    launch: Callable[..., Any]
    description: str = ""


_BACKENDS: dict = {}

# name -> module that registers it on import
_PROVIDERS = {
    "ref": "repro_torch.kernels.ref",
    "cuda": "repro_torch.kernels.faas_event_step",
}


def register_backend(name: str, *, description: str = ""):
    """Decorator: register ``fn`` as backend ``name``'s row launcher."""

    def deco(fn):
        _BACKENDS[name] = BackendSpec(name=name, launch=fn, description=description)
        return fn

    return deco


def resolve_backend(name: str) -> BackendSpec:
    if name not in _BACKENDS and name in _PROVIDERS:
        importlib.import_module(_PROVIDERS[name])
    if name not in _BACKENDS:
        for mod in _PROVIDERS.values():
            importlib.import_module(mod)
        raise ValueError(
            f"unknown backend {name!r}; registered backends: {sorted(_BACKENDS)}"
        )
    return _BACKENDS[name]


@dataclasses.dataclass(frozen=True)
class Execution:
    """One frozen execution plan: engine, backend and device.

    ``backend=None`` and ``device=None`` resolve as the module docstring
    says; :meth:`resolve` validates the pair and returns the backend spec
    and the concrete :class:`torch.device`.
    """

    engine: str = "scan"
    backend: Optional[str] = None
    device: Optional[Any] = None

    def resolved_device(self) -> torch.device:
        dev = torch.device("cuda" if self.device is None else self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; the port runs on the GPU unless "
                "asked for the CPU — pass device='cpu' to run the plain "
                "backend 'ref' there"
            )
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
        return dev

    def resolve(self) -> tuple:
        """``(BackendSpec, torch.device)`` for this plan, validated."""
        if self.engine not in ENGINES:
            raise ValueError(
                f"unknown engine {self.engine!r}; registered engines: "
                f"{list(ENGINES)}"
            )
        dev = self.resolved_device()
        name = self.backend or ("cuda" if dev.type == "cuda" else "ref")
        bspec = resolve_backend(name)
        if name == "cuda" and dev.type != "cuda":
            raise ValueError(
                "backend 'cuda' launches the Hopper kernel and needs a CUDA "
                "device; use backend='ref' for the plain version on the CPU"
            )
        return bspec, dev


def plan_of(
    execution: Optional[Execution],
    backend: Optional[str] = None,
    device=None,
) -> Execution:
    """Merge an optional plan with the ``backend=``/``device=`` kwargs
    (kwargs win)."""
    plan = execution if execution is not None else Execution()
    if not isinstance(plan, Execution):
        raise TypeError(
            f"execution must be an Execution plan, got {type(plan).__name__}"
        )
    changes = {}
    if backend is not None:
        changes["backend"] = backend
    if device is not None:
        changes["device"] = device
    return dataclasses.replace(plan, **changes) if changes else plan
