"""Execution plans and the backend registry of the PyTorch port.

A frozen :class:`Execution` names the engine (simulation semantics), the
backend (the row launchers that run the f32 block kernels) and the device.
Backends register one row launcher per engine at import; the registry
imports the providing modules on first resolution (``_PROVIDERS``), and
unknown names raise with the registered list.

* ``"cuda"`` — the hand-written Hopper kernels
  (:mod:`repro_torch.kernels.faas_event_step`,
  :mod:`repro_torch.kernels.par_event_step`,
  :mod:`repro_torch.kernels.fleet_event_step`); needs a CUDA device.
* ``"ref"`` — the plain PyTorch versions of the same loops
  (:mod:`repro_torch.kernels.ref`); runs on any device.

The engines are the reference's: ``"scan"`` (steady state) and
``"temporal"`` (transient curves from a custom initial pool) share the
pool-state launcher; ``"par"`` (concurrency value > 1) has its own
``finish[M, c]`` launcher.  Fleets (:mod:`repro_torch.core.fleet`) run on
the scan engine through each backend's ``"fleet"`` launcher.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and a CUDA request without a visible GPU
raises instead of falling back.  ``backend=None`` picks ``"cuda"`` on a
CUDA device and ``"ref"`` on the CPU.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Optional, Sequence

import torch

# engines this port serves on the f32 block kernels; the reference's f64
# scan substrate arrives with the f64 engine (ROADMAP Queue A item 2)
ENGINES = ("scan", "temporal", "par")


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """A registered f32 block-engine substrate and its row launchers.

    ``launchers`` maps an engine to its row launcher.  The pool-state
    launcher (engines ``scan`` and ``temporal``) is ``launch(alive0,
    creation0, busy0, t0, t_exp, t_end, skip, dts, warms, colds, *,
    max_concurrency, prestamped, grid_times=None)`` on ``[C, ...]`` row
    tensors and returns the ``[C, ACC_COLS + 3G]`` accumulator; the par
    launcher is ``launch(t_exp, t_end, skip, dts, warms, colds, *,
    max_concurrency, concurrency, slots, prestamped)`` and returns
    ``[C, PAR_ACC_COLS]``.  The fleet launcher is ``launch(t_exp, limit,
    ncl, t_end, skip, stream, times, fids, warms, colds, *, slots,
    queue_depth, prestamped)`` on ``[N, F]`` / ``[N]`` fleet tensors and a
    ``[S, K]`` stream, and returns ``(acc[N, F, 13], qleft[N, F])``.
    """

    name: str
    launchers: Any = dataclasses.field(default_factory=dict)  # engine -> fn
    description: str = ""

    @property
    def launch(self) -> Optional[Callable[..., Any]]:
        """The steady-state (scan-engine) row launcher."""
        return self.launchers.get("scan")

    def launch_for(self, engine: str) -> Callable[..., Any]:
        """The row launcher serving ``engine``; raises with the served
        list when the backend has none for it."""
        fn = self.launchers.get(engine)
        if fn is None:
            raise ValueError(
                f"backend {self.name!r} has no row launcher for engine "
                f"{engine!r}; launchers: {sorted(self.launchers)}"
            )
        return fn


_BACKENDS: dict = {}

# name -> modules that register its launchers on import
_PROVIDERS = {
    "ref": ("repro_torch.kernels.ref",),
    "cuda": (
        "repro_torch.kernels.faas_event_step",
        "repro_torch.kernels.par_event_step",
        "repro_torch.kernels.fleet_event_step",
    ),
}


def register_backend(
    name: str, *, description: str = "", engines: Sequence[str] = ("scan",)
):
    """Decorator: register ``fn`` as backend ``name``'s row launcher for
    every engine in ``engines``.  A later registration under the same name
    adds launchers for other engines and keeps the first description."""
    if name not in _BACKENDS:
        _BACKENDS[name] = BackendSpec(name=name, description=description)

    def deco(fn):
        spec = _BACKENDS[name]
        _BACKENDS[name] = dataclasses.replace(
            spec, launchers={**spec.launchers, **{e: fn for e in engines}}
        )
        return fn

    return deco


def resolve_backend(name: str) -> BackendSpec:
    if name in _PROVIDERS:
        for mod in _PROVIDERS[name]:
            importlib.import_module(mod)
    if name not in _BACKENDS:
        for mods in _PROVIDERS.values():
            for mod in mods:
                importlib.import_module(mod)
        raise ValueError(
            f"unknown backend {name!r}; registered backends: {sorted(_BACKENDS)}"
        )
    return _BACKENDS[name]


@dataclasses.dataclass(frozen=True)
class Execution:
    """One frozen execution plan: engine, backend and device.

    ``backend=None`` and ``device=None`` resolve as the module docstring
    says; :meth:`resolve` validates the triple and returns the backend
    spec and the concrete :class:`torch.device`.
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
        """``(BackendSpec, torch.device)`` for this plan, validated: the
        engine is known and the backend has a row launcher for it."""
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
                "backend 'cuda' launches the Hopper kernels and needs a CUDA "
                "device; use backend='ref' for the plain version on the CPU"
            )
        bspec.launch_for(self.engine)
        return bspec, dev


def plan_of(
    execution: Optional[Execution],
    backend: Optional[str] = None,
    device=None,
    *,
    engine: Optional[str] = None,
) -> Execution:
    """Merge an optional plan with the ``backend=``/``device=``/``engine=``
    kwargs (kwargs win)."""
    plan = execution if execution is not None else Execution()
    if not isinstance(plan, Execution):
        raise TypeError(
            f"execution must be an Execution plan, got {type(plan).__name__}"
        )
    changes = {}
    if engine is not None:
        changes["engine"] = engine
    if backend is not None:
        changes["backend"] = backend
    if device is not None:
        changes["device"] = device
    return dataclasses.replace(plan, **changes) if changes else plan
