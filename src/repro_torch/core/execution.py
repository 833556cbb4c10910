"""Execution plans and the backend registry of the PyTorch port.

A frozen :class:`Execution` names the engine (simulation semantics), the
backend (the row launchers that run the f32 block kernels), the device and
the draw mode (``"staged"`` sample buffers, or ``"fused"`` draws made in the
kernel from per-row threefry keys, :mod:`repro_torch.core.drawplan`).
Backends register one row launcher per engine at import; the registry
imports the providing modules on first resolution (``_PROVIDERS``), and
unknown names raise with the registered list.

* ``"scan"`` — the f64 engine's hand-written kernels, the reference's
  default ``lax.scan`` substrate decision for decision
  (:mod:`repro_torch.kernels.scan_event_step`,
  :mod:`repro_torch.kernels.par_scan_event_step`,
  :mod:`repro_torch.kernels.fleet_scan_event_step`); needs a CUDA device.
  It alone (with its plain version) serves the instance-count histogram,
  oldest-first routing, windowed single runs, lifespans, reliability on
  the temporal and par engines, fleets of more than 8 functions and fused
  NHPP thinning.
* ``"scan_ref"`` — the plain f64 PyTorch versions of those kernels
  (:mod:`repro_torch.kernels.ref64`); runs on any device.
* ``"cuda"`` — the f32 block engine's hand-written Hopper kernels
  (:mod:`repro_torch.kernels.faas_event_step`,
  :mod:`repro_torch.kernels.par_event_step`,
  :mod:`repro_torch.kernels.fleet_event_step`); needs a CUDA device.
* ``"ref"`` — the plain PyTorch versions of the same loops
  (:mod:`repro_torch.kernels.ref`); runs on any device.

The engines are the reference's (:data:`ENGINE_SPECS`, each with the
backends that serve its feature layers): ``"scan"`` (steady state) and
``"temporal"`` (transient curves from a custom initial pool) share the
pool-state launcher; ``"par"`` (concurrency value > 1) has its own
``finish[M, c]`` launcher.  Fleets (:mod:`repro_torch.core.fleet`) run on
the scan engine through each backend's ``"fleet"`` launcher.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and a CUDA request without a visible GPU
raises instead of falling back.  ``backend=None`` picks the reference's
default, the f64 scan: ``"scan"`` on a CUDA device and ``"scan_ref"`` on
the CPU, for every engine and for fleets; the f32 block engine runs when
it is named (``"cuda"``, or ``"ref"`` on the CPU).  A backend that needs a CUDA device
raises on the CPU, naming its plain version; none falls back to another.

``Execution(devices=..., shard="grid")`` splits a sweep's flattened row
axis into contiguous spans (:func:`shard_spans`), one per entry of
:meth:`Execution.resolved_devices`, on the backends marked
``BackendSpec.shardable``.  The first device stages and assembles the
grid; every shard's launch is enqueued before any is read, and each cell
is bit for bit the unsharded grid's (rows are independent).  A device may
be named more than once: each entry is one shard, so one card (or the
CPU) can run a grid in several shards.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import Any, Callable, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """An engine (the semantics axis) and the feature layers it serves.

    ``windowed_backends`` lists the backends on which the engine produces
    per-window metrics, ``reliability_backends`` those on which it serves
    timeouts, failures and retries, ``fused_backends`` those on which it
    draws its samples inline (``Execution(draws="fused")``),
    ``faults_backends`` those on which it serves platform faults
    (instance crashes and capacity churn);
    :func:`repro_torch.core.scenario.run` and ``sweep`` refuse a layer on
    any other backend.
    """

    name: str
    windowed_backends: tuple = ()
    reliability_backends: tuple = ()
    fused_backends: tuple = ()
    faults_backends: tuple = ()


# the engines and the backends serving each layer: the f32 block kernels
# ("cuda"/"ref") and the f64 engine ("scan"/"scan_ref"); the par and
# temporal engines draw no fused samples, as in the reference
ENGINE_SPECS = {
    "scan": EngineSpec(
        "scan", windowed_backends=("cuda", "ref", "scan", "scan_ref"),
        reliability_backends=("cuda", "ref", "scan", "scan_ref"),
        fused_backends=("cuda", "ref", "scan", "scan_ref"),
        faults_backends=("cuda", "ref", "scan", "scan_ref"),
    ),
    "temporal": EngineSpec("temporal", reliability_backends=("scan", "scan_ref")),
    "par": EngineSpec("par", reliability_backends=("scan", "scan_ref")),
}
# backends that need a CUDA device, each with its plain version
_CUDA_ONLY = {"cuda": "ref", "scan": "scan_ref"}
ENGINES = tuple(ENGINE_SPECS)


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """A registered f32 block-engine substrate and its row launchers.

    ``launchers`` maps an engine to its row launcher.  The pool-state
    launcher (engines ``scan`` and ``temporal``) is ``launch(alive0,
    creation0, busy0, t0, t_exp, t_end, skip, dts, warms, colds, *,
    max_concurrency, prestamped, grid_times=None)`` on ``[C, ...]`` row
    tensors and returns the ``[C, ACC_COLS + 3G]`` accumulator (with fused
    draws, ``dts``/``warms``/``colds`` None and the ``fused_*`` inputs of
    ``faas_sweep``, the pair ``(acc, t)``: the final clock feeds the
    coverage guard); the par
    launcher is ``launch(t_exp, t_end, skip, dts, warms, colds, *,
    max_concurrency, concurrency, slots, prestamped)`` and returns
    ``[C, PAR_ACC_COLS]``.  The fleet launcher is ``launch(t_exp, limit,
    ncl, t_end, skip, stream, times, fids, warms, colds, *, slots,
    queue_depth, prestamped, live_bound)`` on ``[N, F]`` / ``[N]`` fleet
    tensors and a ``[S, K]`` stream, and returns ``(acc[N, F, 13],
    qleft[N, F])`` on the block engine, a :class:`~repro_torch.kernels.
    ref64.FleetScanOut` on the f64 engine.
    """

    name: str
    launchers: Any = dataclasses.field(default_factory=dict)  # engine -> fn
    description: str = ""
    # the f64 engine (the reference's scan, ``kernels/ref64.py``'s layout)
    # rather than the f32 block kernels
    f64: bool = False
    # launches that split by rows: Execution(shard="grid") may run it
    shardable: bool = False

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
    "scan_ref": ("repro_torch.kernels.ref64",),
    "scan": (
        "repro_torch.kernels.scan_event_step",
        "repro_torch.kernels.par_scan_event_step",
        "repro_torch.kernels.fleet_scan_event_step",
    ),
}


def register_backend(
    name: str, *, description: str = "", engines: Sequence[str] = ("scan",),
    f64: bool = False, shardable: bool = False,
):
    """Decorator: register ``fn`` as backend ``name``'s row launcher for
    every engine in ``engines``; ``f64`` marks a backend of the f64 engine,
    ``shardable`` one whose sweeps may split their rows over devices.  A
    later registration under the same name adds launchers for other
    engines, keeps the first description and may mark it shardable."""
    if name not in _BACKENDS:
        _BACKENDS[name] = BackendSpec(name=name, description=description, f64=f64)
    if _BACKENDS[name].f64 != f64:
        raise ValueError(f"backend {name!r} is registered both as f64 and as f32")

    def deco(fn):
        spec = _BACKENDS[name]
        _BACKENDS[name] = dataclasses.replace(
            spec, launchers={**spec.launchers, **{e: fn for e in engines}},
            shardable=spec.shardable or shardable,
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
    """One frozen execution plan: engine, backend, device, draw mode and
    placement.

    ``backend=None`` and ``device=None`` resolve as the module docstring
    says; ``draws=None`` means ``"staged"``.  ``shard="grid"`` splits a
    sweep's rows over ``devices``: None (every visible CUDA device, or the
    CPU), an int (the first N CUDA devices; 1 on the CPU) or a sequence of
    devices of one type, where a device may repeat (each entry is one
    shard).  :meth:`resolve` validates the plan and returns the backend
    spec and the concrete :class:`torch.device`, the one that stages and
    assembles (``resolved_devices()[0]`` under ``shard``).
    """

    engine: str = "scan"
    backend: Optional[str] = None
    device: Optional[Any] = None
    draws: Optional[str] = None
    devices: Optional[Any] = None
    shard: Optional[str] = None

    def __post_init__(self):
        if self.draws not in (None, "staged", "fused"):
            raise ValueError(
                f"unknown draws mode {self.draws!r}; supported: 'staged' "
                "(sample buffers staged on the device) and 'fused' (draws "
                "made in the kernel from per-row threefry keys)"
            )
        if self.shard not in (None, "grid"):
            raise ValueError(
                f"unknown shard spec {self.shard!r}; supported: 'grid' "
                "(split the flattened sweep axis across devices)"
            )
        d = self.devices
        if isinstance(d, bool):
            raise TypeError("devices must be None, a count or a sequence of devices")
        if isinstance(d, int):
            if d < 1:
                raise ValueError("devices count must be >= 1")
        elif d is not None:
            d = tuple(torch.device(x) for x in d)
            if not d:
                raise ValueError(
                    "devices sequence is empty; pass None for every visible "
                    "device, or name at least one"
                )
            if len({x.type for x in d}) > 1 or d[0].type not in ("cuda", "cpu"):
                raise ValueError(
                    f"devices must all be CUDA devices or all 'cpu', got "
                    f"{[str(x) for x in d]}"
                )
            object.__setattr__(self, "devices", d)

    @property
    def resolved_draws(self) -> str:
        """The concrete draw mode: an unset ``draws`` means staged."""
        return self.draws or "staged"

    def resolved_device(self) -> torch.device:
        """The device that stages and assembles: ``device``, else the first
        of a ``devices`` sequence, else the card."""
        if self.device is not None:
            dev = torch.device(self.device)
        elif isinstance(self.devices, tuple):
            dev = self.devices[0]
        else:
            dev = torch.device("cuda")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; the port runs on the GPU unless "
                "asked for the CPU — pass device='cpu' to run the plain "
                "backends ('scan_ref', 'ref') there"
            )
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
        return dev

    def resolved_devices(self) -> tuple:
        """The devices a sharded sweep runs on, one shard each, in row
        order; raises where a CUDA device asked for is not visible."""
        dev = self.resolved_device()
        d = self.devices
        if dev.type == "cpu":
            if isinstance(d, int) and d != 1:
                raise ValueError(
                    f"Execution.devices={d} on the CPU: only 1 is valid (name "
                    "the CPU more than once, devices=('cpu',) * n, for n shards)"
                )
            if isinstance(d, tuple) and d[0].type != "cpu":
                raise ValueError(f"devices {[str(x) for x in d]} are not on {dev}")
            return d if isinstance(d, tuple) else (dev,)
        n = torch.cuda.device_count()
        if d is None:
            return tuple(torch.device("cuda", i) for i in range(n))
        if isinstance(d, int):
            if d > n:
                raise ValueError(
                    f"Execution.devices={d} but only {n} CUDA devices are visible"
                )
            return tuple(torch.device("cuda", i) for i in range(d))
        if d[0].type != "cuda":
            raise ValueError(f"devices {[str(x) for x in d]} are not on {dev}")
        out = tuple(_indexed(x) for x in d)
        missing = sorted({x.index for x in out if x.index >= n})
        if missing:
            raise ValueError(
                f"devices name cuda:{missing[0]}, but only {n} CUDA devices are visible"
            )
        return out

    @property
    def n_devices(self) -> int:
        return len(self.resolved_devices())

    def resolve(self) -> tuple:
        """``(BackendSpec, torch.device)`` for this plan, validated: the
        engine is known, the backend has a row launcher for it and, with
        fused draws, is one of the engine's ``fused_backends``; a sharded
        plan has staged draws, a shardable backend and devices that can be
        resolved, ``device`` (if set) first among them."""
        if self.engine not in ENGINES:
            raise ValueError(
                f"unknown engine {self.engine!r}; registered engines: "
                f"{list(ENGINES)}"
            )
        dev = self.resolved_device()
        name = self.backend or ("scan" if dev.type == "cuda" else "scan_ref")
        bspec = resolve_backend(name)
        if name in _CUDA_ONLY and dev.type != "cuda":
            raise ValueError(
                f"backend {name!r} launches the Hopper kernels and needs a CUDA "
                f"device; use backend={_CUDA_ONLY[name]!r} for the plain version "
                "on the CPU"
            )
        bspec.launch_for(self.engine)
        espec = ENGINE_SPECS[self.engine]
        if self.resolved_draws == "fused":
            if name not in espec.fused_backends:
                raise ValueError(
                    f"engine {self.engine!r} cannot draw fused samples on backend "
                    f"{name!r}; fused-capable backends: {espec.fused_backends or '()'} "
                    "(drop draws='fused' to keep the staged pipeline)"
                )
            if self.shard == "grid":
                raise ValueError(
                    "draws='fused' does not support shard='grid'; a sharded "
                    "sweep splits staged sample buffers — drop shard= or use "
                    "draws='staged'"
                )
        if self.shard == "grid" and not bspec.shardable:
            for mods in _PROVIDERS.values():
                for mod in mods:
                    importlib.import_module(mod)
            shardable = sorted(n for n, s in _BACKENDS.items() if s.shardable)
            raise ValueError(
                f"backend {name!r} does not support shard='grid'; shardable "
                f"backends: {shardable}"
            )
        if self.devices is not None and self.shard is None:
            # devices take effect only through grid sharding: running on
            # one device would make the plan lie
            raise ValueError(
                "devices= is set but shard is None, so the plan would run "
                "single-device; add shard='grid' (or drop devices=)"
            )
        if self.shard == "grid":
            first = self.resolved_devices()[0]
            if self.device is not None and _indexed(dev) != first:
                raise ValueError(
                    f"device={str(self.device)!r} stages and assembles a sharded "
                    f"sweep, so it must be the first of devices ({first}); drop "
                    "device= or put it first"
                )
            dev = first
        return bspec, dev


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index (``"cuda"`` is the current device)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def launching_on(device):
    """The context of a launch on ``device``: that CUDA device current,
    the caller's restored after (a kernel's C entry switches the thread to
    the device it launches on); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_spans(rows: int, n: int) -> list:
    """The contiguous ``[lo, hi)`` row spans of ``rows`` rows in ``n``
    shards, in row order: sizes differ by at most one (the larger first)
    and no span is empty, so a grid of fewer rows than shards runs one row
    a shard on its first ``rows`` devices.  No padding: rows are
    independent, and every kernel takes any row count."""
    q, r = divmod(int(rows), int(n))
    spans, lo = [], 0
    for i in range(min(int(n), int(rows))):
        hi = lo + q + (i < r)
        spans.append((lo, hi))
        lo = hi
    return spans


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
