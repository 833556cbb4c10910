"""Multi-function fleets in PyTorch: per-function pools under a shared
cluster capacity, with bounded FIFO queues.

A :class:`FleetScenario` is a tuple of per-function specs (each with its
own arrival and service processes, keep-alive threshold and concurrency
limit) plus shared cluster parameters: the total live-instance capacity
``n_cluster``, the admission rule (warm first, then cold iff the function's
limit and the cluster both have room) and per-function FIFO queues of
depth ``queue_depth`` for arrivals that cannot start.

Per-function event streams are drawn on the device (function f from the
f-th generator triple of ``SeedSequence(seed).spawn(F)``), cumulated in
f64 (a timestamp process, NHPP, MMPP or trace replay, gives its f64 times
directly), merged per replica by a stable sort on the f64 times (ties keep
function order) and only then cast to f32: one ``[replicas, K]`` stream
of times, acting-function ids, warm and cold samples.  A one-function
fleet passes its stream through as gaps (or as its timestamps,
prestamped), the draws :func:`~repro_torch.core.scenario.run` makes on
the same seed.

:func:`fleet_sweep` sweeps ``expiration_threshold`` (a scalar for every
function, or one value per function), ``n_cluster``, ``sim_time`` and
``skip_time``.  All four are per-fleet values, so every cell reads the one
stream and a whole sweep is ONE launch of the fleet kernel; the result has
a trailing ``function`` axis.  Two engines serve fleets:

* the f64 fleet scan, the reference's default (``_make_fleet_step``):
  backend ``"scan"`` (the kernel ``kernels/csrc/
  fleet_scan_event_step.cu``, ``LAUNCH_COUNTS["fleet_scan_sweep"]``, any
  F) or ``"scan_ref"`` (its plain version,
  :func:`repro_torch.kernels.ref64.fleet_scan_sweep_ref`); its staging
  keeps the merged times in f64, and its summaries carry lifespans;
* the f32 block engine: backend ``"cuda"`` (the kernel
  ``kernels/csrc/fleet_event_step.cu``, ``LAUNCH_COUNTS["fleet_sweep"]``,
  F <= 8) or ``"ref"`` (its plain version).

Platform faults (``FleetScenario(faults=FaultModel(...))``, not with
queues) run the fault path of the fleet kernel: each function pool under
the crash hazard, the fleet's live count under the capacity ceiling.  The
crash uniforms are one ``[replicas, K]`` stream positional on the merged
events, drawn from the crash generator of function 0's draw cell (so a
one-function fleet draws what :func:`~repro_torch.core.scenario.run`
draws); each function's summary carries its crashes, evictions and
interrupted arrivals.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cost import BillingModel, CostEstimate, estimate_cost
from repro_torch.core.execution import (
    _PROVIDERS,
    Execution,
    launching_on,
    plan_of,
    resolve_backend,
    shard_spans,
)
from repro_torch.core.faults import FaultModel
from repro_torch.core.processes import SimProcess
from repro_torch.core.scenario import GridResult, Scenario
from repro_torch.core.simulator import (
    CRASH_STREAM,
    FAULT_STREAMS,
    SimulationSummary,
    cell_generators,
    draw_arrival_times,
    draw_crash_uniforms,
    draw_service_samples,
    draw_workload_samples,
)
from repro_torch.kernels.ref import FAULT_COLS, FLEET_ACC_COLS, MAX_FUNCTIONS
from repro_torch.kernels.ref64 import FLEET64_COLS, FLEET64_PEAK

__all__ = [
    "FleetFunction",
    "FleetScenario",
    "FleetSummary",
    "FleetResult",
    "FleetGridResult",
    "fleet_run",
    "fleet_sweep",
]

# sweepable fleet axes: per-fleet values, so every cell shares the one stream
_FLEET_AXES = ("expiration_threshold", "n_cluster", "sim_time", "skip_time")
# fleet structure that fixes the launch's shapes
_STRUCTURE = ("queue_depth", "functions", "slots")


# --------------------------------------------------------------------------
# Scenario types
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FleetFunction:
    """One function in a fleet: a named single-function workload spec.

    The workload fields mirror :class:`~repro_torch.core.scenario.Scenario`
    (``arrival_process`` or ``arrival_rate``, warm/cold service processes);
    the platform fields are the function's keep-alive threshold and
    concurrency limit.  ``memory_gb`` weights its bill in the fleet's cost.
    """

    name: str
    arrival_process: Optional[SimProcess] = None
    warm_service_process: Optional[SimProcess] = None
    cold_service_process: Optional[SimProcess] = None
    expiration_threshold: float = 600.0
    max_concurrency: int = 1000
    memory_gb: float = 0.128
    rate_profile: Optional[Any] = None
    arrival_rate: Optional[float] = None

    def __post_init__(self):
        if not isinstance(self.name, str) or not self.name:
            raise ValueError("FleetFunction.name must be a non-empty string")
        if not self.memory_gb > 0:
            raise ValueError(f"memory_gb must be > 0, got {self.memory_gb}")
        # Scenario validates the workload and folds arrival_rate into the
        # process (a rate profile becomes its NHPP process)
        scn = Scenario(
            arrival_process=self.arrival_process,
            warm_service_process=self.warm_service_process,
            cold_service_process=self.cold_service_process,
            expiration_threshold=self.expiration_threshold,
            max_concurrency=self.max_concurrency,
            rate_profile=self.rate_profile,
            arrival_rate=self.arrival_rate,
        )
        object.__setattr__(self, "arrival_process", scn.arrival_process)
        object.__setattr__(self, "rate_profile", None)
        object.__setattr__(self, "arrival_rate", None)

    def as_scenario(self, *, sim_time: float, skip_time: float, slots: int) -> Scenario:
        """This function as a standalone single-function Scenario."""
        return Scenario(
            arrival_process=self.arrival_process,
            warm_service_process=self.warm_service_process,
            cold_service_process=self.cold_service_process,
            expiration_threshold=self.expiration_threshold,
            max_concurrency=self.max_concurrency,
            sim_time=float(sim_time),
            skip_time=float(skip_time),
            slots=int(slots),
        )


@dataclasses.dataclass(frozen=True)
class FleetScenario:
    """A set of functions sharing one cluster.

    ``n_cluster`` is the total live-instance capacity across all functions
    (``math.inf``: uncoupled pools); ``queue_depth`` is each function's
    FIFO queue for arrivals that cannot start (0: they are rejected, as in
    the single-function engines); ``slots`` is each function's pool size;
    ``faults`` is an optional :class:`~repro_torch.core.faults.FaultModel`
    (not with queues).
    """

    functions: Tuple[FleetFunction, ...]
    n_cluster: float = math.inf
    queue_depth: int = 0
    sim_time: float = 1e5
    skip_time: float = 100.0
    slots: int = 64
    billing: BillingModel = BillingModel()
    faults: Optional[Any] = None

    def __post_init__(self):
        fns = tuple(self.functions)
        object.__setattr__(self, "functions", fns)
        if not fns:
            raise ValueError("FleetScenario needs at least one function")
        if not all(isinstance(f, FleetFunction) for f in fns):
            raise TypeError("FleetScenario.functions must be FleetFunction")
        names = [f.name for f in fns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate function names in fleet: {names}")
        if not self.n_cluster > 0:
            raise ValueError(f"n_cluster must be > 0, got {self.n_cluster}")
        if self.queue_depth < 0:
            raise ValueError("queue_depth must be >= 0")
        if self.faults is not None and not isinstance(self.faults, FaultModel):
            raise ValueError(
                "FleetScenario.faults must be a FaultModel (or None), got "
                f"{type(self.faults).__name__}"
            )
        if self.active_faults is not None and self.queue_depth > 0:
            raise ValueError(
                "platform faults do not serve fleet FIFO queues yet "
                "(eviction would have to reconcile queued work); set "
                "queue_depth=0 or drop the FaultModel"
            )
        if not self.sim_time > 0:
            raise ValueError(f"sim_time must be > 0, got {self.sim_time}")
        if self.skip_time < 0 or self.skip_time >= self.sim_time:
            raise ValueError("need 0 <= skip_time < sim_time")
        if self.slots < 1:
            raise ValueError("slots must be >= 1")

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.functions)

    @property
    def active_faults(self) -> Optional[FaultModel]:
        """The fault model when it injects anything, else None."""
        return self.faults if self.faults is not None and self.faults.enabled else None

    def with_rates(self, rates: Dict[str, float]) -> "FleetScenario":
        """Copy with the named functions' arrival processes re-rated
        (``with_rate``; unnamed functions untouched).  Unknown names raise
        a pointed KeyError."""
        unknown = [n for n in rates if n not in self.names]
        if unknown:
            raise KeyError(
                f"unknown function(s) {unknown}; fleet functions: {list(self.names)}"
            )
        fns = []
        for f in self.functions:
            if f.name in rates:
                r = float(rates[f.name])
                if not r > 0:
                    raise ValueError(f"rate for {f.name!r} must be > 0, got {r}")
                f = dataclasses.replace(f, arrival_process=f.arrival_process.with_rate(r))
            fns.append(f)
        return dataclasses.replace(self, functions=tuple(fns))


# --------------------------------------------------------------------------
# Staging: per-function draws merged into one stream per replica
# --------------------------------------------------------------------------


def _short(name: str):
    raise RuntimeError(
        f"function {name!r}: pre-drawn arrivals ended before sim_time; pass a "
        "larger steps="
    )


def _stage_fleet(
    fleet: FleetScenario, seed: int, replicas: int, steps: Optional[int],
    max_sim: float, device, f64: bool = False,
) -> Dict[str, Any]:
    """Draw every function's stream on ``device`` and merge them per replica.

    Returns ``times`` (f32), ``fids`` (uint8), ``warms``, ``colds`` (f32),
    each ``[replicas, K]``, and ``prestamped``; with crashes also
    ``crash_u`` (f32 ``[replicas, K]``, one uniform per merged event).
    For F > 1 each function's gaps are cumulated in f64 and must reach
    ``max_sim`` (a timestamp process gives its f64 times, guarded on its
    own coverage); the streams,
    concatenated in function order, are merged by a stable sort on the f64
    times (the reference's ``np.lexsort((fids, times))``) and cast to f32
    after the merge: at t ~ 1e5 s f32 spaces times ~0.008 s apart, so
    sorting after the cast would reorder the stream.  For F == 1 the gaps
    pass through (``prestamped=False``), or a timestamp process's times
    (``prestamped=True``), as :func:`~repro_torch.core.scenario.run` draws
    them.  With ``f64`` (the f64 fleet scan) absolute times stay f64.
    """
    stamp = (lambda x: x.double()) if f64 else (lambda x: x.float())
    F, R = len(fleet.functions), int(replicas)
    flt = fleet.active_faults
    crashes = flt is not None and flt.crashes
    limit = torch.tensor(max_sim, dtype=torch.float64, device=device)
    times, fids, warms, colds = [], [], [], []
    cells = cell_generators(seed, F, device, FAULT_STREAMS if crashes else 3)

    def with_crashes(out):
        if crashes:
            # one uniform per merged event, drawn after the merge
            K = out["times"].shape[1]
            out["crash_u"] = draw_crash_uniforms(cells[0][CRASH_STREAM], R, K, device)
        return out

    for f, (fn, gens) in enumerate(zip(fleet.functions, cells)):
        scn_f = fn.as_scenario(sim_time=max_sim, skip_time=fleet.skip_time, slots=fleet.slots)
        n_f = int(steps) if steps is not None else scn_f.steps_needed()
        if scn_f.prestamped:
            # a timestamp process's f64 times, guarded on its own coverage
            stream = t_f = draw_arrival_times(scn_f, gens[0], R, n_f, device)
            warm, cold = draw_service_samples(scn_f, gens[1:3], R, n_f, device)
        else:
            stream, warm, cold = draw_workload_samples(scn_f, gens[:3], R, n_f, device)
            # f64 times to merge; one function's gaps pass through, and the
            # guard reads only their f64 sum
            t_f = (stream.double().cumsum_(1) if F > 1
                   else stream.sum(1, keepdim=True, dtype=torch.float64))
            if bool((t_f[:, -1] < limit).any()):
                _short(fn.name)
        if F == 1:
            return with_crashes(dict(
                times=stamp(stream) if scn_f.prestamped else stream.float(),
                fids=torch.zeros((R, n_f), dtype=torch.uint8, device=device),
                warms=warm, colds=cold, prestamped=scn_f.prestamped,
            ))
        times.append(t_f)
        fids.append(torch.full((R, n_f), f, dtype=torch.uint8, device=device))
        warms.append(warm)
        colds.append(cold)
        del stream, t_f
    merged, order = torch.sort(torch.cat(times, 1), dim=1, stable=True)
    del times
    take = lambda parts: torch.cat(parts, 1).gather(1, order)
    return with_crashes(dict(
        times=stamp(merged), fids=take(fids), warms=take(warms), colds=take(colds),
        prestamped=True,
    ))


def _check_staged(staged, fleet: FleetScenario, replicas: int, max_sim: float, device,
                  f64: bool = False) -> dict:
    """A handed-in stream (see :func:`repro_torch.interop.
    fleet_staged_from_reference`) on ``device``, behind the coverage
    guard: every function's last arrival must reach ``max_sim``.  With
    crashes it also holds ``crash_u``; with ``f64`` prestamped times stay
    f64."""
    crashes = fleet.active_faults is not None and fleet.faults.crashes
    keys = ("times", "fids", "warms", "colds", "prestamped") + (("crash_u",) if crashes else ())
    if not isinstance(staged, Mapping) or any(k not in staged for k in keys):
        raise ValueError(
            "staged must map times, fids, warms, colds and prestamped"
            + (" (and crash_u with crashes)" if crashes else "")
            + " (see repro_torch.interop.fleet_staged_from_reference)"
        )
    floats = ("times", "warms", "colds") + (("crash_u",) if crashes else ())
    stamped = bool(staged["prestamped"])
    wide = lambda k: torch.float64 if f64 and stamped and k == "times" else torch.float32
    out = {k: torch.as_tensor(staged[k], dtype=wide(k)).to(device).contiguous() for k in floats}
    out["fids"] = torch.as_tensor(staged["fids"]).to(device, torch.uint8).contiguous()
    out["prestamped"] = stamped
    shape = tuple(out["times"].shape)
    if len(shape) != 2 or shape[0] != replicas or any(
        tuple(out[k].shape) != shape for k in ("fids",) + floats[1:]
    ):
        raise ValueError(
            f"staged buffers must all be [{replicas}, K]; got "
            f"{[tuple(out[k].shape) for k in ('times', 'fids') + floats[1:]]}"
        )
    times, fids = out["times"], out["fids"]
    if out["prestamped"]:
        # f32 rounding is monotone, so compare against the horizon in the
        # times' own dtype
        need = torch.tensor(max_sim, dtype=times.dtype, device=device)
        for f, fn in enumerate(fleet.functions):
            last = torch.where(fids == f, times, -math.inf).amax(1)
            if bool((last < need).any()):
                _short(fn.name)
    elif bool((times.sum(1, dtype=torch.float64) < max_sim).any()):
        _short(fleet.functions[0].name)
    return out


# --------------------------------------------------------------------------
# Execution resolution
# --------------------------------------------------------------------------


def _fleet_capable_combos() -> List[str]:
    names = [n for n in sorted(_PROVIDERS) if "fleet" in resolve_backend(n).launchers]
    return [f"engine='scan', backend='{n}'" for n in names]


def _resolve_fleet(execution, engine, backend, device):
    plan = plan_of(execution, backend, device, engine=engine)
    if plan.engine != "scan":
        raise ValueError(
            f"engine '{plan.engine}' does not serve the fleet coupling (shared "
            "cluster capacity + per-function pools); fleet-capable "
            f"combinations: {'; '.join(_fleet_capable_combos())}"
        )
    bspec, dev = plan.resolve()
    if "fleet" not in bspec.launchers:
        raise ValueError(
            f"backend '{bspec.name}' has no fleet launcher; fleet-capable "
            f"combinations: {'; '.join(_fleet_capable_combos())}"
        )
    if plan.resolved_draws == "fused":
        raise ValueError(
            "fleet simulations stage their merged per-function event streams "
            "on the host; draws='fused' is not served — use draws='staged' "
            "(the default), which works with backend='scan', 'cuda' and 'ref'"
        )
    if plan.shard == "grid" and not bspec.f64:
        raise ValueError(
            "fleet shard='grid' is served by the f64 scan backend only (the "
            "block fleet launch is single-device); use "
            "Execution(devices=..., shard='grid', backend='scan'), or drop "
            "shard= to keep backend='cuda'/'ref'"
        )
    devices = plan.resolved_devices() if plan.shard else None
    plan = dataclasses.replace(plan, backend=bspec.name, device=str(dev), devices=devices)
    return plan, bspec, dev


# --------------------------------------------------------------------------
# Cells and the launch
# --------------------------------------------------------------------------


def _normalize_thr(fleet: FleetScenario, v) -> Tuple[float, ...]:
    F = len(fleet.functions)
    if np.ndim(v) == 0:
        out = (float(v),) * F
    else:
        out = tuple(float(x) for x in v)
        if len(out) != F:
            raise ValueError(
                f"expiration_threshold axis values must be scalars or "
                f"length-{F} sequences, got length {len(out)}"
            )
    if not all(x > 0 for x in out):
        raise ValueError(f"expiration_threshold must be > 0, got {v!r}")
    return out


def _cell_params(fleet: FleetScenario, names, combo):
    d = dict(zip(names, combo))
    thr = d.get(
        "expiration_threshold", tuple(f.expiration_threshold for f in fleet.functions)
    )
    thr = _normalize_thr(fleet, thr)
    ncl = float(d.get("n_cluster", fleet.n_cluster))
    sim = float(d.get("sim_time", fleet.sim_time))
    skip = float(d.get("skip_time", fleet.skip_time))
    if not ncl > 0:
        raise ValueError(f"n_cluster must be > 0, got {ncl}")
    if not sim > 0 or skip < 0 or skip >= sim:
        raise ValueError(f"need 0 <= skip_time < sim_time, got {skip}, {sim}")
    return thr, ncl, sim, skip


def _validate_axes(fleet: FleetScenario, over: Mapping[str, Sequence]) -> None:
    for name in over:
        if name in _STRUCTURE:
            raise ValueError(
                f"'{name}' is compile-time fleet structure, not a sweepable "
                f"axis; build separate FleetScenarios instead "
                f"(sweepable: {', '.join(_FLEET_AXES)})"
            )
        if name not in _FLEET_AXES:
            raise ValueError(
                f"unknown fleet sweep axis '{name}'; sweepable axes: "
                f"{', '.join(_FLEET_AXES)}"
            )
        if len(list(over[name])) == 0:
            raise ValueError(f"sweep axis '{name}' must be non-empty")


@dataclasses.dataclass
class FleetInputs:
    """What one fleet launch takes: per-fleet ``[N, F]`` / ``[N]`` values
    (fleets in ``(cell, replica)`` order; fleet ``(c, r)`` reads stream row
    ``r``) and the ``[replicas, K]`` stream, all on the device."""

    axis_vals: dict
    cells: dict  # host per-cell values, [C, F] / [C]
    t_exp: torch.Tensor
    limit: torch.Tensor
    ncl: torch.Tensor
    t_end: torch.Tensor
    skip: torch.Tensor
    stream: torch.Tensor
    staged: dict
    faults: dict  # the launch's fault inputs (empty without faults)
    live_bound: int  # no fleet of the launch holds more live instances
    stream_rows: np.ndarray  # ``stream`` on the host


def live_bound(n_cluster, limits, slots: int) -> int:
    """The most live instances any fleet can hold, known on the host: a
    cold start needs the fleet's live count below ``n_cluster`` and its
    function's below its limit and a free slot of ``slots``, so each fleet
    holds at most min(ceil(n_cluster), sum_f min(ceil(limit_f), slots),
    F * slots).  ``n_cluster`` is ``[N]`` (inf or 1e30: unbounded) and
    ``limits`` ``[N, F]``, each in the dtype the launch's kernel compares
    them in (f32 for the block engine, f64 for the scan); the result is the
    largest over the fleets, at least 1.
    """
    lim = np.atleast_2d(np.asarray(limits)).astype(np.float64)
    ncl = np.asarray(n_cluster).astype(np.float64)
    M = int(slots)
    by_fn = np.clip(np.nan_to_num(np.ceil(lim), nan=0.0), 0, M).sum(1)
    by_cluster = np.nan_to_num(np.ceil(ncl), nan=0.0)
    per_fleet = np.minimum(np.minimum(by_cluster, by_fn), lim.shape[1] * M)
    return max(int(per_fleet.max()), 1)


def fleet_inputs(
    fleet: FleetScenario, over: Mapping[str, Sequence], seed: int, *,
    replicas: int, device, steps: Optional[int] = None, staged=None, f64: bool = False,
) -> FleetInputs:
    """The cells of ``over``'s product grid and the staged stream:
    everything :func:`fleet_sweep` does before its launch.  ``f64`` stages
    for the f64 fleet scan: f64 per-fleet values (an unbounded cluster as
    inf) and f64 absolute times."""
    F = len(fleet.functions)
    if F > MAX_FUNCTIONS and not f64:
        raise ValueError(
            f"block backends serve fleets of at most {MAX_FUNCTIONS} functions "
            f"(functions ride one warp of the f32 kernels); got F={F} — use "
            "backend='scan'"
        )
    names = list(over)
    axis_vals = {n: tuple(over[n]) for n in names}
    combos = list(itertools.product(*[axis_vals[n] for n in names])) or [()]
    per_cell = [_cell_params(fleet, names, c) for c in combos]
    max_sim = max(p[2] for p in per_cell)
    R = int(replicas)
    if staged is None:
        staged = _stage_fleet(fleet, seed, R, steps, max_sim, device, f64)
    else:
        staged = _check_staged(staged, fleet, R, max_sim, device, f64)
    C = len(per_cell)
    cells = dict(
        expiration_threshold=np.array([p[0] for p in per_cell], np.float64),
        limit=np.broadcast_to(
            np.array([f.max_concurrency for f in fleet.functions], np.float64), (C, F)
        ),
        n_cluster=np.array([p[1] for p in per_cell], np.float64),
        sim_time=np.array([p[2] for p in per_cell], np.float64),
        skip_time=np.array([p[3] for p in per_cell], np.float64),
    )
    # per-fleet values, f32 for the block engine (an unbounded cluster
    # travels as 1e30) or f64
    rows = lambda a: torch.tensor(
        np.repeat(np.asarray(a, np.float64), R, axis=0),
        dtype=torch.float64 if f64 else torch.float32, device=device,
    ).contiguous()
    ncl = (cells["n_cluster"] if f64 else
           np.where(np.isfinite(cells["n_cluster"]), cells["n_cluster"], 1e30))
    vdt = np.float64 if f64 else np.float32  # the kernel's comparisons
    flt = fleet.active_faults
    faults = {}
    if flt is not None and flt.crashes:
        faults.update(crash_rate=rows(np.full(C, flt.crash_rate)), crash_u=staged["crash_u"])
    if flt is not None and flt.capacity is not None:
        cap = lambda x: rows(np.tile(np.asarray(x, np.float64), (C, 1)))
        faults.update(cap_edges=cap(flt.capacity.edges), cap_values=cap(flt.capacity.values))
    return FleetInputs(
        axis_vals=axis_vals,
        cells=cells,
        t_exp=rows(cells["expiration_threshold"]),
        limit=rows(cells["limit"]),
        ncl=rows(ncl),
        t_end=rows(cells["sim_time"]),
        skip=rows(cells["skip_time"]),
        stream=torch.arange(R, dtype=torch.int64, device=device).repeat(C),
        staged=staged,
        faults=faults,
        live_bound=live_bound(ncl.astype(vdt), cells["limit"].astype(vdt), fleet.slots),
        stream_rows=np.tile(np.arange(R, dtype=np.int64), C),
    )


def _launch_fleet(fleet: FleetScenario, inp: FleetInputs, bspec, replicas: int,
                  devices=None) -> list:
    """ONE launch of the backend's fleet launcher over every (cell,
    replica) fleet, or on the f64 fleet scan with ``devices`` one a device
    (:func:`_launch_fleet64`); returns one dict per cell: per-function
    ``summaries`` plus ``[F, R]`` fleet arrays and the ``[R]`` peak."""
    if bspec.f64:
        return _launch_fleet64(fleet, inp, bspec, replicas, devices)
    F, R = len(fleet.functions), int(replicas)
    st = inp.staged
    acc, qleft = bspec.launch_for("fleet")(
        inp.t_exp, inp.limit, inp.ncl, inp.t_end, inp.skip, inp.stream,
        st["times"], st["fids"], st["warms"], st["colds"],
        slots=fleet.slots, queue_depth=fleet.queue_depth, prestamped=st["prestamped"],
        live_bound=inp.live_bound, **inp.faults,
    )
    C = len(inp.cells["n_cluster"])
    faults = bool(inp.faults)
    cols = FLEET_ACC_COLS + (FAULT_COLS if faults else 0)
    acc = acc.double().cpu().numpy().reshape(C, R, F, cols)
    qleft = qleft.double().cpu().numpy().reshape(C, R, F)
    if acc[..., 7].sum() > 0:
        raise RuntimeError(
            "instance-pool overflow during fleet run; raise FleetScenario.slots"
        )
    out = []
    zeros = np.zeros((R,))
    for c in range(C):
        measured = float(inp.cells["sim_time"][c] - inp.cells["skip_time"][c])
        a = acc[c]  # [R, F, cols]
        summaries = [
            SimulationSummary(
                n_cold=a[:, f, 0], n_warm=a[:, f, 1], n_reject=a[:, f, 2],
                time_running=a[:, f, 3], time_idle=a[:, f, 4],
                sum_cold_resp=a[:, f, 5], sum_warm_resp=a[:, f, 6],
                lifespan_sum=zeros, lifespan_count=zeros,
                measured_time=measured, overflow=a[:, f, 7],
                **(dict(
                    n_crash=a[:, f, FLEET_ACC_COLS], n_evict=a[:, f, FLEET_ACC_COLS + 1],
                    n_interrupt=a[:, f, FLEET_ACC_COLS + 2],
                ) if faults else {}),
            )
            for f in range(F)
        ]
        out.append(dict(
            summaries=summaries, arrivals=a[:, :, 8].T, enq=a[:, :, 9].T,
            qserved=a[:, :, 10].T, qwait=a[:, :, 11].T, qleft=qleft[c].T,
            peak=a[:, 0, 12],
        ))
    return out


def _fleet_shard(inp: FleetInputs, lo: int, hi: int, device) -> tuple:
    """Fleets ``[lo, hi)`` of a launch on ``device``: their rows of the
    per-fleet inputs and of the fault rows, and the stream-table rows they
    read (a contiguous run of rows sliced, else gathered on the first
    device), with ``stream`` rebased to that table."""
    rows = inp.stream_rows[lo:hi]
    used = np.unique(rows)
    if used[-1] - used[0] + 1 == len(used):
        table = lambda x: x[used[0]:used[-1] + 1]
        stream = rows - used[0]
    else:
        idx = torch.as_tensor(used, device=inp.stream.device)
        table = lambda x: x.index_select(0, idx)
        stream = np.searchsorted(used, rows)
    move = lambda x: x.to(device, non_blocking=True)
    st = inp.staged
    args = tuple(move(x[lo:hi]) for x in (inp.t_exp, inp.limit, inp.ncl, inp.t_end, inp.skip))
    args += (torch.as_tensor(stream, dtype=torch.int64).to(device),)
    args += tuple(move(table(st[k])) for k in ("times", "fids", "warms", "colds"))
    faults = {k: move(table(v) if k == "crash_u" else v[lo:hi]) for k, v in inp.faults.items()}
    return args, faults


def _launch_fleet64(fleet: FleetScenario, inp: FleetInputs, bspec, replicas: int,
                    devices=None) -> list:
    """:func:`_launch_fleet` on the f64 fleet scan (the reference's
    ``_scan_fleet_cells``): the short-stream and overflow guards, and
    per-function summaries with lifespans and the fault columns.
    ``devices`` (default: the staging device alone; a sharded
    ``fleet_sweep`` names more) splits the fleets into one contiguous span
    a device (:func:`~repro_torch.core.execution.shard_spans`): every
    span's inputs are placed first, then every span is launched, with the
    whole launch's ``live_bound``, and only then is any read back, the
    spans joined in fleet order."""
    F, R = len(fleet.functions), int(replicas)
    st = inp.staged
    kw = dict(slots=fleet.slots, queue_depth=fleet.queue_depth, prestamped=st["prestamped"],
              live_bound=inp.live_bound)
    devices = devices or (inp.t_exp.device,)
    spans = shard_spans(inp.t_exp.shape[0], len(devices))
    shards = [(d, *_fleet_shard(inp, lo, hi, d)) for (lo, hi), d in zip(spans, devices)]
    launch = bspec.launch_for("fleet")
    outs = []
    for d, args, faults in shards:
        with launching_on(d):
            outs.append(launch(*args, **kw, **faults))
    del shards
    read = lambda name: np.concatenate([getattr(o, name).cpu().numpy() for o in outs])
    C = len(inp.cells["n_cluster"])
    faults = bool(inp.faults)
    acc = read("acc").reshape(C, R, F, -1)
    qleft = read("qleft").reshape(C, R, F)
    if not st["prestamped"]:
        short = read("t") < np.repeat(inp.cells["sim_time"], R)
        if short.any():
            raise RuntimeError("pre-drawn arrivals ended before sim_time; pass a larger steps=")
    if acc[..., 9].sum() > 0:
        raise RuntimeError("instance-pool overflow during fleet run; raise FleetScenario.slots")
    if not (np.isfinite(acc).all() and np.isfinite(qleft).all()):
        raise RuntimeError(
            "the f64 fleet scan returned non-finite outputs: a fleet held more live "
            f"instances than the launch's live bound {inp.live_bound}"
        )
    res = []
    FC = FLEET64_COLS
    for c in range(C):
        measured = float(inp.cells["sim_time"][c] - inp.cells["skip_time"][c])
        a = acc[c]  # [R, F, cols]
        summaries = [
            SimulationSummary(
                n_cold=a[:, f, 0], n_warm=a[:, f, 1], n_reject=a[:, f, 2],
                time_running=a[:, f, 3], time_idle=a[:, f, 4],
                sum_cold_resp=a[:, f, 5], sum_warm_resp=a[:, f, 6],
                lifespan_sum=a[:, f, 7], lifespan_count=a[:, f, 8],
                measured_time=measured, overflow=a[:, f, 9],
                **(dict(n_crash=a[:, f, FC], n_evict=a[:, f, FC + 1],
                        n_interrupt=a[:, f, FC + 2]) if faults else {}),
            )
            for f in range(F)
        ]
        res.append(dict(
            summaries=summaries, arrivals=a[:, :, FC - 5].T, enq=a[:, :, FC - 4].T,
            qserved=a[:, :, FC - 3].T, qwait=a[:, :, FC - 2].T, qleft=qleft[c].T,
            peak=a[:, 0, FLEET64_PEAK],
        ))
    return res


# --------------------------------------------------------------------------
# Results
# --------------------------------------------------------------------------


@dataclasses.dataclass
class FleetSummary:
    """Per-function and fleet-wide outcome of one fleet cell.

    ``summaries[f]`` is function f's :class:`SimulationSummary` over
    replicas; the fleet arrays are ``[F, R]`` counters (``arrivals``,
    ``enqueued``, ``queue_served``, ``queue_wait_sum``, ``queue_left``)
    and the per-replica peak cluster occupancy ``peak_cluster``.
    """

    functions: Tuple[str, ...]
    summaries: List[SimulationSummary]
    arrivals: np.ndarray
    enqueued: np.ndarray
    queue_served: np.ndarray
    queue_wait_sum: np.ndarray
    queue_left: np.ndarray
    peak_cluster: np.ndarray
    n_cluster: float
    measured_time: float

    def __getitem__(self, name: str) -> SimulationSummary:
        return self.summaries[self.functions.index(name)]

    @property
    def cold_start_prob(self) -> np.ndarray:
        """Per-function cold-start probability, ``[F]``."""
        return np.array([s.cold_start_prob for s in self.summaries])

    @property
    def avg_response_time(self) -> np.ndarray:
        return np.array([s.avg_response_time for s in self.summaries])

    @property
    def rejection_prob(self) -> np.ndarray:
        return np.array([s.rejection_prob for s in self.summaries])

    @property
    def queue_wait_avg(self) -> np.ndarray:
        """Mean queue wait per queue-served request, per function ``[F]``."""
        served = self.queue_served.sum(axis=1)
        return self.queue_wait_sum.sum(axis=1) / np.maximum(served, 1)

    @property
    def avg_cluster_occupancy(self) -> float:
        """Mean live instances across the cluster (all functions)."""
        return float(sum(s.avg_server_count for s in self.summaries))

    @property
    def cluster_utilization(self) -> float:
        """Mean occupancy / ``n_cluster`` (0.0 for an unbounded cluster)."""
        if not math.isfinite(self.n_cluster):
            return 0.0
        return self.avg_cluster_occupancy / self.n_cluster

    @property
    def max_peak_cluster(self) -> float:
        return float(np.max(self.peak_cluster))

    def to_dict(self) -> Dict[str, Any]:
        return dict(
            functions=list(self.functions),
            cold_start_prob=self.cold_start_prob.tolist(),
            rejection_prob=self.rejection_prob.tolist(),
            avg_response_time=self.avg_response_time.tolist(),
            queue_wait_avg=self.queue_wait_avg.tolist(),
            avg_cluster_occupancy=self.avg_cluster_occupancy,
            cluster_utilization=self.cluster_utilization,
            max_peak_cluster=self.max_peak_cluster,
            n_cluster=self.n_cluster if math.isfinite(self.n_cluster) else "inf",
        )


@dataclasses.dataclass
class FleetResult:
    """A fleet run: the scenario, its summary and per-function costs."""

    fleet: FleetScenario
    summary: FleetSummary
    costs: List[CostEstimate]

    def cost_of(self, name: str) -> CostEstimate:
        return self.costs[self.fleet.names.index(name)]

    @property
    def developer_cost(self) -> float:
        """Fleet-total developer bill (all functions)."""
        return float(sum(c.developer_total for c in self.costs))

    @property
    def provider_cost(self) -> float:
        """Fleet-total provider infrastructure cost."""
        return float(sum(c.provider_infra_cost for c in self.costs))


@dataclasses.dataclass
class FleetGridResult(GridResult):
    """A :class:`GridResult` whose trailing named axis is ``function``.

    ``sel(function="thumbnail")`` selects by catalog name or by position;
    the per-function metric grids are joined by the fleet-level
    ``queue_wait_avg``, ``cluster_utilization`` and ``peak_cluster`` grids
    (cluster-level values repeated over the function axis).
    """

    queue_wait_avg: Optional[np.ndarray] = None
    cluster_utilization: Optional[np.ndarray] = None
    peak_cluster: Optional[np.ndarray] = None

    _METRIC_FIELDS = GridResult._METRIC_FIELDS + (
        "queue_wait_avg",
        "cluster_utilization",
        "peak_cluster",
    )

    def _index_of(self, name: str, value) -> int:
        try:
            return super()._index_of(name, value)
        except KeyError:
            # the function axis holds names: an int that is not itself an
            # axis value selects by position
            n = len(self.axis(name))
            if isinstance(value, int) and not isinstance(value, bool) and 0 <= value < n:
                return value
            raise


# --------------------------------------------------------------------------
# Front door
# --------------------------------------------------------------------------


def _fleet_summary(fleet, cells, cell_out, c) -> FleetSummary:
    return FleetSummary(
        functions=fleet.names,
        summaries=cell_out["summaries"],
        arrivals=cell_out["arrivals"],
        enqueued=cell_out["enq"],
        queue_served=cell_out["qserved"],
        queue_wait_sum=cell_out["qwait"],
        queue_left=cell_out["qleft"],
        peak_cluster=cell_out["peak"],
        n_cluster=float(cells["n_cluster"][c]),
        measured_time=float(cells["sim_time"][c] - cells["skip_time"][c]),
    )


def _fleet_costs(fleet: FleetScenario, summaries) -> List[CostEstimate]:
    return [
        estimate_cost(s, dataclasses.replace(fleet.billing, memory_gb=fn.memory_gb))
        for fn, s in zip(fleet.functions, summaries)
    ]


def fleet_run(
    fleet: FleetScenario,
    seed: int,
    *,
    replicas: int = 4,
    engine: Optional[str] = None,
    backend: Optional[str] = None,
    device=None,
    execution: Optional[Execution] = None,
    steps: Optional[int] = None,
    staged=None,
) -> FleetResult:
    """Run one fleet cell (``replicas`` fleets, one launch; default: the
    f64 fleet scan, its kernel on the card); returns per-function and fleet
    metrics.

    ``seed`` seeds the per-function generators; ``staged`` (a dict of
    ``[replicas, K]`` ``times``/``fids``/``warms``/``colds`` and
    ``prestamped``, and ``crash_u`` with crashes) replaces the draws, and
    ``steps`` sets each function's draw count.
    """
    plan, bspec, dev = _resolve_fleet(execution, engine, backend, device)
    if plan.shard is not None:
        raise ValueError("shard= applies to fleet_sweep(); fleet_run executes one cell")
    inp = fleet_inputs(fleet, {}, seed, replicas=replicas, device=dev, steps=steps,
                       staged=staged, f64=bspec.f64)
    outs = _launch_fleet(fleet, inp, bspec, replicas)
    summary = _fleet_summary(fleet, inp.cells, outs[0], 0)
    return FleetResult(fleet=fleet, summary=summary,
                       costs=_fleet_costs(fleet, summary.summaries))


def fleet_sweep(
    fleet: FleetScenario,
    over: Mapping[str, Sequence],
    seed: int,
    *,
    replicas: int = 4,
    engine: Optional[str] = None,
    backend: Optional[str] = None,
    device=None,
    execution: Optional[Execution] = None,
    steps: Optional[int] = None,
    staged=None,
) -> FleetGridResult:
    """Product sweep over fleet axes, named axes, ONE launch.

    ``over`` maps an axis name to its values: ``expiration_threshold``
    (a scalar broadcast to every function, or a length-F sequence),
    ``n_cluster``, ``sim_time``, ``skip_time``.  The result grid gains a
    trailing ``function`` axis (selectable by name or by position).

    On the f64 fleet scan ``execution=Execution(devices=...,
    shard="grid")`` splits the (cell, replica) fleets into one contiguous
    span a device, each launched on its rows of the stream (one launch a
    device, every launch before any read): bit for bit the unsharded grid.
    """
    plan, bspec, dev = _resolve_fleet(execution, engine, backend, device)
    _validate_axes(fleet, over)
    inp = fleet_inputs(fleet, over, seed, replicas=replicas, device=dev, steps=steps,
                       staged=staged, f64=bspec.f64)
    outs = _launch_fleet(fleet, inp, bspec, replicas, plan.devices)
    F = len(fleet.functions)
    names = list(inp.axis_vals)
    dims = tuple(len(inp.axis_vals[n]) for n in names)
    n_cells = len(outs)

    metrics = (
        "cold_start_prob", "rejection_prob", "avg_server_count", "avg_running_count",
        "avg_idle_count", "wasted_ratio", "avg_response_time", "developer_cost",
        "provider_cost", "goodput", "availability", "queue_wait_avg",
        "cluster_utilization", "peak_cluster",
    )
    grids = {m: np.zeros((n_cells, F)) for m in metrics}
    summaries = np.empty((n_cells, F), dtype=object)
    for c, out in enumerate(outs):
        fsum = _fleet_summary(fleet, inp.cells, out, c)
        costs = _fleet_costs(fleet, fsum.summaries)
        qwa = fsum.queue_wait_avg
        for f, s in enumerate(fsum.summaries):
            summaries[c, f] = s
            grids["cold_start_prob"][c, f] = s.cold_start_prob
            grids["rejection_prob"][c, f] = s.rejection_prob
            grids["avg_server_count"][c, f] = s.avg_server_count
            grids["avg_running_count"][c, f] = s.avg_running_count
            grids["avg_idle_count"][c, f] = s.avg_idle_count
            grids["wasted_ratio"][c, f] = s.avg_wasted_ratio
            grids["avg_response_time"][c, f] = s.avg_response_time
            grids["developer_cost"][c, f] = costs[f].developer_total
            grids["provider_cost"][c, f] = costs[f].provider_infra_cost
            grids["goodput"][c, f] = s.goodput
            grids["availability"][c, f] = s.availability
            grids["queue_wait_avg"][c, f] = qwa[f]
            grids["cluster_utilization"][c, f] = fsum.cluster_utilization
            grids["peak_cluster"][c, f] = fsum.max_peak_cluster

    shape = dims + (F,)
    grids = {m: g.reshape(shape) for m, g in grids.items()}
    ok = np.ones(shape, bool)
    for g in grids.values():
        ok &= np.isfinite(g)
    return FleetGridResult(
        axes={**{n: inp.axis_vals[n] for n in names}, "function": fleet.names},
        replicas=int(replicas),
        backend=bspec.name,
        summaries=summaries.reshape(shape),
        ok=ok,
        execution=plan,
        **grids,
    )
