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
f64, merged per replica by a stable sort on the f64 times (ties keep
function order) and only then cast to f32: one ``[replicas, K]`` stream
of times, acting-function ids, warm and cold samples.  A one-function
fleet passes its stream through as gaps, the draws :func:`~repro_torch.
core.scenario.run` makes on the same seed.

:func:`fleet_sweep` sweeps ``expiration_threshold`` (a scalar for every
function, or one value per function), ``n_cluster``, ``sim_time`` and
``skip_time``.  All four are per-fleet values, so every cell reads the one
stream and a whole sweep is ONE launch of the fleet kernel
(``LAUNCH_COUNTS["fleet_sweep"]``); the result has a trailing
``function`` axis.  The engine is the f32 block engine: backend
``"cuda"`` (the kernel ``kernels/csrc/fleet_event_step.cu``, F <= 8) or
``"ref"`` (its plain version).

Not ported yet, each raising with its ROADMAP item: the f64 fleet scan
(backend ``"scan"``, Queue A item 2), platform faults (``faults=``, Queue A
item 4) and rate profiles (Queue A item 3).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cost import BillingModel, CostEstimate, estimate_cost
from repro_torch.core.execution import _PROVIDERS, Execution, plan_of, resolve_backend
from repro_torch.core.processes import SimProcess
from repro_torch.core.scenario import GridResult, Scenario
from repro_torch.core.simulator import (
    SimulationSummary,
    cell_generators,
    draw_workload_samples,
)
from repro_torch.kernels.ref import FLEET_ACC_COLS, MAX_FUNCTIONS

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
        # process (a rate profile raises there, naming its ROADMAP item)
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
    the single-function engines); ``slots`` is each function's pool size.
    ``faults`` must stay ``None``: platform faults are not ported yet.
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
        if self.faults is not None:
            raise NotImplementedError(
                "FleetScenario.faults is not ported to repro_torch yet; see "
                "ROADMAP.md Queue A item 4 (platform faults)"
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
    max_sim: float, device,
) -> Dict[str, Any]:
    """Draw every function's stream on ``device`` and merge them per replica.

    Returns ``times`` (f32), ``fids`` (uint8), ``warms``, ``colds`` (f32),
    each ``[replicas, K]``, and ``prestamped``.  For F > 1 each function's
    gaps are cumulated in f64 and must reach ``max_sim``; the streams,
    concatenated in function order, are merged by a stable sort on the f64
    times (the reference's ``np.lexsort((fids, times))``) and cast to f32
    after the merge: at t ~ 1e5 s f32 spaces times ~0.008 s apart, so
    sorting after the cast would reorder the stream.  For F == 1 the gaps
    pass through (``prestamped=False``), as :func:`~repro_torch.core.
    scenario.run` draws them.
    """
    F, R = len(fleet.functions), int(replicas)
    limit = torch.tensor(max_sim, dtype=torch.float64, device=device)
    times, fids, warms, colds = [], [], [], []
    for f, (fn, gens) in enumerate(zip(fleet.functions, cell_generators(seed, F, device))):
        scn_f = fn.as_scenario(sim_time=max_sim, skip_time=fleet.skip_time, slots=fleet.slots)
        n_f = int(steps) if steps is not None else scn_f.steps_needed()
        arr, warm, cold = draw_workload_samples(scn_f, gens, R, n_f, device)
        if F == 1:
            if bool((arr.sum(1, dtype=torch.float64) < limit).any()):
                _short(fn.name)
            return dict(
                times=arr, fids=torch.zeros(arr.shape, dtype=torch.uint8, device=device),
                warms=warm, colds=cold, prestamped=False,
            )
        t_f = arr.double().cumsum_(1)
        if bool((t_f[:, -1] < limit).any()):
            _short(fn.name)
        times.append(t_f)
        fids.append(torch.full(arr.shape, f, dtype=torch.uint8, device=device))
        warms.append(warm)
        colds.append(cold)
        del arr
    merged, order = torch.sort(torch.cat(times, 1), dim=1, stable=True)
    del times
    take = lambda parts: torch.cat(parts, 1).gather(1, order)
    return dict(
        times=merged.float(), fids=take(fids), warms=take(warms), colds=take(colds),
        prestamped=True,
    )


def _check_staged(staged, fleet: FleetScenario, replicas: int, max_sim: float, device) -> dict:
    """A handed-in stream (see :func:`repro_torch.interop.
    fleet_staged_from_reference`) on ``device``, behind the coverage
    guard: every function's last arrival must reach ``max_sim``."""
    keys = ("times", "fids", "warms", "colds", "prestamped")
    if not isinstance(staged, Mapping) or any(k not in staged for k in keys):
        raise ValueError(
            "staged must map times, fids, warms, colds and prestamped "
            "(see repro_torch.interop.fleet_staged_from_reference)"
        )
    out = {k: torch.as_tensor(staged[k], dtype=torch.float32).to(device).contiguous()
           for k in ("times", "warms", "colds")}
    out["fids"] = torch.as_tensor(staged["fids"]).to(device, torch.uint8).contiguous()
    out["prestamped"] = bool(staged["prestamped"])
    shape = tuple(out["times"].shape)
    if len(shape) != 2 or shape[0] != replicas or any(
        tuple(out[k].shape) != shape for k in ("fids", "warms", "colds")
    ):
        raise ValueError(
            f"staged buffers must all be [{replicas}, K]; got "
            f"{[tuple(out[k].shape) for k in keys[:4]]}"
        )
    times, fids = out["times"], out["fids"]
    if out["prestamped"]:
        # f32 rounding is monotone, so compare against the f32 horizon
        need = torch.tensor(max_sim, dtype=torch.float32, device=device)
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
    if plan.backend == "scan":
        raise NotImplementedError(
            "backend='scan' (the f64 fleet scan engine) is not ported to "
            "repro_torch yet; see ROADMAP.md Queue A item 2"
        )
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
    return dataclasses.replace(plan, backend=bspec.name, device=str(dev)), bspec, dev


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


def fleet_inputs(
    fleet: FleetScenario, over: Mapping[str, Sequence], seed: int, *,
    replicas: int, device, steps: Optional[int] = None, staged=None,
) -> FleetInputs:
    """The cells of ``over``'s product grid and the staged stream:
    everything :func:`fleet_sweep` does before its launch."""
    F = len(fleet.functions)
    if F > MAX_FUNCTIONS:
        raise ValueError(
            f"block backends serve fleets of at most {MAX_FUNCTIONS} functions "
            f"(one warp holds a fleet's pools); got F={F} — use backend='scan' "
            "(the f64 fleet scan, not ported yet: ROADMAP.md Queue A item 2)"
        )
    names = list(over)
    axis_vals = {n: tuple(over[n]) for n in names}
    combos = list(itertools.product(*[axis_vals[n] for n in names])) or [()]
    per_cell = [_cell_params(fleet, names, c) for c in combos]
    max_sim = max(p[2] for p in per_cell)
    R = int(replicas)
    if staged is None:
        staged = _stage_fleet(fleet, seed, R, steps, max_sim, device)
    else:
        staged = _check_staged(staged, fleet, R, max_sim, device)
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
    # f32 per-fleet values; an unbounded cluster travels as 1e30
    rows = lambda a: torch.tensor(
        np.repeat(np.asarray(a, np.float64), R, axis=0), dtype=torch.float32,
        device=device,
    ).contiguous()
    ncl = np.where(np.isfinite(cells["n_cluster"]), cells["n_cluster"], 1e30)
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
    )


def _launch_fleet(fleet: FleetScenario, inp: FleetInputs, bspec, replicas: int) -> list:
    """ONE launch of the backend's fleet launcher over every (cell,
    replica) fleet; returns one dict per cell: per-function ``summaries``
    plus ``[F, R]`` fleet arrays and the ``[R]`` peak."""
    F, R = len(fleet.functions), int(replicas)
    st = inp.staged
    acc, qleft = bspec.launch_for("fleet")(
        inp.t_exp, inp.limit, inp.ncl, inp.t_end, inp.skip, inp.stream,
        st["times"], st["fids"], st["warms"], st["colds"],
        slots=fleet.slots, queue_depth=fleet.queue_depth, prestamped=st["prestamped"],
    )
    C = len(inp.cells["n_cluster"])
    acc = acc.double().cpu().numpy().reshape(C, R, F, FLEET_ACC_COLS)
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
            )
            for f in range(F)
        ]
        out.append(dict(
            summaries=summaries, arrivals=a[:, :, 8].T, enq=a[:, :, 9].T,
            qserved=a[:, :, 10].T, qwait=a[:, :, 11].T, qleft=qleft[c].T,
            peak=a[:, 0, 12],
        ))
    return out


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
    CUDA kernel on the card); returns per-function and fleet metrics.

    ``seed`` seeds the per-function generators; ``staged`` (a dict of
    ``[replicas, K]`` ``times``/``fids``/``warms``/``colds`` and
    ``prestamped``) replaces the draws, and ``steps`` sets each function's
    draw count.
    """
    _, bspec, dev = _resolve_fleet(execution, engine, backend, device)
    inp = fleet_inputs(fleet, {}, seed, replicas=replicas, device=dev, steps=steps,
                       staged=staged)
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
    """
    plan, bspec, dev = _resolve_fleet(execution, engine, backend, device)
    _validate_axes(fleet, over)
    inp = fleet_inputs(fleet, over, seed, replicas=replicas, device=dev, steps=steps,
                       staged=staged)
    outs = _launch_fleet(fleet, inp, bspec, replicas)
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
