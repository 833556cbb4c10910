"""The Scenario front door of the PyTorch port: :func:`run` and :func:`sweep`
on the f32 block engines (backends ``"cuda"``/``"ref"``) and on the f64
engine (backends ``"scan"``/``"scan_ref"``, the reference's default
substrate, decision for decision).

* :class:`Scenario` — one frozen description of a simulation: the arrival
  and service processes, platform limits, horizon/warm-up and billing,
  with the reference's fields and validation.
* :func:`run` — one scenario, ``replicas`` rows, one kernel launch of the
  chosen engine (``"scan"``, ``"temporal"`` or ``"par"``); returns a
  :class:`Result` (summary plus cost, and the transient curves for
  ``"temporal"``).
* :func:`sweep` — a product grid over scenario fields returning a
  :class:`GridResult` with named axes.  Axes partition as in the
  reference: **static** fields (``slots``, ``max_concurrency``, …) give
  one launch each; **draw** fields (``expiration_threshold``,
  ``arrival_rate``, the processes) give each cell its own sample draws;
  **param** fields (``sim_time``, ``skip_time``) share the draw cells'
  buffers.  Every non-static axis is flattened onto the row axis in the
  order ``(draw, param, replica)``, so a threshold × rate × horizon grid is
  ONE launch of the kernel (``LAUNCH_COUNTS`` pins it).  Sweeps run the
  steady-state engine only, as in the reference.

The reliability layer (``Scenario.reliability``: timeouts, invocation
failures, client retries) runs on the scan engine: ``t_timeout`` and
``p_fail`` are param axes, the ``backoff_*`` parameters draw axes (they
shape the attempt table), and retries run the sorted attempt table
prestamped.  Metric windows (``Scenario.window_bounds``, a static axis)
fill per-cell :class:`~repro_torch.core.simulator.WindowedMetrics` and
the ``GridResult.windowed_*`` grids; as in the reference, single runs on
the block engines take no windows.

Platform faults (``Scenario.faults``, a :class:`~repro_torch.core.faults.
FaultModel`: instance crashes and capacity churn) run on the scan engine
with staged draws, alone, with reliability or with retries; the
``crash_rate`` and ``capacity`` axes are param axes, so a crash-rate ×
threshold × capacity grid is one launch.  Each draw cell's crash uniforms
come from its own generator (:data:`~repro_torch.core.simulator.
CRASH_STREAM`), after the base and reliability streams, which a fault
model leaves bit for bit unchanged.

Samples are staged on the device as f32 ``[C, K]`` buffers from per-draw-
cell generators (``SeedSequence(seed).spawn(D)``) and never copied to the
host: the coverage guard sums them on the device in f64, and only the
``[C, 8]`` accumulator comes back.  ``staged=`` (see :mod:`repro_torch.
interop`) replaces the draws with the reference's own buffers.

With ``Execution(draws="fused")`` (scan engine, no retries) no sample
buffer exists: the grid lowers to one :class:`~repro_torch.core.drawplan.
DrawPlan`, each row carries a uint32 key pair per stream and parameter
pairs (f32 on the block engine, 48 bytes a row, 56 with the failure
stream; f64 on the f64 engine), the kernel draws every sample, and the
coverage guard reads the kernel's final clock.  One launch serves a sweep.
``fused_keys=`` replaces the keys derived from ``seed`` (see
:func:`repro_torch.interop.fused_keys_from_reference`).

Non-stationary workloads (``Scenario.rate_profile``, lowered to
:class:`~repro_torch.core.processes.NHPPArrivalProcess`; MMPP and trace
replay) yield absolute timestamps: the staging layer thins and sorts them
in f64, guards each draw cell on the process's own coverage, casts once
into the f32 buffers, and the kernels run ``prestamped``.  ``profile`` is
a draw axis (one draw cell per profile); a grid must not mix stationary
and timestamp cells.  Fused draws thin an NHPP arrival process inline on
the f64 engine (backends ``"scan"``/``"scan_ref"``: candidates at the
envelope rate, a rejected one an inert arrival); the block kernels evaluate
no ``profile.rate(t)`` and refuse it, and every other timestamp process.

The f64 engine alone serves windowed single runs, the instance-count
histogram (``track_histogram``, ``hist_bins``), oldest-first routing,
lifespans and reliability on the temporal and par engines; the block
backends refuse them with the reference's messages.  Its staging keeps
absolute timestamps in f64 and retry positions as integers.  ``scan_unroll``
is a static axis whose values share one launch and its cells (it changes
only the reference's compile).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import warnings
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import drawplan as dp
from repro_torch.core.cost import BillingModel, CostEstimate, estimate_cost
from repro_torch.core.execution import (
    ENGINE_SPECS,
    Execution,
    launching_on,
    plan_of,
    shard_spans,
)
from repro_torch.core.faults import CapacityProfile, FaultModel
from repro_torch.core.processes import (
    ArrivalTimeProcess,
    ExpSimProcess,
    NHPPArrivalProcess,
    RateProfile,
    SimProcess,
)
from repro_torch.core.par_simulator import run_par, run_par64
from repro_torch.core.reliability import Reliability
from repro_torch.core.simulator import (
    CRASH_STREAM,
    FAULT_STREAMS,
    RELY_STREAMS,
    SimulationSummary,
    WindowedMetrics,
    cell_generators,
    check_clock_covered,
    check_covered,
    check_staged,
    check_table_covered,
    deferred_guards,
    draw_crash_uniforms,
    draw_reliability_stream,
    draw_workload_samples,
    fault_inputs,
    fault_rows as fault_rows_of,
    host_acc,
    run_samples,
    run_scan64,
    scan_cell_summaries,
    scan_launch,
    staged_dtypes,
    staged_widths,
    summary_from_acc,
)
from repro_torch.core.temporal import TemporalSummary, run_temporal, run_temporal64
from repro_torch.kernels.ref import ACC_COLS, NEG, RELY_COLS, WINDOW_COLS
from repro_torch.kernels.ref64 import ScanLayout


# what makes a call pay again after warm-up, counted by the online
# what-if service around each tick's dispatch (``"online_tick"``: kernel
# libraries built or loaded and CUDA allocator segments newly reserved;
# :func:`repro_torch.serving.online.trace_total`)
TRACE_COUNTS: dict = {"online_tick": 0}


def _check_process(name: str, p) -> None:
    if not isinstance(p, SimProcess):
        raise TypeError(
            f"{name} must be a repro_torch SimProcess, got "
            f"{type(p).__name__} (convert a reference scenario with "
            "repro_torch.interop.scenario_from_reference)"
        )


def _rated(process: SimProcess, rate: float) -> SimProcess:
    """Re-rate an arrival process; fall back to exponential when the
    family has no rate handle (the reference's behaviour)."""
    try:
        return process.with_rate(float(rate))
    except NotImplementedError:
        return ExpSimProcess(rate=float(rate))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One declarative description of a serverless simulation experiment
    (the reference's fields; see the module docstring for what this slice
    runs)."""

    arrival_process: Optional[SimProcess] = None
    warm_service_process: Optional[SimProcess] = None
    cold_service_process: Optional[SimProcess] = None
    expiration_threshold: float = 600.0
    max_concurrency: int = 1000
    sim_time: float = 1e5
    skip_time: float = 100.0  # warm-up transient excluded from metrics
    slots: int = 64  # instance-pool array size (>= peak live instances)
    routing: str = "newest"  # warm routing: "newest" (paper) or "oldest" idle
    scan_unroll: int = 1  # the reference's lax.scan unroll (semantics-free)
    track_histogram: bool = False  # time at each instance count (f64 engine)
    hist_bins: int = 65  # histogram bins [0, hist_bins)
    window_bounds: Optional[tuple] = None
    rate_profile: Optional[Any] = None
    arrival_rate: Optional[float] = None
    concurrency_value: int = 1
    billing: BillingModel = BillingModel()
    reliability: Optional[Any] = None
    faults: Optional[Any] = None

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        if not self.sim_time > 0:
            raise ValueError(f"sim_time must be > 0, got {self.sim_time}")
        if self.skip_time < 0:
            raise ValueError(f"skip_time must be >= 0, got {self.skip_time}")
        if self.skip_time >= self.sim_time:
            raise ValueError("skip_time must be < sim_time")
        if not self.expiration_threshold > 0:
            raise ValueError(
                f"expiration_threshold must be > 0, got {self.expiration_threshold}"
            )
        if self.max_concurrency < 1:
            raise ValueError("max_concurrency must be >= 1")
        if self.hist_bins < 1:
            raise ValueError("hist_bins must be >= 1")
        if self.scan_unroll < 1:
            raise ValueError("scan_unroll must be >= 1")
        if self.arrival_rate is not None and not self.arrival_rate > 0:
            raise ValueError(f"arrival_rate must be > 0, got {self.arrival_rate}")
        if self.concurrency_value < 1:
            raise ValueError("concurrency_value must be >= 1")
        if self.reliability is not None and not isinstance(self.reliability, Reliability):
            raise ValueError(
                "Scenario.reliability must be a Reliability (or None), got "
                f"{type(self.reliability).__name__}"
            )
        if self.faults is not None:
            if not isinstance(self.faults, FaultModel):
                raise ValueError(
                    "Scenario.faults must be a FaultModel (or None), got "
                    f"{type(self.faults).__name__}"
                )
            if self.faults.enabled and self.window_bounds is not None:
                raise ValueError(
                    "platform faults do not serve windowed metrics yet; "
                    "drop window_bounds or the FaultModel"
                )
            if self.faults.enabled and self.track_histogram:
                raise ValueError(
                    "platform faults do not serve the instance-count "
                    "histogram; drop track_histogram or the FaultModel"
                )
        if self.window_bounds is not None:
            wb = np.asarray(self.window_bounds, dtype=np.float64)
            if wb.ndim != 1 or len(wb) < 2 or (np.diff(wb) <= 0).any():
                raise ValueError("window_bounds must be >= 2 strictly increasing values")
            object.__setattr__(self, "window_bounds", tuple(float(b) for b in wb))
        if self.warm_service_process is None or self.cold_service_process is None:
            raise ValueError(
                "Scenario needs warm_service_process and cold_service_process"
            )
        prof = self.rate_profile
        if prof is not None and not isinstance(prof, RateProfile):
            raise TypeError(
                f"rate_profile must be a repro_torch RateProfile, got "
                f"{type(prof).__name__} (convert a reference scenario with "
                "repro_torch.interop.scenario_from_reference)"
            )
        ap = self.arrival_process
        if ap is None:
            if prof is None:
                raise ValueError("Scenario needs an arrival_process or a rate_profile")
            ap = NHPPArrivalProcess(profile=prof)
        elif prof is not None and not (
            isinstance(ap, NHPPArrivalProcess) and ap.profile == prof
        ):
            # (a resolved profile round-trips through replace/of)
            raise ValueError("give either arrival_process or rate_profile, not both")
        for name in ("warm_service_process", "cold_service_process"):
            _check_process(name, getattr(self, name))
        _check_process("arrival_process", ap)
        if self.arrival_rate is not None:
            if isinstance(ap, ArrivalTimeProcess):
                # NHPP re-levels its profile; MMPP and trace have no rate
                # handle and must not fall back to exponential (_rated would)
                try:
                    ap = ap.with_rate(float(self.arrival_rate))
                except NotImplementedError:
                    raise ValueError(
                        "arrival_rate cannot re-rate a timestamp process "
                        f"({type(ap).__name__}); sweep over rate profiles instead"
                    ) from None
                if prof is not None:
                    object.__setattr__(self, "rate_profile", ap.profile)
            else:
                ap = _rated(ap, self.arrival_rate)
            # fold the rate into the process and clear the field, as the
            # reference does, so a later replace() cannot re-rate it back
            object.__setattr__(self, "arrival_rate", None)
        object.__setattr__(self, "arrival_process", ap)

    @classmethod
    def of(cls, config, **changes) -> "Scenario":
        """A plain Scenario copied from ``config``, with overrides applied."""
        kw = {f.name: getattr(config, f.name) for f in dataclasses.fields(cls)}
        kw.update(changes)
        return Scenario(**kw)

    @property
    def prestamped(self) -> bool:
        """True when the arrival process yields absolute timestamps."""
        return isinstance(self.arrival_process, ArrivalTimeProcess)

    @property
    def active_faults(self) -> Optional[FaultModel]:
        """The fault model when it injects anything, else None."""
        return self.faults if self.faults is not None and self.faults.enabled else None

    @property
    def max_retries(self) -> int:
        """The retry budget (0 without reliability): it sets the attempt
        table's width, and a retry stream runs prestamped."""
        return 0 if self.reliability is None else int(self.reliability.retry.max_retries)

    def steps_needed(self) -> int:
        """Upper bound on arrivals within ``sim_time`` (mean + 6 sigma)."""
        n = self.sim_time / self.arrival_process.mean()
        return int(n + 6.0 * np.sqrt(max(n, 1.0)) + 16)


@dataclasses.dataclass
class Result:
    """One scenario's outcome: the summary plus its cost estimate."""

    scenario: Scenario
    summary: SimulationSummary  # ParSimulationSummary for engine="par"
    cost: CostEstimate
    temporal: Optional[TemporalSummary] = None  # when engine="temporal"

    @property
    def cold_start_prob(self) -> float:
        return self.summary.cold_start_prob

    @property
    def rejection_prob(self) -> float:
        return self.summary.rejection_prob

    @property
    def avg_server_count(self) -> float:
        return self.summary.avg_server_count

    @property
    def avg_running_count(self) -> float:
        return self.summary.avg_running_count

    @property
    def avg_response_time(self) -> float:
        return self.summary.avg_response_time

    @property
    def avg_wasted_ratio(self) -> float:
        return self.summary.avg_wasted_ratio

    def to_dict(self) -> dict:
        return {
            **self.summary.to_dict(),
            "developer_cost": self.cost.developer_total,
            "provider_cost": self.cost.provider_infra_cost,
        }


# ---------------------------------------------------------------------------
# the shared block launch
# ---------------------------------------------------------------------------


def _rows_on(x, lo: int, hi: int, device, dtype=torch.float64):
    """Rows ``[lo, hi)`` of a per-row launch input on ``device``: None stays
    None; a scalar is broadcast and a host array sliced, both copied in
    ``dtype``; a device tensor is sliced (a view on its own device) and
    copied to another device without blocking the host."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x[lo:hi].to(device, non_blocking=True)
    a = np.asarray(x, np.float64)
    a = np.broadcast_to(a, (hi - lo,)) if a.ndim == 0 else a[lo:hi]
    return torch.tensor(a, dtype=dtype, device=device)


def _block_launch(
    scn, t_exp, t_end, skip, samples, bspec, device, *,
    prestamped=False, window_rows=None, t_timeout=None, p_fail=None, fused=None,
    faults=None, devices=None,
):
    """Fresh pools, per-row f32 parameters and the staged buffers
    (``samples``: ``dts, warms, colds``, then ``fail_u`` with reliability,
    ``is_first, child_pos`` with retries and ``crash_u`` with crashes) into
    the backend's row launcher; returns the f64 accumulator on the host
    after the overflow guard.  ``window_rows`` is the ``[C, W+1]``
    window-bound matrix; ``t_timeout``/``p_fail`` the per-row reliability
    parameters; ``faults`` the per-row fault inputs (:func:`~repro_torch.core.simulator.fault_rows`:
    ``crash_rate`` ``[C]`` with crashes, ``cap_edges``/``cap_values``
    ``[C, E]``/``[C, E+1]`` with capacity).  With ``fused``
    (:func:`fused_state`) there are no samples: the kernel draws them, and
    its final clock goes through the coverage guard.

    ``devices`` (default: ``device`` alone) splits the rows into one
    contiguous span a device (:func:`~repro_torch.core.execution.
    shard_spans`): every span's inputs are placed on its device, then
    every span is launched, and only then is any read back, the
    accumulators joined in row order."""
    C = fused["keys"][0].shape[0] if fused is not None else samples[0].shape[0]
    M = scn.slots
    faults = faults or {}
    devices = devices or (device,)
    shards = []
    # every shard's inputs before any launch: a copy from the first device
    # queued behind a launch there would hold the next shard back
    for (lo, hi), dev in zip(shard_spans(C, len(devices)), devices):
        on = functools.partial(_rows_on, lo=lo, hi=hi, device=dev, dtype=torch.float32)
        n = hi - lo
        kw = dict(max_concurrency=scn.max_concurrency)
        if window_rows is not None:
            kw["window_bounds"] = on(window_rows)
        part = tuple(on(x) for x in samples)
        if fused is not None:
            kw.update(fused_keys=tuple(on(k) for k in fused["keys"]),
                      fused_params=tuple(on(p) for p in fused["params"]),
                      fused_dists=fused["dists"], fused_k=fused["n_steps"])
            if t_timeout is not None:
                kw.update(t_timeout=on(t_timeout), p_fail=on(p_fail),
                          fused_fail_keys=on(fused["fail_keys"]))
            part = (None, None, None)
        else:
            kw["prestamped"] = prestamped
            if "crash_rate" in faults:
                kw.update(crash_rate=on(faults["crash_rate"]), crash_u=part[-1])
                part = part[:-1]
            if "cap_values" in faults:
                kw.update(cap_edges=on(faults["cap_edges"]), cap_values=on(faults["cap_values"]))
            if len(part) > 3:
                kw.update(t_timeout=on(t_timeout), p_fail=on(p_fail), fail_u=part[3])
            if len(part) > 4:
                kw.update(is_first=part[4], child_pos=part[5])
        alive0 = torch.zeros((n, M), dtype=torch.float32, device=dev)
        frozen = torch.full((n, M), NEG, dtype=torch.float32, device=dev)
        t0 = torch.zeros((n,), dtype=torch.float32, device=dev)
        args = (alive0, frozen, frozen, t0, on(t_exp), on(t_end), on(skip), *part[:3])
        shards.append((dev, args, kw))
    with deferred_guards() as checks:
        outs = []
        for dev, args, kw in shards:
            with launching_on(dev):
                outs.append(bspec.launch(*args, **kw))
    del shards
    for read in checks:
        read()
    if fused is not None:
        (acc, t_last), = outs
        check_clock_covered(t_last, np.broadcast_to(np.asarray(t_end, np.float64), (C,)))
        return host_acc(acc)
    return host_acc(torch.cat([acc.cpu() for acc in outs]))


def fused_state(cfgs, seed, replicas: int, n_steps: int, device, *, param_cells=1,
                fused_keys=None, f64: bool = False) -> dict:
    """The fused launch's whole sample state for the draw cells ``cfgs``
    (rows in ``(draw, param, replica)`` order, each draw cell's rows
    repeated over ``param_cells``): ``dists``, uint32 ``[C, 2]`` ``keys``
    (arrival, warm, cold) and ``fail_keys`` (with reliability, else None),
    ``[C, 2]`` ``params`` (f32, or f64 for the f64 engine), ``n_steps``
    and, for an NHPP arrival (the f64 engine only), the ``profile`` block
    (a tuple of floats), on ``device``.  The keys are
    :func:`~repro_torch.core.drawplan.stream_row_keys` of ``seed``, or
    ``fused_keys`` (a dict of ``[D*replicas, 2]`` uint32 arrays per
    stream) when given.  One plan serves the grid, so every draw cell must
    lower to the same distribution families and rate profile."""
    lowered = [dp.lower_scenario(c) for c in cfgs]
    plans = {plan for plan, _ in lowered}
    if len(plans) > 1:
        raise ValueError(
            "fused draws run one DrawPlan for the whole grid; sweeping "
            "distribution families or rate profiles across draw cells needs "
            "draws='staged'"
        )
    plan = plans.pop()
    nhpp = plan.arrival.kind == dp.NHPP
    if nhpp and not f64:
        raise ValueError(
            "fused NHPP thinning is scan-backend only (the block kernels have "
            "no profile.rate(t) at trace time); use backend='scan' or "
            "draws='staged'"
        )
    D, R = len(cfgs), int(replicas)
    streams = dp.STREAMS[:4 if plan.fail else 3]
    if fused_keys is None:
        cells = [dp.stream_row_keys(seed, d, R, fail=plan.fail) for d in range(D)]
        keys = {s: np.concatenate([c[s] for c in cells]) for s in streams}
    else:
        keys = _handed_keys(fused_keys, streams, D * R)
    rep = lambda a: np.repeat(a.reshape(D, 1, R, 2), param_cells, axis=1).reshape(-1, 2)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    ptype = np.float64 if f64 else np.float32
    params = [
        np.repeat(np.asarray([pv[s] for _, pv in lowered], ptype), param_cells * R, axis=0)
        for s in streams[:3]
    ]
    return dict(
        dists=plan.dists,
        keys=tuple(dev(rep(keys[s])) for s in streams[:3]),
        fail_keys=dev(rep(keys["fail"])) if plan.fail else None,
        params=tuple(dev(p) for p in params),
        n_steps=int(n_steps),
        profile=plan.arrival.profile.block() if nhpp else None,
    )


def _handed_keys(fused_keys, streams, rows: int) -> dict:
    """The handed-in ``fused_keys`` as numpy uint32 ``[rows, 2]`` arrays."""
    missing = [s for s in streams if s not in fused_keys]
    if missing:
        raise ValueError(f"fused_keys needs the streams {list(streams)}; missing {missing}")
    out = {}
    for s in streams:
        x = fused_keys[s]
        if isinstance(x, torch.Tensor):
            if x.dtype != torch.uint32:
                raise ValueError(f"fused_keys[{s!r}] must be uint32, got {x.dtype}")
            x = x.cpu().view(torch.int32).numpy().view(np.uint32)
        x = np.asarray(x)
        if x.dtype != np.uint32 or x.shape != (rows, 2):
            raise ValueError(
                f"fused_keys[{s!r}] must be uint32 [{rows}, 2] (draw cell, "
                f"replica rows), got {x.dtype} {x.shape}"
            )
        out[s] = x
    return out


def _cell_summaries(acc, R, measured, bounds=None, reliability=False, faults=False) -> list:
    """Per-cell summaries off a launch's ``[cells * R, cols]`` accumulator
    (the 8 base columns, ``5W`` window columns when ``bounds`` is given,
    then the 4 reliability columns, then the 3 fault columns);
    ``measured[c]`` is cell c's measured time."""
    W = 0 if bounds is None else len(bounds) - 1
    A, RB = ACC_COLS, ACC_COLS + WINDOW_COLS * W
    FB = RB + (RELY_COLS if reliability else 0)
    out = []
    for c in range(acc.shape[0] // R):
        cell = acc[c * R:(c + 1) * R]
        extra = {}
        if W:
            cold = cell[:, A:A + W]
            extra["windows"] = WindowedMetrics(
                bounds=np.asarray(bounds, np.float64),
                n_cold=cold,
                n_warm=cell[:, A + W:A + 2 * W] - cold,
                n_arrivals=cell[:, A + 2 * W:A + 3 * W],
                time_running=cell[:, A + 3 * W:A + 4 * W],
                time_idle=cell[:, A + 4 * W:A + 5 * W],
            )
        if reliability:
            extra.update(
                n_timeout=cell[:, RB], n_fail=cell[:, RB + 1],
                n_retry=cell[:, RB + 2], n_abandon=cell[:, RB + 3],
            )
        if faults:
            extra.update(
                n_crash=cell[:, FB], n_evict=cell[:, FB + 1], n_interrupt=cell[:, FB + 2],
            )
        out.append(summary_from_acc(cell, float(measured[c]), **extra))
    return out


def _check_fault_plan(espec, bspec_name: str, fused: bool) -> None:
    """The reference's capability errors of a fault run on this plan."""
    if bspec_name not in espec.faults_backends:
        raise ValueError(
            f"engine {espec.name!r} does not serve platform faults on "
            f"backend {bspec_name!r}; fault-capable backends "
            f"(EngineSpec.faults_backends): {espec.faults_backends or '()'}"
        )
    if fused:
        raise ValueError(
            "draws='fused' does not serve platform faults (the crash "
            "stream is host-staged); use draws='staged'"
        )


# ---------------------------------------------------------------------------
# run(): one scenario, one launch
# ---------------------------------------------------------------------------


def run(
    scenario: Scenario,
    seed: int,
    *,
    replicas: int = 8,
    engine: Optional[str] = None,
    backend: Optional[str] = None,
    device=None,
    execution: Optional[Execution] = None,
    steps: Optional[int] = None,
    staged=None,
    grid=None,
    initial_instances: Sequence = (),
    fused_keys=None,
) -> Result:
    """Run one scenario on an f32 block engine: ``replicas`` rows, one
    launch of the backend (default: the CUDA kernel on the card).

    * ``engine="scan"`` (default) — steady-state scale-per-request, with
      the reliability layer when ``scenario.reliability`` is set.
    * ``engine="temporal"`` — transient analysis from the pool
      ``initial_instances`` (:class:`~repro_torch.core.temporal.
      InstanceSnapshot`), with point-in-time
      curves on ``grid`` (default: 33 points over the horizon) in
      ``Result.temporal``; ``skip_time`` is taken as 0.
    * ``engine="par"`` — concurrency-value platforms
      (``scenario.concurrency_value`` requests per instance); the summary
      is a :class:`~repro_torch.core.par_simulator.ParSimulationSummary`.

    ``seed`` seeds the draw cell's generators; ``staged`` (the ``[replicas,
    K]`` buffers ``dts, warms, colds``, then ``fail_u`` with reliability
    and ``is_first, child_pos`` with retries, as
    :func:`repro_torch.interop.staged_from_reference` builds them)
    replaces the draws, and ``steps`` sets the base K when drawing.  With
    ``execution=Execution(draws="fused")`` the kernel draws ``steps``
    (default ``scenario.steps_needed()``) events from keys derived from
    ``seed``, or from ``fused_keys`` (uint32 ``[replicas, 2]`` per stream).
    """
    plan = plan_of(execution, backend, device, engine=engine)
    bspec, dev = plan.resolve()
    if plan.shard is not None:
        raise ValueError(
            "shard= applies to sweep() (there is no grid axis to split in a "
            "single run)"
        )
    fused = plan.resolved_draws == "fused"
    _check_draw_inputs(fused, staged, fused_keys)
    if plan.engine != "temporal" and (grid is not None or len(initial_instances)):
        raise ValueError("grid= and initial_instances= belong to engine='temporal'")
    scn = Scenario.of(scenario)
    espec = ENGINE_SPECS[plan.engine]
    if scn.active_faults is not None:
        _check_fault_plan(espec, bspec.name, fused)
    if scn.reliability is not None and bspec.name not in espec.reliability_backends:
        raise ValueError(
            f"the {plan.engine} engine serves reliability on the f64 scan "
            "backend only; use backend='scan' (or 'scan_ref', its plain "
            "version); reliability-capable backends "
            f"(EngineSpec.reliability_backends): {espec.reliability_backends}"
        )
    kw = dict(replicas=replicas, steps=steps, staged=staged)
    temporal = None
    if bspec.f64:
        if plan.engine == "temporal":
            summary, temporal = run_temporal64(
                scn, seed, bspec, dev, grid=grid, initial_instances=initial_instances, **kw
            )
        elif plan.engine == "par":
            summary = run_par64(scn, seed, bspec, dev, **kw)
        else:
            summary = run_scan64(scn, seed, bspec, dev, fused=fused, fused_keys=fused_keys,
                                 **kw)
        return Result(scenario=scn, summary=summary,
                      cost=estimate_cost(summary, scn.billing), temporal=temporal)
    _check_block_single(scn, plan.engine)
    if plan.engine == "temporal":
        summary, temporal = run_temporal(
            scn, seed, bspec, dev, grid=grid, initial_instances=initial_instances, **kw
        )
    elif plan.engine == "par":
        summary = run_par(scn, seed, bspec, dev, **kw)
    else:
        summary = _run_scan(scn, seed, bspec, dev, fused=fused, fused_keys=fused_keys, **kw)
    return Result(
        scenario=scn,
        summary=summary,
        cost=estimate_cost(summary, scn.billing),
        temporal=temporal,
    )


def _check_block_single(scn, engine: str) -> None:
    """The reference's refusals of a single run on a block backend: what
    only the f64 engine serves."""
    if engine == "scan" and scn.window_bounds is not None:
        raise ValueError(
            "windowed single runs need backend='scan' (block windowed "
            "grids are available through sweep())"
        )
    if scn.track_histogram:
        raise ValueError("histograms need the f64 scan backend")
    if engine != "par":
        _check_block_routing(scn)


def _check_block_routing(scn) -> None:
    if scn.routing != "newest":
        raise ValueError(
            "block backends implement newest-idle routing only; use "
            f"backend='scan' for routing={scn.routing!r}"
        )


def _check_draw_inputs(fused: bool, staged, fused_keys) -> None:
    """``staged=`` hands in staged buffers, ``fused_keys=`` fused keys."""
    if fused and staged is not None:
        raise ValueError(
            "staged= hands in sample buffers, which fused draws do not read; "
            "hand keys in with fused_keys=, or use draws='staged'"
        )
    if not fused and fused_keys is not None:
        raise ValueError("fused_keys= needs execution=Execution(draws='fused')")


def _run_scan(scn, seed, bspec, dev, *, replicas, steps, staged, fused=False,
              fused_keys=None):
    """The steady-state engine: fresh pools, one launch."""
    rel, flt = scn.reliability, scn.active_faults
    samples, state = (), None
    if fused:
        n = int(steps or scn.steps_needed())
        state = fused_state([scn], seed, replicas, n, dev, fused_keys=fused_keys)
    else:
        samples = run_samples(scn, seed, replicas, steps, staged, dev)
    acc = _block_launch(
        scn, scn.expiration_threshold, scn.sim_time, scn.skip_time, samples, bspec, dev,
        prestamped=scn.prestamped or scn.max_retries > 0,
        t_timeout=None if rel is None else rel.failure.timeout_or_inf,
        p_fail=None if rel is None else rel.failure.p_fail, fused=state,
        faults=fault_inputs(scn, replicas),
    )
    return _cell_summaries(
        acc, replicas, [scn.sim_time - scn.skip_time], reliability=rel is not None,
        faults=flt is not None,
    )[0]


# ---------------------------------------------------------------------------
# sweep(): product grids with static/draw/param partitioning
# ---------------------------------------------------------------------------

# fields that change the launched program: one launch per combination
# (scan_unroll, the reference's compile knob, launches nothing of its own)
_STATIC_FIELDS = (
    "slots",
    "max_concurrency",
    "routing",
    "scan_unroll",
    "track_histogram",
    "hist_bins",
    "window_bounds",
)
# fields that change the per-cell sample draws (one draw cell each);
# expiration_threshold stays a draw field, as in the reference, so cells
# map one to one onto the reference's chained draws; the backoff
# parameters shape the attempt table, so each value is a draw cell
_DRAW_FIELDS = (
    "expiration_threshold",
    "arrival_rate",
    "profile",
    "arrival_process",
    "warm_service_process",
    "cold_service_process",
    "backoff_base",
    "backoff_mult",
    "backoff_jitter",
)
# pure per-row values: cells along these axes share the draw cells' buffers
# (t_timeout and p_fail are per-row comparisons against the shared draws;
# crash_rate scales the shared crash uniforms into lifetimes per row, and
# capacity is a per-row profile: CapacityProfile values sharing a step count)
_PARAM_FIELDS = ("sim_time", "skip_time", "t_timeout", "p_fail", "crash_rate", "capacity")
# axes that need Scenario.reliability (its structure and failure uniforms)
_RELY_AXES = ("t_timeout", "p_fail", "backoff_base", "backoff_mult", "backoff_jitter")
# axes that need Scenario.faults (its structure and the crash stream)
_FAULT_AXES = ("crash_rate", "capacity")


@dataclasses.dataclass
class GridResult:
    """Named-axis product-grid results (one entry per ``over`` axis).

    Every metric array has shape ``tuple(len(v) for v in axes.values())``
    in the ``over`` insertion order; ``summaries`` is an object array of
    per-cell :class:`SimulationSummary` (replicas pooled inside each
    cell); ``ok`` masks cells whose metrics are all finite.  Windowed
    arrays carry a trailing ``W`` axis and are ``None`` when the scenario
    has no ``window_bounds`` (or when ``window_bounds`` itself is swept:
    the per-cell summaries keep their windows either way).
    """

    axes: dict
    replicas: int
    backend: str
    summaries: np.ndarray
    cold_start_prob: np.ndarray
    rejection_prob: np.ndarray
    avg_server_count: np.ndarray
    avg_running_count: np.ndarray
    avg_idle_count: np.ndarray
    wasted_ratio: np.ndarray
    avg_response_time: np.ndarray
    developer_cost: np.ndarray
    provider_cost: np.ndarray
    goodput: Optional[np.ndarray] = None
    availability: Optional[np.ndarray] = None
    ok: Optional[np.ndarray] = None
    execution: Optional[Execution] = None
    window_bounds: Optional[np.ndarray] = None  # [W+1]
    windowed_cold_prob: Optional[np.ndarray] = None  # [*dims, W]
    windowed_arrivals: Optional[np.ndarray] = None  # [*dims, W] replica mean
    windowed_instance_count: Optional[np.ndarray] = None  # [*dims, W]

    _METRIC_FIELDS = (
        "cold_start_prob",
        "rejection_prob",
        "avg_server_count",
        "avg_running_count",
        "avg_idle_count",
        "wasted_ratio",
        "avg_response_time",
        "developer_cost",
        "provider_cost",
        "goodput",
        "availability",
        "ok",
    )
    # windowed grids: a trailing [W] axis that selection leaves untouched
    _WINDOWED_FIELDS = (
        "windowed_cold_prob",
        "windowed_arrivals",
        "windowed_instance_count",
    )

    @property
    def shape(self) -> tuple:
        return tuple(len(v) for v in self.axes.values())

    def axis(self, name: str) -> tuple:
        if name not in self.axes:
            raise KeyError(f"unknown axis {name!r}; axes: {list(self.axes)}")
        return self.axes[name]

    def _index_of(self, name: str, value) -> int:
        vals = list(self.axis(name))
        try:
            return vals.index(value)
        except ValueError:
            raise KeyError(
                f"{value!r} is not on axis {name!r}; values: {vals}"
            ) from None

    def cell(self, **coords):
        """The per-cell summary at axis *values* (e.g. ``sim_time=500.0``)."""
        for name in self.axes:
            if name not in coords:
                raise KeyError(f"missing coordinate {name!r}")
        idx = tuple(self._index_of(n, coords[n]) for n in self.axes)
        return self.summaries[idx]

    def sel(self, **coords) -> "GridResult":
        """Pin axes by value and drop them from the result; selecting every
        axis leaves scalar metrics (and the bare per-cell summary)."""
        picked = {n: self._index_of(n, v) for n, v in coords.items()}
        indexer = tuple(picked.get(n, slice(None)) for n in self.axes)

        def take(a):
            return None if a is None else np.asarray(a)[indexer]

        return dataclasses.replace(
            self,
            axes={n: v for n, v in self.axes.items() if n not in picked},
            summaries=self.summaries[indexer],
            **{f: take(getattr(self, f)) for f in self._METRIC_FIELDS + self._WINDOWED_FIELDS},
        )

    def to_dict(self) -> dict:
        """JSON-able export: axes (non-scalar values stringified), every
        metric grid including ``ok`` and the windowed grids when present,
        and the resolved device and draw mode (with the shard spec and
        devices of a sharded sweep)."""
        jsonable = lambda x: x if isinstance(x, (int, float, str, bool)) else repr(x)
        out = {
            "axes": {n: [jsonable(x) for x in v] for n, v in self.axes.items()},
            "replicas": self.replicas,
            "backend": self.backend,
        }
        if self.execution is not None:
            out["device"] = str(self.execution.device)
            out["draws"] = self.execution.resolved_draws
            if self.execution.shard is not None:
                out["shard"] = self.execution.shard
                out["devices"] = [str(d) for d in self.execution.devices]
        for f in self._METRIC_FIELDS + self._WINDOWED_FIELDS:
            a = getattr(self, f)
            if a is not None:
                out[f] = np.asarray(a).tolist()
        if self.window_bounds is not None:
            out["window_bounds"] = np.asarray(self.window_bounds).tolist()
        return out


def _apply_axis(scn: Scenario, name: str, value) -> Scenario:
    """One scenario-field override, with the workload conveniences."""
    if name == "profile":
        if not isinstance(value, RateProfile):
            raise TypeError(f"expected RateProfile, got {type(value).__name__}")
        return Scenario.of(scn, arrival_process=NHPPArrivalProcess(profile=value),
                           rate_profile=None, arrival_rate=None)
    if name == "arrival_process":
        if not isinstance(value, SimProcess):
            raise TypeError(f"expected SimProcess, got {type(value).__name__}")
        return Scenario.of(scn, arrival_process=value, rate_profile=None, arrival_rate=None)
    if name == "arrival_rate":
        return Scenario.of(scn, arrival_rate=float(value))
    if name in ("backoff_base", "backoff_mult", "backoff_jitter"):
        retry = dataclasses.replace(scn.reliability.retry, **{name: float(value)})
        return Scenario.of(
            scn, reliability=dataclasses.replace(scn.reliability, retry=retry)
        )
    return Scenario.of(scn, **{name: value})


@dataclasses.dataclass
class SweepInputs:
    """What :func:`sweep` launches for one grid: the per-row parameters
    (host f64, rows in ``(draw, param, replica)`` order) and the staged f32
    ``[C, K]`` buffers on the device (``dts, warms, colds``, then
    ``fail_u`` with reliability and ``is_first, child_pos`` with retries,
    whose K is the attempt table's), or with fused draws no buffers and
    the :func:`fused_state` dict."""

    names: list
    vals: dict
    thr_rows: np.ndarray
    sim_rows: np.ndarray
    skip_rows: np.ndarray
    samples: tuple
    t_timeout_rows: Optional[np.ndarray] = None
    p_fail_rows: Optional[np.ndarray] = None
    prestamped: bool = False
    fused: Optional[dict] = None
    fault_rows: Optional[dict] = None


def _check_axes(base: Scenario, over: Mapping[str, Sequence]) -> tuple:
    """The axis names and value tuples, validated as the reference does."""
    names = list(over.keys())
    if not names:
        raise ValueError("over must name at least one axis to sweep")
    vals = {}
    for n in names:
        if n not in _STATIC_FIELDS + _DRAW_FIELDS + _PARAM_FIELDS:
            raise ValueError(
                f"unknown sweep axis {n!r}; sweepable fields: "
                f"{_STATIC_FIELDS + _DRAW_FIELDS + _PARAM_FIELDS}"
            )
        vals[n] = tuple(over[n])
        if not vals[n]:
            raise ValueError(f"sweep axis {n!r} is empty")
    rely_axes = [n for n in names if n in _RELY_AXES]
    if rely_axes and base.reliability is None:
        raise ValueError(
            f"sweeping {rely_axes} needs Scenario.reliability= to be set "
            "on the base scenario (it provides the static reliability "
            "structure and the failure uniforms)"
        )
    for v in vals.get("t_timeout", ()):
        if not float(v) > 0:
            raise ValueError(f"t_timeout values must be > 0, got {v}")
    for v in vals.get("p_fail", ()):
        if not 0.0 <= float(v) < 1.0:
            raise ValueError(f"p_fail values must be in [0, 1), got {v}")
    fault_axes = [n for n in names if n in _FAULT_AXES]
    if fault_axes and base.faults is None:
        raise ValueError(
            f"sweeping {fault_axes} needs Scenario.faults= to be set on "
            "the base scenario (it provides the static fault structure "
            "and the crash stream)"
        )
    for v in vals.get("crash_rate", ()):
        if not np.isfinite(float(v)) or float(v) < 0:
            raise ValueError(f"crash_rate values must be finite and >= 0, got {v}")
    caps = vals.get("capacity", ())
    for v in caps:
        if not isinstance(v, CapacityProfile):
            raise TypeError(
                f"capacity axis values must be CapacityProfile, got {type(v).__name__}"
            )
    if caps and len({len(v.values) for v in caps}) > 1:
        raise ValueError(
            "capacity profiles on one sweep axis must share a step count "
            "(one launch takes one [C, len(values)] ceiling matrix); split the sweep"
        )
    return names, vals


def fault_plan(base: Scenario, names) -> tuple:
    """``(crashes, capped)``: whether a sweep over ``names`` runs the crash
    path (the base has a crash rate, or ``crash_rate`` is swept) and the
    capacity path."""
    flt = base.faults
    crashes = flt is not None and (flt.crashes or "crash_rate" in names)
    capped = flt is not None and (flt.capacity is not None or "capacity" in names)
    return crashes, capped


def sweep_inputs(
    base: Scenario,
    over: Mapping[str, Sequence],
    seed: int,
    *,
    replicas: int,
    device,
    steps: Optional[int] = None,
    staged=None,
    draws: str = "staged",
    fused_keys=None,
    f64: bool = False,
) -> SweepInputs:
    """Partition the axes, build the per-row parameters and stage the
    samples (or, with ``draws="fused"``, the keys and parameters) —
    everything :func:`sweep` does before its launches.  ``f64`` stages the
    f64 engine's buffers (:func:`~repro_torch.core.simulator.staged_dtypes`)."""
    names, vals = _check_axes(base, over)
    draw_names = [n for n in names if n in _DRAW_FIELDS]
    param_names = [n for n in names if n in _PARAM_FIELDS]

    draw_cfgs = []
    for combo in itertools.product(*[vals[n] for n in draw_names]):
        c = base
        for n, v in zip(draw_names, combo):
            c = _apply_axis(c, n, v)
        draw_cfgs.append(c)
    # an arrival_process or profile axis can make the draw cells differ from
    # the base: the cells decide whether the launch runs prestamped
    stamped = {c.prestamped for c in draw_cfgs}
    if len(stamped) > 1:
        raise ValueError(
            "cannot mix stationary and timestamp arrival processes in one "
            "grid; split the sweep"
        )
    prestamped = stamped.pop()

    sim_vals = vals.get("sim_time", (base.sim_time,))
    skip_vals = vals.get("skip_time", (base.skip_time,))
    if max(skip_vals) >= min(sim_vals):
        raise ValueError("every skip_time must be < every sim_time on the grid")
    max_sim = float(max(sim_vals))

    R = int(replicas)
    D = len(draw_cfgs)
    rel = base.reliability
    crashes, capped = fault_plan(base, names)
    width = staged_widths(base, crashes)
    dtypes = staged_dtypes(base, crashes, f64)
    param_cells = int(np.prod([len(vals[n]) for n in param_names]))
    n_steps = (
        int(steps)
        if steps is not None
        else max(Scenario.of(c, sim_time=max_sim).steps_needed() for c in draw_cfgs)
    )
    fused = None
    if draws == "fused":
        fused = fused_state(draw_cfgs, seed, R, n_steps, device, param_cells=param_cells,
                            fused_keys=fused_keys, f64=f64)
        # fused streams are gaps (NHPP thinning is inline)
        prestamped = False
        bufs = ()
    elif staged is not None:
        bufs = check_staged(staged, D * R, device, width, crashes, dtypes)
    else:
        K = n_steps * (base.max_retries + 1)
        bufs = tuple(torch.empty((D * R, K), dtype=d, device=device) for d in dtypes)
        streams = FAULT_STREAMS if crashes else 3 if rel is None else RELY_STREAMS
        for d, (c, gens) in enumerate(zip(draw_cfgs, cell_generators(seed, D, device, streams))):
            part = tuple(x[d * R:(d + 1) * R] for x in bufs)
            # each cell's timestamps (and a retry table's gaps) are guarded
            # against the grid's largest horizon
            c_sim = Scenario.of(c, sim_time=max_sim)
            if rel is None:
                draw_workload_samples(c_sim, gens[:3], R, n_steps, device, out=part[:3])
            else:
                draw_reliability_stream(c_sim, gens[:RELY_STREAMS], R, n_steps, device,
                                        out=part[:width - int(crashes)])
            if crashes:
                # positional per event, shared by the draw cell's param cells
                draw_crash_uniforms(gens[CRASH_STREAM], R, K, device, out=part[-1])

    param_combos = list(itertools.product(*[vals[n] for n in param_names]))
    Wn = len(param_combos)

    def _param_col(name, default):
        if name in param_names:
            i = param_names.index(name)
            col = np.asarray([pc[i] for pc in param_combos], np.float64)
        else:
            col = np.full((Wn,), default, np.float64)
        return np.tile(np.repeat(col, R), D)  # [C]

    def _expand(x):
        # param cells share their draw cell's buffers: [D*R, K] -> [D*Wn*R, K]
        if Wn == 1:
            return x
        k = x.shape[1]
        return x.reshape(D, 1, R, k).expand(D, Wn, R, k).reshape(D * Wn * R, k)

    fault_rows = None
    if crashes or capped:
        flt = base.faults
        if "capacity" in param_names:
            i = param_names.index("capacity")
            profs = [pc[i] for pc in param_combos]
        else:
            profs = [flt.capacity] * Wn
        # [Wn] -> [C] in the (draw, param, replica) row order
        fault_rows = fault_rows_of(
            crashes, _param_col("crash_rate", flt.crash_rate),
            [p for _ in range(D) for p in profs for _ in range(R)] if capped else None,
        )
    return SweepInputs(
        names=names,
        vals=vals,
        thr_rows=np.repeat(
            np.asarray([c.expiration_threshold for c in draw_cfgs], np.float64),
            Wn * R,
        ),
        sim_rows=_param_col("sim_time", base.sim_time),
        skip_rows=_param_col("skip_time", base.skip_time),
        samples=tuple(_expand(x) for x in bufs),
        t_timeout_rows=None if rel is None else _param_col("t_timeout", rel.failure.timeout_or_inf),
        p_fail_rows=None if rel is None else _param_col("p_fail", rel.failure.p_fail),
        prestamped=prestamped or base.max_retries > 0,
        fused=fused,
        fault_rows=fault_rows,
    )


def sweep(
    scenario: Scenario,
    over: Mapping[str, Sequence],
    seed: int,
    *,
    replicas: int = 4,
    backend: Optional[str] = None,
    device=None,
    execution: Optional[Execution] = None,
    steps: Optional[int] = None,
    staged=None,
    fused_keys=None,
    deferred: bool = False,
):
    """Product-grid what-if sweep over scenario fields (module docstring
    has the partitioning rules): one launch per static combination.

    ``seed`` seeds the per-draw-cell generators; ``staged`` (the
    ``[D*replicas, K]`` buffers ``dts, warms, colds``, then ``fail_u``
    with reliability and ``is_first, child_pos`` with retries, draw cells
    in ``over``'s product order) replaces the draws, and ``steps`` sets
    the base K when drawing.  With ``execution=Execution(draws="fused")``
    the kernel draws every sample from per-row keys (``fused_keys``, uint32
    ``[D*replicas, 2]`` per stream, replaces the keys of ``seed``); the
    result's ``execution.draws`` says which mode ran.

    ``deferred=True`` (the f64 scan backends only) stages and launches
    every static combination and returns a :class:`PendingSweep` without
    reading the device: the coverage guards' reads, the copies to the host,
    the pool-overflow guard and the grid's assembly wait for its
    ``result()``, which is bit for bit the ``deferred=False`` grid (the
    same kernel on the same operands).  The online what-if service uses it
    to overlap a tick's launch with the ingestion of the next batch.

    ``execution=Execution(devices=..., shard="grid")`` splits each launch's
    rows into one contiguous span per device (a device named twice takes
    two): the first device stages every draw, as an unsharded sweep does,
    each span's rows are placed on its device, every span is launched
    before any is read, and the spans' accumulators are joined in row
    order, so each cell is bit for bit the unsharded grid's.  On the block
    backends a sharded sweep refuses reliability and faults, as the
    reference's does.
    """
    plan = plan_of(execution, backend, device)
    if plan.engine != "scan":
        raise ValueError(
            f"engine {plan.engine!r} does not support sweep(); it runs "
            "single scenarios only (use run(), or engine='scan' for grids)"
        )
    bspec, dev = plan.resolve()
    if deferred and not bspec.f64:
        raise ValueError(
            "deferred=True needs an f64 scan backend ('scan', or 'scan_ref' on "
            "the CPU): the block backends read their results back inside the "
            f"launcher; got backend={bspec.name!r}"
        )
    devices = plan.resolved_devices() if plan.shard else None
    plan = dataclasses.replace(plan, backend=bspec.name, device=str(dev),
                               draws=plan.resolved_draws, devices=devices)
    _check_draw_inputs(plan.draws == "fused", staged, fused_keys)
    base = Scenario.of(scenario)
    espec = ENGINE_SPECS[plan.engine]
    if devices and not bspec.f64:
        if base.reliability is not None:
            raise ValueError(
                "reliability sweeps on block backends are single-device; drop "
                "shard='grid' or use backend='scan'"
            )
        if any(fault_plan(base, over)):
            raise ValueError(
                "fault sweeps on block backends are single-device; drop "
                "shard='grid' or use backend='scan'"
            )
    if base.reliability is not None and bspec.name not in espec.reliability_backends:
        raise ValueError(
            f"backend {bspec.name!r} does not serve reliability on engine "
            f"{plan.engine!r}; reliability_backends: {espec.reliability_backends}"
        )
    windowed = base.window_bounds is not None or "window_bounds" in over
    if windowed and bspec.name not in espec.windowed_backends:
        raise ValueError(
            f"backend {bspec.name!r} does not serve metric windows on engine "
            f"{plan.engine!r}; windowed_backends: {espec.windowed_backends}"
        )
    if any(fault_plan(base, over)):
        _check_fault_plan(espec, bspec.name, plan.draws == "fused")
        if windowed:
            raise ValueError(
                "platform faults do not serve windowed metrics yet; drop "
                "window_bounds or the fault axes"
            )
        if base.track_histogram or "track_histogram" in over:
            raise ValueError(
                "platform faults do not serve the instance-count "
                "histogram; drop track_histogram or the fault axes"
            )
    scan64 = bspec.f64
    with deferred_guards() as guards:
        inp = sweep_inputs(
            base, over, seed, replicas=replicas, device=dev, steps=steps, staged=staged,
            draws=plan.draws, fused_keys=fused_keys, f64=scan64,
        )
        samples = inp.samples
        if base.max_retries > 0:
            if staged is not None:  # drawn tables were guarded on their gaps
                check_table_covered(samples[0], samples[4], inp.sim_rows, dev)
        elif inp.fused is None and not inp.prestamped:
            # fused launches are guarded on their final clock, timestamp
            # streams on their process's coverage when drawn
            check_covered(samples[0], inp.sim_rows, dev)
    names, vals, R = inp.names, inp.vals, int(replicas)
    static_names = [n for n in names if n in _STATIC_FIELDS]
    if not deferred:
        for read in guards:
            read()

    # ---- one launch per static combination; each gives a collector of
    # its cells, which the f64 engine reads back only when the grid is
    # assembled (a block launch has read its cells already)
    combos: list = []
    launched: dict = {}
    for idx in itertools.product(*[range(len(vals[n])) for n in static_names]):
        scn_s = base
        for n, i in zip(static_names, idx):
            scn_s = _apply_axis(scn_s, n, vals[n][i])
        wb = scn_s.window_bounds
        window_rows = None if wb is None else np.tile(wb, (len(inp.thr_rows), 1))
        measured = (inp.sim_rows - inp.skip_rows)[::R]
        # scan_unroll changes only the reference's compile: the values of
        # that axis share one launch's cells
        key = tuple(i for n, i in zip(static_names, idx) if n != "scan_unroll")
        if key not in launched:
            if scan64:
                launched[key] = _scan_sweep_cells(scn_s, inp, samples, bspec, dev, R,
                                                  window_rows, measured, devices)
            else:
                if scn_s.track_histogram:
                    raise ValueError("histograms need the f64 scan backend")
                _check_block_routing(scn_s)
                acc = _block_launch(
                    scn_s, inp.thr_rows, inp.sim_rows, inp.skip_rows, samples, bspec, dev,
                    prestamped=inp.prestamped, window_rows=window_rows,
                    t_timeout=inp.t_timeout_rows, p_fail=inp.p_fail_rows, fused=inp.fused,
                    faults=inp.fault_rows, devices=devices,
                )
                cells = _cell_summaries(acc, R, measured, bounds=wb,
                                        reliability=base.reliability is not None,
                                        faults=inp.fault_rows is not None)
                launched[key] = lambda cells=cells: cells
        combos.append((wb, launched[key]))
    # the grid's assembly keeps the axes, not the staged buffers
    del samples
    inp = dataclasses.replace(inp, samples=(), fused=None)
    finish = functools.partial(_assemble_grid, base, inp, combos, guards if deferred else (),
                               plan, bspec.name, R)
    if deferred:
        return PendingSweep(finish, devices or (dev,))
    return finish()


class PendingSweep:
    """A launched, not yet read :func:`sweep` (``deferred=True``).

    :meth:`result` runs the staging's coverage guards, copies the
    launches' outputs to the host (each shard's on the CUDA stream of its
    device that launched it), runs the reference's guards (short stream,
    pool overflow) and assembles the :class:`GridResult`, bit for bit the
    synchronous sweep's.  It memoises: a second call returns the same grid,
    and the device tensors are dropped after the first.
    """

    def __init__(self, finish, devices):
        self._finish = finish
        self._result: Optional[GridResult] = None
        # the current stream of each CUDA device the launches went to
        cuda = [torch.device(d) for d in devices if torch.device(d).type == "cuda"]
        self._streams = tuple({torch.cuda.current_stream(d).cuda_stream:
                               torch.cuda.current_stream(d) for d in cuda}.values())

    def result(self) -> GridResult:
        if self._result is None:
            with contextlib.ExitStack() as on_streams:
                for stream in self._streams:
                    on_streams.enter_context(torch.cuda.stream(stream))
                self._result = self._finish()
            self._finish = None  # drop the captured device tensors
        return self._result


def _assemble_grid(base, inp: SweepInputs, combos, guards, plan, backend: str,
                   R: int) -> GridResult:
    """The named-axis :class:`GridResult` of a sweep's launches: ``combos``
    holds each static combination's window bounds and cell collector, in
    the static axes' product order; ``guards`` are the coverage guards'
    deferred reads, run first."""
    for read in guards:
        read()
    names, vals = inp.names, inp.vals
    static_names = [n for n in names if n in _STATIC_FIELDS]
    draw_names = [n for n in names if n in _DRAW_FIELDS]
    param_names = [n for n in names if n in _PARAM_FIELDS]
    all_summaries: list = []
    win_parts = []
    for wb, collect in combos:
        cells = collect()
        all_summaries.extend(cells)
        if wb is not None:
            win_parts.append(np.stack([
                np.stack([
                    c.windows.cold_start_prob,
                    c.windows.n_arrivals.mean(axis=0),
                    c.windows.avg_instance_count,
                ])
                for c in cells
            ]))  # [cells, 3, W]

    # ---- named-axis grid (internal order: static, draw, param)
    internal_names = static_names + draw_names + param_names
    internal_dims = tuple(len(vals[n]) for n in internal_names)
    perm = [internal_names.index(n) for n in names]

    def _grid(values, trailing=0):
        values = np.asarray(values)
        arr = values.reshape(internal_dims + values.shape[values.ndim - trailing:])
        return np.transpose(arr, perm + list(range(len(perm), arr.ndim)))

    costs = [estimate_cost(s, base.billing) for s in all_summaries]
    metric = lambda f: _grid(np.asarray([f(s) for s in all_summaries], np.float64))
    summaries_grid = np.empty((len(all_summaries),), dtype=object)
    summaries_grid[:] = all_summaries
    metrics = dict(
        cold_start_prob=metric(lambda s: s.cold_start_prob),
        rejection_prob=metric(lambda s: s.rejection_prob),
        avg_server_count=metric(lambda s: s.avg_server_count),
        avg_running_count=metric(lambda s: s.avg_running_count),
        avg_idle_count=metric(lambda s: s.avg_idle_count),
        wasted_ratio=metric(lambda s: s.avg_wasted_ratio),
        avg_response_time=metric(lambda s: s.avg_response_time),
        developer_cost=_grid(np.asarray([c.developer_total for c in costs])),
        provider_cost=_grid(np.asarray([c.provider_infra_cost for c in costs])),
        goodput=metric(lambda s: s.goodput),
        availability=metric(lambda s: s.availability),
    )
    ok = np.ones(metrics["cold_start_prob"].shape, bool)
    for m in metrics.values():
        ok &= np.isfinite(m)
    if not ok.all():
        _warn_nonfinite(vals, ok)
    windows = {}
    # one shared window grid stacks into [*dims, W]; a swept window_bounds
    # axis gives per-combination W's that cannot (the summaries keep them)
    if base.window_bounds is not None and "window_bounds" not in static_names:
        stack = np.concatenate(win_parts)  # [cells, 3, W]
        windows = dict(
            window_bounds=np.asarray(base.window_bounds),
            windowed_cold_prob=_grid(stack[:, 0], trailing=1),
            windowed_arrivals=_grid(stack[:, 1], trailing=1),
            windowed_instance_count=_grid(stack[:, 2], trailing=1),
        )
    return GridResult(
        axes={n: vals[n] for n in names},
        replicas=R,
        backend=backend,
        execution=plan,
        summaries=_grid(summaries_grid),
        **metrics,
        ok=ok,
        **windows,
    )


def _scan_sweep_cells(scn_s, inp: SweepInputs, samples, bspec, dev, R: int, window_rows,
                      measured, devices=None):
    """One f64 engine launch of a sweep's static combination, or with
    ``devices`` one launch a device on its span of the rows (as
    :func:`_block_launch` splits them: every span's inputs placed, then
    every span launched); returns the collector that reads the launches
    back, joins them in row order and gives the per-cell summaries after
    the reference's guards."""
    devices = devices or (dev,)
    shards = []
    for (lo, hi), d in zip(shard_spans(len(inp.thr_rows), len(devices)), devices):
        on = functools.partial(_rows_on, lo=lo, hi=hi, device=d)
        faults = inp.fault_rows and {k: on(v) for k, v in inp.fault_rows.items()}
        shards.append((d, tuple(on(x) for x in samples), dict(
            t_exp=on(inp.thr_rows), t_end=on(inp.sim_rows), skip=on(inp.skip_rows),
            prestamped=inp.prestamped, window_rows=on(window_rows),
            t_timeout=on(inp.t_timeout_rows), p_fail=on(inp.p_fail_rows), faults=faults,
            fused=inp.fused,
        )))
    # the window-bound checks read the device: deferred to the collector
    with deferred_guards() as checks:
        outs = []
        for d, part, kw in shards:
            with launching_on(d):
                outs.append(scan_launch(scn_s, bspec, d, part, **kw))
    # the collector holds the accumulators and the clocks, not the staging
    parts = [(out.acc, out.t) for out in outs]
    prestamped, sim_rows = inp.prestamped, inp.sim_rows
    faults = inp.fault_rows is not None
    del shards, outs

    def collect() -> list:
        for read in checks:
            read()
        acc = np.concatenate([a.cpu().numpy() for a, _ in parts])
        t_last = np.concatenate([t.cpu().numpy() for _, t in parts])
        if not prestamped and (t_last < sim_rows).any():
            raise RuntimeError(
                "pre-drawn arrivals ended before sim_time "
                f"(min final t {t_last.min():.1f}); pass a larger `steps`"
            )
        if acc[:, 9].sum() > 0:
            raise RuntimeError("instance-pool overflow during sweep; raise Scenario.slots")
        wb = scn_s.window_bounds
        layout = ScanLayout(
            W=0 if wb is None else len(wb) - 1,
            H=scn_s.hist_bins if scn_s.track_histogram else 0,
            rely=scn_s.reliability is not None, faults=faults,
        )
        return scan_cell_summaries(acc, R, measured, layout, bounds=wb,
                                   histogram=scn_s.track_histogram, faults=faults)

    return collect


def _warn_nonfinite(axes: dict, ok: np.ndarray) -> None:
    """Name the grid cells whose metrics came back non-finite."""
    bad = np.argwhere(~ok)
    names = list(axes)
    cells = [
        "(" + ", ".join(f"{n}={axes[n][i]!r}" for n, i in zip(names, idx)) + ")"
        for idx in bad[:8]
    ]
    more = "" if len(bad) <= 8 else f" (+{len(bad) - 8} more)"
    warnings.warn(
        f"sweep produced non-finite metrics in {len(bad)} cell(s): "
        + ", ".join(cells) + more + "; see GridResult.ok",
        RuntimeWarning,
        stacklevel=3,
    )
