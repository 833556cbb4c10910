"""Online what-if service: the live control loop of the port.

The rest of the package is offline: fit a profile once, sweep once, read
the grid.  This module closes the loop the paper's provider-facing pitch
implies: ingest a *live* arrival stream, keep a rolling-window rate
estimate blended by an EMA, re-fit a :class:`PiecewiseConstantRate` each
tick, re-sweep the keep-alive threshold grid (one launch of the f64 pool
scan, ``kernels/csrc/scan_event_step.cu``, on the card) and emit a
:class:`Recommendation` through the :class:`ThresholdGovernor` hysteresis
of :mod:`repro_torch.serving.autoscale`.  It is the reference's
``repro/serving/online.py``, decision for decision.

A tick must pay nothing again after warm-up.  Every shape that reaches the
launch is pinned at construction:

* the profile's bin count (``OnlineConfig.n_bins``: ``fit``'s ``n_bins=``
  keeps the re-fit's shape while only the rates move),
* the candidate-stream width (``steps``, sized once from the
  ``rate_ceiling`` envelope: NHPP thinning draws candidates at the
  profile's ``max_rate``, so a buffer that covers the horizon at the
  ceiling covers it for every estimate the clamp can give),
* the threshold grid and the replica count.

``TRACE_COUNTS["online_tick"]`` (:mod:`repro_torch.core.scenario`) adds up
what each tick's dispatch made the process pay again: kernel libraries
built or loaded (``kernels._build.LOAD_COUNTS``) and CUDA allocator
segments newly reserved (:func:`trace_total`).  After warm-up (the first
ticks, while the allocator's pool grows to hold a pending tick beside the
one being staged) the delta is 0.

Ticks overlap the simulation with the ingestion: ``sweep(deferred=True)``
launches tick *t* on the current CUDA stream and returns at once; the
service then reads tick *t-1*'s grid back while the card runs *t*.  A
deferred launch runs the same kernel on the same operands as a synchronous
one, so a tick's recommendation is bit for bit the offline
:func:`~repro_torch.core.scenario.sweep` on the same fitted profile and
seed (:meth:`OnlineWhatIfService.offline_equivalent`).

Random streams: where the reference splits a ``jax.random`` key per tick,
the service spawns one child of ``numpy.random.SeedSequence(config.seed)``
per tick and hands its integer seed (:func:`~repro_torch.serving.autoscale.
child_seed`) to ``sweep``; ``Recommendation.seed`` records it, and
:meth:`OnlineWhatIfService.checkpoint` stores the number of children
spawned (the port's own checkpoint format, version 1).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.execution import Execution, plan_of
from repro_torch.core.processes import (
    ArrivalTimeProcess,
    NHPPArrivalProcess,
    PiecewiseConstantRate,
    RateProfile,
    TraceArrivalProcess,
)
from repro_torch.core.scenario import TRACE_COUNTS, Scenario
from repro_torch.core.scenario import sweep as scenario_sweep
from repro_torch.kernels import _build
from repro_torch.serving.autoscale import (
    PlanResult,
    ThresholdGovernor,
    child_seed,
    select_threshold,
)

CHECKPOINT_VERSION = 1


def trace_total() -> int:
    """What a call can make the process pay again, as one count: kernel
    libraries built or loaded, plus the CUDA caching allocator's segments
    reserved so far on every visible card (0 before CUDA is initialised and
    on the CPU)."""
    total = sum(_build.LOAD_COUNTS.values())
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for d in range(torch.cuda.device_count()):
            total += int(torch.cuda.memory_stats(d).get("segment.all.allocated", 0))
    return total


def replay_arrivals(source, t_end: float, seed: Optional[int] = None) -> np.ndarray:
    """Arrival timestamps on ``[0, t_end)`` from a recorded trace, a
    :class:`RateProfile` or a timestamp arrival process: the replay feed for
    :meth:`OnlineWhatIfService.observe`.

    Traces replay exactly; profiles are lowered to NHPP and drawn on the
    host from a ``torch.Generator`` seeded with ``seed`` (required), the
    candidate buffer doubled and redrawn until the thinned stream covers
    the horizon.
    """
    if not t_end > 0:
        raise ValueError(f"t_end must be > 0, got {t_end}")
    if isinstance(source, TraceArrivalProcess):
        ts = np.asarray(source.timestamps, np.float64)
        return ts[ts < t_end]
    if isinstance(source, RateProfile):
        source = NHPPArrivalProcess(profile=source)
    if not isinstance(source, ArrivalTimeProcess):
        raise TypeError(
            "replay_arrivals needs a TraceArrivalProcess, RateProfile, or "
            f"timestamp arrival process; got {type(source).__name__}"
        )
    if seed is None:
        raise ValueError(
            "replaying a stochastic arrival process needs seed= (traces "
            "replay exactly and don't)"
        )
    lam = 1.0 / source.mean()  # the candidate envelope rate
    n = t_end * lam
    steps = int(n + 6.0 * np.sqrt(max(n, 1.0)) + 16)
    while True:
        gen = torch.Generator().manual_seed(int(seed))
        times, coverage = source.arrival_times(gen, (1, steps), "cpu")
        if float(coverage[0]) >= t_end:
            break
        steps *= 2  # an unlucky gap draw: widen and redraw
    ts = times[0].numpy().astype(np.float64)
    return ts[ts < t_end]


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    """Knobs of the online services.

    ``rate_ceiling`` is the envelope the estimate is clamped to *and* what
    sizes the pinned candidate buffer: it must bound any plausible peak
    arrival rate (headroom costs only simulated steps; undershooting clips
    the estimate).  ``device`` is the port's shorthand for the sweeps'
    device (``None``: the card; ``"cpu"``: the plain versions), as
    ``sweep(device=)`` takes it.
    """

    rate_ceiling: float
    cold_slo: float = 0.1
    thresholds: Tuple[float, ...] = (30.0, 60.0, 120.0, 300.0, 600.0, 1200.0)
    bin_width: float = 60.0  # profile bin width (stream seconds)
    n_bins: int = 16  # pinned bin count; rolling window = n_bins * bin_width
    ema_alpha: float = 0.3  # EMA weight of the newest window estimate
    rate_floor: float = 1e-9  # empty-bin / idle-function clamp
    sim_time: Optional[float] = None  # what-if horizon; None = window span
    skip_time: float = 0.0
    replicas: int = 4
    seed: int = 0
    execution: Optional[Execution] = None
    overlap: bool = True  # deferred ticks (the f64 scan backends)
    patience: int = 2  # governor: consecutive ticks before switching
    deadband: float = 0.0  # governor: relative no-op band
    capacity: Optional[float] = None  # headroom base; None = Scenario.slots
    device: Optional[str] = None

    def __post_init__(self):
        if not self.rate_ceiling > 0:
            raise ValueError(f"rate_ceiling must be > 0, got {self.rate_ceiling}")
        if not self.thresholds:
            raise ValueError("thresholds must name at least one candidate")
        if not self.bin_width > 0:
            raise ValueError(f"bin_width must be > 0, got {self.bin_width}")
        if self.n_bins < 1:
            raise ValueError(f"n_bins must be >= 1, got {self.n_bins}")
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError(f"ema_alpha must be in (0, 1], got {self.ema_alpha}")
        if not self.rate_floor > 0:
            raise ValueError(f"rate_floor must be > 0, got {self.rate_floor}")

    @property
    def span(self) -> float:
        return self.n_bins * self.bin_width

    @property
    def horizon(self) -> float:
        return float(self.sim_time) if self.sim_time is not None else self.span


@dataclasses.dataclass(frozen=True)
class Recommendation:
    """One tick's output: the keep-alive advice and its evidence."""

    tick: int
    t_now: float  # stream time the estimate was fitted at
    threshold: float  # raw grid choice this tick
    applied_threshold: float  # after ThresholdGovernor hysteresis
    predicted_cold_prob: float
    predicted_cost: float  # developer cost at the chosen threshold
    predicted_goodput: float
    predicted_avg_replicas: float
    headroom: float  # capacity - predicted avg replicas
    rate_mean: float  # time-averaged EMA rate estimate
    profile: PiecewiseConstantRate  # the fitted and blended profile swept
    seed: int  # the sweep's seed (the offline reproduction handle)
    grid: "object"  # the GridResult the choice was read from
    # a tick whose sweep came back non-finite or whose ingest stalled
    # re-issues the last good advice instead of acting on it, and says so
    degraded: bool = False
    degraded_reason: Optional[str] = None


def _check_config(config) -> None:
    if not isinstance(config, OnlineConfig):
        raise TypeError(f"config must be an OnlineConfig, got {type(config).__name__}")
    if not config.skip_time < config.horizon:
        raise ValueError(
            f"skip_time {config.skip_time} must be < horizon {config.horizon}"
        )


class OnlineWhatIfService:
    """Live keep-alive tuner for one function (module docstring).

    ``base`` supplies the service processes and platform fields; its
    arrival side is replaced each tick by the live estimate.  Push
    timestamps with :meth:`observe` (batches, ascending stream time), then
    call :meth:`tick` at the re-plan cadence.  With ``overlap`` (default)
    on an f64 scan backend, ``tick`` returns the *previous* tick's
    recommendation (the current one is still on the card), and
    :meth:`flush` drains the last pending tick.
    """

    def __init__(self, base: Scenario, config: OnlineConfig):
        _check_config(config)
        self.config = config
        self._edges = tuple(float(e) for e in np.arange(1, config.n_bins) * config.bin_width)
        # the tick scenario template: the what-if horizon pinned, the
        # arrival side swapped each tick
        ceiling = PiecewiseConstantRate(
            edges=self._edges, rates=(config.rate_ceiling,) * config.n_bins
        )
        self._base = Scenario.of(
            base, arrival_process=NHPPArrivalProcess(profile=ceiling), rate_profile=None,
            arrival_rate=None, sim_time=config.horizon, skip_time=config.skip_time,
        )
        # the candidate width at the ceiling covers any clamped estimate
        self._steps = self._base.steps_needed()
        plan = plan_of(config.execution, None, config.device)
        bspec, self._device = plan.resolve()
        self._deferred = config.overlap and bspec.f64
        self._buf = np.empty((0,), np.float64)
        self._now = 0.0
        self._ema: Optional[np.ndarray] = None
        self._ticks = 0
        self._seeds = np.random.SeedSequence(int(config.seed))
        self._pending = None  # (PendingSweep or GridResult, tick metadata)
        self._seen = False  # any timestamp ever observed
        self._warned_unsorted = False  # the one-time out-of-order warning
        self._last_tick_now = None  # the stream clock at the previous tick
        self.governor = ThresholdGovernor(patience=config.patience, deadband=config.deadband)
        self.history: List[Recommendation] = []
        cap = config.capacity
        self._capacity = float(cap) if cap is not None else float(base.slots)

    # ---- ingestion ------------------------------------------------------

    def observe(self, timestamps) -> None:
        """Push a batch of arrival timestamps (stream time).

        Out-of-order stamps *within* a batch are tolerated: the batch is
        sorted, with a one-time warning (collectors deliver near-sorted
        feeds; re-sorting silently forever would hide a broken one).
        NaN or infinite stamps, negative stamps and duplicates (within the
        batch or replaying the stream head) are refused: each means the
        feed is corrupt, not merely jittered.
        """
        ts = np.asarray(timestamps, np.float64).ravel()
        if len(ts) == 0:
            return
        if not np.isfinite(ts).all():
            bad = int(np.flatnonzero(~np.isfinite(ts))[0])
            raise ValueError(f"timestamps must be finite; batch[{bad}] = {ts[bad]}")
        if (ts < 0).any():
            bad = int(np.flatnonzero(ts < 0)[0])
            raise ValueError(f"timestamps must be >= 0; batch[{bad}] = {ts[bad]}")
        if (np.diff(ts) < 0).any():
            if not self._warned_unsorted:
                warnings.warn(
                    "observe() received an out-of-order batch and sorted it; "
                    "deliver sorted batches to silence this (warned once per "
                    "service)",
                    RuntimeWarning,
                    stacklevel=2,
                )
                self._warned_unsorted = True
            ts = np.sort(ts, kind="stable")
        if (np.diff(ts) == 0).any():
            bad = int(np.flatnonzero(np.diff(ts) == 0)[0]) + 1
            raise ValueError(
                f"duplicate timestamp in batch: batch[{bad}] = {ts[bad]} appears "
                "twice; arrival stamps must be distinct"
            )
        if self._seen and ts[0] <= self._now:
            raise ValueError(
                f"batch starts at {ts[0]} but the stream is already at {self._now}; "
                "batches must arrive in stream order without duplicating the "
                "stream head"
            )
        self._buf = np.concatenate([self._buf, ts])
        self._now = float(ts[-1])
        self._seen = True
        # the rolling window: drop what can never enter an estimate again
        self._buf = self._buf[self._buf >= self._now - self.config.span]

    def observe_trace(self, trace: TraceArrivalProcess) -> None:
        """Replay a recorded trace into the stream in one push."""
        self.observe(np.asarray(trace.timestamps, np.float64))

    @property
    def now(self) -> float:
        return self._now

    # ---- estimation -----------------------------------------------------

    def estimate(self) -> PiecewiseConstantRate:
        """The EMA-blended rolling-window profile a tick would sweep now
        (it also advances the EMA: called once a tick)."""
        cfg = self.config
        t0 = max(0.0, self._now - cfg.span)
        rel = self._buf[self._buf >= t0] - t0
        if len(rel):
            # fold the right edge in: the newest arrival sits exactly at the
            # window's end, one ulp past fit()'s half-open range
            rel = np.minimum(rel, np.nextafter(cfg.span, 0.0))
            fitted = PiecewiseConstantRate.fit(
                rel, cfg.bin_width, rate_floor=cfg.rate_floor, n_bins=cfg.n_bins,
            )
            rates = np.asarray(fitted.rates, np.float64)
        else:
            rates = np.full((cfg.n_bins,), cfg.rate_floor)
        if self._ema is None:
            self._ema = rates
        else:
            self._ema = cfg.ema_alpha * rates + (1 - cfg.ema_alpha) * self._ema
        clamped = np.clip(self._ema, cfg.rate_floor, cfg.rate_ceiling)
        return PiecewiseConstantRate(edges=self._edges, rates=tuple(float(r) for r in clamped))

    # ---- the tick loop --------------------------------------------------

    def _scenario(self, profile) -> Scenario:
        return Scenario.of(
            self._base, arrival_process=NHPPArrivalProcess(profile=profile),
            rate_profile=None, arrival_rate=None,
        )

    def _sweep(self, profile, seed: int, deferred: bool):
        cfg = self.config
        return scenario_sweep(
            self._scenario(profile), over={"expiration_threshold": list(cfg.thresholds)},
            seed=seed, replicas=cfg.replicas, device=cfg.device, execution=cfg.execution,
            steps=self._steps, deferred=deferred,
        )

    def tick(self) -> Optional[Recommendation]:
        """Re-fit, re-sweep, recommend.

        Launches this tick's sweep and (with overlap) drains the
        *previous* tick's: returns ``None`` on the first overlapped tick.
        What the dispatch made the process pay again lands in
        ``TRACE_COUNTS["online_tick"]``: 0 after warm-up.
        """
        stall = None
        if self._last_tick_now is not None and self._now <= self._last_tick_now:
            stall = (
                "ingest stalled: no arrivals observed since the previous tick "
                f"(stream clock held at t={self._now})"
            )
        self._last_tick_now = self._now
        profile = self.estimate()
        seed = child_seed(self._seeds.spawn(1)[0])
        before = trace_total()
        out = self._sweep(profile, seed, self._deferred)
        TRACE_COUNTS["online_tick"] += trace_total() - before
        item = (out, (self._ticks, self._now, profile, seed, stall))
        self._ticks += 1
        if self._deferred:
            prev, self._pending = self._pending, item
            return self._drain(prev) if prev is not None else None
        return self._drain(item)

    def flush(self) -> Optional[Recommendation]:
        """Drain the pending overlapped tick, if any."""
        if self._pending is None:
            return None
        prev, self._pending = self._pending, None
        return self._drain(prev)

    def _drain(self, item) -> Recommendation:
        out, (tick, t_now, profile, seed, stall) = item
        grid = out.result() if hasattr(out, "result") else out
        reason = stall
        ok = np.asarray(grid.ok)
        if reason is None and not ok.all():
            reason = (
                f"sweep produced non-finite metrics in {int((~ok).sum())} of "
                f"{ok.size} grid cell(s)"
            )
        if reason is not None:
            last_good = next((r for r in reversed(self.history) if not r.degraded), None)
            if last_good is not None:
                # hold: re-issue the last healthy advice untouched; the
                # governor is not fed a choice read off a bad grid
                rec = dataclasses.replace(
                    last_good, tick=tick, t_now=t_now, degraded=True,
                    degraded_reason=reason,
                )
                self.history.append(rec)
                return rec
            # nothing good to hold yet: this tick's advice, flagged
        plan: PlanResult = select_threshold(grid, self.config.cold_slo)
        applied = self.governor.update(plan.expiration_threshold)
        rec = Recommendation(
            tick=tick,
            t_now=t_now,
            threshold=plan.expiration_threshold,
            applied_threshold=applied,
            predicted_cold_prob=plan.predicted_cold_prob,
            predicted_cost=plan.predicted_cost,
            predicted_goodput=plan.predicted_goodput,
            predicted_avg_replicas=plan.predicted_avg_replicas,
            headroom=self._capacity - plan.predicted_avg_replicas,
            rate_mean=profile.mean_rate(),
            profile=profile,
            seed=seed,
            grid=grid,
            degraded=reason is not None,
            degraded_reason=reason,
        )
        self.history.append(rec)
        return rec

    # ---- checkpoint / restore -------------------------------------------

    def checkpoint(self) -> dict:
        """Snapshot the mutable service state as plain numpy and Python
        data: the rolling buffer, the stream clock, the EMA, the tick
        counter, the seed sequence's position (its seed and the children
        spawned) and the governor's hysteresis, enough for a restarted
        process to continue the stream bit for bit.  A pending overlapped
        tick is not captured (it is on the card): restore and tick again."""
        return {
            "version": CHECKPOINT_VERSION,
            "buf": self._buf.copy(),
            "now": self._now,
            "seen": self._seen,
            "ema": None if self._ema is None else np.asarray(self._ema).copy(),
            "ticks": self._ticks,
            "last_tick_now": self._last_tick_now,
            "seed": int(self.config.seed),
            "n_children_spawned": int(self._seeds.n_children_spawned),
            "governor": {
                "applied": self.governor.applied,
                "candidate": self.governor._candidate,
                "streak": self.governor._streak,
            },
        }

    def restore(self, state: dict) -> None:
        """Restore a :meth:`checkpoint` snapshot (drops any pending
        overlapped tick; ``history`` is a log and is left alone)."""
        if state.get("version") != CHECKPOINT_VERSION:
            raise ValueError(
                f"unknown checkpoint version {state.get('version')!r}; this "
                f"service reads version {CHECKPOINT_VERSION}"
            )
        self._buf = np.asarray(state["buf"], np.float64).copy()
        self._now = float(state["now"])
        self._seen = bool(state["seen"])
        ema = state["ema"]
        self._ema = None if ema is None else np.asarray(ema, np.float64).copy()
        self._ticks = int(state["ticks"])
        self._last_tick_now = state["last_tick_now"]
        self._seeds = np.random.SeedSequence(
            int(state["seed"]), n_children_spawned=int(state["n_children_spawned"])
        )
        gov = state["governor"]
        self.governor.applied = gov["applied"]
        self.governor._candidate = gov["candidate"]
        self.governor._streak = gov["streak"]
        self._pending = None

    def offline_equivalent(self, rec: Recommendation):
        """Re-run ``rec``'s sweep offline (synchronously) on the recorded
        profile and seed: bit for bit ``rec.grid`` by construction."""
        return self._sweep(rec.profile, rec.seed, False)


# --------------------------------------------------------------------------
# Fleet service mode
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FleetRecommendation:
    """One fleet tick: per-function keep-alive advice under the shared
    cluster budget."""

    tick: int
    t_now: float
    plans: Dict[str, PlanResult]  # per-function grid choice
    applied: Dict[str, float]  # per-function governed threshold
    rates: Dict[str, float]  # per-function EMA rate estimate
    predicted_total_replicas: float
    headroom: float  # n_cluster - predicted total
    seed: int
    grid: "object"  # the FleetGridResult

    @property
    def thresholds(self) -> Dict[str, float]:
        return {n: p.expiration_threshold for n, p in self.plans.items()}


class OnlineFleetWhatIfService:
    """The fleet-mode service: one scalar EMA rate per function, the
    functions' processes re-levelled by :meth:`FleetScenario.with_rates`,
    one ``fleet_sweep`` a tick (one launch of the f64 fleet scan,
    ``kernels/csrc/fleet_scan_event_step.cu``, on the card), a per-function
    threshold choice and the cluster's headroom.

    ``fleet_sweep`` reads its results back inside its launcher, so fleet
    ticks are synchronous, as in the reference; the shapes are pinned as in
    the single-function service (steps, grid, the fleet's structure).
    """

    def __init__(self, fleet, config: OnlineConfig):
        from repro_torch.core.fleet import FleetScenario

        if not isinstance(fleet, FleetScenario):
            raise TypeError(f"fleet must be a FleetScenario, got {type(fleet).__name__}")
        _check_config(config)
        self.config = config
        self._fleet = dataclasses.replace(
            fleet, sim_time=config.horizon, skip_time=config.skip_time
        )
        # each function's peak-to-mean ratio of the re-levelled process: the
        # EMA clamp must keep max_rate (the thinning envelope) under the
        # ceiling, not just the mean; with_rate(1.0) normalises, so its
        # candidate rate IS the ratio (stationary families: 1)
        self._ratio = {}
        for f in self._fleet.functions:
            p1 = f.arrival_process.with_rate(1.0)
            self._ratio[f.name] = (
                float(p1.profile.max_rate()) if isinstance(p1, NHPPArrivalProcess) else 1.0
            )
        # the candidate width: every function simulated at the ceiling
        n = config.horizon * config.rate_ceiling
        self._steps = int(n + 6.0 * np.sqrt(max(n, 1.0)) + 16)
        self._buf: Dict[str, np.ndarray] = {
            n_: np.empty((0,), np.float64) for n_ in self._fleet.names
        }
        self._now = 0.0
        self._ema: Dict[str, float] = {}
        self._ticks = 0
        self._seeds = np.random.SeedSequence(int(config.seed))
        self.governors: Dict[str, ThresholdGovernor] = {
            n_: ThresholdGovernor(patience=config.patience, deadband=config.deadband)
            for n_ in self._fleet.names
        }
        self.history: List[FleetRecommendation] = []

    def observe(self, name: str, timestamps) -> None:
        """Push a batch of one function's arrival timestamps."""
        if name not in self._buf:
            raise KeyError(
                f"unknown function {name!r}; fleet functions: {list(self._fleet.names)}"
            )
        ts = np.asarray(timestamps, np.float64).ravel()
        if len(ts) == 0:
            return
        if not np.isfinite(ts).all() or (ts < 0).any():
            raise ValueError("timestamps must be finite and >= 0")
        if (np.diff(ts) < 0).any():
            raise ValueError("batch must be sorted ascending")
        self._buf[name] = np.concatenate([self._buf[name], ts])
        self._now = max(self._now, float(ts[-1]))
        span = self.config.span
        for n_ in self._buf:
            self._buf[n_] = self._buf[n_][self._buf[n_] >= self._now - span]

    @property
    def now(self) -> float:
        return self._now

    def estimate(self) -> Dict[str, float]:
        """Per-function EMA-blended windowed mean rates (advances the EMA:
        called once a tick)."""
        cfg = self.config
        span = min(cfg.span, self._now) or cfg.span
        rates = {}
        for n_, buf in self._buf.items():
            inst = len(buf[buf >= self._now - cfg.span]) / span
            prev = self._ema.get(n_)
            ema = inst if prev is None else cfg.ema_alpha * inst + (1 - cfg.ema_alpha) * prev
            self._ema[n_] = ema
            ceiling = cfg.rate_ceiling / self._ratio[n_]
            rates[n_] = float(np.clip(ema, cfg.rate_floor, ceiling))
        return rates

    def tick(self) -> FleetRecommendation:
        """Re-estimate, re-level the fleet, re-sweep, recommend."""
        from repro_torch.core.fleet import fleet_sweep

        cfg = self.config
        rates = self.estimate()
        fleet_t = self._fleet.with_rates(rates)
        seed = child_seed(self._seeds.spawn(1)[0])
        before = trace_total()
        grid = fleet_sweep(
            fleet_t, over={"expiration_threshold": list(cfg.thresholds)}, seed=seed,
            replicas=cfg.replicas, device=cfg.device, execution=cfg.execution,
            steps=self._steps,
        )
        TRACE_COUNTS["online_tick"] += trace_total() - before
        plans, applied, total = {}, {}, 0.0
        for n_ in self._fleet.names:
            plan = select_threshold(grid.sel(function=n_), cfg.cold_slo)
            plans[n_] = plan
            applied[n_] = self.governors[n_].update(plan.expiration_threshold)
            total += plan.predicted_avg_replicas
        rec = FleetRecommendation(
            tick=self._ticks,
            t_now=self._now,
            plans=plans,
            applied=applied,
            rates=rates,
            predicted_total_replicas=total,
            headroom=float(self._fleet.n_cluster) - total,
            seed=seed,
            grid=grid,
        )
        self._ticks += 1
        self.history.append(rec)
        return rec
