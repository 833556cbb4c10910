"""Simulation summaries and sample staging for the PyTorch port.

:class:`SimulationSummary` is the reference's per-replica result record
(numpy arrays, host side) with the paper's derived metrics;
:func:`draw_workload_samples` stages the (arrivals, warm, cold) f32
``[R, n]`` sample buffers on the device from three explicit generators,
:func:`draw_reliability_stream` adds the reliability layer's failure
uniforms or, with retries, the sorted attempt table, and
:func:`draw_crash_uniforms` the platform-fault layer's crash stream.
:class:`WindowedMetrics` holds per-window metrics.  An arrival process
that yields absolute timestamps (NHPP, MMPP, trace replay) is drawn in
f64 by :func:`draw_arrival_times`, behind its own coverage guard, and cast
into the f32 staging once, after its sort.
The helpers below them are what every engine does around its launch:
stage a run's samples behind the coverage guard (:func:`run_samples`),
bring the accumulator to the host behind the overflow guard
(:func:`host_acc`) and read a summary off its base columns
(:func:`summary_from_acc`).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class WindowedMetrics:
    """Per-window metrics over a user time grid.

    Request counts are taken per arrival-window (half-open ``[b_w, b_w+1)``
    membership of the arrival instant); instance-time integrals are exact
    over each window intersected with ``[0, sim_time]``.  Windows ignore
    ``skip_time``: the grid itself says what the user wants to see.
    """

    bounds: np.ndarray  # [W+1] window boundaries
    n_cold: np.ndarray  # [R, W]
    n_warm: np.ndarray  # [R, W]
    n_arrivals: np.ndarray  # [R, W] (includes rejected arrivals)
    time_running: np.ndarray  # [R, W] exact integral per window
    time_idle: np.ndarray  # [R, W]
    n_fail: Optional[np.ndarray] = None  # [R, W] timeouts+failures (f64 engine)

    @property
    def widths(self) -> np.ndarray:
        return np.diff(self.bounds)

    @property
    def failure_prob(self) -> np.ndarray:
        """[W] pooled timeouts+failures per served request (zeros unless
        the f64 engine ran with reliability: the block kernels keep
        aggregate reliability columns, not per-window ones)."""
        if self.n_fail is None:
            return np.zeros(len(self.bounds) - 1)
        served = (self.n_cold + self.n_warm).sum(axis=0)
        return self.n_fail.sum(axis=0) / np.maximum(served, 1)

    @property
    def cold_start_prob(self) -> np.ndarray:
        """[W] pooled-over-replicas per-window cold-start probability."""
        served = (self.n_cold + self.n_warm).sum(axis=0)
        return self.n_cold.sum(axis=0) / np.maximum(served, 1)

    @property
    def arrival_rate(self) -> np.ndarray:
        """[W] mean observed arrivals per second per window."""
        return self.n_arrivals.mean(axis=0) / self.widths

    @property
    def avg_instance_count(self) -> np.ndarray:
        """[W] replica-mean of total (running+idle) instance count."""
        return (self.time_running + self.time_idle).mean(axis=0) / self.widths

    @property
    def avg_running_count(self) -> np.ndarray:
        return self.time_running.mean(axis=0) / self.widths

    def to_dict(self) -> dict:
        return {
            "bounds": self.bounds.tolist(),
            "cold_start_prob": self.cold_start_prob.tolist(),
            "arrival_rate": self.arrival_rate.tolist(),
            "avg_instance_count": self.avg_instance_count.tolist(),
        }


@dataclasses.dataclass
class SimulationSummary:
    """Aggregated results.  Per-replica arrays retained for CIs."""

    n_cold: np.ndarray
    n_warm: np.ndarray
    n_reject: np.ndarray
    time_running: np.ndarray  # integral of running-instance count (s)
    time_idle: np.ndarray
    sum_cold_resp: np.ndarray
    sum_warm_resp: np.ndarray
    lifespan_sum: np.ndarray
    lifespan_count: np.ndarray
    measured_time: float
    histogram: Optional[np.ndarray] = None  # [R, hist_bins] time at count=k
    overflow: Optional[np.ndarray] = None
    windows: Optional[WindowedMetrics] = None  # set when window_bounds given
    # ---- reliability counters (None unless Scenario.reliability is set) --
    n_timeout: Optional[np.ndarray] = None  # served but cut at t_timeout
    n_fail: Optional[np.ndarray] = None  # served, completed, then failed
    n_retry: Optional[np.ndarray] = None  # re-enqueued attempts processed
    n_abandon: Optional[np.ndarray] = None  # gave up (retry budget spent)
    # ---- platform-fault counters (None unless Scenario.faults is set) ----
    n_crash: Optional[np.ndarray] = None  # instances lost to the crash hazard
    n_evict: Optional[np.ndarray] = None  # idle instances evicted by churn
    n_interrupt: Optional[np.ndarray] = None  # served attempts cut by a crash

    @property
    def n_requests(self) -> np.ndarray:
        """Processed attempts per replica (served plus rejected; retries
        count individually)."""
        return self.n_cold + self.n_warm + self.n_reject

    def _rely(self, x) -> np.ndarray:
        return np.zeros_like(np.asarray(self.n_cold)) if x is None else x

    @property
    def n_attempts(self) -> np.ndarray:
        """Alias of ``n_requests`` emphasising attempts vs completions."""
        return self.n_requests

    @property
    def n_completions(self) -> np.ndarray:
        """Served attempts that neither timed out, failed, nor were
        interrupted by an instance crash."""
        return (
            self.n_cold
            + self.n_warm
            - self._rely(self.n_timeout)
            - self._rely(self.n_fail)
            - self._rely(self.n_interrupt)
        )

    @property
    def timeout_prob(self) -> float:
        served = (self.n_cold + self.n_warm).sum()
        return float(self._rely(self.n_timeout).sum() / np.maximum(served, 1))

    @property
    def failure_prob(self) -> float:
        served = (self.n_cold + self.n_warm).sum()
        return float(self._rely(self.n_fail).sum() / np.maximum(served, 1))

    @property
    def goodput(self) -> float:
        """Successful completions per second (replica mean)."""
        return float(self.n_completions.mean() / max(self.measured_time, 1e-12))

    @property
    def interrupt_prob(self) -> float:
        """Served attempts cut short by an instance crash, per served."""
        served = (self.n_cold + self.n_warm).sum()
        return float(self._rely(self.n_interrupt).sum() / np.maximum(served, 1))

    @property
    def availability(self) -> float:
        """Fraction of served attempts the platform carried to completion
        without losing the instance underneath them: 1 − interrupt_prob
        (1.0 when no fault model is active)."""
        return 1.0 - self.interrupt_prob

    @property
    def retry_amplification(self) -> float:
        """Attempts per original request — the retry-amplified load."""
        attempts = self.n_requests.sum()
        firsts = attempts - self._rely(self.n_retry).sum()
        return float(attempts / np.maximum(firsts, 1))

    @property
    def cold_start_prob(self) -> float:
        served = self.n_cold + self.n_warm
        return float(self.n_cold.sum() / np.maximum(served.sum(), 1))

    @property
    def rejection_prob(self) -> float:
        return float(self.n_reject.sum() / np.maximum(self.n_requests.sum(), 1))

    @property
    def avg_running_count(self) -> float:
        return float(self.time_running.mean() / self.measured_time)

    @property
    def avg_idle_count(self) -> float:
        return float(self.time_idle.mean() / self.measured_time)

    @property
    def avg_server_count(self) -> float:
        return self.avg_running_count + self.avg_idle_count

    @property
    def avg_lifespan(self) -> float:
        return float(self.lifespan_sum.sum() / np.maximum(self.lifespan_count.sum(), 1))

    @property
    def avg_response_time(self) -> float:
        served = np.maximum((self.n_cold + self.n_warm).sum(), 1)
        return float((self.sum_cold_resp + self.sum_warm_resp).sum() / served)

    @property
    def avg_wasted_ratio(self) -> float:
        """Idle / total instance-time — the provider's wasted capacity."""
        total = self.time_running + self.time_idle
        return float((self.time_idle.sum()) / np.maximum(total.sum(), 1e-12))

    def to_dict(self) -> dict:
        return {
            "cold_start_prob": self.cold_start_prob,
            "rejection_prob": self.rejection_prob,
            "avg_server_count": self.avg_server_count,
            "avg_running_count": self.avg_running_count,
            "avg_idle_count": self.avg_idle_count,
            "avg_lifespan": self.avg_lifespan,
            "avg_response_time": self.avg_response_time,
            "avg_wasted_ratio": self.avg_wasted_ratio,
            "n_requests": int(self.n_requests.sum()),
            "n_completions": int(self.n_completions.sum()),
            "n_timeouts": int(self._rely(self.n_timeout).sum()),
            "n_failures": int(self._rely(self.n_fail).sum()),
            "n_retries": int(self._rely(self.n_retry).sum()),
            "n_abandoned": int(self._rely(self.n_abandon).sum()),
            "goodput": self.goodput,
            "retry_amplification": self.retry_amplification,
            "n_crashes": int(self._rely(self.n_crash).sum()),
            "n_evictions": int(self._rely(self.n_evict).sum()),
            "n_interrupted": int(self._rely(self.n_interrupt).sum()),
            "availability": self.availability,
        }


# ---------------------------------------------------------------------------
# Closed-form interval integration of the f64 engine, on [..., M] slot
# tensors: the plain f64 versions (kernels/ref64.py) step with these, and
# the f64 kernels compute the same pieces slot by slot
# ---------------------------------------------------------------------------

# the f64 engine's dead-slot sentinel (the reference's _NEG_INF)
NEG_INF = -1e30


def interval_integrals(alive, busy_until, exp_threshold, lo, hi):
    """Exact ∫running and ∫idle instance counts over the window ``(lo, hi]``,
    summed over the last (slot) axis.

    Per live slot: running on ``(lo, min(busy, hi)]``, idle on ``(max(busy,
    lo), min(busy + T_exp, hi)]``.  The window may be empty (``lo >= hi``);
    ``exp_threshold``, ``lo`` and ``hi`` broadcast against the slots."""
    expire = busy_until + exp_threshold
    run_t = (torch.minimum(busy_until, hi) - lo).clamp_min(0.0)
    idle_t = (torch.minimum(expire, hi) - torch.maximum(busy_until, lo)).clamp_min(0.0)
    run_t = torch.where(alive, run_t, 0.0)
    idle_t = torch.where(alive, idle_t, 0.0)
    return run_t.sum(-1), idle_t.sum(-1)


def fault_interval_integrals(alive, busy_until, exp_threshold, doom, lo, hi):
    """:func:`interval_integrals` under a crash hazard: a slot's accrual
    stops at its crash time ``doom`` (it is removed at the next event, but
    it stops existing, and billing, at ``doom``)."""
    expire = busy_until + exp_threshold
    stop = torch.minimum(hi, doom)
    run_t = (torch.minimum(busy_until, stop) - lo).clamp_min(0.0)
    idle_t = (torch.minimum(expire, stop) - torch.maximum(busy_until, lo)).clamp_min(0.0)
    run_t = torch.where(alive, run_t, 0.0)
    idle_t = torch.where(alive, idle_t, 0.0)
    return run_t.sum(-1), idle_t.sum(-1)


def histogram_update(hist, alive, busy_until, exp_threshold, lo, hi):
    """Add to ``hist [R, H]`` the time each row spends at each total
    instance count within ``(lo, hi]`` (``lo``, ``hi``, ``exp_threshold``:
    ``[R, 1]``; the pool ``[R, M]``).

    Between arrivals the count only falls, at each slot's expiry: sort the
    expiries inside the window; segment k (between consecutive order
    statistics) has count n0 - k, n0 being the slots live at ``lo``.
    Segments with a negative count (the padding past the last expiry) or
    no length add nothing, and counts past the last bin add to it."""
    H = hist.shape[-1]
    window = (hi - lo).clamp_min(0.0)
    expire = torch.where(alive, busy_until + exp_threshold, NEG_INF)
    n0 = (expire > lo).sum(-1, keepdim=True)
    ev = torch.where((expire > lo) & (expire <= hi), expire, hi)
    ev = torch.where(window > 0.0, ev, hi)
    ev_sorted = torch.sort(ev, dim=-1).values
    bounds = torch.cat([lo, ev_sorted], dim=-1)
    nxt = torch.cat([ev_sorted, hi], dim=-1)
    durations = (nxt - bounds).clamp_min(0.0)
    durations = torch.where(window > 0.0, durations, 0.0)
    counts = n0 - torch.arange(bounds.shape[-1], device=hist.device)
    valid = (counts >= 0) & (durations > 0.0)
    durations = torch.where(valid, durations, 0.0)
    return hist.scatter_add_(-1, counts.clamp(0, H - 1), durations)


def window_integrals(bounds, alive, busy_until, exp_threshold, lo_eff, hi_eff):
    """Exact per-window ∫running / ∫idle over ``(lo_eff, hi_eff]`` ∩ each
    window: ``bounds [R, W+1]``, the pool ``[R, M]``, ``exp_threshold``,
    ``lo_eff``, ``hi_eff`` ``[R]``; returns two ``[R, W]`` tensors.  A
    window the interval misses adds exactly 0."""
    wlo = torch.maximum(bounds[:, :-1], lo_eff[:, None])[..., None]
    whi = torch.minimum(bounds[:, 1:], hi_eff[:, None])[..., None]
    return interval_integrals(alive[:, None, :], busy_until[:, None, :],
                              exp_threshold[:, None, None], wlo, whi)


# the streams of one draw cell, in SeedSequence word order: the base
# (arrival, warm, cold) streams, then the reliability layer's (failure
# uniforms, backoff jitter, retry attempts' warm and cold draws), then the
# fault layer's crash uniforms (stream CRASH_STREAM of FAULT_STREAMS)
BASE_STREAMS = 3
RELY_STREAMS = 7
FAULT_STREAMS = 8
CRASH_STREAM = 7


def cell_generators(seed: int, n_cells: int, device, streams: int = BASE_STREAMS) -> list:
    """``streams`` generators per draw cell (:data:`BASE_STREAMS`,
    :data:`RELY_STREAMS` or :data:`FAULT_STREAMS`).

    Cell ``d`` is seeded from ``numpy.random.SeedSequence(seed).spawn(n)[d]``,
    so every cell's streams are independent and a cell's draws do not
    depend on how many cells the grid has before it changes shape.  A
    longer ``generate_state`` request keeps its first words, so the
    reliability streams take words 3 to 6 and the crash stream word 7, and
    each layer leaves the streams before it bit for bit as without it.
    """
    out = []
    for child in np.random.SeedSequence(int(seed)).spawn(int(n_cells)):
        gens = []
        for s in child.generate_state(int(streams), np.uint64):
            g = torch.Generator(device=device)
            g.manual_seed(int(s))
            gens.append(g)
        out.append(tuple(gens))
    return out


# the list of the innermost open deferred_guards(), None outside one
_DEFERRED: contextvars.ContextVar = contextvars.ContextVar("deferred_guards", default=None)


@contextlib.contextmanager
def deferred_guards():
    """Within this context the staging's coverage guards and the kernel
    wrappers' checks on device values (window bounds) compute their flags
    on the device but do not read them: each read, a closure that raises
    the guard's error, is appended to the yielded list for the caller to
    run before it returns a result (a deferred sweep's ``result()``, a
    sharded sweep's reads).  A read synchronises the host with the device,
    so a deferred sweep reads nothing before its launch, and a sharded one
    nothing between its shards' launches."""
    checks: list = []
    token = _DEFERRED.set(checks)
    try:
        yield checks
    finally:
        _DEFERRED.reset(token)


def guard(read) -> None:
    """Run the guard ``read`` now, or defer it (:func:`deferred_guards`)."""
    checks = _DEFERRED.get()
    if checks is None:
        read()
    else:
        checks.append(read)


def draw_arrival_times(scn, generator, replicas: int, n: int, device) -> torch.Tensor:
    """The f64 ``[replicas, n]`` absolute timestamps of ``scn``'s
    timestamp process (NHPP, MMPP, trace), thinned and sorted in f64,
    behind the coverage guard: a padded stream ends in ``PAD_TIME``, so the
    generating process reports how far it is exact, and every row must
    reach ``scn.sim_time``."""
    times, coverage = scn.arrival_process.arrival_times(generator, (replicas, n), device)
    short = (coverage < scn.sim_time).any()

    def read():
        if bool(short):
            raise RuntimeError(
                "arrival-stream coverage ended before sim_time "
                f"(min coverage {coverage.min().item():.1f} < {scn.sim_time}); "
                "pass a larger `steps`"
            )

    guard(read)
    return times


def draw_workload_samples(scn, generators, replicas: int, n: int, device, out=None,
                          f64: bool = False):
    """Draw the (arrivals, warm, cold) f32 ``[replicas, n]`` sample buffers
    on ``device`` from the three generators of one draw cell: inter-arrival
    gaps, or with a timestamp process (``scn.prestamped``) the absolute
    times of :func:`draw_arrival_times`, cast to f32 as they are written
    (kept in f64 with ``f64=True``: the f64 engine's staging).

    ``out`` optionally gives three preallocated ``[replicas, n]`` buffers
    (views into a sweep's ``[C, K]`` staging) to fill in place; the times
    take the first one's dtype.
    """
    if out is None:
        dtype = torch.float64 if f64 and scn.prestamped else torch.float32
        arr = torch.empty((replicas, n), dtype=dtype, device=device)
    else:
        arr = out[0]
    if scn.prestamped:
        arr.copy_(draw_arrival_times(scn, generators[0], replicas, n, device))
    else:
        scn.arrival_process.sample_into(arr, generators[0])
    return (arr,) + draw_service_samples(scn, generators[1:3], replicas, n, device,
                                         None if out is None else out[1:])


def draw_service_samples(scn, generators, replicas: int, n: int, device, out=None):
    """Draw the (warm, cold) f32 ``[replicas, n]`` service samples from a
    draw cell's warm and cold ``generators``, into ``out`` where given."""
    if out is None:
        out = tuple(
            torch.empty((replicas, n), dtype=torch.float32, device=device)
            for _ in range(2)
        )
    warms, colds = out
    scn.warm_service_process.sample_into(warms, generators[0])
    scn.cold_service_process.sample_into(colds, generators[1])
    return warms, colds


def draw_reliability_stream(scn, generators, replicas: int, n: int, device, out=None,
                            f64: bool = False):
    """Draw ``(samples, extras)`` for a reliability run from the
    :data:`RELY_STREAMS` generators of one draw cell, as the reference's
    ``draw_reliability_stream`` lays them out.

    The base ``(arrivals, warm, cold)`` come from the first three streams
    exactly as :func:`draw_workload_samples` draws them.  With
    ``max_retries == 0`` the gap stream is kept and ``extras = (fail_u,)``
    (f32 ``[replicas, n]``).  With retries J > 0 the stream becomes the
    sorted attempt table of :func:`~repro_torch.core.reliability.
    build_attempt_table` (K = n·(J+1) attempts; absolute times, so the
    launch runs ``prestamped``), built in f64 on the device in row chunks
    after the coverage guard, and ``extras = (fail_u, is_first,
    child_pos)``.  Every buffer is f32 ``[replicas, K]`` (with ``f64=True``
    the f64 engine's dtypes, :func:`staged_dtypes`: f64 times, bool flags
    and int32 positions); ``out`` optionally gives the six (or four)
    preallocated buffers to fill, whose dtypes the values take.
    """
    from repro_torch.core.reliability import build_attempt_table

    rel = scn.reliability
    g_arr, g_warm, g_cold, g_fail, g_jit, g_wx, g_cx = generators
    J = int(rel.retry.max_retries)
    f32 = dict(dtype=torch.float32, device=device)
    if J == 0:
        base = None if out is None else out[:3]
        samples = draw_workload_samples(scn, generators[:3], replicas, n, device, out=base,
                                        f64=f64)
        fail = torch.empty((replicas, n), **f32) if out is None else out[3]
        return samples, (torch.rand(fail.shape, generator=g_fail, out=fail),)
    K = n * (J + 1)
    if out is None:
        dtypes = staged_dtypes(scn, False, f64)
        out = tuple(torch.empty((replicas, K), dtype=d, device=device) for d in dtypes)
    if scn.prestamped:
        # the process's f64 timestamps themselves, guarded on its coverage
        times0 = draw_arrival_times(scn, g_arr, replicas, n, device)
        warms, colds = draw_service_samples(scn, (g_warm, g_cold), replicas, n, device)
        first_times = lambda rows: times0[rows]
    else:
        gaps, warms, colds = draw_workload_samples(scn, generators[:3], replicas, n, device)
        # the gap stream becomes absolute times, whose coverage the launch
        # can no longer check: guard it here, on the f64 sum of the f32 gaps
        check_covered(gaps, [scn.sim_time] * replicas, device)
        first_times = lambda rows: torch.cumsum(gaps[rows].double(), dim=1)
    jitter = torch.rand((replicas, n, J), generator=g_jit, dtype=torch.float64, device=device)
    warms_x = scn.warm_service_process.sample(g_wx, (replicas, n * J), device)
    colds_x = scn.cold_service_process.sample(g_cx, (replicas, n * J), device)
    fail_a = torch.rand((replicas, n, J + 1), generator=g_fail, **f32)
    for r in range(0, replicas, ATTEMPT_ROWS):
        rows = slice(r, min(r + ATTEMPT_ROWS, replicas))
        table = build_attempt_table(
            first_times(rows),
            torch.cat([warms[rows, :, None], warms_x[rows].view(-1, n, J)], dim=2),
            torch.cat([colds[rows, :, None], colds_x[rows].view(-1, n, J)], dim=2),
            fail_a[rows],
            jitter[rows],
            rel.retry,
        )
        for buf, x in zip(out, table):
            buf[rows] = x
    return tuple(out[:3]), tuple(out[3:])


# rows of one attempt-table build: its f64 temporaries (times, sort keys
# and ranks, ~40 bytes an attempt) stay a few GB at a full-width horizon
ATTEMPT_ROWS = 32


def draw_crash_uniforms(generator, replicas: int, n: int, device, out=None):
    """The fault layer's per-event crash-lifetime uniforms, f32 ``[replicas,
    n]`` on ``device`` from the draw cell's crash generator (``out``: a
    preallocated buffer to fill).  ``n`` is the width of the event stream
    the launch steps (the attempt table's under retries): a cold start at
    event k draws its lifetime from uniform k."""
    if out is None:
        out = torch.empty((replicas, n), dtype=torch.float32, device=device)
    return torch.rand(out.shape, generator=generator, out=out)


def staged_widths(scn, crashes: Optional[bool] = None) -> int:
    """How many staged buffers a run of ``scn`` takes: the base three,
    plus ``fail_u`` with reliability, plus ``is_first`` and ``child_pos``
    with retries, plus ``crash_u`` with crashes (``crashes``, default:
    the scenario's fault model has a crash rate)."""
    rel = scn.reliability
    if crashes is None:
        crashes = scn.faults is not None and scn.faults.crashes
    width = 3 if rel is None else 6 if rel.retry.max_retries > 0 else 4
    return width + int(bool(crashes))


def staged_dtypes(scn, crashes: Optional[bool] = None, f64: bool = False) -> tuple:
    """The dtype of each staged buffer of a run of ``scn`` (as many as
    :func:`staged_widths`): all f32 for the block engines; with ``f64``
    (the f64 engine) the arrival column is f64 when it holds absolute
    times (a timestamp process or a retry table), ``is_first`` bool and
    ``child_pos`` int32, so that times and positions stay exact."""
    f32 = torch.float32
    width = staged_widths(scn, crashes)
    if not f64:
        return (f32,) * width
    times = torch.float64 if scn.prestamped or scn.max_retries > 0 else f32
    out = (times, f32, f32) + ((f32,) if scn.reliability is not None else ())
    if scn.max_retries > 0:
        out = out + (torch.bool, torch.int32)
    return out + (f32,) * (width - len(out))


def check_staged(staged, rows: int, device, width: int, crashes: bool = False,
                 dtypes=None) -> tuple:
    """The staged buffers handed in instead of draws — ``(dts, warms,
    colds)``, then ``fail_u`` with reliability, ``is_first``, ``child_pos``
    with retries and ``crash_u`` with crashes (``width`` of them) — as
    contiguous ``[rows, K]`` tensors on ``device``: f32, or ``dtypes``
    (:func:`staged_dtypes`)."""
    if len(staged) != width:
        rely = width - int(crashes)
        raise ValueError(
            f"staged must hold {width} buffers (dts, warms, colds"
            + (", fail_u" if rely > 3 else "")
            + (", is_first, child_pos" if rely > 4 else "")
            + (", crash_u" if crashes else "")
            + f"), got {len(staged)}"
        )
    dtypes = dtypes or (torch.float32,) * width
    out = tuple(
        torch.as_tensor(x).to(device=device, dtype=d).contiguous()
        for x, d in zip(staged, dtypes)
    )
    shape = tuple(out[0].shape)
    if len(shape) != 2 or shape[0] != rows or any(tuple(x.shape) != shape for x in out):
        raise ValueError(
            f"staged buffers must all be [{rows}, K] (rows in draw-cell, "
            f"replica order); got {[tuple(x.shape) for x in out]}"
        )
    return out


def check_covered(dts, sim_rows, device) -> None:
    """Coverage guard on the real draws, summed on the device in f64:
    every row's arrivals must reach its horizon (the arrival that steps
    past it closes the books, and the grid curves need it)."""
    covered = dts.sum(1, dtype=torch.float64)
    need = torch.as_tensor(np.asarray(sim_rows, np.float64), device=device)
    short = (covered < need).any()

    def read():
        if bool(short):
            raise RuntimeError(
                "pre-drawn arrivals ended before sim_time "
                f"(min final t {covered.min().item():.1f}); pass a larger `steps`"
            )

    guard(read)


def check_clock_covered(t_last, sim_rows) -> None:
    """Coverage guard of a fused launch, on the kernel's final clock: every
    row's drawn arrivals must reach its horizon."""
    need = torch.as_tensor(np.array(sim_rows, np.float64), device=t_last.device)
    if bool((t_last.double() < need).any()):
        raise RuntimeError(
            "fused arrival stream ended before sim_time "
            f"(min final t {t_last.min().item():.1f}); pass a larger `steps`"
        )


def check_table_covered(times, is_first, sim_rows, device) -> None:
    """Coverage guard of staged attempt tables (absolute times): every
    row's first attempts must reach its horizon."""
    last = torch.where(is_first > 0, times, -torch.inf).amax(1)
    need = torch.as_tensor(np.asarray(sim_rows, np.float64), device=device)
    if bool((last.double() < need).any()):
        raise RuntimeError(
            "the staged attempt table's first attempts end before sim_time "
            f"(min last first attempt {last.min().item():.1f}); draw more steps"
        )


def run_samples(scn, seed: int, replicas: int, steps, staged, device,
                f64: bool = False) -> tuple:
    """The staged buffers of one run (``staged_widths(scn)`` of them: the
    base three, then the reliability extras, then the crash uniforms): the
    handed-in ``staged`` buffers, or ``steps`` (default
    ``scn.steps_needed()``) draws of one draw cell seeded by ``seed``;
    gap streams behind the coverage guard on their sums, drawn timestamp
    streams behind their process's coverage."""
    crashes = scn.faults is not None and scn.faults.crashes
    width = staged_widths(scn)
    if staged is not None:
        samples = check_staged(staged, replicas, device, width, crashes,
                               staged_dtypes(scn, crashes, f64))
    else:
        n = int(steps or scn.steps_needed())
        streams = FAULT_STREAMS if crashes else BASE_STREAMS if scn.reliability is None \
            else RELY_STREAMS
        gens = cell_generators(seed, 1, device, streams)[0]
        if scn.reliability is None:
            samples = draw_workload_samples(scn, gens[:3], replicas, n, device, f64=f64)
        else:
            base, extras = draw_reliability_stream(scn, gens[:RELY_STREAMS], replicas, n,
                                                   device, f64=f64)
            samples = base + extras
        if crashes:
            samples = samples + (draw_crash_uniforms(
                gens[CRASH_STREAM], replicas, samples[0].shape[1], device),)
    sim_rows = [scn.sim_time] * replicas
    if scn.max_retries > 0:
        check_table_covered(samples[0], samples[4], sim_rows, device)
    elif not scn.prestamped:
        # drawn timestamps were guarded on their process's coverage; handed-in
        # ones on the producer's
        check_covered(samples[0], sim_rows, device)
    return samples


def host_acc(acc) -> np.ndarray:
    """A launch's f32 accumulator as f64 on the host, after the overflow
    guard (column 7 counts arrivals that found every slot taken)."""
    acc = acc.double().cpu().numpy()
    if acc[:, 7].sum() > 0:
        raise RuntimeError("instance-pool overflow; raise Scenario.slots")
    return acc


def summary_from_acc(acc, measured_time: float, cls=SimulationSummary, **extra):
    """A summary from the 8 base accumulator columns (lifespans stay a
    capability of the f64 engine: zeros here, as in the reference's block
    backends)."""
    zeros = np.zeros((acc.shape[0],))
    return cls(
        n_cold=acc[:, 0],
        n_warm=acc[:, 1],
        n_reject=acc[:, 2],
        time_running=acc[:, 3],
        time_idle=acc[:, 4],
        sum_cold_resp=acc[:, 5],
        sum_warm_resp=acc[:, 6],
        lifespan_sum=zeros,
        lifespan_count=zeros,
        measured_time=measured_time,
        overflow=acc[:, 7],
        **extra,
    )


# ---------------------------------------------------------------------------
# The f64 engine (backends "scan" and "scan_ref"): launch and summaries
# ---------------------------------------------------------------------------

def scan_backend(engine: str, backend: Optional[str], device) -> tuple:
    """``(BackendSpec, torch.device)`` of an f64 engine run: ``backend``
    (default ``"scan"`` on a CUDA device, ``"scan_ref"`` on the CPU) must
    be a backend of the f64 engine (``BackendSpec.f64``)."""
    from repro_torch.core.execution import Execution, resolve_backend

    dev = Execution(device=device).resolved_device()
    name = backend or ("scan" if dev.type == "cuda" else "scan_ref")
    if not resolve_backend(name).f64:
        raise ValueError(
            f"the f64 engine runs on backends 'scan' and 'scan_ref', got {name!r}"
        )
    return Execution(engine=engine, backend=name, device=dev).resolve()


def _f64_rows(x, C: int, device) -> torch.Tensor:
    """An f64 ``[C]`` tensor from a scalar or a length-C sequence (a tensor
    passes through: the caller placed it on the device)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(
        np.broadcast_to(np.asarray(x, np.float64), (C,)).copy(), device=device
    )


def scan_launch(
    scn, bspec, device, samples, *, t_exp, t_end, skip, prestamped, engine="scan",
    window_rows=None, t_timeout=None, p_fail=None, faults=None, pool=None, grid=None,
    fused=None,
):
    """One launch of the f64 pool scan (``engine`` ``"scan"`` or
    ``"temporal"``) on ``samples`` (``staged_dtypes(..., f64=True)``
    buffers: ``arr, warms, colds``, then ``fail_u`` with reliability,
    ``is_first, child_pos`` with retries and ``crash_u`` with crashes);
    ``t_exp``/``t_end``/``skip`` (and ``t_timeout``/``p_fail``) are scalars
    or per-row values, ``window_rows`` the ``[C, W+1]`` window bounds (a
    per-row input given as a tensor is taken as placed on ``device``),
    ``faults`` the per-row fault inputs (``crash_rate``, ``cap_edges``,
    ``cap_values``), ``pool`` an initial ``(alive, creation, busy)`` of
    ``[M]`` host arrays (default: empty) and ``grid`` the ``[G]`` snapshot
    times.  Routing, the histogram and the pool come from ``scn``.  With
    ``fused`` (:func:`~repro_torch.core.scenario.fused_state` with
    ``f64=True``) ``samples`` is empty and the kernel draws every sample.
    Returns the backend's :class:`~repro_torch.kernels.ref64.ScanOut`."""
    C = fused["keys"][0].shape[0] if fused is not None else samples[0].shape[0]
    M = scn.slots
    rows = lambda x: _f64_rows(x, C, device)
    if pool is None:
        alive0 = torch.zeros((C, M), dtype=torch.bool, device=device)
        creation0 = torch.full((C, M), NEG_INF, dtype=torch.float64, device=device)
        busy0 = creation0.clone()
    else:
        alive0, creation0, busy0 = (
            torch.as_tensor(np.asarray(x)).to(device).expand(C, M).contiguous() for x in pool
        )
    kw = dict(
        t_exp=rows(t_exp), t_end=rows(t_end), skip=rows(skip),
        max_concurrency=scn.max_concurrency, prestamped=prestamped, routing=scn.routing,
        hist_bins=scn.hist_bins if scn.track_histogram else 0,
    )
    mat = lambda a: a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a, np.float64), device=device).contiguous()
    if window_rows is not None:
        kw["window_bounds"] = mat(window_rows)
    if grid is not None:
        kw["grid_times"] = mat(np.tile(np.asarray(grid, np.float64), (C, 1)))
    faults = faults or {}
    if "crash_rate" in faults:
        kw.update(crash_rate=rows(faults["crash_rate"]), crash_u=samples[-1])
        samples = samples[:-1]
    if "cap_values" in faults:
        kw.update(cap_edges=mat(faults["cap_edges"]), cap_values=mat(faults["cap_values"]))
    if fused is not None:
        kw.update(fused_keys=fused["keys"], fused_params=fused["params"],
                  fused_dists=fused["dists"], fused_k=fused["n_steps"],
                  fused_fail_keys=fused["fail_keys"], fused_profile=fused["profile"])
        if t_timeout is not None:
            kw.update(t_timeout=rows(t_timeout), p_fail=rows(p_fail))
        return bspec.launch_for(engine)(alive0, creation0, busy0, None, None, None, **kw)
    if len(samples) > 3:
        kw.update(t_timeout=rows(t_timeout), p_fail=rows(p_fail), fail_u=samples[3])
    if len(samples) > 4:
        kw.update(is_first=samples[4], child_pos=samples[5])
    return bspec.launch_for(engine)(alive0, creation0, busy0, *samples[:3], **kw)


def scan_cell_summaries(acc, R: int, measured, layout, *, bounds=None, histogram=False,
                        faults=False, cls=SimulationSummary, **extra) -> list:
    """Per-cell summaries off an f64 launch's ``[cells * R, cols]`` host
    accumulator laid out by ``layout`` (a :class:`~repro_torch.kernels.
    ref64.ScanLayout`); ``measured[c]`` is cell c's measured time, and
    ``extra`` maps a summary field to its base column (the par engine's
    ``time_in_flight``).  ``faults`` reports the fault counters, zeros
    where the launch had no fault columns."""
    W = layout.W
    out = []
    for c in range(acc.shape[0] // R):
        cell = acc[c * R:(c + 1) * R]
        kw = {name: cell[:, col] for name, col in extra.items()}
        if W:
            w = cell[:, layout.win_at:layout.hist_at].reshape(R, 6, W)
            kw["windows"] = WindowedMetrics(
                bounds=np.asarray(bounds, np.float64),
                n_cold=w[:, 0], n_warm=w[:, 1], n_arrivals=w[:, 2],
                time_running=w[:, 3], time_idle=w[:, 4],
                n_fail=w[:, 5] if layout.rely else None,
            )
        if histogram:
            kw["histogram"] = cell[:, layout.hist_at:layout.grid_at]
        if layout.rely:
            r = layout.rely_at
            kw.update(n_timeout=cell[:, r], n_fail=cell[:, r + 1], n_retry=cell[:, r + 2],
                      n_abandon=cell[:, r + 3])
        if faults:
            f = layout.fault_at
            zeros = np.zeros((R,))
            kw.update(
                n_crash=cell[:, f] if layout.faults else zeros,
                n_evict=cell[:, f + 1] if layout.faults else zeros,
                n_interrupt=cell[:, f + 2] if layout.faults else zeros,
            )
        out.append(cls(
            n_cold=cell[:, 0], n_warm=cell[:, 1], n_reject=cell[:, 2],
            time_running=cell[:, 3], time_idle=cell[:, 4],
            sum_cold_resp=cell[:, 5], sum_warm_resp=cell[:, 6],
            lifespan_sum=cell[:, 7], lifespan_count=cell[:, 8],
            measured_time=float(measured[c]), overflow=cell[:, 9], **kw,
        ))
    return out


def scan_host(out, scn) -> tuple:
    """A single run's f64 launch output on the host, ``(acc, t_last)``,
    after the reference's guards: every row's stream reached ``sim_time``,
    and no arrival needed a slot beyond ``scn.slots``."""
    acc = out.acc.cpu().numpy()
    t_last = out.t.cpu().numpy()
    if (t_last < scn.sim_time).any():
        raise RuntimeError(
            "arrival stream ended before sim_time "
            f"(min final t {t_last.min():.1f} < {scn.sim_time}); "
            "pass a larger `steps`"
        )
    if acc[:, 9].sum() > 0:
        raise RuntimeError(
            f"instance-pool overflow ({int(acc[:, 9].sum())} arrivals "
            f"needed a slot beyond slots={scn.slots} while below "
            "max_concurrency); raise Scenario.slots"
        )
    return acc, t_last


def fault_rows(crashes: bool, crash_rate, profiles) -> dict:
    """A launch's per-row fault inputs: ``crash_rate`` (a scalar or
    ``[C]``) with crashes, ``cap_edges``/``cap_values`` matrices from the
    per-row :class:`~repro_torch.core.faults.CapacityProfile` list
    ``profiles`` (None: no capacity)."""
    out = {}
    if crashes:
        out["crash_rate"] = crash_rate
    if profiles is not None:
        out["cap_edges"] = np.asarray([p.edges for p in profiles], np.float64).reshape(
            len(profiles), len(profiles[0].edges))
        out["cap_values"] = np.asarray([p.values for p in profiles], np.float64)
    return out


def fault_inputs(scn, replicas: int) -> Optional[dict]:
    """A single run's per-row fault inputs (:func:`fault_rows`), None
    without a fault model that injects anything."""
    flt = scn.faults
    if flt is None or not flt.enabled:
        return None
    return fault_rows(flt.crashes, flt.crash_rate,
                      None if flt.capacity is None else [flt.capacity] * replicas)


def run_scan64(scn, seed: int, bspec, device, *, replicas: int, steps=None,
               staged=None, fused: bool = False, fused_keys=None) -> SimulationSummary:
    """The steady-state engine on the f64 scan: ``replicas`` rows from
    empty pools, one launch, with every layer of ``scn`` (reliability and
    retries, faults, routing, the histogram, metric windows).  With
    ``fused`` (the reference's ``_run_scan_fused``) the kernel draws
    ``steps`` (default ``steps_needed()``) events of gaps from the keys of
    ``seed`` (or ``fused_keys``), NHPP thinned inline, and the guards read
    its final clock."""
    from repro_torch.core.scenario import fused_state
    from repro_torch.kernels.ref64 import ScanLayout

    rel = scn.reliability
    state = None
    if fused:
        if scn.faults is not None and scn.faults.enabled:
            raise ValueError(
                "draws='fused' does not serve platform faults (the crash stream is "
                "host-staged); use draws='staged'"
            )
        n = int(steps or scn.steps_needed())
        state = fused_state([scn], seed, replicas, n, device, fused_keys=fused_keys, f64=True)
        samples = ()
    else:
        samples = run_samples(scn, seed, replicas, steps, staged, device, f64=True)
    fi = fault_inputs(scn, replicas)
    W = 0 if scn.window_bounds is None else len(scn.window_bounds) - 1
    out = scan_launch(
        scn, bspec, device, samples, t_exp=scn.expiration_threshold, t_end=scn.sim_time,
        skip=scn.skip_time, fused=state,
        prestamped=not fused and (scn.prestamped or scn.max_retries > 0),
        window_rows=None if not W else np.tile(scn.window_bounds, (replicas, 1)),
        t_timeout=None if rel is None else rel.failure.timeout_or_inf,
        p_fail=None if rel is None else rel.failure.p_fail, faults=fi,
    )
    acc, _ = scan_host(out, scn)
    layout = ScanLayout(W=W, H=scn.hist_bins if scn.track_histogram else 0,
                        rely=rel is not None, faults=fi is not None)
    return scan_cell_summaries(
        acc, replicas, [scn.sim_time - scn.skip_time], layout, bounds=scn.window_bounds,
        histogram=scn.track_histogram, faults=scn.faults is not None,
    )[0]


class ServerlessSimulator:
    """Steady-state scale-per-request simulator on the f64 engine (paper
    §3, §4.1): the reference's ``ServerlessSimulator``.

    >>> sim = ServerlessSimulator(Scenario(...))
    >>> summary = sim.run(0, replicas=8)
    >>> summary.cold_start_prob

    ``backend`` is ``"scan"`` (the kernel; the default on a CUDA device)
    or ``"scan_ref"`` (its plain f64 version; the default on the CPU).
    Prefer the front door :func:`repro_torch.core.scenario.run`, which
    wraps this engine and adds costing.
    """

    def __init__(self, config, *, device=None, backend: Optional[str] = None):
        self.config = config
        self.bspec, self.device = scan_backend("scan", backend, device)

    @classmethod
    def from_rates(cls, arrival_rate: float, warm_service_time: float,
                   cold_service_time: float, expiration_threshold: float = 600.0,
                   sim_time: float = 1e5, *, device=None, backend=None,
                   **kw) -> "ServerlessSimulator":
        """Paper-style constructor (exponential processes, Table 1)."""
        from repro_torch.core.processes import ExpSimProcess
        from repro_torch.core.scenario import Scenario

        cfg = Scenario(
            arrival_process=ExpSimProcess(rate=arrival_rate),
            warm_service_process=ExpSimProcess(rate=1.0 / warm_service_time),
            cold_service_process=ExpSimProcess(rate=1.0 / cold_service_time),
            expiration_threshold=expiration_threshold,
            sim_time=sim_time,
            **kw,
        )
        return cls(cfg, device=device, backend=backend)

    def draw_samples(self, seed: int, replicas: int, steps: Optional[int] = None) -> tuple:
        """The staged buffers a run of ``seed`` draws (the f64 engine's
        dtypes), to hand back in as ``staged=``."""
        return run_samples(self.config, seed, replicas, steps, None, self.device, f64=True)

    def run(self, seed: int, replicas: int = 8, steps: Optional[int] = None,
            staged=None) -> SimulationSummary:
        """``replicas`` replicas of ``steps`` events (default
        ``steps_needed()``) drawn from ``seed``, or the ``staged`` buffers
        (:func:`repro_torch.interop.staged_from_reference` with
        ``f64=True`` carries the reference's own)."""
        return run_scan64(self.config, seed, self.bspec, self.device, replicas=replicas,
                          steps=steps, staged=staged)
