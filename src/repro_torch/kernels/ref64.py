"""Plain f64 PyTorch versions of the f64 engine's kernels (backend ``"scan_ref"``).

:func:`scan_sweep_ref` is the reference's f64 ``lax.scan`` step
(``repro/core/simulator.py::_make_scan_fn`` and ``_flush``) as a loop over
events of ``[R, M]`` tensor ops, one row per replica (or grid cell), with
every optional path of that step: routing to the newest or the oldest idle
instance, the reliability layer and client retries (the activation plane),
instance crashes and capacity churn, the instance-count histogram, metric
windows, prestamped f64 timestamps, and the temporal engine's grid
snapshots from an initial pool (``repro/core/temporal.py:79-140``).
:func:`par_scan_sweep_ref` is ``repro/core/par_simulator.py::_par_scan_fn``
with its tail flush: the concurrency-value platform's ``finish[M, c]``
pool, with the histogram, reliability and retries.

Each decision is the reference's, with its tie rules (``argmax`` takes the
lowest slot among equal priorities), and each clock and integral piece is
one rounded f64 operation as there; only the order in which a row's pieces
are summed differs.  The hand-written kernels
(``kernels/csrc/scan_event_step.cu``, ``par_scan_event_step.cu``) are
held to these on the card; on the CPU the ``"scan"`` wrappers run them.

Accumulators are one f64 ``[R, cols]`` matrix per launch, laid out by
:class:`ScanLayout`: the base columns (:data:`SCAN_COLS`: cold, warm,
reject, ∫running, ∫idle, Σcold response, Σwarm response, Σlifespan,
lifespans, overflow; the par engine adds ∫in-flight), then the
reliability columns (timeouts, failures, retries, abandons), the fault
columns (crashes, evictions, interrupted attempts), ``6W`` window columns
(per window: cold, warm, arrivals, ∫running, ∫idle, failures), ``H``
histogram bins and ``4G`` grid columns (per grid point: running, idle,
the no-idle indicator and whether an interval held it).  Counters are
exact in f64.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core.execution import register_backend
from repro_torch.core.reliability import NO_CHILD
from repro_torch.core.simulator import (
    NEG_INF,
    fault_interval_integrals,
    histogram_update,
    interval_integrals,
    window_integrals,
)

F64 = torch.float64
# base accumulator columns of the pool scan; the par scan adds ∫in-flight
SCAN_COLS = 10
PAR_SCAN_COLS = 11
RELY64_COLS = 4
FAULT64_COLS = 3
WINDOW64_COLS = 6
GRID64_COLS = 4
ROUTINGS = ("newest", "oldest")


@dataclasses.dataclass(frozen=True)
class ScanLayout:
    """Column offsets of an f64 engine accumulator (module docstring)."""

    W: int = 0  # metric windows
    H: int = 0  # histogram bins (0: no histogram)
    G: int = 0  # grid points (0: no grid snapshots)
    rely: bool = False
    faults: bool = False
    par: bool = False

    @property
    def base(self) -> int:
        return PAR_SCAN_COLS if self.par else SCAN_COLS

    @property
    def rely_at(self) -> int:
        return self.base

    @property
    def fault_at(self) -> int:
        return self.rely_at + (RELY64_COLS if self.rely else 0)

    @property
    def win_at(self) -> int:
        return self.fault_at + (FAULT64_COLS if self.faults else 0)

    @property
    def hist_at(self) -> int:
        return self.win_at + WINDOW64_COLS * self.W

    @property
    def grid_at(self) -> int:
        return self.hist_at + self.H

    @property
    def cols(self) -> int:
        return self.grid_at + GRID64_COLS * self.G

    @property
    def float_cols(self) -> list:
        """The columns that sum f64 pieces over slots (∫running, ∫idle,
        Σlifespan, ∫in-flight, the window integrals, the histogram bins):
        a kernel may add them in another order than the plain version, so
        they agree to rounding; every other column is a count or a sum in
        event order, equal bit for bit."""
        cols = [3, 4, 7] + ([10] if self.par else [])
        cols += [self.win_at + j * self.W + w for j in (3, 4) for w in range(self.W)]
        return cols + list(range(self.hist_at, self.grid_at))


class ScanOut(NamedTuple):
    """What :func:`scan_sweep_ref` and the kernel's wrapper return: the
    final pool and clock (after the tail flush, which changes neither),
    the accumulator, and the planes of the optional paths, None where the
    path is off."""

    alive: torch.Tensor  # bool [R, M]
    creation: torch.Tensor  # f64 [R, M]
    busy: torch.Tensor  # f64 [R, M]
    t: torch.Tensor  # f64 [R] the last event's clock
    acc: torch.Tensor  # f64 [R, cols]
    act: Optional[torch.Tensor] = None  # bool [R, K] activation plane (retries)
    doom: Optional[torch.Tensor] = None  # f64 [R, M] crash clocks (crashes)


class ParScanOut(NamedTuple):
    """What :func:`par_scan_sweep_ref` and the kernel's wrapper return."""

    alive: torch.Tensor  # bool [R, M]
    creation: torch.Tensor  # f64 [R, M]
    finish: torch.Tensor  # f64 [R, M, c] request finish times
    t: torch.Tensor  # f64 [R]
    acc: torch.Tensor  # f64 [R, cols]
    act: Optional[torch.Tensor] = None  # bool [R, K] (retries)


def _col(x, R, device):
    """A per-row f64 ``[R]`` vector from a scalar or an ``[R]`` tensor."""
    return torch.as_tensor(x, dtype=F64, device=device).expand(R).contiguous()


def _lifetimes(crash_u, crash_rate):
    """Exp(``crash_rate``) lifetimes ``-log(1 - u) / rate`` in f64, +inf
    where the rate is 0 (the reference's 0/0 at u = 0 would give NaN)."""
    life = -torch.log(1.0 - crash_u.to(F64)) / crash_rate
    return torch.where(crash_rate > 0, life, torch.inf)


def _grid_counts(alive, busy, te, grid):
    """Running and idle instances at each grid point ``[R, G]`` of the pool
    ``[R, M]``: live means ``busy + T_exp > g``."""
    g = grid[:, :, None]
    live = alive[:, None, :] & ((busy + te)[:, None, :] > g)
    run = (live & (busy[:, None, :] > g)).sum(-1)
    idle = (live & (busy[:, None, :] <= g)).sum(-1)
    return run, idle


def _switch_on(act, on, child):
    """``act[r, child[r]] = True`` where ``on[r]``, as a scatter of one
    position a row (no host read-back, so it can sit in a CUDA graph)."""
    idx = torch.where(on, child, 0)[:, None]
    act.scatter_(1, idx, act.gather(1, idx) | on[:, None])


def check_scan_inputs(layout_kw: dict) -> None:
    """The optional inputs' structure, as both f64 wrappers check it on
    any device: pairs that come together, and a known routing."""
    kw = layout_kw
    if kw.get("routing", "newest") not in ROUTINGS:
        raise ValueError(f"routing must be one of {ROUTINGS}, got {kw['routing']!r}")
    rely = [kw.get(n) is None for n in ("t_timeout", "p_fail", "fail_u")]
    if len(set(rely)) > 1:
        raise ValueError("t_timeout, p_fail and fail_u come together (reliability)")
    if (kw.get("is_first") is None) != (kw.get("child_pos") is None):
        raise ValueError("is_first and child_pos come together (retries)")
    if kw.get("is_first") is not None and rely[0]:
        raise ValueError("retries need the reliability inputs t_timeout, p_fail, fail_u")
    if (kw.get("crash_rate") is None) != (kw.get("crash_u") is None):
        raise ValueError("crash_rate and crash_u come together (crashes)")
    if (kw.get("cap_edges") is None) != (kw.get("cap_values") is None):
        raise ValueError("cap_edges and cap_values come together (capacity)")
    wb = kw.get("window_bounds")
    if wb is not None and wb.shape[-1] > 1 and not bool((wb[:, 1:] > wb[:, :-1]).all()):
        raise ValueError("window_bounds must be strictly increasing in every row")


def scan_sweep_ref(
    alive,  # bool [R, M]
    creation,  # f64 [R, M]
    busy,  # f64 [R, M]
    arr,  # f32 [R, K] gaps, or f64 [R, K] absolute times if prestamped
    warms,  # f32 [R, K]
    colds,  # f32 [R, K]
    *,
    t_exp,  # f64 [R] or scalar
    t_end,  # f64 [R] or scalar — horizon
    skip,  # f64 [R] or scalar — warm-up exclusion
    max_concurrency: int,
    prestamped: bool = False,
    routing: str = "newest",
    doom=None,  # f64 [R, M] initial crash clocks (default +inf; crashes)
    hist_bins: int = 0,  # instance-count histogram bins (0: none)
    window_bounds=None,  # f64 [R, W+1]
    grid_times=None,  # f64 [R, G] snapshot times (the temporal engine)
    t_timeout=None,  # f64 [R] or scalar (reliability)
    p_fail=None,  # f64 [R] or scalar (reliability)
    fail_u=None,  # f32 [R, K] (reliability)
    is_first=None,  # bool [R, K] (retries)
    child_pos=None,  # int32 [R, K] (retries; NO_CHILD for a last attempt)
    crash_rate=None,  # f64 [R] or scalar (crashes)
    crash_u=None,  # f32 [R, K] (crashes)
    cap_edges=None,  # f64 [R, E] capacity step times (capacity churn)
    cap_values=None,  # f64 [R, E+1] ceilings (capacity churn)
    state0: Optional[ScanOut] = None,  # a chunk's return value to continue
    first_event=0,  # position of arr[:, 0] in the run (int or int64 tensor)
    events: Optional[int] = None,  # events in the whole run (default K)
    flush: bool = True,  # False: stop after the last event, no tail flush
) -> ScanOut:
    """Run K events against each row's ``[M]`` pool from clock 0, then
    flush the tail ``(t_last, t_end]``: the reference's f64 scan step, row
    by row (module docstring).  Returns a :class:`ScanOut` whose ``acc`` is
    laid out by ``ScanLayout(W, hist_bins, G, reliability, faults)``.
    ``cap_values[searchsorted(cap_edges, t, "right")]`` is the ceiling in
    effect at ``t``.

    A run may be split into chunks of events: each chunk but the last
    passes ``flush=False``, the next continues from its return value
    (``state0``: the pool, crash clocks, clock, accumulator and activation
    plane; the positional pool and ``doom`` are then not read) with
    ``first_event`` the position of its first event in the run, which the
    activation plane's ``child_pos`` refer to (the first chunk sizes that
    plane by ``events``).  Every piece is added in the order one call adds
    it, so the chunks equal one call bit for bit.  A continuation reads no
    value back to the host (no input checks, no data-dependent indexing),
    so a chunk can be captured in a CUDA graph and replayed."""
    if state0 is None:
        check_scan_inputs(dict(routing=routing, t_timeout=t_timeout, p_fail=p_fail,
                               fail_u=fail_u, is_first=is_first, child_pos=child_pos,
                               crash_rate=crash_rate, crash_u=crash_u, cap_edges=cap_edges,
                               cap_values=cap_values, window_bounds=window_bounds))
    else:
        alive, creation, busy, doom = state0.alive, state0.creation, state0.busy, state0.doom
    R, M = alive.shape
    K = arr.shape[1]
    dev = alive.device
    rely, retries = t_timeout is not None, is_first is not None
    crashes, capped = crash_u is not None, cap_values is not None
    W = 0 if window_bounds is None else window_bounds.shape[1] - 1
    G = 0 if grid_times is None else grid_times.shape[1]
    H = int(hist_bins)
    lay = ScanLayout(W=W, H=H, G=G, rely=rely, faults=crashes or capped)
    te, tend, skp = (_col(x, R, dev) for x in (t_exp, t_end, skip))
    te1, tend1, skp1 = te[:, None], tend[:, None], skp[:, None]
    alive = alive.to(torch.bool).clone()
    creation = creation.to(F64).clone()
    busy = busy.to(F64).clone()
    if crashes:
        doom = (torch.full((R, M), torch.inf, dtype=F64, device=dev) if doom is None
                else doom.to(F64).clone())
        crate = _col(crash_rate, R, dev)
    if rely:
        t_to, p_f = _col(t_timeout, R, dev), _col(p_fail, R, dev)
    if capped:
        cap_e, cap_v = cap_edges.to(F64), cap_values.to(F64)
    if state0 is None:
        acc = torch.zeros((R, lay.cols), dtype=F64, device=dev)
        act = (torch.zeros((R, K if events is None else int(events)), dtype=torch.bool,
                           device=dev) if retries else None)
        t_prev = torch.zeros((R,), dtype=F64, device=dev)
    else:
        acc = state0.acc.clone()
        act = state0.act.clone() if retries else None
        t_prev = state0.t
    base = acc[:, :SCAN_COLS]
    hist = acc[:, lay.hist_at:lay.grid_at]
    if retries:
        k0 = torch.as_tensor(first_event, dtype=torch.int64, device=dev).reshape(1, 1)
        K_all = act.shape[1]
    if G:
        grid = grid_times.to(F64)
        g_run = acc[:, lay.grid_at:lay.grid_at + G]
        g_idle = acc[:, lay.grid_at + G:lay.grid_at + 2 * G]
        # 0/1 columns: no idle instance at a point, and an interval held it
        no_idle = acc[:, lay.grid_at + 2 * G:lay.grid_at + 3 * G]
        seen = acc[:, lay.grid_at + 3 * G:]
    if W:
        wb = window_bounds.to(F64)
        wcols = acc[:, lay.win_at:lay.hist_at].view(R, WINDOW64_COLS, W)
        w_ids = torch.arange(W, device=dev)
    slot_ids = torch.arange(M, device=dev)
    newest = routing == "newest"
    for k in range(K):
        t = arr[:, k].to(F64) if prestamped else t_prev + arr[:, k].to(F64)
        t1 = t[:, None]
        if G:
            # snapshots of the pre-event pool at the grid points inside
            # (t_prev, min(t, t_end)]
            in_win = (grid > t_prev[:, None]) & (grid <= torch.minimum(t, tend)[:, None])
            run_g, idle_g = _grid_counts(alive, busy, te1, grid)
            g_run += torch.where(in_win, run_g, 0)
            g_idle += torch.where(in_win, idle_g, 0)
            no_idle.masked_fill_(in_win & (idle_g == 0), 1.0)
            seen.masked_fill_(in_win, 1.0)
        lo = torch.minimum(torch.maximum(t_prev, skp), tend)[:, None]
        hi = torch.minimum(torch.maximum(t, skp), tend)[:, None]
        if crashes:
            run_t, idle_t = fault_interval_integrals(alive, busy, te1, doom, lo, hi)
        else:
            run_t, idle_t = interval_integrals(alive, busy, te1, lo, hi)
        base[:, 3] += run_t
        base[:, 4] += idle_t
        if W:
            run_w, idle_w = window_integrals(wb, alive, busy, te, torch.minimum(t_prev, tend),
                                             torch.minimum(t, tend))
            wcols[:, 3] += run_w
            wcols[:, 4] += idle_w
        if H:
            histogram_update(hist, alive, busy, te1, lo, hi)

        # ---- exits at or before the event
        expire = busy + te1
        if crashes:
            exit_t = torch.minimum(expire, doom)
            exited = alive & (exit_t <= t1)
            acc[:, lay.fault_at] += (exited & (doom < expire) & (doom > skp1)
                                     & (doom <= tend1)).sum(-1)
        else:
            exit_t = expire
            exited = alive & (expire <= t1)
        life_ok = exited & (exit_t > skp1) & (exit_t <= tend1)
        base[:, 7] += torch.where(life_ok, exit_t - creation, 0.0).sum(-1)
        base[:, 8] += life_ok.sum(-1)
        alive &= ~exited

        # ---- capacity churn: evict the newest idle instances over the ceiling
        if capped:
            seg = (cap_e <= t1).sum(-1, keepdim=True)
            cap_now = cap_v.gather(1, seg)[:, 0]
            idle_now = alive & (busy <= t1)
            over = alive.sum(-1).to(F64) - cap_now
            cre_a, cre_b = creation[:, :, None], creation[:, None, :]
            newer = (cre_b > cre_a) | ((cre_b == cre_a) & (slot_ids[None, :] < slot_ids[:, None]))
            rank = (idle_now[:, None, :] & newer).sum(-1)
            evict = idle_now & (rank.to(F64) < over[:, None]) & (t <= tend)[:, None]
            evict_ok = evict & (t > skp)[:, None]
            acc[:, lay.fault_at + 1] += evict_ok.sum(-1)
            base[:, 7] += torch.where(evict_ok, t1 - creation, 0.0).sum(-1)
            base[:, 8] += evict_ok.sum(-1)
            alive &= ~evict

        # ---- routing
        active = t <= tend
        if retries:
            active &= is_first[:, k] | act.gather(1, (k0 + k).expand(R, 1))[:, 0]
        idle_mask = alive & (busy <= t1)
        any_idle = idle_mask.any(-1)
        prio = creation if newest else -creation
        warm_idx = torch.argmax(torch.where(idle_mask, prio, NEG_INF), dim=-1)
        free = ~alive
        any_free = free.any(-1)
        free_idx = torch.argmax(free.to(torch.uint8), dim=-1)
        n_alive = alive.sum(-1)
        below = n_alive < max_concurrency
        can_cold = ~any_idle & below & any_free
        if capped:
            can_cold &= n_alive.to(F64) < cap_now
        is_warm = any_idle & active
        is_cold = can_cold & active
        is_reject = ~any_idle & ~can_cold & active
        chosen = torch.where(is_warm, warm_idx, free_idx)[:, None]
        warm_s, cold_s = warms[:, k].to(F64), colds[:, k].to(F64)
        service = torch.where(is_warm, warm_s, cold_s)
        assign = is_warm | is_cold
        occupancy = torch.minimum(service, t_to) if rely else service
        finish = t + occupancy
        busy.scatter_(1, chosen, torch.where(assign, finish, busy.gather(1, chosen)[:, 0])[:, None])
        creation.scatter_(1, chosen, torch.where(is_cold, t, creation.gather(1, chosen)[:, 0])[:, None])
        alive.scatter_(1, chosen, (alive.gather(1, chosen)[:, 0] | is_cold)[:, None])
        if crashes:
            life = _lifetimes(crash_u[:, k], crate)
            doom_c = torch.where(is_cold, t + life, doom.gather(1, chosen)[:, 0])
            doom.scatter_(1, chosen, doom_c[:, None])

        counted = t > skp
        base[:, 0] += is_cold & counted
        base[:, 1] += is_warm & counted
        base[:, 2] += is_reject & counted
        base[:, 9] += ~any_idle & below & ~any_free & active
        if rely:
            timed_out = assign & (service > t_to)
            failed = assign & ~timed_out & (fail_u[:, k].to(F64) < p_f)
            trigger = timed_out | failed | is_reject
            if crashes:
                interrupted = assign & ~timed_out & ~failed & (doom_c < finish)
                trigger |= interrupted
            cold_r, warm_r = torch.minimum(cold_s, t_to), torch.minimum(warm_s, t_to)
        else:
            if crashes:
                interrupted = assign & (doom_c < finish)
            cold_r, warm_r = cold_s, warm_s
        base[:, 5] += torch.where(is_cold & counted, cold_r, 0.0)
        base[:, 6] += torch.where(is_warm & counted, warm_r, 0.0)
        if crashes:
            acc[:, lay.fault_at + 2] += interrupted & counted
        if rely:
            r = lay.rely_at
            acc[:, r] += timed_out & counted
            acc[:, r + 1] += failed & counted
            if retries:
                child = child_pos[:, k].to(torch.int64)
                acc[:, r + 2] += ~is_first[:, k] & active & counted
                acc[:, r + 3] += trigger & (child >= NO_CHILD) & counted
                _switch_on(act, trigger & (child >= 0) & (child < K_all), child)
            else:
                acc[:, r + 3] += trigger & counted
        if W:
            w_idx = (wb <= t1).sum(-1, keepdim=True) - 1
            onehot = (w_ids[None, :] == w_idx) & active[:, None]
            wcols[:, 0] += onehot & is_cold[:, None]
            wcols[:, 1] += onehot & is_warm[:, None]
            wcols[:, 2] += onehot
            if rely:
                wcols[:, 5] += onehot & (timed_out | failed)[:, None]
        t_prev = t

    if not flush:
        return ScanOut(alive, creation, busy, t_prev, acc, act, doom if crashes else None)
    # ---- grid points after the last event
    if G:
        tail = (grid > t_prev[:, None]) & (grid <= tend1) & (seen == 0)
        run_g, idle_g = _grid_counts(alive, busy, te1, grid)
        g_run += torch.where(tail, run_g, 0)
        g_idle += torch.where(tail, idle_g, 0)
        no_idle.masked_fill_(tail & (idle_g == 0), 1.0)
        seen.masked_fill_(tail, 1.0)
    # ---- the tail flush (t_last, t_end]
    lo = torch.minimum(torch.maximum(t_prev, skp), tend)[:, None]
    if crashes:
        run_t, idle_t = fault_interval_integrals(alive, busy, te1, doom, lo, tend1)
    else:
        run_t, idle_t = interval_integrals(alive, busy, te1, lo, tend1)
    base[:, 3] += run_t
    base[:, 4] += idle_t
    if W:
        run_w, idle_w = window_integrals(wb, alive, busy, te, torch.minimum(t_prev, tend), tend)
        wcols[:, 3] += run_w
        wcols[:, 4] += idle_w
    if H:
        histogram_update(hist, alive, busy, te1, lo, tend1)
    expire = busy + te1
    exit_t = torch.minimum(expire, doom) if crashes else expire
    tail_exp = alive & (exit_t <= tend1) & (exit_t > skp1)
    base[:, 7] += torch.where(tail_exp, exit_t - creation, 0.0).sum(-1)
    base[:, 8] += tail_exp.sum(-1)
    if crashes:
        acc[:, lay.fault_at] += (tail_exp & (doom < expire)).sum(-1)
    return ScanOut(alive, creation, busy, t_prev, acc, act, doom if crashes else None)


def par_scan_sweep_ref(
    arr,  # f32 [R, K] gaps, or f64 [R, K] absolute times if prestamped
    warms,  # f32 [R, K]
    colds,  # f32 [R, K]
    *,
    t_exp,
    t_end,
    skip,
    max_concurrency: int,
    concurrency: int,
    slots: int,
    prestamped: bool = False,
    hist_bins: int = 0,
    t_timeout=None,
    p_fail=None,
    fail_u=None,
    is_first=None,
    child_pos=None,
    state0: Optional[ParScanOut] = None,  # a chunk's return value to continue
    first_event=0,  # position of arr[:, 0] in the run (int or int64 tensor)
    events: Optional[int] = None,  # events in the whole run (default K)
    flush: bool = True,  # False: stop after the last event, no tail flush
) -> ParScanOut:
    """The concurrency-value platform's f64 scan (``_par_scan_fn``) over K
    events from an empty pool of ``slots`` instances with ``concurrency``
    request sub-slots each, then its tail flush.  Routing takes the newest
    instance with a finished sub-slot (lowest slot on a tie), the request
    the instance's first finished sub-slot; a cold start wipes the reused
    row first.  ``acc`` is laid out by ``ScanLayout(H=hist_bins,
    rely=reliability, par=True)``.  ``state0``, ``first_event``,
    ``events`` and ``flush`` split a run into chunks that equal one call
    bit for bit, as :func:`scan_sweep_ref`'s do."""
    if state0 is None:
        check_scan_inputs(dict(t_timeout=t_timeout, p_fail=p_fail, fail_u=fail_u,
                               is_first=is_first, child_pos=child_pos))
    R, K = arr.shape
    M, c = int(slots), int(concurrency)
    dev = arr.device
    rely, retries = t_timeout is not None, is_first is not None
    H = int(hist_bins)
    lay = ScanLayout(H=H, rely=rely, par=True)
    te, tend, skp = (_col(x, R, dev) for x in (t_exp, t_end, skip))
    te1, tend1, skp1 = te[:, None], tend[:, None], skp[:, None]
    if rely:
        t_to, p_f = _col(t_timeout, R, dev), _col(p_fail, R, dev)
    if state0 is None:
        alive = torch.zeros((R, M), dtype=torch.bool, device=dev)
        creation = torch.full((R, M), NEG_INF, dtype=F64, device=dev)
        finish = torch.full((R, M, c), NEG_INF, dtype=F64, device=dev)
        acc = torch.zeros((R, lay.cols), dtype=F64, device=dev)
        act = (torch.zeros((R, K if events is None else int(events)), dtype=torch.bool,
                           device=dev) if retries else None)
        t_prev = torch.zeros((R,), dtype=F64, device=dev)
    else:
        alive, creation, finish, t_prev, acc = (x.clone() for x in state0[:5])
        act = state0.act.clone() if retries else None
    base = acc[:, :PAR_SCAN_COLS]
    hist = acc[:, lay.hist_at:lay.grid_at]
    if retries:
        k0 = torch.as_tensor(first_event, dtype=torch.int64, device=dev).reshape(1, 1)
        K_all = act.shape[1]
    rows = torch.arange(R, device=dev)

    def in_flight(lo, hi):
        part = (torch.minimum(finish, hi[:, :, None]) - lo[:, :, None]).clamp_min(0.0)
        return torch.where(alive[:, :, None], part, 0.0).sum((-1, -2))

    for k in range(K):
        t = arr[:, k].to(F64) if prestamped else t_prev + arr[:, k].to(F64)
        t1 = t[:, None]
        busy = finish.amax(-1)
        lo = torch.minimum(torch.maximum(t_prev, skp), tend)[:, None]
        hi = torch.minimum(torch.maximum(t, skp), tend)[:, None]
        run_t, idle_t = interval_integrals(alive, busy, te1, lo, hi)
        base[:, 3] += run_t
        base[:, 4] += idle_t
        base[:, 10] += in_flight(lo, hi)
        if H:
            histogram_update(hist, alive, busy, te1, lo, hi)
        expire = busy + te1
        exited = alive & (expire <= t1)
        life_ok = exited & (expire > skp1) & (expire <= tend1)
        base[:, 7] += torch.where(life_ok, expire - creation, 0.0).sum(-1)
        base[:, 8] += life_ok.sum(-1)
        alive &= ~exited

        active = t <= tend
        if retries:
            active &= is_first[:, k] | act.gather(1, (k0 + k).expand(R, 1))[:, 0]
        has_cap = alive & ((finish > t1[:, :, None]).sum(-1) < c)
        any_cap = has_cap.any(-1)
        warm_idx = torch.argmax(torch.where(has_cap, creation, NEG_INF), dim=-1)
        free = ~alive
        any_free = free.any(-1)
        free_idx = torch.argmax(free.to(torch.uint8), dim=-1)
        below = alive.sum(-1) < max_concurrency
        can_cold = ~any_cap & below & any_free
        is_warm = any_cap & active
        is_cold = can_cold & active
        is_reject = ~any_cap & ~can_cold & active
        inst = torch.where(is_warm, warm_idx, free_idx)
        row = finish[rows, inst]  # [R, c], before a cold start wipes it
        sub = torch.argmax((row <= t1).to(torch.uint8), dim=-1)
        warm_s, cold_s = warms[:, k].to(F64), colds[:, k].to(F64)
        service = torch.where(is_warm, warm_s, cold_s)
        assign = is_warm | is_cold
        occupancy = torch.minimum(service, t_to) if rely else service
        wiped = torch.where(is_cold[:, None], NEG_INF, row)
        wiped[rows, sub] = torch.where(assign, t + occupancy, wiped[rows, sub])
        finish[rows, inst] = wiped
        creation[rows, inst] = torch.where(is_cold, t, creation[rows, inst])
        alive[rows, inst] |= is_cold

        counted = t > skp
        base[:, 0] += is_cold & counted
        base[:, 1] += is_warm & counted
        base[:, 2] += is_reject & counted
        base[:, 9] += ~any_cap & below & ~any_free & active
        if rely:
            timed_out = assign & (service > t_to)
            failed = assign & ~timed_out & (fail_u[:, k].to(F64) < p_f)
            trigger = timed_out | failed | is_reject
            cold_r, warm_r = torch.minimum(cold_s, t_to), torch.minimum(warm_s, t_to)
        else:
            cold_r, warm_r = cold_s, warm_s
        base[:, 5] += torch.where(is_cold & counted, cold_r, 0.0)
        base[:, 6] += torch.where(is_warm & counted, warm_r, 0.0)
        if rely:
            r = lay.rely_at
            acc[:, r] += timed_out & counted
            acc[:, r + 1] += failed & counted
            if retries:
                child = child_pos[:, k].to(torch.int64)
                acc[:, r + 2] += ~is_first[:, k] & active & counted
                acc[:, r + 3] += trigger & (child >= NO_CHILD) & counted
                _switch_on(act, trigger & (child >= 0) & (child < K_all), child)
            else:
                acc[:, r + 3] += trigger & counted
        t_prev = t

    if not flush:
        return ParScanOut(alive, creation, finish, t_prev, acc, act)
    busy = finish.amax(-1)
    lo = torch.minimum(torch.maximum(t_prev, skp), tend)[:, None]
    run_t, idle_t = interval_integrals(alive, busy, te1, lo, tend1)
    base[:, 3] += run_t
    base[:, 4] += idle_t
    base[:, 10] += in_flight(lo, tend1)
    if H:
        histogram_update(hist, alive, busy, te1, lo, tend1)
    expire = busy + te1
    tail_exp = alive & (expire <= tend1) & (expire > skp1)
    base[:, 7] += torch.where(tail_exp, expire - creation, 0.0).sum(-1)
    base[:, 8] += tail_exp.sum(-1)
    return ParScanOut(alive, creation, finish, t_prev, acc, act)


@register_backend(
    "scan_ref",
    description="plain f64 PyTorch loops over events (the f64 kernels' mirrors)",
    engines=("scan", "temporal"),
    f64=True,
)
def _scan_ref_rows(alive0, creation0, busy0, arr, warms, colds, **kw) -> ScanOut:
    """Backend ``"scan_ref"``'s pool-state launcher (``kw`` as
    :func:`scan_sweep_ref` takes them)."""
    return scan_sweep_ref(alive0, creation0, busy0, arr, warms, colds, **kw)


@register_backend("scan_ref", engines=("par",), f64=True)
def _par_scan_ref_rows(arr, warms, colds, **kw) -> ParScanOut:
    """Backend ``"scan_ref"``'s par launcher."""
    return par_scan_sweep_ref(arr, warms, colds, **kw)
