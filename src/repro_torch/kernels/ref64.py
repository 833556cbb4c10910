"""Plain f64 PyTorch versions of the f64 engine's kernels (backend ``"scan_ref"``).

:func:`scan_sweep_ref` is the reference's f64 ``lax.scan`` step
(``repro/core/simulator.py::_make_scan_fn`` and ``_flush``) as a loop over
events of ``[R, M]`` tensor ops, one row per replica (or grid cell), with
every optional path of that step: routing to the newest or the oldest idle
instance, the reliability layer and client retries (the activation plane),
instance crashes and capacity churn, the instance-count histogram, metric
windows, prestamped f64 timestamps, and the temporal engine's grid
snapshots from an initial pool (``repro/core/temporal.py:79-140``), and
fused draws (``_scan_one_fused``, ``repro/core/simulator.py:1008-1166``):
each event's samples drawn from per-row threefry keys in f64, with inline
NHPP thinning.
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

from repro_torch.core import drawplan as dp
from repro_torch.core.execution import register_backend
from repro_torch.core.processes import block_rate
from repro_torch.core.reliability import NO_CHILD
from repro_torch.core.simulator import (
    NEG_INF,
    fault_interval_integrals,
    guard,
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


class _FusedEvents:
    """The fused draws of a run (``_fused_event_xs``): event ``i``'s f64
    gap, warm and cold samples, the f32 acceptance uniform (NHPP) and the
    f32 failure uniform, from per-row threefry keys; the uniforms of
    ``DRAW_BLOCK`` events are drawn together from the counter ``first +
    k`` (an int or an int64 tensor, so a chunk can sit in a CUDA graph),
    the transforms run one contiguous ``[R]`` column an event."""

    def __init__(self, keys, params, dists, fail_keys, first, K):
        self.keys = [dp.words(k) for k in keys]
        self.fail = None if fail_keys is None else dp.words(fail_keys)
        self.params = [dp.param_rows(p, self.keys[0].shape[0], self.keys[0].device, F64)
                       for p in params]
        self.dists = tuple(dists)
        self.nhpp = self.dists[0] == dp.NHPP
        self.first, self.K = first, K
        self._start, self._u = None, None

    def _block(self, k):
        start = k - k % dp.DRAW_BLOCK
        if start != self._start:
            n = min(dp.DRAW_BLOCK, self.K - start)
            dev = self.keys[0].device
            idx = torch.as_tensor(self.first, dtype=torch.int64, device=dev).reshape(1, 1) \
                + torch.arange(start, start + n, dtype=torch.int64, device=dev)[None, :]
            idx = idx & 0xFFFFFFFF
            keys = self.keys + ([self.fail] if self.fail is not None else [])
            self._start = start
            self._u = [dp.event_uniforms(kk[:, :1], kk[:, 1:], idx) for kk in keys]
        return k - start

    def take(self, k):
        """``(dt, warm, cold, u_acc, fail_u)`` of event ``k`` of the call;
        u_acc None without NHPP, fail_u None without the failure stream."""
        j = self._block(k)
        col = [(u0[:, j].contiguous(), u1[:, j].contiguous()) for u0, u1 in self._u]
        a_kind = "exp" if self.nhpp else self.dists[0]
        xs = [dp.sample_dist(kind, u0, u1, p0, p1) for kind, (u0, u1), (p0, p1)
              in zip((a_kind,) + self.dists[1:], col[:3], self.params)]
        u_acc = col[0][1] if self.nhpp else None
        fail_u = col[3][0] if self.fail is not None else None
        return xs[0], xs[1], xs[2], u_acc, fail_u


def check_fused_inputs(fused_keys, fused_params, fused_dists, fused_profile) -> None:
    """The fused inputs' structure, as both wrappers of the pool scan check
    it on any device."""
    if any(x is None for x in (fused_keys, fused_params, fused_dists)):
        raise ValueError("fused_keys, fused_params and fused_dists come together (fused draws)")
    if len(fused_keys) != 3 or len(fused_params) != 3 or len(fused_dists) != 3:
        raise ValueError("fused draws take 3 key pairs, parameter pairs and distributions "
                         "(arrival, warm, cold)")
    known = dp.FUSED_DISTS + (dp.NHPP,)
    if any(d not in known for d in fused_dists) or dp.NHPP in fused_dists[1:]:
        raise ValueError(f"unknown fused distributions {fused_dists}; known: {known} "
                         "(nhpp for the arrival stream only)")
    if (fused_dists[0] == dp.NHPP) != (fused_profile is not None):
        raise ValueError("an nhpp arrival stream and fused_profile come together")


def check_increasing(window_bounds) -> None:
    """Every row of the window bounds strictly increasing: read at once,
    or where the open :func:`~repro_torch.core.simulator.deferred_guards`
    reads its guards."""
    ok = (window_bounds[:, 1:] > window_bounds[:, :-1]).all()

    def read():
        if not bool(ok):
            raise ValueError("window_bounds must be strictly increasing in every row")

    guard(read)


def check_scan_inputs(layout_kw: dict) -> None:
    """The optional inputs' structure, as both f64 wrappers check it on
    any device: pairs that come together, and a known routing."""
    kw = layout_kw
    if kw.get("routing", "newest") not in ROUTINGS:
        raise ValueError(f"routing must be one of {ROUTINGS}, got {kw['routing']!r}")
    fail = "fused_fail_keys" if kw.get("fused_keys") is not None else "fail_u"
    rely = [kw.get(n) is None for n in ("t_timeout", "p_fail", fail)]
    if len(set(rely)) > 1:
        raise ValueError(f"t_timeout, p_fail and {fail} come together (reliability)")
    if (kw.get("is_first") is None) != (kw.get("child_pos") is None):
        raise ValueError("is_first and child_pos come together (retries)")
    if kw.get("is_first") is not None and rely[0]:
        raise ValueError("retries need the reliability inputs t_timeout, p_fail, fail_u")
    if (kw.get("crash_rate") is None) != (kw.get("crash_u") is None):
        raise ValueError("crash_rate and crash_u come together (crashes)")
    if (kw.get("cap_edges") is None) != (kw.get("cap_values") is None):
        raise ValueError("cap_edges and cap_values come together (capacity)")
    wb = kw.get("window_bounds")
    if wb is not None and wb.shape[-1] > 1:
        check_increasing(wb)
    if kw.get("fused_keys") is not None:
        check_fused_inputs(kw["fused_keys"], kw.get("fused_params"), kw.get("fused_dists"),
                           kw.get("fused_profile"))
        bad = [n for n in ("arr", "is_first", "crash_u", "cap_values", "grid_times")
               if kw.get(n) is not None]
        if bad or kw.get("prestamped") or kw.get("fail_u") is not None:
            raise ValueError(
                "fused draws serve gap streams without staged samples, retries, faults "
                f"or grid points; got {bad + [n for n in ('prestamped', 'fail_u') if kw.get(n)]}")
        if kw.get("fused_k") is None or int(kw["fused_k"]) < 0:
            raise ValueError("fused draws need fused_k >= 0 events")
    elif any(kw.get(n) is not None for n in ("fused_params", "fused_dists", "fused_fail_keys",
                                               "fused_profile")):
        raise ValueError("fused inputs need fused_keys")


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
    fused_keys=None,  # 3 uint32 [R, 2] key pairs: arrival, warm, cold (fused)
    fused_params=None,  # 3 f64 [R, 2] (p0, p1) pairs (fused)
    fused_dists=None,  # 3 distribution names; the arrival's may be "nhpp"
    fused_k: Optional[int] = None,  # events the call draws (fused)
    fused_fail_keys=None,  # uint32 [R, 2] (fused, reliability)
    fused_profile=None,  # profile block, a tuple of floats (fused NHPP)
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

    With fused draws (``arr``, ``warms`` and ``colds`` None) event ``i`` of
    the run draws its samples from the counter ``(i, 0)`` under the row's
    keys in f64 (:mod:`repro_torch.core.drawplan`): ``fused_k`` events, gap
    streams only, without grid points, retries or faults; with an
    ``"nhpp"`` arrival the gap is the envelope's exponential at ``p0`` and
    a candidate whose acceptance uniform ``u`` has ``u * p0 >
    rate(t)`` (``fused_profile``, :func:`~repro_torch.core.processes.
    block_rate`) is an inert arrival: it moves the clock, integrates and
    expires, and routes nothing.

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
    fused = fused_keys is not None
    if state0 is None:
        check_scan_inputs(dict(routing=routing, t_timeout=t_timeout, p_fail=p_fail,
                               fail_u=fail_u, is_first=is_first, child_pos=child_pos,
                               crash_rate=crash_rate, crash_u=crash_u, cap_edges=cap_edges,
                               cap_values=cap_values, window_bounds=window_bounds,
                               fused_keys=fused_keys, fused_params=fused_params,
                               fused_dists=fused_dists, fused_k=fused_k,
                               fused_fail_keys=fused_fail_keys, fused_profile=fused_profile,
                               arr=arr, grid_times=grid_times, prestamped=prestamped))
    else:
        alive, creation, busy, doom = state0.alive, state0.creation, state0.busy, state0.doom
    R, M = alive.shape
    K = int(fused_k) if fused else arr.shape[1]
    dev = alive.device
    if fused:
        draws = _FusedEvents(fused_keys, fused_params, fused_dists, fused_fail_keys,
                             first_event, K)
        if draws.nhpp:
            lam = draws.params[0][0]
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
        if fused:
            dt, warm_s, cold_s, u_acc, fail_k = draws.take(k)
            t = t_prev + dt
        else:
            t = arr[:, k].to(F64) if prestamped else t_prev + arr[:, k].to(F64)
            warm_s, cold_s = warms[:, k].to(F64), colds[:, k].to(F64)
            fail_k = fail_u[:, k] if rely else None
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
        if fused and draws.nhpp:
            # thinning: a rejected candidate is an inert arrival
            active &= u_acc.to(F64) * lam <= block_rate(fused_profile, t)
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
            failed = assign & ~timed_out & (fail_k.to(F64) < p_f)
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


# the f64 fleet scan's columns per function: the pool scan's SCAN_COLS
# (cold, warm, reject, ∫running, ∫idle, Σcold response, Σwarm response,
# Σlifespan, lifespans, overflow), then arrivals, enqueued, queue-served,
# Σqueue wait and the fleet's peak live count (the same in every function's
# row); faults add crashes, evictions and interrupted arrivals
FLEET64_COLS = 15
FLEET64_PEAK = 14


class FleetScanOut(NamedTuple):
    """What :func:`fleet_scan_sweep_ref` and the kernel's wrapper return: the
    final pools and clock (the tail flush changes neither), the
    accumulator, the queues left, and the planes of the optional paths."""

    alive: torch.Tensor  # bool [N, F, M]
    creation: torch.Tensor  # f64 [N, F, M]
    busy: torch.Tensor  # f64 [N, F, M]
    t: torch.Tensor  # f64 [N] the last event's clock
    acc: torch.Tensor  # f64 [N, F, FLEET64_COLS (+ FAULT64_COLS)]
    qleft: torch.Tensor  # f64 [N, F] queued requests left
    queue: Optional[torch.Tensor] = None  # f64 [N, F, Q, 3] (t, warm, cold), head first
    doom: Optional[torch.Tensor] = None  # f64 [N, F, M] crash clocks (crashes)


# the fleet columns that sum f64 pieces over slots (∫running, ∫idle,
# Σlifespan), which a kernel may add in another order; every other column
# is a count, a maximum or a sum in event order
FLEET64_FLOAT_COLS = (3, 4, 7)


def fleet_scan_sweep_ref(
    t_exp,  # f64 [N, F]
    limit,  # f64 [N, F] concurrency limits
    ncl,  # f64 [N] cluster capacity (inf: unbounded)
    t_end,  # f64 [N]
    skip,  # f64 [N]
    stream,  # int64 [N] the stream row of each fleet
    times,  # [S, K] f32 gaps, or f64 absolute times if prestamped
    fids,  # uint8 [S, K] the acting function
    warms,  # f32 [S, K]
    colds,  # f32 [S, K]
    *,
    slots: int,
    queue_depth: int = 0,
    prestamped: bool = False,
    crash_rate=None,  # f64 [N] (crashes)
    crash_u=None,  # f32 [S, K] (crashes)
    cap_edges=None,  # f64 [N, E] (capacity churn)
    cap_values=None,  # f64 [N, E+1] (capacity churn)
    state0: Optional[FleetScanOut] = None,  # a chunk's return value to continue
    flush: bool = True,  # False: stop after the last event, no tail flush
) -> FleetScanOut:
    """The reference's f64 fleet scan (``repro/core/fleet.py::
    _make_fleet_step`` and ``_fleet_flush``), fleet by fleet: ``N`` fleets
    of ``F`` function pools of ``slots`` slots under one cluster capacity,
    each running the K events of its stream row.  Per event: the integrals
    over the interval clipped to ``[skip, t_end]`` (cut at each slot's
    crash clock), exits at ``min(busy + t_exp, doom)`` with lifespans and
    crashes, capacity churn (the newest idle instances fleet-wide above
    the ceiling leave, ties to the lower flat id ``f*M + m``), then, for
    the acting function, up to ``queue_depth`` FIFO drain passes, and the
    arrival: warm on its newest idle instance, else cold under its limit,
    a free slot, the cluster capacity (and the ceiling), else the queue,
    else rejected; the peak live count on every event.  Then the tail
    ``(t_last, t_end]``.  ``state0``/``flush`` split a run into chunks of
    events that equal one call bit for bit (no host read-back, so a chunk
    can sit in a CUDA graph)."""
    N, F = t_exp.shape
    M, Q = int(slots), int(queue_depth)
    K = times.shape[1]
    dev = t_exp.device
    crashes, capped = crash_u is not None, cap_values is not None
    if (crash_rate is None) == crashes or (cap_edges is None) == capped:
        raise ValueError("crash_rate/crash_u and cap_edges/cap_values come together")
    if Q and (crashes or capped):
        raise ValueError("fleet faults are incompatible with queue_depth > 0")
    cols = FLEET64_COLS + (FAULT64_COLS if crashes or capped else 0)
    te = t_exp.to(F64)[:, :, None]
    lim, ncl_ = limit.to(F64), ncl.to(F64)
    tend, skp = t_end.to(F64), skip.to(F64)
    tend3, skp3 = tend[:, None, None], skp[:, None, None]
    if crashes:
        crate = crash_rate.to(F64)
    if capped:
        cap_e, cap_v = cap_edges.to(F64), cap_values.to(F64)
    rows = torch.arange(N, device=dev)
    flat_ids = torch.arange(F * M, device=dev)
    if state0 is None:
        alive = torch.zeros((N, F, M), dtype=torch.bool, device=dev)
        creation = torch.full((N, F, M), NEG_INF, dtype=F64, device=dev)
        busy = creation.clone()
        doom = torch.full((N, F, M), torch.inf, dtype=F64, device=dev) if crashes else None
        queue = torch.full((N, F, Q, 3), NEG_INF, dtype=F64, device=dev) if Q else None
        acc = torch.zeros((N, F, cols), dtype=F64, device=dev)
        t_prev = torch.zeros((N,), dtype=F64, device=dev)
    else:
        alive, creation, busy = (x.clone() for x in state0[:3])
        t_prev, acc = state0.t, state0.acc.clone()
        queue = state0.queue.clone() if Q else None
        doom = state0.doom.clone() if crashes else None
    FC = FLEET64_COLS

    def add(col, fid, v):
        acc[rows, fid, col] += v

    def pool_of(fid):
        return alive[rows, fid], creation[rows, fid], busy[rows, fid]

    def clip(x):
        return torch.minimum(torch.maximum(x, skp), tend)

    for k in range(K):
        x = times[:, k][stream]
        fid = fids[:, k][stream].to(torch.int64)
        warm_s, cold_s = warms[:, k][stream].to(F64), colds[:, k][stream].to(F64)
        t = x.to(F64) if prestamped else t_prev + x.to(F64)
        t1, t3 = t[:, None], t[:, None, None]
        lo, hi = clip(t_prev)[:, None, None], clip(t)[:, None, None]
        if crashes:
            run_t, idle_t = fault_interval_integrals(alive, busy, te, doom, lo, hi)
        else:
            run_t, idle_t = interval_integrals(alive, busy, te, lo, hi)
        acc[:, :, 3] += run_t
        acc[:, :, 4] += idle_t

        # ---- exits at or before the event
        expire = busy + te
        if crashes:
            exit_t = torch.minimum(expire, doom)
            exited = alive & (exit_t <= t3)
            acc[:, :, FC] += (exited & (doom < expire) & (doom > skp3)
                              & (doom <= tend3)).sum(-1)
        else:
            exit_t = expire
            exited = alive & (expire <= t3)
        life_ok = exited & (exit_t > skp3) & (exit_t <= tend3)
        acc[:, :, 7] += torch.where(life_ok, exit_t - creation, 0.0).sum(-1)
        acc[:, :, 8] += life_ok.sum(-1)
        alive &= ~exited

        # ---- capacity churn: the newest idle instances fleet-wide over the
        # ceiling leave (rank among the idle by creation, then flat id)
        if capped:
            seg = (cap_e <= t1).sum(-1, keepdim=True)
            cap_now = cap_v.gather(1, seg)[:, 0]
            idle_now = (alive & (busy <= t3)).reshape(N, F * M)
            over = alive.sum((1, 2)).to(F64) - cap_now
            key = torch.where(idle_now, creation.reshape(N, F * M), -torch.inf)
            order = torch.sort(key, dim=1, descending=True, stable=True).indices
            rank = torch.empty_like(order).scatter_(
                1, order, flat_ids.expand(N, F * M).contiguous())
            evict = (idle_now & (rank.to(F64) < over[:, None])
                     & (t <= tend)[:, None]).reshape(N, F, M)
            evict_ok = evict & (t > skp)[:, None, None]
            acc[:, :, FC + 1] += evict_ok.sum(-1)
            acc[:, :, 7] += torch.where(evict_ok, t3 - creation, 0.0).sum(-1)
            acc[:, :, 8] += evict_ok.sum(-1)
            alive &= ~evict

        active = t <= tend
        counted = t > skp
        lim_f = lim[rows, fid]

        def route(fid):
            a_f, c_f, b_f = pool_of(fid)
            idle_f = a_f & (b_f <= t1)
            any_idle = idle_f.any(-1)
            warm_idx = torch.argmax(torch.where(idle_f, c_f, NEG_INF), dim=-1)
            any_free = (~a_f).any(-1)
            free_idx = torch.argmax((~a_f).to(torch.uint8), dim=-1)
            n_alive = a_f.sum(-1)
            cluster = alive.sum((1, 2))
            return any_idle, warm_idx, any_free, free_idx, n_alive, cluster

        def assign_to(fid, chosen, on, cold, service):
            b = busy[rows, fid, chosen]
            busy[rows, fid, chosen] = torch.where(on, t + service, b)
            creation[rows, fid, chosen] = torch.where(cold, t, creation[rows, fid, chosen])
            alive[rows, fid, chosen] = alive[rows, fid, chosen] | cold

        # ---- FIFO drain: freed capacity serves the acting function's queue
        # head before its arrival is routed
        for _ in range(Q):
            head = queue[rows, fid, 0]  # [N, 3]
            ht, hw, hc = head[:, 0], head[:, 1], head[:, 2]
            has = (ht > NEG_INF * 0.5) & active
            any_idle, warm_idx, any_free, free_idx, n_alive, cluster = route(fid)
            can_warm = has & any_idle
            can_cold = has & ~any_idle & (n_alive < lim_f) & any_free & (cluster < ncl_)
            serve = can_warm | can_cold
            chosen = torch.where(can_warm, warm_idx, free_idx)
            assign_to(fid, chosen, serve, can_cold, torch.where(can_warm, hw, hc))
            add(0, fid, can_cold & counted)
            add(1, fid, can_warm & counted)
            add(5, fid, torch.where(can_cold & counted, hc, 0.0))
            add(6, fid, torch.where(can_warm & counted, hw, 0.0))
            add(FC - 3, fid, serve & counted)
            add(FC - 2, fid, torch.where(serve & counted, t - ht, 0.0))
            qf = queue[rows, fid]
            shifted = torch.cat([qf[:, 1:], torch.full_like(qf[:, :1], NEG_INF)], 1)
            queue[rows, fid] = torch.where(serve[:, None, None], shifted, qf)

        # ---- the arrival
        any_idle, warm_idx, any_free, free_idx, n_alive, cluster = route(fid)
        below = n_alive < lim_f
        can_cold = ~any_idle & below & any_free & (cluster < ncl_)
        if capped:
            can_cold &= cluster.to(F64) < cap_now
        overflow = ~any_idle & below & ~any_free & active
        is_warm = any_idle & active
        is_cold = can_cold & active
        if Q:
            qf = queue[rows, fid]
            qlen = (qf[:, :, 0] > NEG_INF * 0.5).sum(-1)
            is_enq = ~any_idle & ~can_cold & (qlen < Q) & active
            is_reject = ~any_idle & ~can_cold & ~(qlen < Q) & active
        else:
            is_reject = ~any_idle & ~can_cold & active
        chosen = torch.where(is_warm, warm_idx, free_idx)
        service = torch.where(is_warm, warm_s, cold_s)
        assign = is_warm | is_cold
        assign_to(fid, chosen, assign, is_cold, service)
        if crashes:
            life = _lifetimes(crash_u[:, k][stream], crate)
            doom_c = torch.where(is_cold, t + life, doom[rows, fid, chosen])
            doom[rows, fid, chosen] = doom_c
            add(FC + 2, fid, assign & (doom_c < t + service) & counted)
        if Q:
            pos = torch.clamp(qlen, max=Q - 1)
            old = queue[rows, fid, pos]
            new = torch.stack([t, warm_s, cold_s], -1)
            queue[rows, fid, pos] = torch.where(is_enq[:, None], new, old)
            add(FC - 4, fid, is_enq & counted)
        add(0, fid, is_cold & counted)
        add(1, fid, is_warm & counted)
        add(2, fid, is_reject & counted)
        add(5, fid, torch.where(is_cold & counted, cold_s, 0.0))
        add(6, fid, torch.where(is_warm & counted, warm_s, 0.0))
        add(9, fid, overflow)
        add(FC - 5, fid, active & counted)
        peak = torch.maximum(acc[:, 0, FLEET64_PEAK], alive.sum((1, 2)).to(F64))
        acc[:, :, FLEET64_PEAK] = peak[:, None]
        t_prev = t

    qleft = ((queue[:, :, :, 0] > NEG_INF * 0.5).sum(-1).to(F64) if Q
             else torch.zeros((N, F), dtype=F64, device=dev))
    out = FleetScanOut(alive, creation, busy, t_prev, acc, qleft, queue, doom)
    if not flush:
        return out
    # ---- the tail flush (t_last, t_end]
    lo = clip(t_prev)[:, None, None]
    if crashes:
        run_t, idle_t = fault_interval_integrals(alive, busy, te, doom, lo, tend3)
    else:
        run_t, idle_t = interval_integrals(alive, busy, te, lo, tend3)
    acc[:, :, 3] += run_t
    acc[:, :, 4] += idle_t
    expire = busy + te
    exit_t = torch.minimum(expire, doom) if crashes else expire
    tail = alive & (exit_t <= tend3) & (exit_t > skp3)
    acc[:, :, 7] += torch.where(tail, exit_t - creation, 0.0).sum(-1)
    acc[:, :, 8] += tail.sum(-1)
    if crashes:
        acc[:, :, FC] += (tail & (doom < expire)).sum(-1)
    return out


@register_backend(
    "scan_ref",
    description="plain f64 PyTorch loops over events (the f64 kernels' mirrors)",
    engines=("scan", "temporal"),
    f64=True,
    shardable=True,
)
def _scan_ref_rows(alive0, creation0, busy0, arr, warms, colds, **kw) -> ScanOut:
    """Backend ``"scan_ref"``'s pool-state launcher (``kw`` as
    :func:`scan_sweep_ref` takes them)."""
    return scan_sweep_ref(alive0, creation0, busy0, arr, warms, colds, **kw)


@register_backend("scan_ref", engines=("par",), f64=True)
def _par_scan_ref_rows(arr, warms, colds, **kw) -> ParScanOut:
    """Backend ``"scan_ref"``'s par launcher."""
    return par_scan_sweep_ref(arr, warms, colds, **kw)


@register_backend("scan_ref", engines=("fleet",), f64=True)
def _fleet_scan_ref_rows(*args, **kw) -> FleetScanOut:
    """Backend ``"scan_ref"``'s fleet launcher."""
    kw.pop("live_bound", None)
    return fleet_scan_sweep_ref(*args, **kw)
