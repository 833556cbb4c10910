"""Plain PyTorch versions of the f32 block kernels (the kernels' mirrors).

:func:`faas_sweep_ref` is a loop over arrivals of ``[R, M]`` tensor ops in
the same arithmetic order and with the same tie-breaks as the reference
mirror ``repro/kernels/ref.py::faas_sweep_ref`` (base staged path, the
``prestamped`` mode, the transient ``grid_times`` columns, metric windows,
reliability, retries, fused threefry draws and platform faults).
:func:`faas_par_sweep_ref` mirrors ``faas_par_sweep_ref`` there, the
concurrency-value platform's ``finish[M, c]`` loop.  They run on any
device: the CPU tests and the ``device="cpu"`` entry points use them, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.  Their
row launchers are registered as backend ``"ref"``.

:func:`fleet_sweep_ref` mirrors ``fleet_sweep_ref`` there: F function
pools under one shared cluster capacity, with FIFO queues.  It keeps the
reference's per-event arithmetic and tie-breaks but not its block layout
(one fleet per 8-row block, the merged stream copied into every row):
pools are ``[N, F, M]`` and each fleet reads its replica's row of one
``[replicas, K]`` stream through ``stream``.

Platform faults (``crash_rate``, ``crash_u``, ``cap_edges``,
``cap_values``; both plain versions) follow the reference's operations in
its order: an Exp(``crash_rate``) lifetime stamped at each cold start
(the ``doom`` plane), exits at ``min(expiry, doom)``, and a
piecewise-constant capacity ceiling that evicts the newest idle instances
above it and gates cold starts.  One deviation: a row whose crash rate is
0 draws an infinite lifetime even from a zero uniform, where the
reference's ``-log(1 - 0) / 0`` gives NaN.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.drawplan import StreamDraws, param_rows
from repro_torch.core.execution import register_backend

NEG = -1e30
ACC_COLS = 8
# windowed columns per window: cold, served, arrivals, ∫running, ∫idle
WINDOW_COLS = 5
# transient-curve columns per grid point: running, idle, no_idle indicator
GRID_COLS = 3
# reliability columns, after the window and grid columns: timeout, fail,
# retry, abandon
RELY_COLS = 4
# child_pos sentinel of a last attempt, as f32 (core.reliability.NO_CHILD)
NO_CHILD_F = float(1 << 30)
# par accumulator: the 8 base columns, then ∫in-flight requests
PAR_ACC_COLS = 9
# fleet accumulator per function: the 8 base columns, then arrivals,
# enqueued, queue-served, Σqueue wait and the fleet's peak live count
FLEET_ACC_COLS = 13
# the most functions a fleet has on the block backends (the reference's
# BLOCK_R: a fleet was one 8-row block of the TPU kernel)
MAX_FUNCTIONS = 8
# platform-fault columns, after the reliability columns: crashes,
# evictions, interrupted attempts
FAULT_COLS = 3


class SweepOut(NamedTuple):
    """What :func:`faas_sweep_ref` and the kernel's wrapper return: the
    final pool state and clock, the accumulator, and the planes of the
    optional paths by name, None where the path is off."""

    alive: torch.Tensor  # f32 [R, M] 0/1
    creation: torch.Tensor  # f32 [R, M]
    busy: torch.Tensor  # f32 [R, M]
    t: torch.Tensor  # f32 [R] final clock
    acc: torch.Tensor  # f32 [R, cols]
    act: Optional[torch.Tensor] = None  # f32 [R, K] activation plane (retries)
    doom: Optional[torch.Tensor] = None  # f32 [R, M] crash clocks (crashes)

    def apply(self, fn):
        """The same outputs with ``fn`` applied to each that is not None."""
        return self._replace(**{k: fn(v) for k, v in self._asdict().items() if v is not None})


def _rows(x, R, device):
    """A per-row f32 ``[R]`` vector from a scalar or an ``[R]`` tensor."""
    return torch.as_tensor(x, dtype=torch.float32, device=device).expand(R).contiguous()


def check_fault_inputs(crash_rate, crash_u, cap_edges, cap_values):
    """The fault inputs' structure, as both block wrappers check it on any
    device: each pair comes together, and a profile's edges (a leading 0.0
    edge implied) are positive and strictly increasing in every row.
    Returns ``(crashes, capped)``."""
    if (crash_rate is None) != (crash_u is None):
        raise ValueError("crash_rate and crash_u come together (crashes)")
    if (cap_edges is None) != (cap_values is None):
        raise ValueError("cap_edges and cap_values come together (capacity)")
    capped = cap_values is not None
    if (capped and isinstance(cap_edges, torch.Tensor) and cap_edges.dim() == 2
            and cap_edges.shape[1] and not bool(
                (cap_edges[:, 0] > 0).all() & (cap_edges[:, 1:] > cap_edges[:, :-1]).all())):
        raise ValueError("cap_edges must be positive and strictly increasing in every row")
    return crash_u is not None, capped


def lifetime(crash_u, crate):
    """Exp(``crate``) lifetimes from uniforms, ``-log(1 - u) / rate`` (+inf
    where the rate is 0)."""
    life = -torch.log(1.0 - crash_u) / crate
    return torch.where(crate > 0, life, torch.inf)


class Capacity:
    """A per-row piecewise-constant ceiling: ``edges`` f32 ``[R, E]``,
    ``values`` f32 ``[R, E+1]``, with the reference launcher's leading 0.0
    edge, so the segment of ``t`` is a plain count."""

    def __init__(self, edges, values):
        R = values.shape[0]
        zero = torch.zeros((R, 1), dtype=torch.float32, device=values.device)
        self.edges = torch.cat([zero, edges.to(torch.float32)], dim=1)
        self.values = values.to(torch.float32)
        self.col = torch.arange(self.values.shape[1], dtype=torch.float32,
                                device=values.device)

    def at(self, t_new):
        """The ceiling in effect at each row's ``t_new`` ``[R]``."""
        seg = (self.edges <= t_new[:, None]).float().sum(1) - 1.0
        return (self.values * (self.col == seg[:, None])).sum(1)


def newer_rank(idle, creation, flat):
    """Per slot, the idle slots newer than it: a higher creation time, or
    an equal one at a lower flat id (``flat`` ``[..., M]``)."""
    cre_a, cre_b = creation[..., :, None], creation[..., None, :]
    fa, fb = flat[..., :, None], flat[..., None, :]
    newer = (cre_b > cre_a) | ((cre_b == cre_a) & (fb < fa))
    return (idle[..., None, :] & newer).float().sum(-1)


def faas_sweep_ref(
    alive,  # f32 [R, M] 0/1
    creation,  # f32 [R, M]
    busy,  # f32 [R, M]
    t0,  # f32 [R]
    t_exp,  # f32 [R] per-row expiration threshold
    dts,  # f32 [R, K] inter-arrival gaps, or absolute times if prestamped
    warms,  # f32 [R, K]
    colds,  # f32 [R, K]
    *,
    t_end=float("inf"),  # f32 [R] or scalar — per-row horizon
    skip=0.0,  # f32 [R] or scalar — per-row warm-up exclusion
    max_concurrency: int,
    prestamped: bool = False,
    window_bounds=None,  # f32 [R, W+1] metric-window boundaries
    grid_times=None,  # f32 [R, G] transient-curve query times
    t_timeout=None,  # f32 [R] or scalar — execution timeout (reliability)
    p_fail=None,  # f32 [R] or scalar — failure probability (reliability)
    fail_u=None,  # f32 [R, K] per-event failure uniforms (reliability)
    is_first=None,  # f32 [R, K] 0/1 first-attempt flags (retries)
    child_pos=None,  # f32 [R, K] retry-successor positions (retries)
    fused_keys=None,  # uint32 [R, 2] x3 (arrival, warm, cold) stream keys
    fused_params=None,  # f32 [R, 2] x3 per-row (p0, p1) distribution params
    fused_fail_keys=None,  # uint32 [R, 2] failure-stream keys (reliability)
    fused_dists=None,  # 3 distribution names (drawplan.FUSED_DISTS)
    fused_k: int = 0,  # events to run when fused (no dts to size from)
    crash_rate=None,  # f32 [R] or scalar — crash hazard (faults)
    crash_u=None,  # f32 [R, K] per-event crash-lifetime uniforms (faults)
    cap_edges=None,  # f32 [R, E] capacity-profile step times (faults)
    cap_values=None,  # f32 [R, E+1] per-segment capacity ceilings (faults)
    acc0=None,  # f32 [R, cols] accumulator to continue (default zeros)
    doom0=None,  # f32 [R, M] crash clocks to continue (crashes; default +inf)
):
    """Run K arrivals against each row's ``[M]`` pool.

    Per arrival: exact ∫running/∫idle instance-time over the interval
    clipped to ``[skip, t_end]``, expiry past ``t_exp`` (expire-first on a
    tie), then the newest idle instance (warm, lowest slot on a creation
    tie), else a free slot below ``max_concurrency`` (cold), else reject.
    Arrivals past ``t_end`` are inert; request counters engage after
    ``skip``.  ``acc0`` (and ``doom0`` with crashes) continues a run: a
    run without retries or fused draws split into chunks of events, each
    chunk started from the last one's pool, clock, accumulator and crash
    clocks, adds every piece in the order one call would, so it equals that
    call bit for bit.  Nothing in the loop reads the device on the host, so
    a chunk can be captured in a CUDA graph.  Returns a :class:`SweepOut`: ``(alive,
    creation, busy, t, acc)``, the activation plane ``act [R, K]`` with retries and the crash
    clocks ``doom [R, M]`` with crashes (None otherwise).  ``acc`` holds the reference's
    append-only layout: 8 base columns (cold, warm, reject, ∫running,
    ∫idle, Σcold response, Σwarm response, overflow), then ``5W`` window,
    ``3G`` grid, 4 reliability and 3 fault columns.

    ``window_bounds`` (strictly increasing per row) appends, per window,
    cold starts ``[8, 8+W)``, served ``[8+W, 8+2W)``, arrivals including
    rejects ``[8+2W, 8+3W)`` by half-open ``[b_w, b_{w+1})`` membership of
    the active arrival's instant, and ∫running ``[8+3W, 8+4W)`` / ∫idle
    ``[8+4W, 8+5W)`` over the window intersected with the interval clipped
    to ``t_end`` (windows ignore ``skip``).

    ``grid_times`` appends ``3G`` columns: running, idle and the no-idle
    indicator, counted on the pre-expiry pool at each grid point inside
    the interval ``(t, min(t_new, t_end)]`` (live means ``busy + t_exp >
    g``).

    ``t_timeout``/``p_fail``/``fail_u`` (reliability) free a served
    instance at ``t_new + min(service, t_timeout)``; a served attempt
    times out when ``service > t_timeout``, else fails when its uniform is
    below ``p_fail``; response sums read ``min(service, t_timeout)``.  The
    4 last columns count timeouts, failures, retries and abandons.  With
    ``is_first``/``child_pos`` (retries, an attempt table) an attempt is
    active only when it is a first attempt or its parent switched it on;
    inactive attempts still advance the clock, integrate and expire.  A
    timed-out, failed or rejected attempt switches on its successor
    ``child_pos`` (counted past ``skip`` or not) or, with none, is
    abandoned.

    Fused draws (``fused_dists`` given; ``dts``, ``warms``, ``colds`` and
    ``fail_u`` are None): each event's samples are drawn from the global
    event index ``i`` under each row's stream keys, as
    :mod:`repro_torch.core.drawplan` defines them, for ``fused_k`` events;
    the failure uniform is word 0 of ``fused_fail_keys``' draw.  The final
    clock ``t`` is what the caller's coverage guard reads.

    Platform faults: ``crash_rate``/``crash_u`` (crashes) stamp each cold
    start's crash clock ``doom = t_new + lifetime(u, rate)`` (fresh pools
    carry +inf; a warm hit keeps it); an instance stops accruing run/idle
    time at its doom and leaves at ``min(expiry, doom)``, which counts as a
    crash when ``skip < doom <= t_end`` and ``doom < expiry``.  A served
    attempt whose instance dies before it finishes is interrupted (with
    reliability: one not timed out or failed, and it triggers its retry).
    ``cap_edges``/``cap_values`` (capacity) set the ceiling in effect at
    each arrival: above it the newest idle instances are evicted (inside
    the horizon; ranked by creation, the lower slot newer on a tie), and a
    cold start needs the live count below it.  The 3 fault columns count
    crashes, evictions (past ``skip``) and interrupted attempts (past
    ``skip``).
    """
    R, M = alive.shape
    fused = fused_dists is not None
    K = int(fused_k) if fused else dts.shape[1]
    dev = alive.device
    t_exp = _rows(t_exp, R, dev)
    t_end = _rows(t_end, R, dev)
    skip = _rows(skip, R, dev)
    slot_iota = torch.arange(M, dtype=torch.float32, device=dev).expand(R, M)
    W = 0 if window_bounds is None else window_bounds.shape[1] - 1
    G = 0 if grid_times is None else grid_times.shape[1]
    reliability = t_timeout is not None
    retries = is_first is not None
    if reliability:
        t_to = _rows(t_timeout, R, dev)
        p_f = _rows(p_fail, R, dev)
    if fused:
        streams = [
            StreamDraws(kind, keys, *param_rows(par, R, dev))
            for kind, keys, par in zip(fused_dists, fused_keys, fused_params)
        ]
        if reliability:
            streams.append(StreamDraws("uniform", fused_fail_keys))
    if W:
        w_lo, w_hi = window_bounds[:, :-1], window_bounds[:, 1:]
    if retries:
        act = torch.zeros((R, K), dtype=torch.float32, device=dev)
        rows_iota = torch.arange(R, device=dev)
    crashes = crash_u is not None
    cap = None if cap_values is None else Capacity(cap_edges, cap_values)
    faults = crashes or cap is not None
    zero = torch.zeros((R,), dtype=torch.float32, device=dev)
    if crashes:
        crate = _rows(crash_rate, R, dev)
        doom = (doom0.clone() if doom0 is not None
                else torch.full((R, M), torch.inf, dtype=torch.float32, device=dev))
    t = t0
    acc = acc0 if acc0 is not None else torch.zeros(
        (R, ACC_COLS + WINDOW_COLS * W + GRID_COLS * G + (RELY_COLS if reliability else 0)
         + (FAULT_COLS if faults else 0)),
        dtype=torch.float32, device=dev,
    )
    for i in range(K):
        if fused:
            dt_i, warm_i, cold_i, *fail = (s.take(i) for s in streams)
            fail_i = fail[0] if reliability else None
        else:
            dt_i, warm_i, cold_i = dts[:, i], warms[:, i], colds[:, i]
            fail_i = fail_u[:, i] if reliability else None
        t_new = dt_i if prestamped else t + dt_i
        lo = torch.clamp(t, skip, t_end)
        hi = torch.clamp(t_new, skip, t_end)
        expire = busy + t_exp[:, None]
        # a crashed instance stops accruing run/idle time at its doom
        stop = torch.minimum(hi[:, None], doom) if crashes else hi[:, None]
        run_t = torch.clamp(torch.minimum(busy, stop) - lo[:, None], min=0.0)
        idle_t = torch.clamp(
            torch.minimum(expire, stop) - torch.maximum(busy, lo[:, None]), min=0.0
        )
        run_sum = (run_t * alive).sum(1)
        idle_sum = (idle_t * alive).sum(1)
        if W:
            # the interval clipped to the horizon but not to skip
            wlo = torch.maximum(w_lo, torch.minimum(t, t_end)[:, None])
            whi = torch.minimum(w_hi, torch.minimum(t_new, t_end)[:, None])
            run_w = torch.clamp(
                torch.minimum(busy[:, None, :], whi[:, :, None]) - wlo[:, :, None],
                min=0.0,
            )
            idle_w = torch.clamp(
                torch.minimum(expire[:, None, :], whi[:, :, None])
                - torch.maximum(busy[:, None, :], wlo[:, :, None]),
                min=0.0,
            )
            w_run = (run_w * alive[:, None, :]).sum(2)
            w_idle = (idle_w * alive[:, None, :]).sum(2)
        if G:
            g = grid_times
            in_win = (g > t[:, None]) & (g <= torch.minimum(t_new, t_end)[:, None])
            live_g = (alive[:, None, :] > 0) & (expire[:, None, :] > g[:, :, None])
            running_g = (live_g & (busy[:, None, :] > g[:, :, None])).sum(2)
            idle_g = (live_g & (busy[:, None, :] <= g[:, :, None])).sum(2)
            g_run = torch.where(in_win, running_g.float(), 0.0)
            g_idle = torch.where(in_win, idle_g.float(), 0.0)
            g_cold = (in_win & (idle_g == 0)).float()
        # exits: expiry or crash, whichever clock fires first
        exit_time = torch.minimum(expire, doom) if crashes else expire
        expired = (alive > 0) & (exit_time <= t_new[:, None])
        if crashes:
            crash_ok = (expired & (doom < expire) & (doom > skip[:, None])
                        & (doom <= t_end[:, None]))
            n_crash = crash_ok.float().sum(1)
        alive = torch.where(expired, 0.0, alive)
        if cap is not None:
            # capacity churn: evict the newest idle instances above the
            # ceiling in effect at this arrival
            cap_now = cap.at(t_new)
            over = alive.sum(1) - cap_now
            # (a row at or below its ceiling evicts nothing: rank >= 0 >= over)
            idle_now = (alive > 0) & (busy <= t_new[:, None])
            rank = newer_rank(idle_now, creation, slot_iota)
            evict = idle_now & (rank < over[:, None]) & (t_new <= t_end)[:, None]
            n_evict = (evict & (t_new > skip)[:, None]).float().sum(1)
            alive = torch.where(evict, 0.0, alive)

        idle = (alive > 0) & (busy <= t_new[:, None])
        best = torch.where(idle, creation, NEG).amax(1)
        any_idle = best > NEG * 0.5
        is_best = idle & (creation >= best[:, None]) & any_idle[:, None]
        first_best = torch.where(is_best, slot_iota, 1e9).amin(1)
        free = alive <= 0
        any_free = free.any(1)
        first_free = torch.where(free, slot_iota, 1e9).amin(1)
        n_alive = alive.sum(1)

        active = t_new <= t_end
        if retries:
            first_i, child = is_first[:, i], child_pos[:, i]
            active = active & ((first_i > 0) | (act[:, i] > 0))
        counted = t_new > skip
        below = n_alive < max_concurrency
        can_cold = (~any_idle) & below & any_free
        if cap is not None:
            # admission gate while degraded: no cold start over the ceiling
            can_cold = can_cold & (n_alive < cap_now)
        overflow = (~any_idle) & below & (~any_free) & active
        is_warm = any_idle & active
        is_cold = can_cold & active
        is_reject = (~any_idle) & (~can_cold) & active

        chosen = torch.where(is_warm, first_best, first_free)
        service = torch.where(is_warm, warm_i, cold_i)
        # the 1e30 no-timeout sentinel leaves min() the identity
        occupancy = torch.minimum(service, t_to) if reliability else service
        assign = is_warm | is_cold
        sel = (slot_iota == chosen[:, None]) & assign[:, None]
        busy = torch.where(sel, (t_new + occupancy)[:, None], busy)
        sel_cold = sel & is_cold[:, None]
        creation = torch.where(sel_cold, t_new[:, None], creation)
        alive = torch.where(sel_cold, 1.0, alive)
        if crashes:
            # the Exp(crash_rate) lifetime stamped at cold start; a warm hit
            # keeps the instance's doom
            life = lifetime(crash_u[:, i], crate)
            doom = torch.where(sel_cold, (t_new + life)[:, None], doom)
            doom_chosen = torch.where(sel, doom, torch.inf).amin(1)
            cut = assign & (doom_chosen < t_new + occupancy)

        if reliability:
            timed_out = assign & (service > t_to)
            failed = assign & ~timed_out & (fail_i < p_f)
            trigger = timed_out | failed | is_reject
            if crashes:
                interrupted = cut & ~timed_out & ~failed
                trigger = trigger | interrupted
            cold_resp = torch.minimum(cold_i, t_to)
            warm_resp = torch.minimum(warm_i, t_to)
        else:
            if crashes:
                interrupted = cut
            cold_resp, warm_resp = cold_i, warm_i
        cold_c = is_cold & counted
        warm_c = is_warm & counted
        parts = [
            torch.stack(
                [
                    cold_c.float(),
                    warm_c.float(),
                    (is_reject & counted).float(),
                    run_sum,
                    idle_sum,
                    torch.where(cold_c, cold_resp, 0.0),
                    torch.where(warm_c, warm_resp, 0.0),
                    overflow.float(),
                ],
                dim=1,
            )
        ]
        if W:
            onehot = (t_new[:, None] >= w_lo) & (t_new[:, None] < w_hi) & active[:, None]
            parts += [
                (onehot & is_cold[:, None]).float(),
                (onehot & assign[:, None]).float(),
                onehot.float(),
                w_run,
                w_idle,
            ]
        if G:
            parts += [g_run, g_idle, g_cold]
        if reliability:
            if retries:
                r_retry = (first_i <= 0) & active & counted
                r_abandon = trigger & ~(child < NO_CHILD_F) & counted
                # switch on the successor (a position past the stream, as
                # the NO_CHILD sentinel is, matches no event)
                hit = trigger & (child >= 0) & (child < K) & (child == child.floor())
                act[rows_iota[hit], child[hit].long()] = 1.0
            else:
                r_retry = torch.zeros_like(trigger)
                r_abandon = trigger & counted
            parts.append(
                torch.stack(
                    [
                        (timed_out & counted).float(),
                        (failed & counted).float(),
                        r_retry.float(),
                        r_abandon.float(),
                    ],
                    dim=1,
                )
            )
        if faults:
            parts.append(torch.stack([
                n_crash if crashes else zero,
                n_evict if cap is not None else zero,
                (interrupted & counted).float() if crashes else zero,
            ], dim=1))
        acc = acc + torch.cat(parts, dim=1)
        t = t_new
    return SweepOut(alive, creation, busy, t, acc, act if retries else None,
                    doom if crashes else None)


def faas_par_sweep_ref(
    t_exp,  # f32 [R] per-row expiration threshold
    dts,  # f32 [R, K] inter-arrival gaps, or absolute times if prestamped
    warms,  # f32 [R, K]
    colds,  # f32 [R, K]
    *,
    t_end,  # f32 [R] or scalar — per-row horizon
    skip,  # f32 [R] or scalar — per-row warm-up exclusion
    max_concurrency: int,
    concurrency: int,
    slots: int,
    prestamped: bool = False,
    state0=None,  # (alive, creation, finish, t, acc) to continue
):
    """Run K arrivals of the concurrency-value platform from an empty pool
    of ``slots`` instances, each serving up to ``concurrency`` requests
    (or from ``state0``, a chunk's return value: the next chunk of events
    continues that run bit for bit, as :func:`faas_sweep_ref`'s ``acc0``).

    Per arrival: ``busy = max_j finish``; the run/idle integrals over the
    clipped interval and the in-flight integral over every request slot of
    a live instance; expiry (``busy + t_exp <= t_new``, expire-first on a
    tie); then the newest instance with ``#(finish > t_new) < c`` (lowest
    slot on a creation tie), else the first free slot below
    ``max_concurrency`` instances (cold), else reject.  The request goes
    to the chosen instance's first sub-slot with ``finish <= t_new``, read
    before a cold start wipes the row to ``NEG``.  Returns ``(alive,
    creation, finish[R, c, M], t, acc[R, 9])``; ``acc`` is the base
    engine's 8 columns plus ∫in-flight requests.
    """
    R, K = dts.shape
    M, c = int(slots), int(concurrency)
    dev = dts.device
    t_exp = _rows(t_exp, R, dev)
    t_end = _rows(t_end, R, dev)
    skip = _rows(skip, R, dev)
    slot_iota = torch.arange(M, dtype=torch.float32, device=dev).expand(R, M)
    sub_iota = torch.arange(c, dtype=torch.float32, device=dev).expand(R, c)
    if state0 is not None:
        alive, creation, finish, t, acc = state0
    else:
        alive = torch.zeros((R, M), dtype=torch.float32, device=dev)
        creation = torch.full((R, M), NEG, dtype=torch.float32, device=dev)
        finish = torch.full((R, c, M), NEG, dtype=torch.float32, device=dev)
        t = torch.zeros((R,), dtype=torch.float32, device=dev)
        acc = torch.zeros((R, PAR_ACC_COLS), dtype=torch.float32, device=dev)
    for i in range(K):
        dt_i, warm_i, cold_i = dts[:, i], warms[:, i], colds[:, i]
        t_new = dt_i if prestamped else t + dt_i
        busy = finish.amax(1)
        lo = torch.clamp(t, skip, t_end)
        hi = torch.clamp(t_new, skip, t_end)
        expire = busy + t_exp[:, None]
        run_t = torch.clamp(torch.minimum(busy, hi[:, None]) - lo[:, None], min=0.0)
        idle_t = torch.clamp(
            torch.minimum(expire, hi[:, None]) - torch.maximum(busy, lo[:, None]),
            min=0.0,
        )
        run_sum = (run_t * alive).sum(1)
        idle_sum = (idle_t * alive).sum(1)
        flight_t = torch.clamp(
            torch.minimum(finish, hi[:, None, None]) - lo[:, None, None], min=0.0
        )
        flight_sum = (flight_t * alive[:, None, :]).sum((1, 2))
        expired = (alive > 0) & (expire <= t_new[:, None])
        alive = torch.where(expired, 0.0, alive)

        in_flight = (finish > t_new[:, None, None]).sum(1)
        has_cap = (alive > 0) & (in_flight < c)
        best = torch.where(has_cap, creation, NEG).amax(1)
        any_cap = best > NEG * 0.5
        is_best = has_cap & (creation >= best[:, None]) & any_cap[:, None]
        first_best = torch.where(is_best, slot_iota, 1e9).amin(1)
        free = alive <= 0
        any_free = free.any(1)
        first_free = torch.where(free, slot_iota, 1e9).amin(1)
        n_alive = alive.sum(1)

        active = t_new <= t_end
        counted = t_new > skip
        below = n_alive < max_concurrency
        can_cold = (~any_cap) & below & any_free
        overflow = (~any_cap) & below & (~any_free) & active
        is_warm = any_cap & active
        is_cold = can_cold & active
        is_reject = (~any_cap) & (~can_cold) & active

        chosen = torch.where(is_warm, first_best, first_free)
        service = torch.where(is_warm, warm_i, cold_i)
        sel = (slot_iota == chosen[:, None]) & (is_warm | is_cold)[:, None]
        # the chosen instance's first free request sub-slot, read before a
        # cold start wipes its (possibly stale) row
        chosen_fin = torch.where(sel[:, None, :], finish, 0.0).sum(2)
        sub_free = chosen_fin <= t_new[:, None]
        first_sub = torch.where(sub_free, sub_iota, 1e9).amin(1)
        sel_cold = sel & is_cold[:, None]
        finish = torch.where(sel_cold[:, None, :], NEG, finish)
        set3 = sel[:, None, :] & (sub_iota == first_sub[:, None])[:, :, None]
        finish = torch.where(set3, (t_new + service)[:, None, None], finish)
        creation = torch.where(sel_cold, t_new[:, None], creation)
        alive = torch.where(sel_cold, 1.0, alive)

        cold_c = is_cold & counted
        warm_c = is_warm & counted
        delta = torch.stack(
            [
                cold_c.float(),
                warm_c.float(),
                (is_reject & counted).float(),
                run_sum,
                idle_sum,
                torch.where(cold_c, cold_i, 0.0),
                torch.where(warm_c, warm_i, 0.0),
                overflow.float(),
                flight_sum,
            ],
            dim=1,
        )
        acc = acc + delta
        t = t_new
    return alive, creation, finish, t, acc


def fleet_sweep_ref(
    t_exp,  # f32 [N, F] per-function expiration threshold
    limit,  # f32 [N, F] per-function concurrency limit
    ncl,  # f32 [N] or scalar — shared cluster capacity (1e30 = unbounded)
    t_end,  # f32 [N] or scalar — per-fleet horizon
    skip,  # f32 [N] or scalar — per-fleet warm-up exclusion
    stream,  # int [N] the stream row each fleet reads
    times,  # f32 [S, K] merged stream: gaps, or absolute times if prestamped
    fids,  # uint8/int [S, K] acting function of each event
    warms,  # f32 [S, K]
    colds,  # f32 [S, K]
    *,
    slots: int,
    queue_depth: int = 0,
    prestamped: bool = False,
    crash_rate=None,  # f32 [N] or scalar — crash hazard (faults)
    crash_u=None,  # f32 [S, K] per-event crash-lifetime uniforms (faults)
    cap_edges=None,  # f32 [N, E] capacity-profile step times (faults)
    cap_values=None,  # f32 [N, E+1] per-segment capacity ceilings (faults)
):
    """Run the K events of each fleet's stream row against its F pools of
    ``slots`` instances.

    Per event: every pool integrates ∫running/∫idle over the interval
    clipped to ``[skip, t_end]`` and expires past its ``t_exp``
    (expire-first on a tie); with ``queue_depth`` Q > 0, up to Q passes
    serve the acting function's queue head (inside the horizon only);
    then the acting function's arrival goes warm (newest idle, lowest slot
    on a creation tie), else cold when its live count is below its limit,
    it has a free slot and the fleet's live count is below ``ncl``, else
    into its queue if there is room, else it is rejected; the fleet's peak
    live count is updated on every event.  Returns ``(acc[N, F, 13],
    qleft[N, F])``: the reference's ``FLEET_ACC_COLS`` (cold, warm,
    reject, ∫running, ∫idle, Σcold response, Σwarm response, overflow,
    arrivals, enqueued, queue-served, Σqueue wait, peak; the peak repeated
    for every function) and the queue lengths left at the end.

    Platform faults act as in :func:`faas_sweep_ref`, per function pool,
    with no reliability layer and not with queues: the crash uniforms are
    read through ``stream`` like the samples, and the rate and capacity
    profile are per fleet.  The ceiling applies to the fleet's live count:
    the newest idle instances fleet-wide are evicted (on a creation tie the
    lower flat id ``f * slots + m`` counts as newer) and a cold start needs
    the fleet's live count below it.  ``acc`` then has 16 columns per
    function (crashes of its instances, their evictions past ``skip``, its
    interrupted attempts past ``skip``), and with crashes the crash clocks
    ``doom[N, F, M]`` come third.
    """
    N, F = t_exp.shape
    M, Q = int(slots), int(queue_depth)
    K = times.shape[1]
    dev = times.device
    f32 = dict(dtype=torch.float32, device=dev)
    t_exp = torch.as_tensor(t_exp, **f32)
    limit = torch.as_tensor(limit, **f32)
    ncl, t_end, skip = (_rows(x, N, dev) for x in (ncl, t_end, skip))
    idx = torch.as_tensor(stream, device=dev).long()
    dts = times.index_select(0, idx)
    fid = fids.index_select(0, idx).long()
    warm = warms.index_select(0, idx)
    cold = colds.index_select(0, idx)
    slot_iota = torch.arange(M, **f32).expand(N, F, M)
    f_iota = torch.arange(F, device=dev).expand(N, F)
    alive = torch.zeros((N, F, M), **f32)
    creation = torch.full((N, F, M), NEG, **f32)
    busy = torch.full((N, F, M), NEG, **f32)
    t = torch.zeros((N,), **f32)
    crashes = crash_u is not None
    cap = None if cap_values is None else Capacity(cap_edges, cap_values)
    faults = crashes or cap is not None
    if Q and faults:
        raise ValueError("fleet faults are incompatible with queue_depth > 0")
    if crashes:
        crate = _rows(crash_rate, N, dev)
        crash = crash_u.index_select(0, idx)
        doom = torch.full((N, F, M), torch.inf, **f32)
    if cap is not None:
        flat = torch.arange(F * M, **f32).expand(N, F * M)
    acc = torch.zeros((N, F, FLEET_ACC_COLS + (FAULT_COLS if faults else 0)), **f32)
    peak = torch.zeros((N,), **f32)
    zero = torch.zeros((N, F), **f32)
    if Q:
        q_iota = torch.arange(Q, device=dev).expand(N, F, Q)
        qt, qw, qc = (torch.full((N, F, Q), NEG, **f32) for _ in range(3))
        neg_col = torch.full((N, F, 1), NEG, **f32)

    def routing(alive, creation, busy, t_new):
        idle = (alive > 0) & (busy <= t_new[:, None, None])
        best = torch.where(idle, creation, NEG).amax(2)
        any_idle = best > NEG * 0.5
        is_best = idle & (creation >= best[..., None]) & any_idle[..., None]
        first_best = torch.where(is_best, slot_iota, 1e9).amin(2)
        free = alive <= 0
        any_free = free.any(2)
        first_free = torch.where(free, slot_iota, 1e9).amin(2)
        n_alive = alive.sum(2)
        return any_idle, first_best, any_free, first_free, n_alive

    def start(sel, is_cold, t_new, service, alive, creation, busy):
        busy = torch.where(sel, (t_new[:, None] + service)[..., None], busy)
        sel_cold = sel & is_cold[..., None]
        creation = torch.where(sel_cold, t_new[:, None, None], creation)
        alive = torch.where(sel_cold, 1.0, alive)
        return alive, creation, busy

    for i in range(K):
        dt_i, warm_i, cold_i = dts[:, i], warm[:, i], cold[:, i]
        act = f_iota == fid[:, i, None]
        t_new = dt_i if prestamped else t + dt_i
        lo = torch.clamp(t, skip, t_end)[:, None, None]
        hi = torch.clamp(t_new, skip, t_end)[:, None, None]
        expire = busy + t_exp[..., None]
        stop = torch.minimum(hi, doom) if crashes else hi
        run_t = torch.clamp(torch.minimum(busy, stop) - lo, min=0.0)
        idle_t = torch.clamp(torch.minimum(expire, stop) - torch.maximum(busy, lo), min=0.0)
        run_sum = (run_t * alive).sum(2)
        idle_sum = (idle_t * alive).sum(2)
        exit_time = torch.minimum(expire, doom) if crashes else expire
        expired = (alive > 0) & (exit_time <= t_new[:, None, None])
        if crashes:
            crash_ok = (expired & (doom < expire) & (doom > skip[:, None, None])
                        & (doom <= t_end[:, None, None]))
            n_crash = crash_ok.float().sum(2)
        alive = torch.where(expired, 0.0, alive)
        cc = (t_new > skip)[:, None]
        in_h = (t_new <= t_end)[:, None]
        if cap is not None:
            # the fleet's ceiling: the newest idle instances fleet-wide go
            cap_now = cap.at(t_new)
            over = alive.sum(2).sum(1) - cap_now
            n_evict = zero
            if bool((over > 0).any()):  # ranks are needed only above a ceiling
                idle_now = (alive > 0) & (busy <= t_new[:, None, None])
                rank = newer_rank(idle_now.view(N, F * M), creation.view(N, F * M), flat)
                evict = idle_now & (rank.view(N, F, M) < over[:, None, None]) & in_h[..., None]
                n_evict = (evict & cc[..., None]).float().sum(2)
                alive = torch.where(evict, 0.0, alive)

        if Q:
            for _ in range(Q):
                any_idle, first_best, any_free, first_free, n_alive = routing(
                    alive, creation, busy, t_new
                )
                cluster = n_alive.sum(1)[:, None]
                ht, hw, hc = qt[..., 0], qw[..., 0], qc[..., 0]
                has = (ht > NEG * 0.5) & act & in_h
                can_warm = has & any_idle
                can_cold = (
                    has & (~any_idle) & (n_alive < limit) & any_free
                    & (cluster < ncl[:, None])
                )
                serve = can_warm | can_cold
                if not bool(serve.any()):
                    break  # a pass that serves nothing changes nothing
                chosen = torch.where(can_warm, first_best, first_free)
                sel = (slot_iota == chosen[..., None]) & serve[..., None]
                alive, creation, busy = start(
                    sel, can_cold, t_new, torch.where(can_warm, hw, hc),
                    alive, creation, busy,
                )
                delta = torch.stack(
                    [
                        (can_cold & cc).float(),
                        (can_warm & cc).float(),
                        zero,
                        zero,
                        zero,
                        torch.where(can_cold & cc, hc, 0.0),
                        torch.where(can_warm & cc, hw, 0.0),
                        zero,
                        zero,
                        zero,
                        (serve & cc).float(),
                        torch.where(serve & cc, t_new[:, None] - ht, 0.0),
                        zero,
                    ],
                    dim=2,
                )
                acc = acc + delta
                shift = lambda qx: torch.where(
                    serve[..., None], torch.cat([qx[..., 1:], neg_col], dim=2), qx
                )
                qt, qw, qc = shift(qt), shift(qw), shift(qc)

        any_idle, first_best, any_free, first_free, n_alive = routing(
            alive, creation, busy, t_new
        )
        cluster = n_alive.sum(1)[:, None]
        active = in_h & act
        below = n_alive < limit
        can_cold = (~any_idle) & below & any_free & (cluster < ncl[:, None])
        if cap is not None:
            can_cold = can_cold & (cluster < cap_now[:, None])
        overflow = (~any_idle) & below & (~any_free) & active
        is_warm = any_idle & active
        is_cold = can_cold & active
        if Q:
            qlen = (qt > NEG * 0.5).sum(2)
            can_enq = (~any_idle) & (~can_cold) & (qlen < Q)
            is_enq = can_enq & active
            is_reject = (~any_idle) & (~can_cold) & (~can_enq) & active
        else:
            is_enq = torch.zeros_like(active)
            is_reject = (~any_idle) & (~can_cold) & active
        chosen = torch.where(is_warm, first_best, first_free)
        assign = is_warm | is_cold
        sel = (slot_iota == chosen[..., None]) & assign[..., None]
        service = torch.where(is_warm, warm_i[:, None], cold_i[:, None])
        alive, creation, busy = start(sel, is_cold, t_new, service, alive, creation, busy)
        if crashes:
            life = lifetime(crash[:, i], crate)
            doom = torch.where(sel & is_cold[..., None], (t_new + life)[:, None, None], doom)
            doom_chosen = torch.where(sel, doom, torch.inf).amin(2)
            interrupted = assign & (doom_chosen < t_new[:, None] + service)
        if Q:
            qsel = (q_iota == qlen[..., None]) & is_enq[..., None]
            qt = torch.where(qsel, t_new[:, None, None], qt)
            qw = torch.where(qsel, warm_i[:, None, None], qw)
            qc = torch.where(qsel, cold_i[:, None, None], qc)
        peak = torch.maximum(peak, alive.sum(2).sum(1))
        delta = torch.stack(
            [
                (is_cold & cc).float(),
                (is_warm & cc).float(),
                (is_reject & cc).float(),
                run_sum,
                idle_sum,
                torch.where(is_cold & cc, cold_i[:, None], 0.0),
                torch.where(is_warm & cc, warm_i[:, None], 0.0),
                overflow.float(),
                (active & cc).float(),
                (is_enq & cc).float(),
                zero,
                zero,
                zero,
            ]
            + ([
                n_crash if crashes else zero,
                n_evict if cap is not None else zero,
                (interrupted & cc).float() if crashes else zero,
            ] if faults else []),
            dim=2,
        )
        acc = acc + delta
        t = t_new
    acc[..., FLEET_ACC_COLS - 1] = peak[:, None]
    qleft = (qt > NEG * 0.5).sum(2).float() if Q else torch.zeros((N, F), **f32)
    return (acc, qleft, doom) if crashes else (acc, qleft)


@register_backend(
    "ref",
    description="plain PyTorch loops over arrivals (the kernels' mirrors)",
    engines=("scan", "temporal"),
    shardable=True,
)
def _ref_sweep_rows(
    alive0, creation0, busy0, t0, t_exp, t_end, skip, dts, warms, colds, **kw,
):
    """Backend ``"ref"``'s pool-state row launcher: the accumulator, and
    with fused draws ``(acc, t)`` for the caller's coverage guard (``kw``
    as :func:`faas_sweep_ref` takes them)."""
    out = faas_sweep_ref(
        alive0, creation0, busy0, t0, t_exp, dts, warms, colds,
        t_end=t_end, skip=skip, **kw,
    )
    return (out.acc, out.t) if kw.get("fused_dists") is not None else out.acc


@register_backend("ref", engines=("par",))
def _ref_par_rows(
    t_exp, t_end, skip, dts, warms, colds,
    *, max_concurrency, concurrency, slots, prestamped,
):
    """Backend ``"ref"``'s par row launcher: the ``[C, 9]`` accumulator."""
    return faas_par_sweep_ref(
        t_exp, dts, warms, colds, t_end=t_end, skip=skip,
        max_concurrency=max_concurrency, concurrency=concurrency,
        slots=slots, prestamped=prestamped,
    )[4]


@register_backend("ref", engines=("fleet",))
def _ref_fleet_rows(
    t_exp, limit, ncl, t_end, skip, stream, times, fids, warms, colds, *,
    live_bound=None, **kw,
):
    """Backend ``"ref"``'s fleet launcher: ``(acc[N, F, 13 or 16], qleft[N,
    F])`` (``kw`` as :func:`fleet_sweep_ref` takes them; ``live_bound``
    sizes only the kernel's table)."""
    return fleet_sweep_ref(
        t_exp, limit, ncl, t_end, skip, stream, times, fids, warms, colds, **kw,
    )[:2]
