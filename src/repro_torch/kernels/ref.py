"""Plain PyTorch versions of the f32 block kernels (the kernels' mirrors).

:func:`faas_sweep_ref` is a loop over arrivals of ``[R, M]`` tensor ops in
the same arithmetic order and with the same tie-breaks as the reference
mirror ``repro/kernels/ref.py::faas_sweep_ref`` (base staged path, the
``prestamped`` mode and the transient ``grid_times`` columns).
:func:`faas_par_sweep_ref` mirrors ``faas_par_sweep_ref`` there, the
concurrency-value platform's ``finish[M, c]`` loop.  They run on any
device: the CPU tests and the ``device="cpu"`` entry points use them, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.  Their
row launchers are registered as backend ``"ref"``.
"""

from __future__ import annotations

import torch

from repro_torch.core.execution import register_backend

NEG = -1e30
ACC_COLS = 8
# par accumulator: the 8 base columns, then ∫in-flight requests
PAR_ACC_COLS = 9


def _rows(x, R, device):
    """A per-row f32 ``[R]`` vector from a scalar or an ``[R]`` tensor."""
    return torch.as_tensor(x, dtype=torch.float32, device=device).expand(R).contiguous()


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
    grid_times=None,  # f32 [R, G] transient-curve query times
):
    """Run K arrivals against each row's ``[M]`` pool.

    Per arrival: exact ∫running/∫idle instance-time over the interval
    clipped to ``[skip, t_end]``, expiry past ``t_exp`` (expire-first on a
    tie), then the newest idle instance (warm, lowest slot on a creation
    tie), else a free slot below ``max_concurrency`` (cold), else reject.
    Arrivals past ``t_end`` are inert; request counters engage after
    ``skip``.  Returns ``(alive, creation, busy, t, acc)`` with
    ``acc[R, 8]`` = cold, warm, reject, ∫running, ∫idle, Σcold response,
    Σwarm response, overflow.

    ``grid_times`` appends ``3G`` columns: running ``[8, 8+G)``, idle
    ``[8+G, 8+2G)`` and the no-idle indicator ``[8+2G, 8+3G)``, counted on
    the pre-expiry pool at each grid point inside the interval
    ``(t, min(t_new, t_end)]`` (live means ``busy + t_exp > g``).
    """
    R, M = alive.shape
    K = dts.shape[1]
    dev = alive.device
    t_exp = _rows(t_exp, R, dev)
    t_end = _rows(t_end, R, dev)
    skip = _rows(skip, R, dev)
    slot_iota = torch.arange(M, dtype=torch.float32, device=dev).expand(R, M)
    G = 0 if grid_times is None else grid_times.shape[1]
    t = t0
    acc = torch.zeros((R, ACC_COLS + 3 * G), dtype=torch.float32, device=dev)
    for i in range(K):
        dt_i, warm_i, cold_i = dts[:, i], warms[:, i], colds[:, i]
        t_new = dt_i if prestamped else t + dt_i
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
        if G:
            g = grid_times
            in_win = (g > t[:, None]) & (g <= torch.minimum(t_new, t_end)[:, None])
            live_g = (alive[:, None, :] > 0) & (expire[:, None, :] > g[:, :, None])
            running_g = (live_g & (busy[:, None, :] > g[:, :, None])).sum(2)
            idle_g = (live_g & (busy[:, None, :] <= g[:, :, None])).sum(2)
            g_run = torch.where(in_win, running_g.float(), 0.0)
            g_idle = torch.where(in_win, idle_g.float(), 0.0)
            g_cold = (in_win & (idle_g == 0)).float()
        expired = (alive > 0) & (expire <= t_new[:, None])
        alive = torch.where(expired, 0.0, alive)

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
        counted = t_new > skip
        below = n_alive < max_concurrency
        can_cold = (~any_idle) & below & any_free
        overflow = (~any_idle) & below & (~any_free) & active
        is_warm = any_idle & active
        is_cold = can_cold & active
        is_reject = (~any_idle) & (~can_cold) & active

        chosen = torch.where(is_warm, first_best, first_free)
        service = torch.where(is_warm, warm_i, cold_i)
        sel = (slot_iota == chosen[:, None]) & (is_warm | is_cold)[:, None]
        busy = torch.where(sel, (t_new + service)[:, None], busy)
        sel_cold = sel & is_cold[:, None]
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
            ],
            dim=1,
        )
        if G:
            delta = torch.cat([delta, g_run, g_idle, g_cold], dim=1)
        acc = acc + delta
        t = t_new
    return alive, creation, busy, t, acc


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
):
    """Run K arrivals of the concurrency-value platform from an empty pool
    of ``slots`` instances, each serving up to ``concurrency`` requests.

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


@register_backend(
    "ref",
    description="plain PyTorch loops over arrivals (the kernels' mirrors)",
    engines=("scan", "temporal"),
)
def _ref_sweep_rows(
    alive0, creation0, busy0, t0, t_exp, t_end, skip, dts, warms, colds,
    *, max_concurrency, prestamped, grid_times=None,
):
    """Backend ``"ref"``'s pool-state row launcher: the ``[C, 8 + 3G]``
    accumulator."""
    return faas_sweep_ref(
        alive0, creation0, busy0, t0, t_exp, dts, warms, colds,
        t_end=t_end, skip=skip, max_concurrency=max_concurrency,
        prestamped=prestamped, grid_times=grid_times,
    )[4]


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
