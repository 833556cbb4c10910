"""Plain PyTorch version of the f32 block engine (the kernel's mirror).

:func:`faas_sweep_ref` is a loop over arrivals of ``[R, M]`` tensor ops in
the same arithmetic order and with the same tie-breaks as the reference
mirror ``repro/kernels/ref.py::faas_sweep_ref`` (base staged path and the
``prestamped`` mode).  It runs on any device: the CPU tests and the
``device="cpu"`` entry points use it, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card.  Its row launcher is registered as backend
``"ref"``.
"""

from __future__ import annotations

import torch

from repro_torch.core.execution import register_backend

NEG = -1e30
ACC_COLS = 8


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
    """
    R, M = alive.shape
    K = dts.shape[1]
    dev = alive.device
    t_exp = _rows(t_exp, R, dev)
    t_end = _rows(t_end, R, dev)
    skip = _rows(skip, R, dev)
    slot_iota = torch.arange(M, dtype=torch.float32, device=dev).expand(R, M)
    t = t0
    acc = torch.zeros((R, ACC_COLS), dtype=torch.float32, device=dev)
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
        acc = acc + delta
        t = t_new
    return alive, creation, busy, t, acc


@register_backend(
    "ref",
    description="plain PyTorch loop over arrivals (the kernel's mirror)",
)
def _ref_sweep_rows(
    alive0, creation0, busy0, t0, t_exp, t_end, skip, dts, warms, colds,
    *, max_concurrency, prestamped,
):
    """Backend ``"ref"``'s row launcher: the ``[C, 8]`` accumulator."""
    return faas_sweep_ref(
        alive0, creation0, busy0, t0, t_exp, dts, warms, colds,
        t_end=t_end, skip=skip, max_concurrency=max_concurrency,
        prestamped=prestamped,
    )[4]
