"""The temporal engine on the f32 block kernel: transient analysis from a
custom initial pool.

Paper §3/§4.2: the instance pool starts in an arbitrary state — running
instances with remaining service times, idle instances with elapsed idle
times, each with a creation age — and the metrics are **time-bounded**:
expected instance counts and cold-start availability on a user-supplied
time grid, averaged across Monte-Carlo replicas.

Port of ``repro/core/temporal.py``'s block-backend path: the snapshots and
:class:`TemporalSummary` are copied (the port imports nothing of the
reference), and :func:`run_temporal` drives the pool-state row launcher
with the grid as ``grid_times`` rows.  The reference's f64
``ServerlessTemporalSimulator`` class arrives with the f64 engine
(ROADMAP Queue A item 2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.simulator import (
    SimulationSummary,
    host_acc,
    run_samples,
    summary_from_acc,
)
from repro_torch.kernels.ref import ACC_COLS, NEG

# grid points of the default query grid, evenly over [0, sim_time]
DEFAULT_GRID_POINTS = 33


@dataclasses.dataclass(frozen=True)
class InstanceSnapshot:
    """One pre-existing instance at t=0.

    ``idle_for`` is None for a *running* instance (then ``remaining`` is its
    leftover service time); ``remaining`` is None for an *idle* one.
    """

    age: float
    remaining: Optional[float] = None
    idle_for: Optional[float] = None

    def __post_init__(self):
        if (self.remaining is None) == (self.idle_for is None):
            raise ValueError("exactly one of remaining/idle_for must be set")


def _snapshots_to_pool(snapshots: Sequence[InstanceSnapshot], slots: int):
    """The initial ``(alive, creation, busy)`` pool of ``slots`` slots as
    host arrays (bool, f64, f64): ``creation = -age``, ``busy = remaining``
    or ``-idle_for``."""
    alive = np.zeros((slots,), dtype=bool)
    creation = np.full((slots,), NEG, dtype=np.float64)
    busy_until = np.full((slots,), NEG, dtype=np.float64)
    if len(snapshots) > slots:
        raise ValueError(f"{len(snapshots)} snapshots > slots={slots}")
    for i, s in enumerate(snapshots):
        alive[i] = True
        creation[i] = -s.age
        busy_until[i] = s.remaining if s.remaining is not None else -s.idle_for
    return alive, creation, busy_until


@dataclasses.dataclass
class TemporalSummary:
    grid: np.ndarray  # [G] query times
    running_at: np.ndarray  # [G] mean running-instance count at grid times
    idle_at: np.ndarray  # [G]
    total_at: np.ndarray  # [G]
    cold_prob_at: np.ndarray  # [G] P(an arrival at t would be a cold start)
    steady: SimulationSummary  # aggregate metrics over [0, horizon]


def run_temporal(
    scn,
    seed: int,
    bspec,
    device,
    *,
    replicas: int,
    steps: Optional[int],
    staged,
    grid,
    initial_instances: Sequence[InstanceSnapshot],
):
    """Transient analysis on the backend's pool-state row launcher: one
    launch from the snapshot pool, with the query grid (default: 33 points
    over the horizon) as per-row ``grid_times``.  Each grid point falls in
    exactly one inter-arrival interval, so the kernel's additive grid
    columns are the scan engine's snapshots.  ``skip_time`` is forced to 0.
    Returns ``(steady summary, TemporalSummary)``."""
    g = np.asarray(
        grid
        if grid is not None
        else np.linspace(0.0, scn.sim_time, DEFAULT_GRID_POINTS),
        dtype=np.float64,
    )
    if g.ndim != 1 or g.size < 1:
        raise ValueError(f"grid must be a non-empty 1-D sequence of times, got shape {g.shape}")
    cfg = scn if scn.skip_time == 0.0 else dataclasses.replace(scn, skip_time=0.0)
    # the grid curves need every stream to cross the horizon (the coverage
    # guard): a truncated one would silently zero the late points
    dts, warms, colds = run_samples(cfg, seed, replicas, steps, staged, device)
    M = cfg.slots
    pool = _snapshots_to_pool(initial_instances, M)
    # f64 snapshots cast to f32 as the reference casts them
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)
    bcast = lambda x: f32(x).expand(replicas, M).contiguous()
    rows = lambda v: torch.full((replicas,), v, dtype=torch.float32, device=device)
    G = g.size
    acc = host_acc(bspec.launch_for("temporal")(
        *map(bcast, pool),
        rows(0.0),
        rows(cfg.expiration_threshold),
        rows(cfg.sim_time),
        rows(0.0),
        dts, warms, colds,
        max_concurrency=cfg.max_concurrency,
        prestamped=cfg.prestamped,
        grid_times=f32(np.tile(g, (replicas, 1))),
    ))
    steady = summary_from_acc(acc, cfg.sim_time)
    B = ACC_COLS
    running = acc[:, B : B + G].mean(axis=0)
    idle = acc[:, B + G : B + 2 * G].mean(axis=0)
    return steady, TemporalSummary(
        grid=g,
        running_at=running,
        idle_at=idle,
        total_at=running + idle,
        cold_prob_at=acc[:, B + 2 * G : B + 3 * G].mean(axis=0),
        steady=steady,
    )
