"""The temporal engine on the f32 block kernel: transient analysis from a
custom initial pool.

Paper §3/§4.2: the instance pool starts in an arbitrary state — running
instances with remaining service times, idle instances with elapsed idle
times, each with a creation age — and the metrics are **time-bounded**:
expected instance counts and cold-start availability on a user-supplied
time grid, averaged across Monte-Carlo replicas.

Port of ``repro/core/temporal.py``: the snapshots and
:class:`TemporalSummary` are copied (the port imports nothing of the
reference); :func:`run_temporal` drives the f32 block backends' pool-state
row launcher with the grid as ``grid_times`` rows, and
:class:`ServerlessTemporalSimulator` (:func:`run_temporal64`) the f64
engine's (backends ``"scan"``/``"scan_ref"``), which also serves the
reliability layer, routing and the histogram.
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
    scan_backend,
    scan_cell_summaries,
    scan_launch,
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


def _grid_of(scn, grid) -> np.ndarray:
    """The query grid: ``grid``, or 33 points evenly over the horizon."""
    g = np.asarray(
        grid
        if grid is not None
        else np.linspace(0.0, scn.sim_time, DEFAULT_GRID_POINTS),
        dtype=np.float64,
    )
    if g.ndim != 1 or g.size < 1:
        raise ValueError(f"grid must be a non-empty 1-D sequence of times, got shape {g.shape}")
    return g


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
    g = _grid_of(scn, grid)
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


def run_temporal64(
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
    """Transient analysis on the f64 engine: one launch of the pool scan
    from the snapshot pool (f64), with the grid snapshots of each event's
    pre-event pool and, after the last event, of the final one; the
    reliability layer, routing and the histogram as ``scn`` sets them
    (``skip_time`` is forced to 0).  Returns ``(steady summary,
    TemporalSummary)``."""
    from repro_torch.kernels.ref64 import ScanLayout

    g = _grid_of(scn, grid)
    cfg = scn if scn.skip_time == 0.0 else dataclasses.replace(scn, skip_time=0.0)
    rel = cfg.reliability
    samples = run_samples(cfg, seed, replicas, steps, staged, device, f64=True)
    out = scan_launch(
        cfg, bspec, device, samples, t_exp=cfg.expiration_threshold, t_end=cfg.sim_time,
        skip=0.0, prestamped=cfg.prestamped or cfg.max_retries > 0, engine="temporal",
        t_timeout=None if rel is None else rel.failure.timeout_or_inf,
        p_fail=None if rel is None else rel.failure.p_fail,
        pool=_snapshots_to_pool(initial_instances, cfg.slots), grid=g,
    )
    acc = out.acc.cpu().numpy()
    if acc[:, 9].sum() > 0:
        raise RuntimeError(f"instance-pool overflow; raise Scenario.slots (={cfg.slots})")
    G = g.size
    layout = ScanLayout(H=cfg.hist_bins if cfg.track_histogram else 0, G=G,
                        rely=rel is not None)
    steady = scan_cell_summaries(acc, replicas, [cfg.sim_time], layout,
                                 histogram=cfg.track_histogram)[0]
    B = layout.grid_at
    running = acc[:, B:B + G].mean(axis=0)
    idle = acc[:, B + G:B + 2 * G].mean(axis=0)
    return steady, TemporalSummary(
        grid=g,
        running_at=running,
        idle_at=idle,
        total_at=running + idle,
        cold_prob_at=acc[:, B + 2 * G:B + 3 * G].mean(axis=0),
        steady=steady,
    )


class ServerlessTemporalSimulator:
    """Transient simulator with a custom initial pool on the f64 engine
    (the reference's class): ``skip_time`` is taken as 0, and ``backend``
    is ``"scan"`` (default on a CUDA device) or ``"scan_ref"`` (default on
    the CPU)."""

    def __init__(self, config, initial_instances: Sequence[InstanceSnapshot] = (), *,
                 device=None, backend: Optional[str] = None):
        if config.skip_time != 0.0:
            config = dataclasses.replace(config, skip_time=0.0)
        self.config = config
        self.initial_instances = tuple(initial_instances)
        self.bspec, self.device = scan_backend("temporal", backend, device)

    def run(self, seed: int, grid, replicas: int = 64, steps: Optional[int] = None,
            staged=None) -> TemporalSummary:
        return run_temporal64(
            self.config, seed, self.bspec, self.device, replicas=replicas, steps=steps,
            staged=staged, grid=grid, initial_instances=self.initial_instances,
        )[1]
