"""Simulation summaries and sample staging for the PyTorch port.

:class:`SimulationSummary` is the reference's per-replica result record
(numpy arrays, host side) with the paper's derived metrics;
:func:`draw_workload_samples` stages the (arrivals, warm, cold) f32
``[R, n]`` sample buffers on the device from three explicit generators.
The helpers below them are what every engine does around its launch:
stage a run's samples behind the coverage guard (:func:`run_samples`),
bring the accumulator to the host behind the overflow guard
(:func:`host_acc`) and read a summary off its base columns
(:func:`summary_from_acc`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


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
    overflow: Optional[np.ndarray] = None

    @property
    def n_requests(self) -> np.ndarray:
        """Processed arrivals per replica (served plus rejected)."""
        return self.n_cold + self.n_warm + self.n_reject

    @property
    def n_completions(self) -> np.ndarray:
        """Served arrivals.  The reference also subtracts timeouts,
        failures and crash interruptions; those layers are not ported yet
        (ROADMAP Queue A item 4), so every served arrival completes."""
        return self.n_cold + self.n_warm

    @property
    def goodput(self) -> float:
        """Successful completions per second (replica mean)."""
        return float(self.n_completions.mean() / max(self.measured_time, 1e-12))

    @property
    def availability(self) -> float:
        """Share of served arrivals not cut by an instance crash: 1.0
        until platform faults are ported (ROADMAP Queue A item 4)."""
        return 1.0

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
            "goodput": self.goodput,
            "availability": self.availability,
        }


def cell_generators(seed: int, n_cells: int, device) -> list:
    """Three generators (arrival, warm, cold) per draw cell.

    Cell ``d`` is seeded from ``numpy.random.SeedSequence(seed).spawn(n)[d]``,
    so every cell's streams are independent and a cell's draws do not
    depend on how many cells the grid has before it changes shape.
    """
    out = []
    for child in np.random.SeedSequence(int(seed)).spawn(int(n_cells)):
        gens = []
        for s in child.generate_state(3, np.uint64):
            g = torch.Generator(device=device)
            g.manual_seed(int(s))
            gens.append(g)
        out.append(tuple(gens))
    return out


def draw_workload_samples(scn, generators, replicas: int, n: int, device, out=None):
    """Draw the (arrivals, warm, cold) f32 ``[replicas, n]`` sample buffers
    on ``device`` from the three generators of one draw cell.

    ``out`` optionally gives three preallocated f32 ``[replicas, n]``
    buffers (views into a sweep's ``[C, K]`` staging) to fill in place.
    """
    g_arr, g_warm, g_cold = generators
    if out is None:
        out = tuple(
            torch.empty((replicas, n), dtype=torch.float32, device=device)
            for _ in range(3)
        )
    arr, warms, colds = out
    scn.arrival_process.sample_into(arr, g_arr)
    scn.warm_service_process.sample_into(warms, g_warm)
    scn.cold_service_process.sample_into(colds, g_cold)
    return arr, warms, colds


def check_staged(staged, rows: int, device) -> tuple:
    """The ``(dts, warms, colds)`` triple handed in instead of draws, as
    contiguous f32 ``[rows, K]`` tensors on ``device``."""
    if len(staged) != 3:
        raise ValueError("staged must be the (dts, warms, colds) triple")
    out = tuple(
        torch.as_tensor(x, dtype=torch.float32).to(device).contiguous() for x in staged
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
    if bool((covered < need).any()):
        raise RuntimeError(
            "pre-drawn arrivals ended before sim_time "
            f"(min final t {covered.min().item():.1f}); pass a larger `steps`"
        )


def run_samples(scn, seed: int, replicas: int, steps, staged, device) -> tuple:
    """The ``(dts, warms, colds)`` of one run: the handed-in ``staged``
    buffers, or ``steps`` (default ``scn.steps_needed()``) draws of one
    draw cell seeded by ``seed``; either way behind the coverage guard."""
    if staged is not None:
        samples = check_staged(staged, replicas, device)
    else:
        n = int(steps or scn.steps_needed())
        samples = draw_workload_samples(
            scn, cell_generators(seed, 1, device)[0], replicas, n, device
        )
    check_covered(samples[0], [scn.sim_time] * replicas, device)
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
