"""What-if analysis (paper §4.3, Fig. 5): the per-cell loop of the port.

:func:`sweep_legacy` is the reference's ``repro/core/whatif.py::
sweep_legacy``: one :class:`~repro_torch.core.simulator.ServerlessSimulator`
run (one launch of the f64 pool scan, ``kernels/csrc/scan_event_step.cu``,
on the card) per (threshold, rate) cell, kept as the baseline a batched
grid is measured against and as the grid-equivalence oracle.  Cell ``(i,
j)`` draws from the generators of the batched sweep's draw cell ``i * A +
j`` (:func:`~repro_torch.core.simulator.cell_generators` of ``seed`` over
the ``E * A`` cells), so ``sweep_legacy(..., seed)`` equals
``sweep(scn, over={"expiration_threshold": E, "arrival_rate": A}, seed)``
cell by cell, bit for bit.

The reference's ``fresh_jit=True`` (clear the XLA cache before every cell,
the pre-batching compile cost) has no PyTorch counterpart and is left out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.cost import BillingModel, estimate_cost
from repro_torch.core.scenario import Scenario, _rated
from repro_torch.core.simulator import (
    ServerlessSimulator,
    cell_generators,
    draw_workload_samples,
)


@dataclasses.dataclass
class WhatIfResult:
    arrival_rates: np.ndarray  # [A]
    expiration_thresholds: np.ndarray  # [E]
    cold_start_prob: np.ndarray  # [E, A]
    avg_server_count: np.ndarray  # [E, A]
    avg_running_count: np.ndarray  # [E, A]
    wasted_ratio: np.ndarray  # [E, A]
    developer_cost: np.ndarray  # [E, A]
    provider_cost: np.ndarray  # [E, A]

    def best_threshold(self, arrival_idx: int, max_cold_prob: float) -> float:
        """Smallest threshold meeting the cold-start SLO at a given load."""
        ok = self.cold_start_prob[:, arrival_idx] <= max_cold_prob
        if not ok.any():
            return float(self.expiration_thresholds[-1])
        return float(self.expiration_thresholds[np.argmax(ok)])


def _grid_cells(base_config, e, a) -> list:
    base = Scenario.of(base_config)
    return [
        Scenario.of(base, arrival_process=_rated(base.arrival_process, rate),
                    expiration_threshold=float(exp_t))
        for exp_t in e for rate in a
    ]


def sweep_legacy(
    base_config,
    arrival_rates: Sequence[float],
    expiration_thresholds: Sequence[float],
    seed: int,
    replicas: int = 4,
    billing: BillingModel = BillingModel(),
    steps: Optional[int] = None,
    *,
    device=None,
    staged: Optional[Sequence] = None,
) -> WhatIfResult:
    """The per-cell loop: one run, one launch, per (threshold, rate) cell.

    ``steps`` sets every cell's events (default: the grid's largest
    ``steps_needed()``, as :func:`~repro_torch.core.scenario.sweep` sizes
    it); ``staged`` gives each cell's buffers instead (a list of ``E * A``
    ``staged=`` tuples in cell order, e.g. the reference's per-cell draws
    through :func:`repro_torch.interop.staged_from_reference` with
    ``f64=True``).  Each cell runs the f64 engine's default backend on
    ``device``: the kernel on the card, ``"scan_ref"`` on the CPU.
    """
    a = np.asarray(list(arrival_rates), dtype=np.float64)
    e = np.asarray(list(expiration_thresholds), dtype=np.float64)
    cells = _grid_cells(base_config, e, a)
    if staged is not None and len(staged) != len(cells):
        raise ValueError(f"staged= needs one buffer tuple per cell ({len(cells)})")
    n = int(steps) if steps is not None else max(c.steps_needed() for c in cells)
    shape = (len(e), len(a))
    out = {k: np.zeros(shape)
           for k in ("cold", "servers", "running", "wasted", "dev_cost", "prov_cost")}
    gens = None
    for d, cfg in enumerate(cells):
        sim = ServerlessSimulator(cfg, device=device)
        if staged is not None:
            bufs = staged[d]
        else:
            if gens is None:
                gens = cell_generators(seed, len(cells), sim.device)
            bufs = draw_workload_samples(cfg, gens[d], replicas, n, sim.device, f64=True)
        summary = sim.run(seed, replicas=replicas, staged=bufs)
        cost = estimate_cost(summary, billing)
        i, j = divmod(d, len(a))
        out["cold"][i, j] = summary.cold_start_prob
        out["servers"][i, j] = summary.avg_server_count
        out["running"][i, j] = summary.avg_running_count
        out["wasted"][i, j] = summary.avg_wasted_ratio
        out["dev_cost"][i, j] = cost.developer_total
        out["prov_cost"][i, j] = cost.provider_infra_cost
    return WhatIfResult(
        arrival_rates=a,
        expiration_thresholds=e,
        cold_start_prob=out["cold"],
        avg_server_count=out["servers"],
        avg_running_count=out["running"],
        wasted_ratio=out["wasted"],
        developer_cost=out["dev_cost"],
        provider_cost=out["prov_cost"],
    )
