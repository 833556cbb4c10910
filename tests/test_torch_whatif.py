"""The port's per-cell what-if loop (``core/whatif.py::sweep_legacy``)
against the JAX reference's and against the port's own batched sweep, on
the CPU at small sizes.

On the reference's own per-cell draws (its chained key walk) the port's
loop gives the reference's counters exactly and its float metrics within
``FLOAT_RTOL``.  On its own draws, cell ``(i, j)`` takes the batched
sweep's draw cell ``i * A + j``, so the loop equals ``sweep()`` bit for bit.
"""

import jax
import numpy as np
import pytest

import repro.core.processes as jproc
from repro.core import Scenario as JScenario
from repro.core.simulator import draw_workload_samples as j_draw
from repro.core.whatif import sweep_legacy as j_sweep_legacy
from repro_torch import interop
from repro_torch.core import processes as rproc
from repro_torch.core.scenario import Scenario, sweep
from repro_torch.core.whatif import WhatIfResult, sweep_legacy

FLOAT_RTOL = 1e-12
RATES = [0.5, 1.0]
THRESHOLDS = [10.0, 30.0, 60.0]
STEPS = 900  # covers the fastest rate on the 500 s horizon
METRICS = ("cold_start_prob", "avg_server_count", "avg_running_count", "wasted_ratio",
           "developer_cost", "provider_cost")


def base_cfg(**kw):
    d = dict(
        arrival_process=rproc.ExpSimProcess(rate=0.8),
        warm_service_process=rproc.ExpSimProcess(rate=0.5),
        cold_service_process=rproc.ExpSimProcess(rate=0.4),
        expiration_threshold=20.0, sim_time=500.0, skip_time=10.0, slots=32,
    )
    d.update(kw)
    return Scenario(**d)


def j_base_cfg():
    return JScenario(
        arrival_process=jproc.ExpSimProcess(rate=0.8),
        warm_service_process=jproc.ExpSimProcess(rate=0.5),
        cold_service_process=jproc.ExpSimProcess(rate=0.4),
        expiration_threshold=20.0, sim_time=500.0, skip_time=10.0, slots=32,
    )


def batched(cfg, rates, thresholds, seed, replicas=2, steps=None):
    return sweep(cfg, {"expiration_threshold": [float(x) for x in thresholds],
                       "arrival_rate": [float(x) for x in rates]},
                 seed, replicas=replicas, steps=steps, device="cpu")


@pytest.mark.parametrize("seed, steps", [(11, STEPS), (4, None)])
def test_equals_batched_sweep_cell_by_cell(seed, steps):
    cfg = base_cfg()
    legacy = sweep_legacy(cfg, RATES, THRESHOLDS, seed, replicas=2, steps=steps, device="cpu")
    grid = batched(cfg, RATES, THRESHOLDS, seed, steps=steps)
    assert isinstance(legacy, WhatIfResult)
    for m in METRICS:
        np.testing.assert_array_equal(getattr(legacy, m), getattr(grid, m), err_msg=m)
    np.testing.assert_array_equal(legacy.arrival_rates, RATES)
    np.testing.assert_array_equal(legacy.expiration_thresholds, THRESHOLDS)


def test_nhpp_base_equals_batched_sweep():
    prof = rproc.PiecewiseConstantRate(edges=(150.0, 300.0), rates=(0.4, 1.2, 0.7))
    cfg = base_cfg(arrival_process=rproc.NHPPArrivalProcess(profile=prof))
    legacy = sweep_legacy(cfg, [0.6, 0.9], [15.0, 45.0], 2, replicas=2, device="cpu")
    grid = batched(cfg, [0.6, 0.9], [15.0, 45.0], 2)
    for m in METRICS:
        np.testing.assert_array_equal(getattr(legacy, m), getattr(grid, m), err_msg=m)


def test_matches_reference_on_its_draws():
    """The reference's per-cell buffers (its split walk, which its own loop
    and batched sweep share) through the port's loop: the reference's
    metrics."""
    key = jax.random.key(11)
    ref = j_sweep_legacy(j_base_cfg(), RATES, THRESHOLDS, key, replicas=2, steps=STEPS)
    jcfg = j_base_cfg()
    staged, k = [], key
    for t in THRESHOLDS:
        for r in RATES:
            k, sub = jax.random.split(k)
            c = JScenario.of(jcfg, arrival_process=jproc.ExpSimProcess(rate=r),
                             expiration_threshold=t)
            part = tuple(np.asarray(x) for x in j_draw(c, sub, 2, STEPS))
            staged.append(interop.staged_from_reference([part], f64=True))
    port = sweep_legacy(base_cfg(), RATES, THRESHOLDS, 0, replicas=2, device="cpu",
                        staged=staged)
    for m in METRICS:
        np.testing.assert_allclose(getattr(port, m), np.asarray(getattr(ref, m)),
                                   rtol=FLOAT_RTOL, err_msg=m)
    assert port.best_threshold(0, 0.05) == ref.best_threshold(0, 0.05)


def test_best_threshold_and_monotone():
    res = sweep_legacy(base_cfg(sim_time=2000.0), RATES, THRESHOLDS, 0, replicas=4,
                       device="cpu")
    assert (np.diff(res.cold_start_prob, axis=0) <= 0.02).all()
    assert res.best_threshold(1, 1.0) == THRESHOLDS[0]
    assert res.best_threshold(0, -1.0) == THRESHOLDS[-1]


def test_staged_needs_one_tuple_per_cell():
    with pytest.raises(ValueError, match="one buffer tuple per cell"):
        sweep_legacy(base_cfg(), RATES, THRESHOLDS, 0, device="cpu", staged=[()])
