"""Grid sharding in the port (``Execution(devices=..., shard="grid")``) on
the CPU, where a device named more than once is one shard per entry: the
plan's refusals and normalisation (the twins of the reference's own plan
tests), ``sweep()`` split 2, 3 and 4 ways over ``("cpu",) * n`` on the
plain backends ``scan_ref`` and ``ref``, ``sweep(deferred=True)`` sharded,
``fleet_sweep()`` sharded, the sharded port against the JAX package's
single-device grids on the reference's own buffers, and one online
what-if tick under a sharded plan.

Tolerances: a sharded grid is the unsharded one bit for bit, every cell
and every field (rows are independent, and the spans' accumulators are
joined in row order).  Against the JAX package: counters equal, f64 sums
within rtol 1e-12, the f32 block engine's integrals within rtol 1e-5 (XLA
and torch associate the sums over slots differently); the reference's
own sharded runs fail on this tree, so its single-device grids are the
yardstick.  The card's kernels are held to the same equalities in
``test_torch_cuda.py``."""

import dataclasses
import itertools
import math

import jax
import numpy as np
import pytest
import torch

import repro.core.processes as jproc
from repro.core import Scenario as JScenario
from repro.core import fleet as jfleet
from repro.core import scenario as jscn
from repro.core import simulator as jsim
from repro.core.reliability import FailurePolicy as JFail, Reliability as JRely
from repro.data import catalog as jcat
from repro_torch import interop
from repro_torch.core import execution as rexec
from repro_torch.core import fleet as rfleet
from repro_torch.core import scenario as rscn
from repro_torch.core.execution import Execution, register_backend, shard_spans
from repro_torch.core.faults import CapacityProfile, FaultModel
from repro_torch.core.processes import ExpSimProcess
from repro_torch.core.reliability import FailurePolicy, Reliability, RetryPolicy
from repro_torch.core.scenario import PendingSweep, Scenario
from repro_torch.core.simulator import deferred_guards
from repro_torch.kernels import ref as rref
from repro_torch.kernels import ref64 as rref64
from repro_torch.serving import OnlineConfig, OnlineWhatIfService

F64_RTOL = 1e-12
F32_RTOL = 1e-5
COUNTERS = ("n_cold", "n_warm", "n_reject", "lifespan_count", "overflow")
SUMS = ("time_running", "time_idle", "sum_cold_resp", "sum_warm_resp", "lifespan_sum")


def cpus(n):
    return Execution(device="cpu", devices=("cpu",) * n, shard="grid")


def base_scn(**kw):
    d = dict(
        arrival_process=ExpSimProcess(rate=0.9),
        warm_service_process=ExpSimProcess(rate=0.5),
        cold_service_process=ExpSimProcess(rate=0.4),
        expiration_threshold=20.0,
        sim_time=200.0,
        skip_time=10.0,
        slots=16,
    )
    d.update(kw)
    return Scenario(**d)


def assert_same(a, b, where=""):
    """Equal bit for bit: arrays, floats, None, and dataclasses (summaries,
    windows) field by field."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a) is type(b), where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif a is None or b is None:
        assert a is None and b is None, where
    elif isinstance(a, (tuple, list)) and not isinstance(a, np.ndarray):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)


def assert_grids_same(got, want):
    assert got.axes == want.axes and got.shape == want.shape
    for f in got._METRIC_FIELDS + got._WINDOWED_FIELDS + ("window_bounds",):
        assert_same(getattr(got, f), getattr(want, f), f)
    for idx in np.ndindex(got.shape):
        assert_same(got.summaries[idx], want.summaries[idx], f"summaries{idx}")


# ---------------------------------------------------------------------------
# (a) the plan: refusals and normalisation
# ---------------------------------------------------------------------------


def test_plan_validation():
    """tests/test_execution.py:58-67: unknown shard spec, zero devices."""
    with pytest.raises(ValueError, match="shard"):
        Execution(shard="replicas")
    with pytest.raises(ValueError, match="devices"):
        Execution(devices=0)
    with pytest.raises(ValueError, match="devices sequence is empty"):
        Execution(devices=[])
    with pytest.raises(ValueError, match="all be CUDA devices or all 'cpu'"):
        Execution(devices=("cpu", "cuda:0"))
    with pytest.raises(TypeError, match="devices"):
        Execution(devices=True)
    assert (Execution().devices, Execution().shard) == (None, None)


def test_devices_sequence_normalized():
    """tests/test_execution.py:69-74: a sequence becomes a tuple of
    devices, a count resolves to that many, too many raise."""
    e = cpus(3)
    assert e.devices == (torch.device("cpu"),) * 3
    assert e.resolved_devices() == (torch.device("cpu"),) * 3 and e.n_devices == 3
    assert Execution(device="cpu", devices=["cpu", "cpu"], shard="grid").n_devices == 2
    assert Execution(device="cpu", devices=1, shard="grid").resolved_devices() == (
        torch.device("cpu"),)
    assert Execution(device="cpu", shard="grid").resolved_devices() == (torch.device("cpu"),)
    # the first of the devices stages when device= is unset
    assert Execution(devices=("cpu", "cpu"), shard="grid").resolve()[1] == torch.device("cpu")
    with pytest.raises(ValueError, match="only 1 is valid"):
        Execution(device="cpu", devices=2, shard="grid").resolved_devices()
    with pytest.raises(ValueError, match="are not on"):
        Execution(device="cpu", devices=("cuda:0",) * 2, shard="grid").resolve()
    if not torch.cuda.is_available():
        # a CUDA entry on a host without the device raises, no fallback
        for plan in (Execution(devices=("cuda:0",) * 2, shard="grid"),
                     Execution(devices=2, shard="grid"), Execution(shard="grid")):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                plan.resolve()
    else:
        with pytest.raises(ValueError, match="devices are visible"):
            Execution(devices=torch.cuda.device_count() + 1, shard="grid").resolved_devices()


def test_devices_without_shard_rejected():
    """tests/test_execution.py:210-215."""
    with pytest.raises(ValueError, match="shard='grid'"):
        Execution(device="cpu", devices=("cpu",)).resolve()
    Execution(device="cpu", devices=("cpu",), shard="grid").resolve()


def test_fused_draws_refuse_shard():
    with pytest.raises(ValueError, match="draws='staged'"):
        Execution(device="cpu", draws="fused", shard="grid").resolve()
    with pytest.raises(ValueError, match="draws='staged'"):
        rscn.sweep(base_scn(), {"expiration_threshold": [10.0]}, 0, replicas=2,
                   execution=dataclasses.replace(cpus(2), draws="fused"))


def test_shard_capability_declared():
    """tests/test_execution.py:143-163: every shipped sweep backend is
    shardable; the declaration is enforced for one that opts out."""
    register_backend("noshard-test")(lambda *a, **k: None)
    try:
        with pytest.raises(ValueError, match="shardable backends: .*'scan_ref'"):
            Execution(device="cpu", backend="noshard-test", shard="grid").resolve()
    finally:
        del rexec._BACKENDS["noshard-test"]
    for name in ("ref", "scan_ref", "cuda", "scan"):
        assert rexec.resolve_backend(name).shardable, name
    Execution(device="cpu", backend="ref", shard="grid").resolve()
    Execution(device="cpu", backend="scan_ref", shard="grid").resolve()


def test_run_rejects_shard():
    """tests/test_execution.py:275-280."""
    with pytest.raises(ValueError, match="sweep"):
        rscn.run(base_scn(), 0, replicas=2, execution=cpus(2))


def test_fleet_refusals():
    """tests/test_fleet.py:372-380 and fleet_run's own refusal."""
    fleet = small_fleet()
    with pytest.raises(ValueError, match="backend='scan'"):
        rfleet.fleet_sweep(fleet, {"expiration_threshold": [10.0]}, 0, replicas=1,
                           execution=dataclasses.replace(cpus(2), backend="ref"))
    with pytest.raises(ValueError, match="backend='scan'"):
        rfleet.fleet_run(fleet, 0, replicas=1, backend="ref", execution=cpus(2))
    with pytest.raises(ValueError, match="fleet_sweep"):
        rfleet.fleet_run(fleet, 0, replicas=1, execution=cpus(2))


@pytest.mark.parametrize("what", ["reliability", "crash_rate", "capacity"])
def test_block_sweeps_refuse_reliability_and_faults(what):
    """src/repro/core/scenario.py:1838-1847: sharded block sweeps run no
    reliability and no faults."""
    if what == "reliability":
        scn, match = base_scn(reliability=Reliability(failure=FailurePolicy(p_fail=0.1))), \
            "reliability sweeps on block backends"
    else:
        flt = (FaultModel(crash_rate=0.01) if what == "crash_rate" else
               FaultModel(capacity=CapacityProfile(edges=(50.0,), values=(4.0, 2.0))))
        scn, match = base_scn(faults=flt), "fault sweeps on block backends"
    plan = dataclasses.replace(cpus(2), backend="ref")
    with pytest.raises(ValueError, match=match):
        rscn.sweep(scn, {"expiration_threshold": [10.0]}, 0, replicas=2, execution=plan)
    # single-device they run
    rscn.sweep(scn, {"expiration_threshold": [10.0]}, 0, replicas=2, device="cpu",
               backend="ref", steps=400)


@pytest.mark.parametrize("rows, n", [(18, 4), (18, 3), (7, 2), (3, 5), (1, 1)])
def test_shard_spans_cover_rows_in_order(rows, n):
    spans = shard_spans(rows, n)
    assert len(spans) == min(rows, n)
    assert spans[0][0] == 0 and spans[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    sizes = [hi - lo for lo, hi in spans]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    assert sizes == sorted(sizes, reverse=True)


def test_grid_result_records_the_plan():
    grid = rscn.sweep(base_scn(), {"expiration_threshold": [10.0, 40.0]}, 1, replicas=3,
                      execution=cpus(2))
    assert grid.execution.shard == "grid"
    assert grid.execution.devices == (torch.device("cpu"),) * 2
    d = grid.to_dict()
    assert d["shard"] == "grid" and d["devices"] == ["cpu", "cpu"]
    plain = rscn.sweep(base_scn(), {"expiration_threshold": [10.0, 40.0]}, 1, replicas=3,
                       device="cpu")
    assert plain.execution.devices is None and "shard" not in plain.to_dict()


# ---------------------------------------------------------------------------
# (b) sweep() sharded 2, 3 and 4 ways, bit for bit
# ---------------------------------------------------------------------------

# 3 thresholds x 2 horizons x 3 replicas = 18 rows: 4 shards take 5, 5, 4
# and 4 rows, cutting cells apart
OVER = {"expiration_threshold": [10.0, 40.0, 160.0], "sim_time": [150.0, 200.0]}
REPLICAS = 3

SWEEP_CASES = {
    "scan_ref_windows": ("scan_ref", dict(window_bounds=(0.0, 40.0, 90.0, 200.0)), {}),
    "scan_ref_histogram": ("scan_ref", dict(track_histogram=True, hist_bins=8), {}),
    "scan_ref_retries": ("scan_ref", dict(
        reliability=Reliability(failure=FailurePolicy(p_fail=0.15, t_timeout=3.0),
                                retry=RetryPolicy(max_retries=1, backoff_base=0.5)),
        max_concurrency=4), {"t_timeout": [2.0, 6.0]}),
    "scan_ref_crashes_capacity": ("scan_ref", dict(
        faults=FaultModel(crash_rate=0.02,
                          capacity=CapacityProfile(edges=(60.0,), values=(5.0, 2.5)))),
        {"crash_rate": [0.0, 0.03]}),
    "ref_windows": ("ref", dict(window_bounds=(0.0, 40.0, 90.0, 200.0)), {}),
}


def sweep_case(case, execution, **kw):
    backend, fields, extra = SWEEP_CASES[case]
    over = dict(OVER, **extra)
    return rscn.sweep(base_scn(**fields), over, 5, replicas=REPLICAS,
                      execution=dataclasses.replace(execution, backend=backend), **kw)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_sharded_sweep_bitwise_equals_unsharded(case, n, monkeypatch):
    want = sweep_case(case, Execution(device="cpu"))
    backend = SWEEP_CASES[case][0]
    mod, name = (rref64, "scan_sweep_ref") if backend == "scan_ref" else (rref, "faas_sweep_ref")
    rows, real = [], getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda alive, *a, **k: rows.append(alive.shape[0])
                        or real(alive, *a, **k))
    got = sweep_case(case, cpus(n))
    # one launch a shard, each on its span of the rows
    C = len(want.summaries.ravel()) * REPLICAS
    assert rows == [hi - lo for lo, hi in shard_spans(C, n)]
    assert_grids_same(got, want)
    assert got.execution.devices == (torch.device("cpu"),) * n


def test_sharded_static_axis_launches_each_combination_per_shard(monkeypatch):
    rows, real = [], rref64.scan_sweep_ref
    monkeypatch.setattr(rref64, "scan_sweep_ref",
                        lambda alive, *a, **k: rows.append(alive.shape) or real(alive, *a, **k))
    over = {"slots": [8, 16], "expiration_threshold": [10.0, 40.0, 160.0]}
    got = rscn.sweep(base_scn(), over, 2, replicas=REPLICAS, execution=cpus(2))
    assert rows == [(5, 8), (4, 8), (5, 16), (4, 16)]
    assert_grids_same(got, rscn.sweep(base_scn(), over, 2, replicas=REPLICAS, device="cpu"))


def test_window_check_waits_for_the_guards_reads():
    """Inside deferred_guards() the wrappers' window-bound check computes
    its flag and leaves the read to the caller, so no shard's launch reads
    the device before the next is enqueued; outside, it raises at once."""
    bad = torch.tensor([[0.0, 5.0, 3.0]], dtype=torch.float64)
    with pytest.raises(ValueError, match="strictly increasing"):
        rref64.check_increasing(bad)
    with deferred_guards() as reads:
        rref64.check_increasing(bad)
        rref64.check_increasing(torch.tensor([[0.0, 1.0]], dtype=torch.float64))
    assert len(reads) == 2
    reads[1]()
    with pytest.raises(ValueError, match="strictly increasing"):
        reads[0]()


# ---------------------------------------------------------------------------
# (c) deferred sharded sweeps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["scan_ref_windows", "scan_ref_retries"])
def test_deferred_sharded_equals_sync_sharded(case):
    sync = sweep_case(case, cpus(3))
    pend = sweep_case(case, cpus(3), deferred=True)
    assert isinstance(pend, PendingSweep)
    got = pend.result()
    assert_grids_same(got, sync)
    assert pend.result() is got


def test_deferred_sharded_guards_raise_on_result():
    scn = base_scn(sim_time=150.0, skip_time=0.0)
    pend = rscn.sweep(scn, {"expiration_threshold": [20.0]}, 0, replicas=4, steps=20,
                      execution=cpus(2), deferred=True)
    with pytest.raises(RuntimeError, match="before sim_time"):
        pend.result()


# ---------------------------------------------------------------------------
# (d) fleet_sweep() sharded
# ---------------------------------------------------------------------------


def small_fleet(**kw):
    fns = tuple(
        rfleet.FleetFunction(name=f"f{f}", arrival_process=ExpSimProcess(rate=0.6 + 0.2 * f),
                             warm_service_process=ExpSimProcess(rate=0.5),
                             cold_service_process=ExpSimProcess(rate=0.4),
                             expiration_threshold=15.0 + 10 * f, max_concurrency=4)
        for f in range(3)
    )
    d = dict(functions=fns, n_cluster=5.0, sim_time=150.0, skip_time=10.0, slots=8)
    d.update(kw)
    return rfleet.FleetScenario(**d)


FLEET_CASES = {
    "queues": dict(queue_depth=2),
    "faults": dict(faults=FaultModel(crash_rate=0.02,
                                     capacity=CapacityProfile(edges=(60.0,), values=(5.0, 2.0)))),
}


@pytest.mark.parametrize("case", list(FLEET_CASES))
def test_sharded_fleet_sweep_bitwise_equals_unsharded(case, monkeypatch):
    fleet = small_fleet(**FLEET_CASES[case])
    # 2 cells x 5 replicas = 10 fleets in 3 shards: rows 4, 3, 3, the second
    # reading stream rows 4, 0, 1 (gathered and rebased)
    over = {"expiration_threshold": [12.0, (8.0, 30.0, 90.0)]}
    want = rfleet.fleet_sweep(fleet, over, 4, replicas=5, device="cpu")
    calls, real = [], rref64.fleet_scan_sweep_ref
    monkeypatch.setattr(rref64, "fleet_scan_sweep_ref", lambda *a, **k: calls.append(
        (a[0].shape[0], a[6].shape[0], tuple(a[5].tolist()))) or real(*a, **k))
    got = rfleet.fleet_sweep(fleet, over, 4, replicas=5, execution=cpus(3))
    assert calls == [(4, 4, (0, 1, 2, 3)), (3, 3, (2, 0, 1)), (3, 3, (0, 1, 2))]
    assert_grids_same(got, want)
    for f in ("queue_wait_avg", "cluster_utilization", "peak_cluster"):
        assert_same(getattr(got, f), getattr(want, f), f)
    assert got.execution.shard == "grid" and got.execution.devices == (torch.device("cpu"),) * 3


# ---------------------------------------------------------------------------
# (e) against the JAX package's single-device grids, on its own buffers
# ---------------------------------------------------------------------------


def _jax_base(**kw):
    d = dict(arrival_process=jproc.ExpSimProcess(rate=0.9),
             warm_service_process=jproc.ExpSimProcess(rate=0.5),
             cold_service_process=jproc.ExpSimProcess(rate=0.4),
             expiration_threshold=20.0, sim_time=300.0, skip_time=10.0, slots=16)
    d.update(kw)
    return JScenario(**d)


def _reference_parts(jbase, over, key, R, n):
    """The reference's chained draws, one per draw cell, at the grid's
    largest horizon."""
    draw_names = [k for k in over if k in jscn._DRAW_FIELDS]
    max_sim = float(max(over.get("sim_time", (jbase.sim_time,))))
    parts = []
    for combo in itertools.product(*[over[k] for k in draw_names]):
        c = jbase
        for k, v in zip(draw_names, combo):
            c = jscn._apply_axis(c, k, v)
        key, sub = jax.random.split(key)
        c = JScenario.of(c, sim_time=max_sim)
        if c.reliability is not None:
            smp, ext = jsim.draw_reliability_stream(c, sub, R, n)
            parts.append((tuple(map(np.asarray, smp)), tuple(map(np.asarray, ext))))
        else:
            parts.append(tuple(np.asarray(x) for x in jsim.draw_workload_samples(c, sub, R, n)))
    return parts


@pytest.mark.parametrize("backend, fields", [
    ("scan_ref", dict(window_bounds=(0.0, 60.0, 300.0))),
    ("scan_ref", dict(reliability=JRely(failure=JFail(p_fail=0.1, t_timeout=3.0)))),
    ("ref", dict(window_bounds=(0.0, 60.0, 300.0))),
])
def test_sharded_sweep_matches_jax_single_device(backend, fields):
    jbase = _jax_base(**fields)
    over = {"expiration_threshold": [10.0, 40.0, 90.0], "sim_time": [200.0, 300.0]}
    R, key = 3, jax.random.key(3)
    n = JScenario.of(jbase, sim_time=300.0).steps_needed()
    jb = "scan" if backend == "scan_ref" else "ref"
    ref = jscn.sweep(jbase, over, key, replicas=R, backend=jb, steps=n)
    staged = interop.staged_from_reference(_reference_parts(jbase, over, key, R, n),
                                           f64=backend == "scan_ref")
    port = rscn.sweep(interop.scenario_from_reference(jbase), over, 0, replicas=R,
                      staged=staged, execution=dataclasses.replace(cpus(4), backend=backend))
    rtol = F64_RTOL if backend == "scan_ref" else F32_RTOL
    assert port.shape == ref.shape
    for idx in np.ndindex(port.shape):
        p, r = port.summaries[idx], ref.summaries[idx]
        counters = COUNTERS if backend == "scan_ref" else ("n_cold", "n_warm", "n_reject")
        for f in counters:
            np.testing.assert_array_equal(getattr(p, f), np.asarray(getattr(r, f)), err_msg=f)
        for f in ("time_running", "time_idle", "sum_cold_resp", "sum_warm_resp"):
            np.testing.assert_allclose(getattr(p, f), np.asarray(getattr(r, f)), rtol=rtol,
                                       atol=1e-6, err_msg=f)
        if jbase.reliability is not None:
            for f in ("n_timeout", "n_fail"):
                np.testing.assert_array_equal(getattr(p, f), np.asarray(getattr(r, f)))
        if jbase.window_bounds is not None:
            for f in ("n_cold", "n_warm", "n_arrivals"):
                np.testing.assert_array_equal(getattr(p.windows, f),
                                              np.asarray(getattr(r.windows, f)), err_msg=f)


def test_sharded_fleet_sweep_matches_jax_single_device():
    jf = jcat.fleet_of(["thumbnail", "compression", "ml-inference"], n_cluster=6,
                       sim_time=300.0, skip_time=20.0, slots=16)
    over = {"expiration_threshold": [30.0, (20.0, 60.0, 120.0)], "n_cluster": [3.0, math.inf]}
    key = jax.random.key(2)
    ref = jfleet.fleet_sweep(jf, over, key, replicas=3, backend="scan")
    st = interop.fleet_staged_from_reference(jfleet._stage_fleet(jf, key, 3, None, jf.sim_time))
    port = rfleet.fleet_sweep(interop.fleet_from_reference(jf), over, 0, replicas=3,
                              staged=st, execution=dataclasses.replace(cpus(5),
                                                                       backend="scan_ref"))
    assert port.axes == ref.axes
    for idx in np.ndindex(port.shape):
        p, r = port.summaries[idx], ref.summaries[idx]
        for f in COUNTERS:
            np.testing.assert_array_equal(getattr(p, f), np.asarray(getattr(r, f)),
                                          err_msg=f"{f} at {idx}")
        for f in SUMS:
            np.testing.assert_allclose(getattr(p, f), np.asarray(getattr(r, f)),
                                       rtol=F64_RTOL, atol=1e-9, err_msg=f"{f} at {idx}")
    np.testing.assert_array_equal(port.peak_cluster, ref.peak_cluster)


# ---------------------------------------------------------------------------
# (f) the online service under a sharded plan
# ---------------------------------------------------------------------------


def test_online_tick_with_sharded_plan_equals_unsharded():
    cfg = dict(rate_ceiling=4.0, n_bins=6, bin_width=25.0, thresholds=(30.0, 120.0, 600.0),
               replicas=3, overlap=False)
    base = base_scn(slots=32)
    plain = OnlineWhatIfService(base, OnlineConfig(device="cpu", **cfg))
    sharded = OnlineWhatIfService(base, OnlineConfig(execution=cpus(2), **cfg))
    rng = np.random.default_rng(4)
    ts = np.cumsum(rng.exponential(1.0, 150))
    for svc in (plain, sharded):
        svc.observe(ts)
    a, b = plain.tick(), sharded.tick()
    assert a.threshold == b.threshold and a.applied_threshold == b.applied_threshold
    assert_grids_same(b.grid, a.grid)
    assert b.grid.execution.devices == (torch.device("cpu"),) * 2
