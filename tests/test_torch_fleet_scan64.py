"""The port's f64 fleet scan (backend ``"scan_ref"``, the plain version
``kernels/ref64.py::fleet_scan_sweep_ref``) against the reference, through
``fleet_run``/``fleet_sweep``: decision for decision against the pure-Python
oracle ``repro.core.pyref.simulate_fleet_pyref`` on merged streams made
with numpy (F = 1, 3, 8, 9, 16; queues; gap and prestamped streams;
binding and unbounded clusters and limits; crashes, a capacity dip and
creation ties under a fractional ceiling), against the JAX fleet scan on
the reference's own merged stream, and the one-function fleet against
``run()`` on the f64 engine.  The CUDA kernel is held to the plain version
in ``test_torch_cuda.py``.

Tolerances: counters, the peak and the queues are equal; sums of f64
pieces (integrals, response and queue-wait sums, lifespans) agree to rtol
1e-12 against the JAX scan (the same pieces, added in another order where
a sum runs over slots) and to rtol 1e-9 against the oracle (Python floats,
summed per instance)."""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.core import fleet as jfleet
from repro.core.processes import ExpSimProcess as JExp
from repro.core.pyref import simulate_fleet_pyref
from repro.core.simulator import draw_crash_uniforms as j_draw_crash
from repro.data import catalog as jcat
from repro_torch import interop
from repro_torch.core import fleet as rfleet
from repro_torch.core import scenario as rscn
from repro_torch.core.faults import CapacityProfile, FaultModel
from repro_torch.core.processes import ExpSimProcess
from repro_torch.kernels.ref64 import FLEET64_COLS, fleet_scan_sweep_ref

ORACLE_RTOL = 1e-9
JAX_RTOL = 1e-12
COUNTS = ("n_cold", "n_warm", "n_reject", "lifespan_count", "overflow")
SUMS = ("time_running", "time_idle", "sum_cold_resp", "sum_warm_resp", "lifespan_sum")
FAULT_COUNTS = ("n_crash", "n_evict", "n_interrupt")


def _fleet(F, t_exps, limits, *, ncl, Q, sim, skip, slots, faults=None):
    fns = tuple(
        rfleet.FleetFunction(
            name=f"f{f}", arrival_process=ExpSimProcess(rate=1.0),
            warm_service_process=ExpSimProcess(rate=0.5),
            cold_service_process=ExpSimProcess(rate=0.4),
            expiration_threshold=float(t_exps[f]), max_concurrency=int(limits[f]),
        )
        for f in range(F)
    )
    return rfleet.FleetScenario(functions=fns, n_cluster=ncl, queue_depth=Q, sim_time=sim,
                                skip_time=skip, slots=slots, faults=faults)


def _stream(seed, F, R, K, rate, prestamped, sim, ties=0):
    """A merged stream: each function's events up to past ``sim`` (so each
    function covers the horizon), merged by time; with ``ties`` events in
    groups of that many equal times."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, (R, K)).astype(np.float32)
    times = np.cumsum(gaps.astype(np.float64), 1)
    if ties:
        times = np.repeat(times[:, ::ties], ties, 1)[:, :K]
    fids = rng.integers(0, F, (R, K))
    # the last F events of every row: one per function, past the horizon
    fids[:, -F:] = np.arange(F)
    times[:, -F:] = sim + 1.0 + np.arange(F)
    warms = rng.exponential(2.0, (R, K)).astype(np.float32)
    colds = rng.exponential(2.5, (R, K)).astype(np.float32)
    if not prestamped:
        gaps = np.diff(times, axis=1, prepend=0.0).astype(np.float32)
    return dict(times=times if prestamped else gaps, fids=fids.astype(np.uint8), warms=warms,
                colds=colds, prestamped=prestamped), rng


CASES = {
    # F, Q, prestamped, ncl, limits, slots
    "one_gaps": (1, 0, False, math.inf, 1000, 16),
    "one_queue": (1, 2, False, 3.0, 1000, 16),
    "three_queue_binding": (3, 2, True, 4.0, (3, 2, 5), 16),
    "three_gaps": (3, 0, False, 5.0, 1000, 16),
    "eight_limits_bind": (8, 0, True, math.inf, 2, 16),
    "eight_queue": (8, 2, True, 6.0, 1000, 16),
    "nine_queue": (9, 2, True, 8.0, 1000, 16),
    "nine_unbounded": (9, 0, False, math.inf, 1000, 8),
    "sixteen": (16, 0, True, 12.0, 1000, 16),
    "sixteen_queue": (16, 2, True, 10.0, (2, 3) * 8, 16),
}


def _oracle_check(port, st, fleet, rows, *, crash_u=None, flt=None):
    F = len(fleet.functions)
    t_exps = [fn.expiration_threshold for fn in fleet.functions]
    limits = [fn.max_concurrency for fn in fleet.functions]
    for r in range(rows):
        kw = {}
        if flt is not None and flt.crashes:
            kw.update(crash_rate=flt.crash_rate, crash_u=crash_u[r])
        if flt is not None and flt.capacity is not None:
            kw.update(cap_edges=flt.capacity.edges, cap_values=flt.capacity.values)
        py = simulate_fleet_pyref(
            st["times"][r], st["fids"][r], st["warms"][r], st["colds"][r], t_exps, limits,
            fleet.n_cluster, fleet.queue_depth, fleet.sim_time, fleet.skip_time,
            prestamped=st["prestamped"], **kw,
        )
        s = port.summary
        got = lambda name: np.array([getattr(s.summaries[f], name)[r] for f in range(F)])
        for name in ("n_cold", "n_warm", "n_reject", "lifespan_count"):
            np.testing.assert_array_equal(got(name), getattr(py, name), err_msg=name)
        if flt is not None:
            for name in FAULT_COUNTS:
                np.testing.assert_array_equal(got(name), getattr(py, name), err_msg=name)
        np.testing.assert_array_equal(s.arrivals[:, r], py.arrivals)
        np.testing.assert_array_equal(s.enqueued[:, r], py.enqueued)
        np.testing.assert_array_equal(s.queue_served[:, r], py.queue_served)
        np.testing.assert_array_equal(s.queue_left[:, r], py.queue_left)
        assert s.peak_cluster[r] == py.peak_cluster
        for name in SUMS:
            np.testing.assert_allclose(got(name), getattr(py, name), rtol=ORACLE_RTOL,
                                       atol=1e-9, err_msg=name)
        np.testing.assert_allclose(s.queue_wait_sum[:, r], py.queue_wait_sum,
                                   rtol=ORACLE_RTOL, atol=1e-9)


@pytest.mark.parametrize("case", list(CASES))
def test_fleet_scan_decision_exact_vs_pyref(case):
    F, Q, prestamped, ncl, limits, slots = CASES[case]
    R, K, sim = 3, 260, 140.0
    st, rng = _stream(sum(map(ord, case)), F, R, K, 2.0, prestamped, sim)
    t_exps = rng.uniform(3.0, 25.0, F)
    lim = np.broadcast_to(np.asarray(limits), (F,))
    fleet = _fleet(F, t_exps, lim, ncl=ncl, Q=Q, sim=sim, skip=10.0, slots=slots)
    port = rfleet.fleet_run(fleet, 0, replicas=R, device="cpu", backend="scan_ref",
                            staged=st)
    _oracle_check(port, st, fleet, R)
    s = port.summary
    assert s.arrivals.sum() > 0 and sum(x.n_warm.sum() for x in s.summaries) > 0
    if math.isfinite(ncl):
        assert s.max_peak_cluster <= ncl
    if Q:
        assert s.enqueued.sum() > 0


FAULT_CASES = {
    "crashes": dict(F=4, crash_rate=0.05, capacity=None),
    "dip": dict(F=3, crash_rate=0.0, capacity=CapacityProfile(edges=(40.0, 90.0),
                                                             values=(8.0, 2.0, 6.0))),
    "crashes_dip_nine": dict(F=9, crash_rate=0.03, capacity=CapacityProfile(
        edges=(30.0, 80.0), values=(20.0, 3.0, 9.0))),
    # groups of equal arrival times: creation ties, evicted by flat id under
    # a fractional ceiling
    "ties_fractional": dict(F=3, crash_rate=0.0, ties=3, capacity=CapacityProfile(
        edges=(50.0,), values=(12.0, 1.5))),
}


@pytest.mark.parametrize("case", list(FAULT_CASES))
def test_fleet_scan_faults_decision_exact_vs_pyref(case):
    c = FAULT_CASES[case]
    F, R, K, sim = c["F"], 2, 300, 140.0
    st, rng = _stream(7 + len(case), F, R, K, 3.0, True, sim, ties=c.get("ties", 0))
    flt = FaultModel(crash_rate=c["crash_rate"], capacity=c["capacity"])
    fleet = _fleet(F, rng.uniform(10.0, 40.0, F), [1000] * F, ncl=math.inf, Q=0, sim=sim,
                   skip=10.0, slots=16, faults=flt)
    if flt.crashes:
        st["crash_u"] = rng.uniform(size=(R, K)).astype(np.float32)
    port = rfleet.fleet_run(fleet, 0, replicas=R, device="cpu", backend="scan_ref",
                            staged=st)
    _oracle_check(port, st, fleet, R, crash_u=st.get("crash_u"), flt=flt)
    s = port.summary
    if flt.crashes:
        assert sum(x.n_crash.sum() for x in s.summaries) > 0
    if flt.capacity is not None:
        assert sum(x.n_evict.sum() for x in s.summaries) > 0


def _assert_against_jax(port, ref, faults=False):
    p, r = port.summary, ref.summary
    for sp, sr in zip(p.summaries, r.summaries):
        for f in COUNTS + (FAULT_COUNTS if faults else ()):
            np.testing.assert_array_equal(getattr(sp, f), np.asarray(getattr(sr, f)), err_msg=f)
        for f in SUMS:
            np.testing.assert_allclose(getattr(sp, f), np.asarray(getattr(sr, f)),
                                       rtol=JAX_RTOL, err_msg=f)
    for f in ("arrivals", "enqueued", "queue_served", "queue_left", "peak_cluster"):
        np.testing.assert_array_equal(getattr(p, f), np.asarray(getattr(r, f)), err_msg=f)
    np.testing.assert_allclose(p.queue_wait_sum, np.asarray(r.queue_wait_sum), rtol=JAX_RTOL)


def _jfn(name, rate, warm, cold, thr, limit):
    return jfleet.FleetFunction(
        name=name, arrival_process=JExp(rate=rate),
        warm_service_process=JExp(rate=1.0 / warm), cold_service_process=JExp(rate=1.0 / cold),
        expiration_threshold=thr, max_concurrency=limit,
    )


def _hetero(F, **kw):
    base = [("hot", 1.0, 1.5, 3.0, 30.0, 4), ("slow", 0.5, 4.0, 6.0, 60.0, 3),
            ("chatty", 2.0, 0.5, 1.5, 20.0, 5), ("batch", 0.3, 8.0, 10.0, 90.0, 2)]
    fns = tuple(_jfn(f"{base[i % 4][0]}{i}", *base[i % 4][1:]) for i in range(F))
    return jfleet.FleetScenario(functions=fns, sim_time=300.0, skip_time=0.0, slots=16, **kw)


@pytest.mark.parametrize("F,queue_depth,n_cluster", [(4, 2, 6.0), (4, 0, math.inf),
                                                     (9, 2, 10.0)])
def test_fleet_scan_matches_jax_fleet_scan(F, queue_depth, n_cluster):
    jf = _hetero(F, n_cluster=n_cluster, queue_depth=queue_depth)
    key = jax.random.key(F + queue_depth)
    ref = jfleet.fleet_run(jf, key, replicas=2, backend="scan")
    st = interop.fleet_staged_from_reference(
        jfleet._stage_fleet(jf, key, 2, None, jf.sim_time))
    assert st["times"].dtype == torch.float64
    port = rfleet.fleet_run(interop.fleet_from_reference(jf), 0, replicas=2, device="cpu",
                            backend="scan_ref", staged=st)
    _assert_against_jax(port, ref)


def test_fleet_scan_faults_match_jax_fleet_scan():
    from repro.core.faults import CapacityProfile as JCap, FaultModel as JFaults

    jf = _hetero(4, faults=JFaults(crash_rate=0.02, capacity=JCap(edges=(60.0, 150.0),
                                                                   values=(9.0, 3.0, 7.0))))
    key = jax.random.key(5)
    ref = jfleet.fleet_run(jf, key, replicas=2, backend="scan")
    staged = dict(jfleet._stage_fleet(jf, key, 2, None, jf.sim_time))
    staged["crash_u"] = np.asarray(j_draw_crash(key, 2, staged["times"].shape[1]),
                                   np.float32)
    st = interop.fleet_staged_from_reference(staged)
    port = rfleet.fleet_run(interop.fleet_from_reference(jf), 0, replicas=2, device="cpu",
                            backend="scan_ref", staged=st)
    _assert_against_jax(port, ref, faults=True)


def test_catalog_sweep_matches_jax_fleet_scan():
    names = ["thumbnail", "compression", "ml-inference"]
    jf = jcat.fleet_of(names, n_cluster=6, sim_time=300.0, skip_time=20.0, slots=16)
    over = {"expiration_threshold": [30.0, (20.0, 60.0, 120.0)], "n_cluster": [3.0, math.inf]}
    key = jax.random.key(2)
    ref = jfleet.fleet_sweep(jf, over, key, replicas=2, backend="scan")
    st = interop.fleet_staged_from_reference(
        jfleet._stage_fleet(jf, key, 2, None, jf.sim_time))
    port = rfleet.fleet_sweep(interop.fleet_from_reference(jf), over, 0, replicas=2,
                              device="cpu", backend="scan_ref", staged=st)
    assert port.axes == ref.axes and port.backend == "scan_ref"
    for idx in np.ndindex(port.shape):
        for f in COUNTS:
            np.testing.assert_array_equal(getattr(port.summaries[idx], f),
                                          np.asarray(getattr(ref.summaries[idx], f)),
                                          err_msg=f"{f} at {idx}")
    for m in ("cold_start_prob", "rejection_prob", "peak_cluster", "queue_wait_avg",
              "avg_server_count", "wasted_ratio", "cluster_utilization", "developer_cost"):
        np.testing.assert_allclose(getattr(port, m), getattr(ref, m), rtol=JAX_RTOL, err_msg=m)
    assert port.peak_cluster[:, 0].max() == 3.0 and port.peak_cluster[:, 1].max() > 3.0


def test_one_function_fleet_equals_run_on_the_f64_engine():
    fn = rfleet.FleetFunction(
        name="solo", arrival_process=ExpSimProcess(rate=1.0),
        warm_service_process=ExpSimProcess(rate=1 / 1.5),
        cold_service_process=ExpSimProcess(rate=1 / 3.0), expiration_threshold=20.0,
        max_concurrency=3,
    )
    fleet = rfleet.FleetScenario(functions=(fn,), sim_time=300.0, skip_time=20.0, slots=16)
    scn = fn.as_scenario(sim_time=300.0, skip_time=20.0, slots=16)
    one = rfleet.fleet_run(fleet, 5, replicas=3, device="cpu").summary["solo"]
    single = rscn.run(scn, 5, replicas=3, device="cpu").summary
    for f in COUNTS + SUMS:
        np.testing.assert_array_equal(getattr(one, f), getattr(single, f), err_msg=f)


def test_default_fleet_backend_is_the_f64_scan_for_any_F():
    jf = _hetero(16, n_cluster=20.0)
    fleet = interop.fleet_from_reference(jf)
    grid = rfleet.fleet_sweep(dataclasses.replace(fleet, sim_time=60.0),
                              {"expiration_threshold": [10.0, 40.0]}, 3, replicas=2,
                              device="cpu")
    assert grid.backend == "scan_ref" and grid.shape == (2, 16) and grid.ok.all()
    assert grid.peak_cluster.max() <= 20.0
    # the block backends keep the reference's refusal
    with pytest.raises(ValueError) as port:
        rfleet.fleet_run(fleet, 0, replicas=1, device="cpu", backend="ref")
    with pytest.raises(ValueError) as ref:
        jfleet.fleet_run(jf, jax.random.key(0), replicas=1, backend="ref")
    assert "at most 8 functions" in str(port.value) and "backend='scan'" in str(port.value)
    assert "at most 8 functions" in str(ref.value)


@pytest.mark.parametrize("Q", [0, 2])
def test_chunks_equal_one_call(Q):
    """A run split into chunks (``state0``, ``flush=False``) equals one call
    bit for bit, as the card's CUDA-graph replays of the plain version need."""
    F, R, K = 3, 2, 200
    st, rng = _stream(3, F, R, K, 2.0, True, 90.0)
    t = lambda x: torch.as_tensor(np.asarray(x))
    args = (t(rng.uniform(3.0, 20.0, (R, F))), t(np.full((R, F), 4.0)), t(np.full(R, 5.0)),
            t(np.full(R, 90.0)), t(np.full(R, 5.0)), torch.arange(R), t(st["times"]),
            t(st["fids"]), t(st["warms"]), t(st["colds"]))
    kw = dict(slots=16, queue_depth=Q, prestamped=True)
    one = fleet_scan_sweep_ref(*args, **kw)
    seq = args[6:]
    state = None
    for a, b in ((0, 70), (70, 150), (150, K)):
        part = tuple(x[:, a:b] for x in seq)
        state = fleet_scan_sweep_ref(*args[:6], *part, **kw, state0=state, flush=False)
    last = fleet_scan_sweep_ref(*args[:6], *(x[:, K:] for x in seq), **kw, state0=state)
    for name, x, y in zip(one._fields, one, last):
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x, y), name
    assert one.acc.shape == (R, F, FLEET64_COLS)


def test_fleet_scan_refuses_what_the_reference_refuses():
    fleet = _fleet(2, (10.0, 10.0), (5, 5), ncl=4.0, Q=0, sim=50.0, skip=0.0, slots=8)
    from repro_torch.core.execution import Execution

    with pytest.raises(ValueError, match="draws='fused' is not served"):
        rfleet.fleet_run(fleet, 0, replicas=1, execution=Execution(
            draws="fused", device="cpu", backend="scan_ref"))
    with pytest.raises(RuntimeError, match="overflow"):
        rfleet.fleet_run(dataclasses.replace(fleet, slots=1, n_cluster=math.inf), 0,
                         replicas=2, device="cpu", backend="scan_ref")
    with pytest.raises(RuntimeError, match="before sim_time"):
        rfleet.fleet_run(fleet, 0, replicas=1, device="cpu", backend="scan_ref", steps=5)


def test_reference_staging_serves_both_engines():
    """``interop.fleet_staged_from_reference`` keeps the reference's f64
    merged times; each front door casts them to its engine's dtype: f64
    exactly for the scan, and for the block engine the f32 round-to-nearest
    the reference's Pallas launcher applies after the merge."""
    jf = _hetero(3, n_cluster=5.0)
    raw = jfleet._stage_fleet(jf, jax.random.key(4), 2, None, jf.sim_time)
    st = interop.fleet_staged_from_reference(raw)
    assert st["times"].dtype == torch.float64
    fleet = interop.fleet_from_reference(jf)
    wide = rfleet.fleet_inputs(fleet, {}, 0, replicas=2, device="cpu", staged=st, f64=True)
    np.testing.assert_array_equal(wide.staged["times"].numpy(), np.asarray(raw["times"]))
    narrow = rfleet.fleet_inputs(fleet, {}, 0, replicas=2, device="cpu", staged=st)
    np.testing.assert_array_equal(narrow.staged["times"].numpy(),
                                  np.asarray(raw["times"], np.float32))


@pytest.mark.parametrize("f64,bound", [(True, 33), (False, 32)])
def test_live_bound_takes_the_kernels_dtype(f64, bound):
    """A cluster just above 32 admits a 33rd instance where the kernel
    compares in f64, and none where it compares in f32 (32.0000001 rounds
    to 32): the live bound follows the engine's comparison."""
    fleet = _fleet(2, (10.0, 10.0), (40, 40), ncl=32.0000001, Q=0, sim=50.0, skip=0.0,
                   slots=64)
    inp = rfleet.fleet_inputs(fleet, {}, 0, replicas=1, device="cpu", f64=f64)
    assert inp.live_bound == bound


def test_non_finite_fleet_outputs_raise():
    """A fleet whose live table overflowed comes back NaN from the kernel;
    the front door raises instead of returning NaN summaries."""
    from repro_torch.core.execution import register_backend

    @register_backend("nan_scan_ref", engines=("scan", "fleet"), f64=True)
    def _nan(*a, **k):
        out = fleet_scan_sweep_ref(*a, **{n: v for n, v in k.items() if n != "live_bound"})
        return out._replace(acc=torch.full_like(out.acc, math.nan))

    fleet = _fleet(2, (10.0, 10.0), (5, 5), ncl=4.0, Q=0, sim=50.0, skip=0.0, slots=8)
    with pytest.raises(RuntimeError, match="non-finite"):
        rfleet.fleet_run(fleet, 0, replicas=2, device="cpu", backend="nan_scan_ref")
