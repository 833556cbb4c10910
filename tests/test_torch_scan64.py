"""The f64 engine's pool scan on the CPU (backend ``"scan_ref"``, the plain
f64 version of ``csrc/scan_event_step.cu``): the reference's own sample
buffers, carried across in their own precision, through the JAX package's
f64 ``lax.scan`` and through the port, path by path — base, prestamped
timestamps, the histogram, oldest-first routing, metric windows,
reliability, retries, crashes, capacity churn, batch arrivals with tied
creation times — and through ``run``/``sweep`` with ``backend="scan"``;
the temporal engine from an initial pool; decision-exact against
``pyref.simulate_pyref``; the backends' refusals.

Counters (and the response sums, which both engines add in event order)
must be equal; the integrals, lifespans, window integrals and histogram
bins, whose per-event sums over slots associate differently in XLA and
torch, within ``RTOL``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, strategies as st  # optional-dep shim

import repro.core.processes as jproc
from repro.core import Scenario as JScenario
from repro.core import scenario as jscn
from repro.core import simulator as jsim
from repro.core import temporal as jtemp
from repro.core.faults import CapacityProfile as JCap, FaultModel as JFaults
from repro.core.pyref import simulate_pyref
from repro.core.reliability import (
    FailurePolicy as JFail,
    Reliability as JRely,
    RetryPolicy as JRetry,
)
from repro_torch import interop
from repro_torch.core import execution as rexec
from repro_torch.core import fleet as rfleet
from repro_torch.core import scenario as rscn
from repro_torch.core import simulator as rsim
from repro_torch.core import temporal as rtemp
from repro_torch.core.execution import Execution
from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS
from repro_torch.kernels.ref64 import ScanLayout, scan_sweep_ref
from repro_torch.kernels.scan_event_step import scan_sweep

RTOL = 1e-12
PYREF_RTOL = 1e-9
COUNTERS = ("n_cold", "n_warm", "n_reject", "lifespan_count", "overflow",
            "sum_cold_resp", "sum_warm_resp")
FLOATS = ("time_running", "time_idle", "lifespan_sum")
RELY = ("n_timeout", "n_fail", "n_retry", "n_abandon")
FAULTS = ("n_crash", "n_evict", "n_interrupt")


def _jax_base(**kw):
    d = dict(
        arrival_process=jproc.ExpSimProcess(rate=0.9),
        warm_service_process=jproc.ExpSimProcess(rate=1 / 1.991),
        cold_service_process=jproc.ExpSimProcess(rate=1 / 2.244),
        expiration_threshold=30.0,
        sim_time=400.0,
        skip_time=20.0,
        slots=16,
    )
    d.update(kw)
    return JScenario(**d)


def _reference_draws(jscn_, key, R, n):
    """The reference's draws of a run of ``jscn_``: ``(parts, crash_u)``
    for staged_from_reference, and the ``samples=`` its simulator takes."""
    if jscn_.reliability is not None:
        samples, extras = jsim.draw_reliability_stream(jscn_, key, R, n)
    else:
        samples, extras = jsim.draw_workload_samples(jscn_, key, R, n), ()
    crash = None
    flt = jscn_.faults
    if flt is not None and flt.crashes:
        crash = [jsim.draw_crash_uniforms(key, R, samples[0].shape[1])]
    part = (tuple(samples), tuple(extras)) if extras else tuple(samples)
    return [part], crash, (part if extras else tuple(samples))


def assert_summaries(port, ref, rtol=RTOL, extra=()):
    for f in COUNTERS + tuple(extra):
        np.testing.assert_array_equal(np.asarray(getattr(port, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in FLOATS:
        np.testing.assert_allclose(np.asarray(getattr(port, f)), np.asarray(getattr(ref, f)),
                                   rtol=rtol, atol=1e-9, err_msg=f)
    for f in RELY + FAULTS:
        a, b = getattr(port, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)
    assert (port.histogram is None) == (ref.histogram is None)
    if ref.histogram is not None:
        np.testing.assert_allclose(port.histogram, np.asarray(ref.histogram), rtol=rtol,
                                   atol=1e-9)
    assert (port.windows is None) == (ref.windows is None)
    if ref.windows is not None:
        pw, jw = port.windows, ref.windows
        for f in ("n_cold", "n_warm", "n_arrivals", "n_fail"):
            a, b = getattr(pw, f), getattr(jw, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"windows.{f}")
        for f in ("time_running", "time_idle"):
            np.testing.assert_allclose(getattr(pw, f), np.asarray(getattr(jw, f)), rtol=rtol,
                                       atol=1e-9, err_msg=f"windows.{f}")


_TRACE = tuple(float(x) for x in np.cumsum(np.random.default_rng(5).exponential(1.1, 420)))
_TRACE = tuple(float(x) for x in np.repeat(_TRACE[::2], 2))  # duplicated timestamps

CASES = {
    "base": dict(),
    "histogram": dict(track_histogram=True, hist_bins=9),
    "histogram_clipped": dict(track_histogram=True, hist_bins=3, expiration_threshold=80.0),
    "oldest": dict(routing="oldest"),
    "windows": dict(window_bounds=(0.0, 35.0, 100.0, 101.0, 250.0, 600.0)),
    "tight": dict(max_concurrency=3, slots=5, expiration_threshold=8.0),
    "batch_ties": dict(arrival_process=jproc.BatchArrivalProcess(
        base=jproc.ExpSimProcess(rate=0.3), batch_size=3), routing="oldest"),
    "nhpp": dict(arrival_process=None, rate_profile=jproc.SinusoidalRate(
        base=0.9, amplitude=0.6, period=150.0), track_histogram=True, hist_bins=12),
    "trace": dict(arrival_process=jproc.TraceArrivalProcess(_TRACE), sim_time=200.0,
                  window_bounds=(0.0, 50.0, 120.0, 200.0)),
    "fail": dict(reliability=JRely(failure=JFail(p_fail=0.1, t_timeout=3.0)),
                 window_bounds=(0.0, 100.0, 400.0)),
    "retries": dict(reliability=JRely(failure=JFail(p_fail=0.2, t_timeout=2.5),
                                      retry=JRetry(max_retries=2, backoff_base=0.5,
                                                   backoff_jitter=0.3)),
                    max_concurrency=4, slots=6),
    "retries_windows": dict(reliability=JRely(failure=JFail(p_fail=0.1),
                                              retry=JRetry(max_retries=1)),
                            window_bounds=(0.0, 150.0, 400.0), routing="oldest"),
    "crashes": dict(faults=JFaults(crash_rate=0.01)),
    "capacity": dict(faults=JFaults(capacity=JCap(edges=(100.0, 250.0),
                                                  values=(8.0, 2.5, 6.0)))),
    "crash_retry_capacity": dict(
        faults=JFaults(crash_rate=0.02, capacity=JCap(edges=(150.0,), values=(7.0, 3.0))),
        reliability=JRely(failure=JFail(p_fail=0.05, t_timeout=4.0),
                          retry=JRetry(max_retries=2))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scan_ref_matches_jax_scan(case):
    jscn_ = _jax_base(**CASES[case])
    key = jax.random.key(7)
    R = 3
    n = jscn_.steps_needed()
    parts, crash, jsamples = _reference_draws(jscn_, key, R, n)
    ref = jsim.ServerlessSimulator(jscn_).run(key, replicas=R, samples=jsamples)
    staged = interop.staged_from_reference(parts, crash_u=crash, f64=True)
    if jscn_.prestamped or jscn_.reliability is not None and jscn_.reliability.retry.max_retries:
        assert staged[0].dtype == torch.float64
    pscn = interop.scenario_from_reference(jscn_)
    port = rsim.ServerlessSimulator(pscn, device="cpu").run(0, replicas=R, staged=staged)
    assert_summaries(port, ref)
    # the same through the front door, on the same buffers
    res = rscn.run(pscn, 0, replicas=R, device="cpu", backend="scan_ref", staged=staged)
    assert_summaries(res.summary, ref, rtol=0.0)
    if case == "tight":
        assert ref.n_reject.sum() > 0
    if case == "capacity":
        assert ref.n_evict.sum() > 0
    if case == "crashes":
        assert ref.n_crash.sum() > 0 and ref.n_interrupt.sum() >= 0


def test_oldest_routing_changes_decisions():
    key = jax.random.key(3)
    pscn = interop.scenario_from_reference(_jax_base())
    parts, _, _ = _reference_draws(_jax_base(), key, 2, _jax_base().steps_needed())
    staged = interop.staged_from_reference(parts, f64=True)
    newest = rscn.run(pscn, 0, replicas=2, device="cpu", backend="scan_ref", staged=staged)
    oldest = rscn.run(dataclasses.replace(pscn, routing="oldest"), 0, replicas=2,
                      device="cpu", backend="scan_ref", staged=staged)
    # the same arrivals, routed to other instances: other lifetimes
    np.testing.assert_array_equal(oldest.summary.n_requests, newest.summary.n_requests)
    assert oldest.summary.avg_lifespan != newest.summary.avg_lifespan


def test_histogram_mass_is_measured_time():
    pscn = interop.scenario_from_reference(_jax_base(track_histogram=True, hist_bins=40))
    s = rscn.run(pscn, 4, replicas=3, device="cpu", backend="scan_ref").summary
    np.testing.assert_allclose(s.histogram.sum(1), s.measured_time, rtol=1e-12)
    # mean count from the histogram is the time-average instance count
    mean = (s.histogram * np.arange(40)).sum(1) / s.measured_time
    np.testing.assert_allclose(mean, (s.time_running + s.time_idle) / s.measured_time,
                               rtol=1e-9)


def test_windowed_run_base_metrics_equal_unwindowed():
    jbase = _jax_base()
    parts, _, _ = _reference_draws(jbase, jax.random.key(2), 2, jbase.steps_needed())
    staged = interop.staged_from_reference(parts, f64=True)
    pscn = interop.scenario_from_reference(jbase)
    plain = rscn.run(pscn, 0, replicas=2, device="cpu", backend="scan_ref", staged=staged)
    win = rscn.run(dataclasses.replace(pscn, window_bounds=(0.0, 20.0, 200.0, 400.0)), 0,
                   replicas=2, device="cpu", backend="scan_ref", staged=staged)
    for f in COUNTERS + FLOATS:
        np.testing.assert_array_equal(getattr(win.summary, f), getattr(plain.summary, f))
    # the windows past the warm-up tile the measured span: their integrals
    # are the run's, in other pieces
    w = win.summary.windows
    for f in ("time_running", "time_idle"):
        np.testing.assert_allclose(getattr(w, f)[:, 1:].sum(1), getattr(plain.summary, f),
                                   rtol=1e-10)


@pytest.mark.parametrize("case", ["base", "fail_hist", "retries_oldest"])
def test_sweep_scan_backend_matches_jax(case, monkeypatch):
    kw = dict(base={}, fail_hist=dict(
        reliability=JRely(failure=JFail(p_fail=0.1, t_timeout=3.0)), track_histogram=True,
        hist_bins=10, window_bounds=(0.0, 100.0, 400.0)),
        retries_oldest=dict(reliability=JRely(failure=JFail(p_fail=0.1),
                                              retry=JRetry(max_retries=1)),
                            routing="oldest"))[case]
    jbase = _jax_base(**kw)
    over = {"expiration_threshold": [10.0, 40.0], "scan_unroll": [1, 2],
            "sim_time": [300.0, 400.0]}
    if jbase.reliability is not None:
        over["t_timeout"] = [1.5, 6.0]
    key = jax.random.key(11)
    R = 2
    jgrid = jscn.sweep(jbase, over, key, replicas=R, backend="scan")
    # the reference's chained draws, one per draw cell (threshold)
    parts, k = [], key
    n = jscn.Scenario.of(jbase, sim_time=400.0).steps_needed()
    for thr in over["expiration_threshold"]:
        k, sub = jax.random.split(k)
        c = jscn.Scenario.of(jbase, expiration_threshold=thr, sim_time=400.0)
        parts.extend(_reference_draws(c, sub, R, n)[0])
    staged = interop.staged_from_reference(parts, f64=True)
    pbase = interop.scenario_from_reference(jbase)
    LAUNCH_COUNTS.clear()
    launches = []
    launch = rscn._scan_sweep_cells
    monkeypatch.setattr(rscn, "_scan_sweep_cells",
                        lambda *a, **k: launches.append(1) or launch(*a, **k))
    pgrid = rscn.sweep(pbase, over, 0, replicas=R, device="cpu", backend="scan_ref",
                       staged=staged)
    # the two scan_unroll values share one launch
    assert len(launches) == 1
    assert pgrid.shape == jgrid.shape
    for idx in np.ndindex(*pgrid.shape):
        assert_summaries(pgrid.summaries[idx], jgrid.summaries[idx])
    # scan_unroll changes only the reference's compile: its cells are equal
    for f in ("cold_start_prob", "avg_server_count", "avg_response_time"):
        a = getattr(pgrid, f)
        np.testing.assert_array_equal(a.take(0, axis=1), a.take(1, axis=1))
    if jbase.window_bounds is not None:
        np.testing.assert_allclose(pgrid.windowed_instance_count,
                                   jgrid.windowed_instance_count, rtol=1e-12)


def test_temporal_scan_ref_matches_jax_temporal():
    jbase = _jax_base(sim_time=200.0, skip_time=0.0, track_histogram=True, hist_bins=8,
                      reliability=JRely(failure=JFail(p_fail=0.1, t_timeout=3.0),
                                        retry=JRetry(max_retries=1)), routing="oldest")
    snaps = [jtemp.InstanceSnapshot(age=30.0, remaining=1.5),
             jtemp.InstanceSnapshot(age=120.0, idle_for=20.0),
             jtemp.InstanceSnapshot(age=5.0, idle_for=1.0)]
    grid = np.concatenate([[0.0, 0.5], np.linspace(1.0, 200.0, 17), [250.0]])
    key = jax.random.key(9)
    R, n = 4, jbase.steps_needed()
    ref = jtemp.ServerlessTemporalSimulator(jbase, snaps).run(key, grid, replicas=R, steps=n)
    parts, _, _ = _reference_draws(jbase, key, R, n)
    staged = interop.staged_from_reference(parts, f64=True)
    psnaps = [rtemp.InstanceSnapshot(age=s.age, remaining=s.remaining, idle_for=s.idle_for)
              for s in snaps]
    pscn = interop.scenario_from_reference(jbase)
    port = rtemp.ServerlessTemporalSimulator(pscn, psnaps, device="cpu").run(
        0, grid, replicas=R, staged=staged)
    for f in ("running_at", "idle_at", "total_at", "cold_prob_at"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), err_msg=f)
    assert_summaries(port.steady, ref.steady)
    res = rscn.run(pscn, 0, replicas=R, engine="temporal", device="cpu", backend="scan_ref",
                   grid=grid, initial_instances=psnaps, staged=staged)
    np.testing.assert_array_equal(res.temporal.total_at, ref.total_at)
    assert ref.steady.n_retry.sum() > 0


# ---------------------------------------------------------------------------
# decision-exact against the event-driven oracle
# ---------------------------------------------------------------------------


def _vs_pyref(jscn_, seed, R=2):
    key = jax.random.key(seed)
    parts, crash, _ = _reference_draws(jscn_, key, R, jscn_.steps_needed())
    staged = interop.staged_from_reference(parts, crash_u=crash, f64=True)
    port = rsim.ServerlessSimulator(interop.scenario_from_reference(jscn_), device="cpu").run(
        0, replicas=R, staged=staged)
    flat = [x.numpy() for x in staged]
    rel, flt = jscn_.reliability, jscn_.faults
    for r in range(R):
        kw = {}
        if rel is not None:
            kw.update(t_timeout=rel.failure.t_timeout, p_fail=rel.failure.p_fail,
                      fail_u=flat[3][r])
            if rel.retry.max_retries:
                kw.update(is_first=flat[4][r], child_pos=flat[5][r])
        if flt is not None and flt.crashes:
            kw.update(crash_rate=flt.crash_rate, crash_u=flat[-1][r])
        if flt is not None and flt.capacity is not None:
            kw.update(cap_edges=flt.capacity.edges, cap_values=flt.capacity.values)
        ref = simulate_pyref(
            flat[0][r], flat[1][r], flat[2][r], jscn_.expiration_threshold,
            jscn_.max_concurrency, jscn_.sim_time, jscn_.skip_time,
            hist_bins=jscn_.hist_bins if jscn_.track_histogram else 0,
            routing=jscn_.routing, prestamped=jscn_.prestamped or bool(
                rel is not None and rel.retry.max_retries),
            window_bounds=jscn_.window_bounds, **kw,
        )
        assert int(port.n_cold[r]) == ref.n_cold
        assert int(port.n_warm[r]) == ref.n_warm
        assert int(port.n_reject[r]) == ref.n_reject
        assert int(port.lifespan_count[r]) == ref.lifespan_count
        for f in ("time_running", "time_idle", "lifespan_sum"):
            np.testing.assert_allclose(getattr(port, f)[r], getattr(ref, f),
                                       rtol=PYREF_RTOL, err_msg=f)
        if jscn_.track_histogram:
            np.testing.assert_allclose(port.histogram[r], ref.histogram, rtol=PYREF_RTOL,
                                       atol=1e-9)
        if rel is not None:
            assert int(port.n_timeout[r]) == ref.n_timeout
            assert int(port.n_fail[r]) == ref.n_fail
            assert int(port.n_retry[r]) == ref.n_retry
            assert int(port.n_abandon[r]) == ref.n_abandon
        if flt is not None:
            assert int(port.n_crash[r]) == ref.n_crash
            assert int(port.n_evict[r]) == ref.n_evict
            assert int(port.n_interrupt[r]) == ref.n_interrupt
    return port


@pytest.mark.parametrize("case", ["histogram", "oldest", "windows", "retries",
                                  "crash_retry_capacity", "nhpp"])
def test_scan_ref_decision_exact_against_pyref(case):
    _vs_pyref(_jax_base(**CASES[case]), seed=4)


@settings(max_examples=12, deadline=None)
@given(
    rate=st.floats(0.05, 2.0),
    warm=st.floats(0.2, 4.0),
    t_exp=st.floats(0.5, 50.0),
    max_c=st.integers(1, 8),
    oldest=st.booleans(),
    seed=st.integers(0, 100),
)
def test_property_pyref_equivalence(rate, warm, t_exp, max_c, oldest, seed):
    """For any parameters the plain f64 version and the event-driven
    oracle agree decision for decision."""
    jscn_ = _jax_base(
        arrival_process=jproc.ExpSimProcess(rate=rate),
        warm_service_process=jproc.ExpSimProcess(rate=1.0 / warm),
        cold_service_process=jproc.ExpSimProcess(rate=1.0 / (warm * 1.3)),
        expiration_threshold=t_exp, max_concurrency=max_c, slots=max(max_c, 4),
        sim_time=150.0, skip_time=0.0, track_histogram=True, hist_bins=6,
        routing="oldest" if oldest else "newest",
    )
    _vs_pyref(jscn_, seed=seed, R=1)


# ---------------------------------------------------------------------------
# the kernel's wrapper on the CPU, and the backends' refusals
# ---------------------------------------------------------------------------


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    rng = np.random.default_rng(0)
    R, M, K = 3, 8, 200
    t = lambda x, d=torch.float64: torch.tensor(np.asarray(x), dtype=d)
    args = (torch.zeros((R, M), dtype=torch.bool), t(np.full((R, M), -1e30)),
            t(np.full((R, M), -1e30)), t(rng.exponential(1.0, (R, K)), torch.float32),
            t(rng.exponential(2.0, (R, K)), torch.float32),
            t(rng.exponential(2.5, (R, K)), torch.float32))
    kw = dict(t_exp=5.0, t_end=150.0, skip=3.0, max_concurrency=6, hist_bins=7,
              window_bounds=t(np.tile([0.0, 40.0, 150.0], (R, 1))))
    LAUNCH_COUNTS.clear()
    a, b = scan_sweep(*args, **kw), scan_sweep_ref(*args, **kw)
    assert not LAUNCH_COUNTS["scan_sweep"]  # no kernel launch on the CPU
    for x, y in zip(a, b):
        if x is not None:
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert a.acc.shape == (R, ScanLayout(W=2, H=7).cols)
    with pytest.raises(ValueError, match="routing must be one of"):
        scan_sweep(*args, routing="random", **kw)


def test_scan_backend_needs_cuda_and_names_its_plain_version():
    pscn = interop.scenario_from_reference(_jax_base())
    with pytest.raises(ValueError, match="needs a CUDA device.*'scan_ref'"):
        rscn.run(pscn, 0, replicas=2, device="cpu", backend="scan")
    with pytest.raises(ValueError, match="needs a CUDA device.*'scan_ref'"):
        rsim.ServerlessSimulator(pscn, device="cpu", backend="scan")
    # the default backend is the reference's, the f64 scan: its plain
    # version on the CPU, for every engine
    for engine in rexec.ENGINES:
        bspec, dev = Execution(engine=engine, device="cpu").resolve()
        assert bspec.name == "scan_ref" and bspec.f64 and dev.type == "cpu"
    assert rexec.resolve_backend("scan_ref").launch_for("par") is not None
    assert rexec.resolve_backend("scan_ref").launch_for("fleet") is not None


def test_default_backend_serves_the_histogram_as_the_reference():
    """Queue C's input: a histogram run with no backend named returns the
    summary of backend='scan_ref', as the reference's default does."""
    jbase = jscn.Scenario(
        arrival_process=jproc.ExpSimProcess(rate=0.9),
        warm_service_process=jproc.ExpSimProcess(rate=1 / 1.991),
        cold_service_process=jproc.ExpSimProcess(rate=1 / 2.244), sim_time=2000.0, skip_time=10.0,
        track_histogram=True,
    )
    pscn = interop.scenario_from_reference(jbase)
    default = rscn.run(pscn, 0, replicas=2, device="cpu").summary
    named = rscn.run(pscn, 0, replicas=2, device="cpu", backend="scan_ref").summary
    for f in ("n_cold", "n_warm", "n_reject", "time_running", "time_idle", "lifespan_sum",
              "lifespan_count", "histogram"):
        np.testing.assert_array_equal(getattr(default, f), getattr(named, f), err_msg=f)
    assert default.histogram.shape == (2, pscn.hist_bins)
    ref = jscn.run(jbase, jax.random.key(0), replicas=2).summary
    assert ref.histogram.shape == default.histogram.shape


def test_fused_draws_and_fleets_on_the_f64_engine_name_item_2b():
    """The inputs that the f64 engine refused until ROADMAP Queue A item 2b
    (fused draws, fleets) run on its plain version."""
    pscn = interop.scenario_from_reference(_jax_base())
    fused = Execution(draws="fused", device="cpu", backend="scan_ref")
    r = rscn.run(pscn, 0, replicas=2, execution=fused)
    assert r.summary.n_cold.sum() > 0 and r.summary.lifespan_count.sum() > 0
    g = rscn.sweep(pscn, {"expiration_threshold": [5.0]}, 0, replicas=2,
                   execution=fused)
    assert g.execution.draws == "fused" and g.ok.all()
    fleet = rfleet.FleetScenario(functions=(rfleet.FleetFunction(
        name="f", arrival_process=pscn.arrival_process,
        warm_service_process=pscn.warm_service_process,
        cold_service_process=pscn.cold_service_process),), sim_time=100.0, skip_time=10.0)
    s = rfleet.fleet_run(fleet, 0, replicas=1, device="cpu", backend="scan_ref").summary
    assert s.arrivals.sum() > 0 and s.summaries[0].lifespan_count.sum() >= 0


@pytest.mark.parametrize("what", ["histogram", "oldest", "windows"])
@pytest.mark.parametrize("engine", ["scan", "temporal"])
def test_block_backends_refuse_with_the_reference_messages(what, engine):
    kw = dict(histogram=dict(track_histogram=True), oldest=dict(routing="oldest"),
              windows=dict(window_bounds=(0.0, 10.0, 400.0)))[what]
    jbase = _jax_base(**kw)
    if engine == "temporal":
        jbase = JScenario.of(jbase, skip_time=0.0)
    pscn = interop.scenario_from_reference(jbase)
    if what == "windows" and engine == "temporal":
        # the temporal engine reports no windows: neither engine refuses them
        rscn.run(pscn, 0, replicas=1, device="cpu", engine=engine, steps=500, backend="ref")
        rscn.run(pscn, 0, replicas=1, device="cpu", engine=engine, steps=500,
                 backend="scan_ref")
        return
    with pytest.raises(ValueError) as ref:
        jscn.run(jbase, jax.random.key(0), replicas=1, engine=engine, backend="ref")
    with pytest.raises(ValueError) as port:
        rscn.run(pscn, 0, replicas=1, device="cpu", engine=engine, backend="ref")
    assert str(port.value) == str(ref.value)
    # and the f64 engine serves it
    res = rscn.run(pscn, 0, replicas=1, device="cpu", engine=engine, backend="scan_ref")
    assert np.isfinite(res.summary.avg_server_count)


def test_block_sweeps_refuse_histograms_and_routing():
    pscn = interop.scenario_from_reference(_jax_base())
    with pytest.raises(ValueError, match="histograms need the f64 scan backend"):
        rscn.sweep(pscn, {"track_histogram": [False, True]}, 0, replicas=1, device="cpu",
                   backend="ref")
    with pytest.raises(ValueError, match="newest-idle routing only"):
        rscn.sweep(pscn, {"routing": ["oldest"]}, 0, replicas=1, device="cpu", backend="ref")
    grid = rscn.sweep(pscn, {"routing": ["newest", "oldest"], "hist_bins": [4, 9]}, 0,
                      replicas=1, device="cpu", backend="scan_ref")
    assert grid.shape == (2, 2) and grid.ok.all()


def test_staged_dtypes_keep_times_and_positions_exact():
    jbase = _jax_base(reliability=JRely(retry=JRetry(max_retries=2)))
    n = jbase.steps_needed()
    parts, _, _ = _reference_draws(jbase, jax.random.key(0), 2, n)
    s32 = interop.staged_from_reference(parts)
    s64 = interop.staged_from_reference(parts, f64=True)
    assert [x.dtype for x in s32] == [torch.float32] * 6
    assert [x.dtype for x in s64] == [torch.float64, torch.float32, torch.float32,
                                      torch.float32, torch.bool, torch.int32]
    np.testing.assert_array_equal(s64[0].numpy(), np.asarray(parts[0][0][0]))
    pscn = interop.scenario_from_reference(jbase)
    drawn = rsim.ServerlessSimulator(pscn, device="cpu").draw_samples(3, 2, steps=n)
    assert [x.dtype for x in drawn] == [x.dtype for x in s64]
    assert rsim.staged_dtypes(pscn, f64=False) == (torch.float32,) * 6


# ---------------------------------------------------------------------------
# a run split into chunks (state0 / first_event / flush=False) equals one
# call: the plain versions replay CUDA-graph chunks on the card
# ---------------------------------------------------------------------------

CHUNK_CASES = {
    "base": dict(M=12),
    "prestamped_hist": dict(M=12, prestamped=True, hist=9),
    "oldest_windows": dict(M=40, oldest=True, windows=(0.0, 30.0, 31.0, 120.0, 1e4)),
    "rely_windows": dict(M=12, rely=True, windows=(0.0, 60.0, 200.0)),
    "retries_hist": dict(M=12, rely=True, retries=True, max_c=4, hist=5),
    "crashes_capacity": dict(M=40, crashes=True, capped=True, rely=True),
    "crashes_retries": dict(M=12, crashes=True, rely=True, retries=True, oldest=True),
    "grid_pool": dict(M=12, grid=11, pool=True, rely=True, retries=True, hist=6),
}


def chunk_inputs(case, R=5, K=240, seed=3):
    """Scan inputs exercising ``case``'s layers (numpy-seeded, CPU)."""
    c = CHUNK_CASES[case]
    rng = np.random.default_rng(seed)
    M = c["M"]
    f64 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64)
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)
    gaps = rng.exponential(1.0, (R, K)).astype(np.float32)
    prestamped = c.get("prestamped", False) or c.get("retries", False)
    arr = f64(np.cumsum(gaps.astype(np.float64), 1)) if prestamped else f32(gaps)
    if c.get("pool"):
        live = rng.uniform(size=(R, M)) < 0.4
        pool = (torch.tensor(live), f64(np.where(live, -rng.uniform(0, 60, (R, M)), -1e30)),
                f64(np.where(live, rng.uniform(-10, 3, (R, M)), -1e30)))
    else:
        pool = (torch.zeros((R, M), dtype=torch.bool), f64(np.full((R, M), -1e30)),
                f64(np.full((R, M), -1e30)))
    kw = dict(t_exp=f64(8.0 * rng.uniform(0.5, 1.5, R)), t_end=f64(K * rng.uniform(0.5, 0.9, R)),
              skip=f64(K * rng.uniform(0.0, 0.1, R)), prestamped=prestamped,
              max_concurrency=c.get("max_c", 1000), hist_bins=c.get("hist", 0),
              routing="oldest" if c.get("oldest") else "newest")
    if "windows" in c:
        kw["window_bounds"] = f64(np.tile(c["windows"], (R, 1)))
    if "grid" in c:
        kw["grid_times"] = f64(np.tile(np.linspace(0.0, K, c["grid"]), (R, 1)))
    seq = {"arr": arr, "warms": f32(rng.exponential(2.0, (R, K))),
           "colds": f32(rng.exponential(2.5, (R, K)))}
    if c.get("rely"):
        kw.update(t_timeout=f64(rng.uniform(1.0, 4.0, R)), p_fail=f64(rng.uniform(0, 0.3, R)))
        seq["fail_u"] = f32(rng.uniform(size=(R, K)))
    if c.get("retries"):
        seq["is_first"] = torch.tensor(rng.uniform(size=(R, K)) < 0.5)
        child = np.where(rng.uniform(size=(R, K)) < 0.8,
                         np.arange(K)[None, :] + 1 + rng.integers(0, 40, (R, K)), 1 << 30)
        seq["child_pos"] = torch.tensor(child.astype(np.int32))
    if c.get("crashes"):
        kw["crash_rate"] = f64(np.where(np.arange(R) % 3 == 0, 0.0, 0.03))
        seq["crash_u"] = f32(rng.uniform(size=(R, K)))
    if c.get("capped"):
        kw.update(cap_edges=f64(np.tile([40.0, 120.0], (R, 1))),
                  cap_values=f64(np.tile([6.0, 1.5, 4.0], (R, 1))))
    return pool, seq, kw


def assert_chunks_equal_one_call(whole, parts, float_cols):
    """Counters, state and planes equal; sums over slots within 1e-12."""
    for name, a, b in zip(whole._fields, whole, parts):
        if name == "acc":
            exact = [j for j in range(a.shape[1]) if j not in float_cols]
            torch.testing.assert_close(a[:, exact], b[:, exact], rtol=0, atol=0)
            torch.testing.assert_close(a[:, float_cols], b[:, float_cols], rtol=1e-12,
                                       atol=1e-12)
        elif a is None:
            assert b is None, name
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_scan_ref_chunks_continue_one_call(case):
    pool, seq, kw = chunk_inputs(case)
    K = seq["arr"].shape[1]
    whole = scan_sweep_ref(*pool, *(seq[n] for n in ("arr", "warms", "colds")), **kw,
                           **{n: v for n, v in seq.items() if n not in ("arr", "warms", "colds")})
    lay = ScanLayout(W=kw["window_bounds"].shape[1] - 1 if "window_bounds" in kw else 0,
                     H=kw["hist_bins"], G=kw["grid_times"].shape[1] if "grid_times" in kw else 0,
                     rely="t_timeout" in kw, faults="crash_rate" in kw or "cap_values" in kw)
    assert whole.acc[:, 0].sum() > 0 and whole.acc[:, 1].sum() > 0
    # cuts inside a 32-event batch, at batch edges, an empty chunk; every
    # chunk defers the tail, which a last call with no events flushes
    for cuts in ([37, 101, 101, 200], [1, 32, 64], []):
        state, bounds = None, [0, *cuts, K, K]
        for j, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            part = {n: v[:, lo:hi] for n, v in seq.items()}
            state = scan_sweep_ref(
                *(pool if state is None else (state.alive, state.creation, state.busy)),
                part.pop("arr"), part.pop("warms"), part.pop("colds"), **kw, **part,
                state0=state, first_event=lo, events=K, flush=j == len(bounds) - 2)
        assert_chunks_equal_one_call(whole, state, lay.float_cols)
