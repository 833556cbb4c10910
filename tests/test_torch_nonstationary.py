"""The port's non-stationary workloads against the reference: rate profiles
(lookup, validation, ``mean_rate``, ``with_rate``, ``fit`` and their error
messages), NHPP thinning, MMPP and trace replay (``arrival_times``), the
prestamped paths of ``sweep()``/``run()`` on the reference's own staged
buffers against the JAX ``backend="ref"`` block path (a profile x
threshold sweep with windows, an MMPP run, the par and temporal engines, a
fleet with a timestamp function, retries on a prestamped base), the
staging's f64 timestamps and coverage guard, and the refusals.  The CUDA
kernels' prestamped paths are held against the plain versions in
``test_torch_cuda.py``."""

import itertools
import math
import re

import jax
import numpy as np
import pytest
import torch

import repro.core.processes as jproc
from repro.core import Scenario as JScenario
from repro.core import fleet as jfleet
from repro.core import scenario as jscn
from repro.core.reliability import FailurePolicy, Reliability, RetryPolicy
from repro.core.simulator import draw_reliability_stream as j_draw_rely
from repro.core.simulator import draw_workload_samples as j_draw
from repro_torch import interop
from repro_torch.core import fleet as rfleet
from repro_torch.core import processes as rproc
from repro_torch.core import scenario as rscn
from repro_torch.core import simulator as rsim
from repro_torch.core.execution import Execution

# the integral columns sum the M slots' terms per event in another order
# than XLA's; every counter is held bit for bit
INTEGRAL_RTOL = 1e-5
# statistical checks: a count within this many standard errors of its mean
SIGMAS = 4.0
COUNTERS = ("n_cold", "n_warm", "n_reject", "sum_cold_resp", "sum_warm_resp")


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


# ---------------------------------------------------------------------------
# rate profiles
# ---------------------------------------------------------------------------

PW = dict(edges=(100.0, 250.0, 400.0), rates=(0.5, 2.0, 0.25, 1.0))


def test_piecewise_lookup_matches_reference():
    t = np.array([0.0, 50.0, 99.999, 100.0, 100.001, 249.0, 250.0, 399.0, 400.0, 1e6])
    port = rproc.PiecewiseConstantRate(**PW).rate(torch.from_numpy(t))
    ref = np.asarray(jproc.PiecewiseConstantRate(**PW).rate(t))
    assert port.dtype == torch.float64
    np.testing.assert_array_equal(port.numpy(), ref)
    # a constant profile (no interior edges), and 2-D times
    const = rproc.PiecewiseConstantRate(edges=(), rates=(0.7,))
    np.testing.assert_array_equal(const.rate(torch.zeros(2, 3)).numpy(), np.full((2, 3), 0.7))


@pytest.mark.parametrize(
    "kw",
    [
        dict(edges=(1.0,), rates=(1.0,)),
        dict(edges=(2.0, 1.0), rates=(1.0, 1.0, 1.0)),
        dict(edges=(0.0,), rates=(1.0, 1.0)),
        dict(edges=(1.0,), rates=(1.0, 0.0)),
    ],
)
def test_piecewise_validation_matches_reference(kw):
    with pytest.raises(ValueError) as ref:
        jproc.PiecewiseConstantRate(**kw)
    with pytest.raises(ValueError, match=re.escape(str(ref.value))):
        rproc.PiecewiseConstantRate(**kw)


@pytest.mark.parametrize("edges,rates", [((), (0.4,)), ((30.0, 60.0), (1.0, 3.0, 2.0)),
                                         ((10.0, 50.0), (0.5, 1.5, 4.0))])
def test_piecewise_mean_rate_and_with_rate_match_reference(edges, rates):
    port = rproc.PiecewiseConstantRate(edges=edges, rates=rates)
    ref = jproc.PiecewiseConstantRate(edges=edges, rates=rates)
    assert port.mean_rate() == ref.mean_rate()
    assert port.max_rate() == ref.max_rate()
    assert port.with_rate(1.7).rates == ref.with_rate(1.7).rates
    np.testing.assert_allclose(port.with_rate(1.7).mean_rate(), 1.7, rtol=1e-12)
    with pytest.raises(ValueError, match="rate must be > 0"):
        port.with_rate(0.0)


def test_piecewise_fit_matches_reference():
    rng = np.random.default_rng(0)
    ts = np.sort(rng.uniform(0.0, 3599.0, 500))
    for kw in (dict(bin_width=600.0), dict(bin_width=600.0, n_bins=8),
               dict(bin_width=100.0, rate_floor=1e-3)):
        port = rproc.PiecewiseConstantRate.fit(ts, **kw)
        ref = jproc.PiecewiseConstantRate.fit(ts, **kw)
        assert port.edges == tuple(float(e) for e in ref.edges)
        assert port.rates == tuple(float(r) for r in ref.rates)
    fitted = rproc.PiecewiseConstantRate.fit(ts, bin_width=600.0)
    assert len(fitted.rates) == 6 and sum(fitted.rates) * 600.0 == pytest.approx(500)


@pytest.mark.parametrize(
    "ts,kw",
    [
        (np.zeros((2, 2)), dict(bin_width=1.0)),
        ([], dict(bin_width=1.0)),
        ([0.0, np.nan], dict(bin_width=1.0)),
        ([-1.0, 2.0], dict(bin_width=1.0)),
        ([3.0, 1.0], dict(bin_width=1.0)),
        ([1.0, 2.0], dict(bin_width=0.0)),
        ([1.0, 2.0], dict(bin_width=1.0, rate_floor=0.0)),
        ([1.0, 2.0], dict(bin_width=1.0, n_bins=0)),
        ([1.0, 5.0], dict(bin_width=1.0, n_bins=3)),
    ],
)
def test_piecewise_fit_errors_match_reference(ts, kw):
    with pytest.raises(ValueError) as ref:
        jproc.PiecewiseConstantRate.fit(ts, **kw)
    with pytest.raises(ValueError) as port:
        rproc.PiecewiseConstantRate.fit(ts, **kw)
    assert str(port.value) == str(ref.value)


def test_sinusoidal_matches_reference():
    kw = dict(base=0.9, amplitude=0.6, period=3600.0, phase=0.3)
    t = np.linspace(0.0, 1e5, 1001)
    port = rproc.SinusoidalRate(**kw)
    ref = jproc.SinusoidalRate(**kw)
    np.testing.assert_allclose(port.rate(torch.from_numpy(t)).numpy(), np.asarray(ref.rate(t)),
                               rtol=1e-12)
    assert port.max_rate() == ref.max_rate() == pytest.approx(1.44)
    assert port.with_rate(2.0) == rproc.SinusoidalRate(**dict(kw, base=2.0))
    for bad in (dict(kw, amplitude=1.0), dict(kw, base=0.0), dict(kw, period=-1.0)):
        with pytest.raises(ValueError) as r:
            jproc.SinusoidalRate(**bad)
        with pytest.raises(ValueError, match=re.escape(str(r.value))):
            rproc.SinusoidalRate(**bad)


# ---------------------------------------------------------------------------
# timestamp processes
# ---------------------------------------------------------------------------


def _window_counts(times, bounds):
    t = times[times < bounds[-1]]
    return np.histogram(t, bins=bounds)[0]


@pytest.mark.parametrize(
    "profile",
    [rproc.SinusoidalRate(base=2.0, amplitude=0.8, period=500.0),
     rproc.PiecewiseConstantRate(edges=(300.0, 600.0), rates=(0.5, 4.0, 1.5))],
    ids=["sinusoidal", "piecewise"],
)
def test_thinning_counts_follow_the_intensity(profile):
    proc = rproc.NHPPArrivalProcess(profile=profile)
    R, T = 16, 1000.0
    n = rsim_steps(proc, T)
    times, coverage = proc.arrival_times(_gen(0), (R, n), "cpu")
    assert times.dtype == coverage.dtype == torch.float64
    assert times.shape == (R, n) and coverage.shape == (R,)
    assert bool((coverage >= T).all())
    t = times.numpy()
    assert (np.diff(t, axis=1) >= 0).all()
    # rejected candidates are PAD_TIME, all of them after every arrival
    pad = t == rproc.PAD_TIME
    assert pad.any() and (pad[:, 1:] >= pad[:, :-1]).all()
    bounds = np.linspace(0.0, T, 11)
    counts = np.stack([_window_counts(r, bounds) for r in t]).sum(0)
    grid = np.linspace(0.0, T, 100_001)
    lam = profile.rate(torch.from_numpy(grid)).numpy()
    expected = np.array([
        np.trapezoid(lam[(grid >= a) & (grid <= b)], grid[(grid >= a) & (grid <= b)])
        for a, b in zip(bounds[:-1], bounds[1:])
    ]) * R
    assert (np.abs(counts - expected) <= SIGMAS * np.sqrt(expected) + 1).all(), (counts, expected)
    # seeded: the same generator state gives the same stream
    again, _ = proc.arrival_times(_gen(0), (R, n), "cpu")
    assert torch.equal(again, times)


def rsim_steps(proc, T):
    n = T / proc.mean()
    return int(n + 6.0 * np.sqrt(n) + 16)


def test_mmpp_phase_lookup_matches_reference():
    rng = np.random.default_rng(1)
    sw = np.cumsum(rng.exponential(10.0, (3, 40)), axis=1)
    t = np.cumsum(rng.exponential(2.0, (3, 200)), axis=1)
    port = rproc.MMPPArrivalProcess.phase_high(torch.from_numpy(sw), torch.from_numpy(t))
    ref = np.stack([np.asarray(jproc.MMPPArrivalProcess(0.1, 1.0, 0.1).phase_high(s, x))
                    for s, x in zip(sw, t)])
    np.testing.assert_array_equal(port.numpy(), ref)


def test_mmpp_rate_and_coverage():
    proc = rproc.MMPPArrivalProcess(rate_low=0.3, rate_high=3.0, switch_rate=1 / 60)
    R, T = 8, 20_000.0
    n = rsim_steps(proc, T)
    times, coverage = proc.arrival_times(_gen(2), (R, n), "cpu")
    assert bool((coverage >= T).all())
    t = times.numpy()
    inside = (t < T).sum(1)
    # symmetric switching: half the time in each phase on average
    np.testing.assert_allclose(inside.mean() / T, (0.3 + 3.0) / 2, rtol=0.1)
    # bursty: window counts are overdispersed against Poisson
    counts = np.stack([_window_counts(r, np.linspace(0.0, T, 201)) for r in t]).ravel()
    assert counts.var() > 5 * counts.mean()
    with pytest.raises(ValueError, match="rate_high >= rate_low"):
        rproc.MMPPArrivalProcess(rate_low=2.0, rate_high=1.0, switch_rate=1.0)
    with pytest.raises(ValueError, match="positive"):
        rproc.MMPPArrivalProcess(rate_low=0.0, rate_high=1.0, switch_rate=1.0)


@pytest.mark.parametrize("first", [3.5, 0.0], ids=["positive_start", "zero_start"])
@pytest.mark.parametrize("n", [5, 9, 23])
def test_trace_replay_matches_reference(first, n):
    ts = tuple(first + x for x in (0.0, 1.0, 1.0, 4.0, 6.5, 7.0, 12.0))
    port = rproc.TraceArrivalProcess(timestamps=ts)
    ref = jproc.TraceArrivalProcess(timestamps=ts)
    times, cov = port.arrival_times(None, (3, n), "cpu")
    rtimes, rcov = ref.arrival_times(jax.random.key(0), (3, n))
    np.testing.assert_array_equal(times.numpy(), np.asarray(rtimes))
    assert np.isinf(cov.numpy()).all() and cov.shape == (3,)
    if first > 0:
        # the first cycle is the recording itself, ties included
        np.testing.assert_array_equal(times[0, :min(n, len(ts))].numpy(), ts[:n])
    if n > len(ts):
        # the wrap inserts the mean gap, then the cycle repeats
        gaps = np.diff(times[0].numpy())
        cycle = ref._cycle()
        assert gaps[len(ts) - 1] == pytest.approx(cycle[-1])
    assert port.mean() == ref.mean()


def test_trace_validation():
    with pytest.raises(ValueError, match=">= 2 arrivals"):
        rproc.TraceArrivalProcess(timestamps=(1.0,))
    with pytest.raises(ValueError, match="non-decreasing"):
        rproc.TraceArrivalProcess(timestamps=(2.0, 1.0))


def test_timestamp_processes_have_no_gap_path():
    for proc, mean in ((rproc.NHPPArrivalProcess(profile=rproc.SinusoidalRate(1.0, 0.5, 10.0)),
                        1.0 / 1.5),
                       (rproc.MMPPArrivalProcess(0.5, 1.0, 0.1), 1.0),
                       (rproc.TraceArrivalProcess((1.0, 2.0, 4.0)), 4.0 / 3)):
        with pytest.raises(NotImplementedError, match="prestamped"):
            proc.sample(_gen(0), (2, 4), "cpu")
        assert proc.mean() == pytest.approx(mean)


# ---------------------------------------------------------------------------
# staging: f64 timestamps, the coverage guard, draw cells
# ---------------------------------------------------------------------------


def _port_day(**kw):
    d = dict(
        rate_profile=rproc.SinusoidalRate(base=0.9, amplitude=0.7, period=600.0),
        warm_service_process=rproc.ExpSimProcess(rate=1 / 1.991),
        cold_service_process=rproc.ExpSimProcess(rate=1 / 2.244),
        expiration_threshold=30.0,
        sim_time=1200.0,
        skip_time=0.0,
        slots=32,
    )
    d.update(kw)
    return rscn.Scenario(**d)


def test_staging_casts_sorted_f64_times_once():
    scn = _port_day()
    n = scn.steps_needed()
    gens = rsim.cell_generators(4, 1, "cpu")[0]
    arr, warms, colds = rsim.draw_workload_samples(scn, gens, 3, n, "cpu")
    gens = rsim.cell_generators(4, 1, "cpu")[0]
    times = rsim.draw_arrival_times(scn, gens[0], 3, n, "cpu")
    assert times.dtype == torch.float64 and arr.dtype == torch.float32
    assert torch.equal(arr, times.float())
    assert bool((arr[:, 1:] >= arr[:, :-1]).all())
    # the service streams are the stationary draws of their own generators
    gw = rsim.cell_generators(4, 1, "cpu")[0][1]
    assert torch.equal(warms, scn.warm_service_process.sample(gw, (3, n), "cpu"))


def test_coverage_guard_raises_on_a_short_stream():
    scn = _port_day()
    with pytest.raises(RuntimeError, match="coverage ended before sim_time"):
        rscn.run(scn, 0, replicas=2, device="cpu", steps=200, backend="ref")
    with pytest.raises(RuntimeError, match="coverage ended before sim_time"):
        rscn.sweep(scn, {"expiration_threshold": [10.0]}, 0, replicas=2, device="cpu",
                   steps=200, backend="ref")
    # a sim_time axis guards every draw cell against the grid's largest horizon
    n = scn.steps_needed()
    with pytest.raises(RuntimeError, match="coverage ended before sim_time"):
        rscn.sweep(scn, {"sim_time": [600.0, 2400.0]}, 0, replicas=2, device="cpu", steps=n,
                   backend="ref")
    g = rscn.sweep(scn, {"sim_time": [600.0, 1200.0]}, 0, replicas=2, device="cpu", steps=n,
                   backend="ref")
    assert g.ok.all()


def test_scenario_lowers_rate_profile_and_prestamps():
    scn = _port_day()
    assert isinstance(scn.arrival_process, rproc.NHPPArrivalProcess)
    assert scn.prestamped and scn.arrival_process.profile == scn.rate_profile
    assert rscn.Scenario.of(scn) == scn  # a resolved profile round-trips
    # arrival_rate re-levels the profile, keeping its shape
    rated = _port_day(arrival_rate=1.8)
    assert rated.arrival_process.profile == rproc.SinusoidalRate(1.8, 0.7, 600.0)
    assert rated.arrival_rate is None and rscn.Scenario.of(rated) == rated
    assert scn.steps_needed() == int(1200 * 0.9 * 1.7 + 6 * math.sqrt(1200 * 0.9 * 1.7) + 16)
    plain = rscn.Scenario.of(scn, arrival_process=rproc.ExpSimProcess(rate=1.0),
                             rate_profile=None)
    assert not plain.prestamped


# ---------------------------------------------------------------------------
# against the reference's block path, on its own staged buffers
# ---------------------------------------------------------------------------


def _jax_day(**kw):
    d = dict(
        rate_profile=jproc.SinusoidalRate(base=0.9, amplitude=0.7, period=600.0),
        warm_service_process=jproc.ExpSimProcess(rate=1 / 1.991),
        cold_service_process=jproc.ExpSimProcess(rate=1 / 2.244),
        expiration_threshold=30.0,
        sim_time=1200.0,
        skip_time=0.0,
        slots=32,
    )
    d.update(kw)
    return JScenario(**d)


def reference_parts(base, over, key, replicas, n_steps):
    """The reference sweep's per-draw-cell staged buffers (its chained key
    walk), f64 timestamps included."""
    draw_names = [n for n in over if n in jscn._DRAW_FIELDS]
    max_sim = float(max(over.get("sim_time", (base.sim_time,))))
    parts = []
    for combo in itertools.product(*[over[n] for n in draw_names]):
        c = base
        for n, v in zip(draw_names, combo):
            c = jscn._apply_axis(c, n, v)
        key, sub = jax.random.split(key)
        parts.append(tuple(np.asarray(x) for x in j_draw(JScenario.of(c, sim_time=max_sim),
                                                         sub, replicas, n_steps)))
    return parts


def _assert_summaries(p, r):
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(p, f), np.asarray(getattr(r, f)), err_msg=f)
    for f in ("time_running", "time_idle"):
        np.testing.assert_allclose(getattr(p, f), np.asarray(getattr(r, f)),
                                   rtol=INTEGRAL_RTOL, err_msg=f)


def test_profile_threshold_sweep_matches_reference():
    profiles = [(0.2, 600.0), (0.7, 300.0)]
    wb = tuple(np.linspace(0.0, 1200.0, 7))
    jbase = _jax_day(window_bounds=wb)
    over = {"profile": [jproc.SinusoidalRate(0.9, a, p) for a, p in profiles],
            "expiration_threshold": [15.0, 60.0]}
    R, n = 2, jbase.steps_needed()
    key = jax.random.key(11)
    ref = jscn.sweep(jbase, over, key, replicas=R, backend="ref", steps=n)
    parts = reference_parts(jbase, over, key, R, n)
    assert parts[0][0].dtype == np.float64 and (parts[0][0] == rproc.PAD_TIME).any()
    port_over = {"profile": [rproc.SinusoidalRate(0.9, a, p) for a, p in profiles],
                 "expiration_threshold": [15.0, 60.0]}
    port = rscn.sweep(interop.scenario_from_reference(jbase), port_over, 0, replicas=R,
                      device="cpu", staged=interop.staged_from_reference(parts), backend="ref")
    assert port.shape == ref.shape == (2, 2)
    for idx in np.ndindex(port.shape):
        p, r = port.summaries[idx], ref.summaries[idx]
        _assert_summaries(p, r)
        for f in ("n_cold", "n_warm", "n_arrivals"):
            np.testing.assert_array_equal(getattr(p.windows, f), getattr(r.windows, f))
        for f in ("time_running", "time_idle"):
            np.testing.assert_allclose(getattr(p.windows, f), getattr(r.windows, f),
                                       rtol=INTEGRAL_RTOL, atol=1e-6)
    np.testing.assert_array_equal(port.windowed_arrivals, ref.windowed_arrivals)
    np.testing.assert_array_equal(port.windowed_cold_prob, ref.windowed_cold_prob)
    np.testing.assert_allclose(port.windowed_instance_count, ref.windowed_instance_count,
                               rtol=INTEGRAL_RTOL)
    assert port.axes["profile"] == tuple(port_over["profile"])


def _reference_run(jbase, key_seed, replicas, **kw):
    key = jax.random.key(key_seed)
    n = jbase.steps_needed()
    ref = jscn.run(jbase, key, replicas=replicas, backend="ref", steps=n, **kw)
    cfg = JScenario.of(jbase, skip_time=0.0) if kw.get("engine") == "temporal" else jbase
    parts = [tuple(np.asarray(x) for x in j_draw(cfg, key, replicas, n))]
    return ref, interop.staged_from_reference(parts)


def test_mmpp_run_matches_reference():
    jbase = _jax_day(rate_profile=None, sim_time=1500.0, skip_time=100.0, max_concurrency=5,
                     arrival_process=jproc.MMPPArrivalProcess(0.3, 3.0, 1 / 300))
    ref, staged = _reference_run(jbase, 3, 3)
    scn = interop.scenario_from_reference(jbase)
    assert isinstance(scn.arrival_process, rproc.MMPPArrivalProcess) and scn.prestamped
    port = rscn.run(scn, 0, replicas=3, device="cpu", staged=staged, backend="ref")
    _assert_summaries(port.summary, ref.summary)
    assert port.summary.n_reject.sum() > 0  # the bursts hit the limit


@pytest.mark.parametrize("c", [1, 3])
def test_nhpp_par_run_matches_reference(c):
    jbase = _jax_day(concurrency_value=c, sim_time=900.0, skip_time=50.0)
    ref, staged = _reference_run(jbase, 5, 3, engine="par")
    port = rscn.run(interop.scenario_from_reference(jbase), 0, replicas=3, engine="par",
                    device="cpu", staged=staged, backend="ref")
    _assert_summaries(port.summary, ref.summary)
    np.testing.assert_allclose(port.summary.time_in_flight,
                               np.asarray(ref.summary.time_in_flight), rtol=INTEGRAL_RTOL)


def test_nhpp_temporal_run_matches_reference():
    jbase = _jax_day(sim_time=900.0)
    grid = np.linspace(0.0, 900.0, 13)
    ref, staged = _reference_run(jbase, 6, 3, engine="temporal", grid=grid)
    port = rscn.run(interop.scenario_from_reference(jbase), 0, replicas=3, engine="temporal",
                    device="cpu", staged=staged, grid=grid, backend="ref")
    _assert_summaries(port.summary, ref.summary)
    for f in ("running_at", "idle_at", "cold_prob_at"):
        np.testing.assert_array_equal(getattr(port.temporal, f),
                                      np.asarray(getattr(ref.temporal, f)), err_msg=f)


def test_port_draws_feed_every_engine():
    """The port's own NHPP draws: par at c = 1 and temporal from an empty
    pool make the scan engine's decisions on the same seed."""
    scn = _port_day(sim_time=900.0)
    one = rscn.run(scn, 4, replicas=3, device="cpu", backend="ref")
    par = rscn.run(rscn.Scenario.of(scn, concurrency_value=1), 4, replicas=3, engine="par",
                   device="cpu", backend="ref")
    tmp = rscn.run(scn, 4, replicas=3, engine="temporal", device="cpu", backend="ref")
    for f in ("n_cold", "n_warm", "n_reject"):
        np.testing.assert_array_equal(getattr(par.summary, f), getattr(one.summary, f))
        np.testing.assert_array_equal(getattr(tmp.summary, f), getattr(one.summary, f))
    assert one.summary.n_cold.sum() > 0 and np.isfinite(tmp.temporal.total_at).all()


def test_trace_replay_par_run():
    """A recorded batch trace (ties: equal timestamps) replayed on every
    replica: the arrivals are the recording's, only the services differ."""
    from repro_torch.data.workload import batch_arrivals

    ts = tuple(r.arrival_time for r in batch_arrivals(0.5, 4, 600.0, seed=3))
    scn = _port_day(rate_profile=None, arrival_process=rproc.TraceArrivalProcess(ts),
                    sim_time=600.0, concurrency_value=3)
    res = rscn.run(scn, 1, replicas=3, engine="par", device="cpu", backend="ref")
    times, _ = scn.arrival_process.arrival_times(None, (1, scn.steps_needed()), "cpu")
    np.testing.assert_array_equal(times[0, :len(ts)].numpy(), ts)
    # every replica sees the recording (and its loop past the last arrival)
    assert (res.summary.n_requests == int((times < 600.0).sum())).all()
    assert res.summary.n_cold.sum() > 0


def test_fleet_with_a_timestamp_function_matches_reference():
    def jfn(name, arrival, thr, limit):
        return jfleet.FleetFunction(
            name=name, arrival_process=arrival,
            warm_service_process=jproc.ExpSimProcess(rate=0.5),
            cold_service_process=jproc.ExpSimProcess(rate=0.4),
            expiration_threshold=thr, max_concurrency=limit)

    jf = jfleet.FleetScenario(
        functions=(jfn("diurnal", jproc.NHPPArrivalProcess(
            jproc.SinusoidalRate(1.2, 0.8, 400.0)), 30.0, 8),
                   jfn("steady", jproc.ExpSimProcess(rate=0.6), 60.0, 8)),
        n_cluster=6, sim_time=800.0, skip_time=20.0, slots=16)
    key = jax.random.key(4)
    ref = jfleet.fleet_run(jf, key, replicas=2, backend="ref")
    staged = jfleet._stage_fleet(jf, key, 2, None, jf.sim_time)
    port = rfleet.fleet_run(interop.fleet_from_reference(jf), 0, replicas=2, device="cpu",
                            staged=interop.fleet_staged_from_reference(staged), backend="ref")
    for p, r in zip(port.summary.summaries, ref.summary.summaries):
        for f in ("n_cold", "n_warm", "n_reject"):
            np.testing.assert_array_equal(getattr(p, f), np.asarray(getattr(r, f)), err_msg=f)
    np.testing.assert_allclose(port.summary.avg_cluster_occupancy,
                               ref.summary.avg_cluster_occupancy, rtol=INTEGRAL_RTOL)
    assert port.summary.max_peak_cluster == 6


def test_fleet_stages_timestamps_in_f64():
    fns = (
        rfleet.FleetFunction(
            name="diurnal", rate_profile=rproc.SinusoidalRate(1.0, 0.5, 300.0),
            warm_service_process=rproc.ExpSimProcess(rate=0.5),
            cold_service_process=rproc.ExpSimProcess(rate=0.4)),
        rfleet.FleetFunction(
            name="steady", arrival_process=rproc.ExpSimProcess(rate=0.8),
            warm_service_process=rproc.ExpSimProcess(rate=0.5),
            cold_service_process=rproc.ExpSimProcess(rate=0.4)),
    )
    two = rfleet.FleetScenario(functions=fns, n_cluster=8, sim_time=600.0, skip_time=0.0,
                               slots=16)
    st = rfleet._stage_fleet(two, 5, 2, None, 600.0, "cpu")
    assert st["prestamped"]
    t = st["times"]
    assert t.dtype == torch.float32 and bool((t[:, 1:] >= t[:, :-1]).all())
    # the NHPP function's times are its own f64 stream, cast after the merge
    gens = rsim.cell_generators(5, 2, "cpu")[0]
    scn0 = fns[0].as_scenario(sim_time=600.0, skip_time=0.0, slots=16)
    own = rsim.draw_arrival_times(scn0, gens[0], 2, scn0.steps_needed(), "cpu")
    for r in range(2):
        mine = t[r][st["fids"][r] == 0]
        np.testing.assert_array_equal(mine.numpy(), own[r].float().numpy())
    # one function: its timestamps pass through, prestamped
    one = rfleet.FleetScenario(functions=fns[:1], sim_time=600.0, skip_time=0.0, slots=16)
    st1 = rfleet._stage_fleet(one, 5, 2, None, 600.0, "cpu")
    assert st1["prestamped"] and torch.equal(st1["times"], own.float())
    res = rfleet.fleet_run(one, 5, replicas=2, device="cpu", backend="ref")
    run = rscn.run(scn0, 5, replicas=2, device="cpu", backend="ref")
    np.testing.assert_array_equal(res.summary.summaries[0].n_cold, run.summary.n_cold)


def test_retries_on_a_prestamped_base_match_reference():
    rel = Reliability(failure=FailurePolicy(p_fail=0.1, t_timeout=3.0),
                      retry=RetryPolicy(max_retries=1, backoff_base=1.0))
    jbase = _jax_day(reliability=rel, max_concurrency=4, sim_time=600.0)
    over = {"t_timeout": [1.5, 4.0]}
    R, n = 2, jbase.steps_needed()
    key = jax.random.key(8)
    ref = jscn.sweep(jbase, over, key, replicas=R, backend="ref", steps=n)
    _, sub = jax.random.split(key)
    smp, ext = j_draw_rely(jbase, sub, R, n)
    staged = interop.staged_from_reference(
        [(tuple(map(np.asarray, smp)), tuple(map(np.asarray, ext)))])
    port = rscn.sweep(interop.scenario_from_reference(jbase), over, 0, replicas=R,
                      device="cpu", staged=staged, backend="ref")
    for idx in np.ndindex(port.shape):
        p, r = port.summaries[idx], ref.summaries[idx]
        _assert_summaries(p, r)
        for f in ("n_timeout", "n_fail", "n_retry", "n_abandon"):
            np.testing.assert_array_equal(getattr(p, f), np.asarray(getattr(r, f)))
    assert port.summaries[0].n_retry.sum() > 0


def test_port_retry_table_takes_the_f64_timestamps(monkeypatch):
    """With retries the attempt table is built on the process's own f64
    times (not a cumsum of them, nor their f32 copy)."""
    from repro_torch.core import reliability as rrel

    seen = []
    build = rrel.build_attempt_table

    def spy(times0, *a, **k):
        seen.append(times0.clone())
        return build(times0, *a, **k)

    monkeypatch.setattr(rrel, "build_attempt_table", spy)
    rel = Reliability(retry=RetryPolicy(max_retries=1, backoff_base=1.0))
    scn = _port_day(reliability=interop.reliability_from_reference(rel), sim_time=600.0)
    n = scn.steps_needed()
    rsim.draw_reliability_stream(scn, rsim.cell_generators(2, 1, "cpu", rsim.RELY_STREAMS)[0],
                                 2, n, "cpu")
    own = rsim.draw_arrival_times(scn, rsim.cell_generators(2, 1, "cpu")[0][0], 2, n, "cpu")
    assert seen and seen[0].dtype == torch.float64 and torch.equal(seen[0], own)
    res = rscn.run(scn, 2, replicas=2, device="cpu", backend="ref")
    assert res.summary.n_retry is not None


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------


def test_mixed_stationary_and_timestamp_cells_are_refused():
    scn = _port_day()
    over = {"arrival_process": [rproc.ExpSimProcess(rate=1.0),
                                rproc.MMPPArrivalProcess(0.3, 3.0, 0.01)]}
    with pytest.raises(ValueError) as port:
        rscn.sweep(scn, over, 0, replicas=2, device="cpu", backend="ref")
    jover = {"arrival_process": [jproc.ExpSimProcess(rate=1.0),
                                 jproc.MMPPArrivalProcess(0.3, 3.0, 0.01)]}
    with pytest.raises(ValueError) as ref:
        jscn.sweep(_jax_day(), jover, jax.random.key(0), replicas=2, backend="ref")
    assert str(port.value) == str(ref.value)
    # every cell a timestamp process: one prestamped launch
    grid = rscn.sweep(scn, {"arrival_process": [
        rproc.TraceArrivalProcess(tuple(np.arange(1.0, 2000.0, 1.5))),
        rproc.MMPPArrivalProcess(0.3, 3.0, 0.01)]}, 0, replicas=2, device="cpu", backend="ref")
    assert grid.ok.all()


@pytest.mark.parametrize("which", ["mmpp", "trace"])
def test_arrival_rate_refuses_mmpp_and_trace(which):
    jp = (jproc.MMPPArrivalProcess(0.3, 3.0, 0.01) if which == "mmpp"
          else jproc.TraceArrivalProcess((1.0, 2.0, 4.0)))
    with pytest.raises(ValueError) as ref:
        _jax_day(rate_profile=None, arrival_process=jp, arrival_rate=2.0)
    with pytest.raises(ValueError) as port:
        _port_day(rate_profile=None, arrival_process=interop.process_from_reference(jp),
                  arrival_rate=2.0)
    assert str(port.value) == str(ref.value) and "rate profiles" in str(port.value)
    scn = _port_day(rate_profile=None, arrival_process=interop.process_from_reference(jp))
    with pytest.raises(ValueError, match="cannot re-rate a timestamp process"):
        rscn.sweep(scn, {"arrival_rate": [1.0]}, 0, replicas=1, device="cpu", backend="ref")


def test_fused_draws_refuse_nhpp():
    scn = _port_day()
    fused = Execution(draws="fused", device="cpu", backend="ref")
    with pytest.raises(ValueError) as port:
        rscn.sweep(scn, {"expiration_threshold": [10.0]}, 0, replicas=2, execution=fused)
    with pytest.raises(ValueError) as ref:
        jscn.sweep(_jax_day(), {"expiration_threshold": [10.0]}, jax.random.key(0),
                   replicas=2, backend="ref", execution=jscn.Execution(draws="fused"))
    # the block backends refuse fused thinning with the reference's message
    assert str(port.value) == str(ref.value)
    assert str(ref.value).startswith("fused NHPP thinning is scan-backend only")
    with pytest.raises(ValueError, match="fused NHPP"):
        rscn.run(scn, 0, replicas=2, execution=fused)
    for proc in (rproc.MMPPArrivalProcess(0.3, 3.0, 0.01),
                 rproc.TraceArrivalProcess((1.0, 2.0, 4.0))):
        with pytest.raises(ValueError, match="draws='staged'"):
            rscn.run(_port_day(rate_profile=None, arrival_process=proc), 0, replicas=2,
                     execution=fused)


def test_both_arrival_process_and_profile_are_refused():
    with pytest.raises(ValueError) as ref:
        _jax_day(arrival_process=jproc.ExpSimProcess(rate=1.0))
    with pytest.raises(ValueError) as port:
        _port_day(arrival_process=rproc.ExpSimProcess(rate=1.0))
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="arrival_process or a rate_profile"):
        _port_day(rate_profile=None)
