"""The port's online what-if service against the JAX reference, and the
twins of the reference's own service tests (``tests/test_online.py``,
``tests/test_faults.py::TestOnlineChaos``), on the CPU at small sizes.

The ingestion, the EMA fit and the replay of traces are numpy code in both
packages: on the same batches they agree exactly.  A tick's sweep is the
f64 scan on both sides: on the reference's own draws for the recorded
profile (its key walk, pinned ``steps``) the port's grid has the
reference's counters exactly and its float metrics within ``FLOAT_RTOL``.
The port's own draws come from ``SeedSequence`` children, not ``jax.random``
keys, so everything else is held to the port itself: a tick equals the
offline sweep bit for bit, a deferred sweep the synchronous one, a restored
service the original.
"""

import itertools
import warnings

import jax
import numpy as np
import pytest

import repro.core.processes as jproc
from repro.core import Scenario as JScenario
from repro.core import scenario as jscn
from repro.core.simulator import draw_workload_samples as j_draw
from repro.data.catalog import fleet_of as j_fleet_of
from repro.serving import online as jonline
from repro_torch import interop
from repro_torch.core import processes as rproc
from repro_torch.core import scenario as rscn
from repro_torch.core.faults import CapacityProfile, FaultModel
from repro_torch.core.execution import Execution
from repro_torch.core.processes import ExpSimProcess, PiecewiseConstantRate
from repro_torch.core.scenario import TRACE_COUNTS, PendingSweep, Scenario, sweep
from repro_torch.data.catalog import fleet_of
from repro_torch.serving import (
    OnlineConfig,
    OnlineFleetWhatIfService,
    OnlineWhatIfService,
    ThresholdGovernor,
    replay_arrivals,
    select_threshold,
)
from repro_torch.serving.online import trace_total

FLOAT_RTOL = 1e-12
COUNTERS = ("n_cold", "n_warm", "n_reject", "lifespan_count", "overflow")
FLOATS = ("time_running", "time_idle", "sum_cold_resp", "sum_warm_resp", "lifespan_sum")


def base_scn(**kw):
    kw.setdefault("arrival_process", ExpSimProcess(rate=1.0))
    kw.setdefault("warm_service_process", ExpSimProcess(rate=1.0))
    kw.setdefault("cold_service_process", ExpSimProcess(rate=0.5))
    kw.setdefault("slots", 32)
    return Scenario(**kw)


def j_base_scn(**kw):
    kw.setdefault("arrival_process", jproc.ExpSimProcess(rate=1.0))
    kw.setdefault("warm_service_process", jproc.ExpSimProcess(rate=1.0))
    kw.setdefault("cold_service_process", jproc.ExpSimProcess(rate=0.5))
    kw.setdefault("slots", 32)
    return JScenario(**kw)


SMALL = dict(rate_ceiling=4.0, n_bins=6, bin_width=25.0, thresholds=(30.0, 120.0, 600.0),
             replicas=2)


def small_config(**kw):
    return OnlineConfig(**dict(SMALL, device="cpu", **kw))


def j_small_config(**kw):
    return jonline.OnlineConfig(**dict(SMALL, **kw))


def batches(n_ticks, seed=0, rate0=1.0, width=30.0):
    """``n_ticks`` batches of a drifting-rate stream, one a tick."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for i in range(n_ticks):
        rate = rate0 * (1.0 + 0.5 * np.sin(i))
        n = max(1, rng.poisson(rate * width))
        out.append(np.sort(t + rng.uniform(0.0, width, n)))
        t += width
    return out


def drive(svc, n_ticks=6, seed=0):
    """Push a batch and tick, ``n_ticks`` times; flush; the recommendations."""
    recs = []
    for ts in batches(n_ticks, seed):
        svc.observe(ts)
        rec = svc.tick()
        if rec is not None:
            recs.append(rec)
    last = svc.flush()
    if last is not None:
        recs.append(last)
    return recs


# ---------------------------------------------------------------------------
# the numpy side against the reference: replay, estimates
# ---------------------------------------------------------------------------


def test_replay_trace_equals_reference():
    ts = np.cumsum(np.random.default_rng(4).exponential(0.7, 400))
    port = replay_arrivals(rproc.TraceArrivalProcess(timestamps=tuple(ts)), 150.0)
    ref = jonline.replay_arrivals(jproc.TraceArrivalProcess(timestamps=tuple(ts)), 150.0)
    np.testing.assert_array_equal(port, np.asarray(ref))
    assert port.dtype == np.float64 and port[-1] < 150.0


@pytest.mark.parametrize("kw", [
    dict(), dict(ema_alpha=0.25), dict(ema_alpha=1.0, rate_ceiling=1.5),
    dict(n_bins=2, bin_width=50.0), dict(rate_floor=0.05, n_bins=8, bin_width=10.0),
])
def test_estimates_equal_reference_over_ticks(kw):
    """>= 6 ticks of identical batches: the EMA, the clamp, the floor and
    the rolling prune give the reference's profiles bit for bit."""
    port = OnlineWhatIfService(base_scn(), small_config(**kw))
    ref = jonline.OnlineWhatIfService(j_base_scn(), j_small_config(**kw))
    for ts in batches(8, seed=3, rate0=1.4):
        port.observe(ts)
        ref.observe(ts)
        p, r = port.estimate(), ref.estimate()
        assert p.edges == tuple(r.edges)
        assert p.rates == tuple(float(x) for x in r.rates)
        np.testing.assert_array_equal(port._buf, ref._buf)
        assert port.now == ref.now
        assert p.mean_rate() == r.mean_rate()


def test_idle_window_estimate_equals_reference():
    port = OnlineWhatIfService(base_scn(), small_config())
    ref = jonline.OnlineWhatIfService(j_base_scn(), j_small_config())
    assert port.estimate().rates == tuple(float(x) for x in ref.estimate().rates)
    for svc in (port, ref):
        svc.observe([1.0, 2.0, 3.0])
        svc.observe([500.0])  # the window moves past the first batch
    assert port.estimate().rates == tuple(float(x) for x in ref.estimate().rates)


def test_fleet_estimates_equal_reference():
    names = ["thumbnail", "crypto-sign", "video-transcode"]
    kw = dict(n_cluster=24, sim_time=500.0, skip_time=0.0, slots=16)
    cfg = dict(SMALL, rate_ceiling=3.0, sim_time=150.0)
    port = OnlineFleetWhatIfService(fleet_of(names, **kw), OnlineConfig(**cfg, device="cpu"))
    ref = jonline.OnlineFleetWhatIfService(j_fleet_of(names, **kw), jonline.OnlineConfig(**cfg))
    assert port._ratio == ref._ratio and port._steps == ref._steps
    rng = np.random.default_rng(5)
    for i in range(7):
        for name, rate in zip(names, (0.6, 0.2, 2.5)):
            n = max(1, rng.poisson(rate * 30.0 * (1 + 0.4 * np.sin(i))))
            ts = np.sort(i * 30.0 + rng.uniform(0.0, 30.0, n))
            port.observe(name, ts)
            ref.observe(name, ts)
        assert port.estimate() == ref.estimate()


# ---------------------------------------------------------------------------
# one tick's sweep on the reference's draws
# ---------------------------------------------------------------------------


def reference_parts(base, over, key, replicas, n_steps):
    """The reference sweep's per-draw-cell staged buffers (its chained key
    walk), f64 timestamps included."""
    draw_names = [n for n in over if n in jscn._DRAW_FIELDS]
    parts = []
    for combo in itertools.product(*[over[n] for n in draw_names]):
        c = base
        for n, v in zip(draw_names, combo):
            c = jscn._apply_axis(c, n, v)
        key, sub = jax.random.split(key)
        parts.append(tuple(np.asarray(x) for x in j_draw(c, sub, replicas, n_steps)))
    return parts


def assert_grids_match(port, ref, exact=False):
    assert port.shape == tuple(ref.shape)
    for idx in np.ndindex(port.shape):
        p, r = port.summaries[idx], ref.summaries[idx]
        for f in COUNTERS:
            np.testing.assert_array_equal(getattr(p, f), np.asarray(getattr(r, f)), err_msg=f)
        for f in FLOATS:
            a, b = getattr(p, f), np.asarray(getattr(r, f))
            if exact:
                np.testing.assert_array_equal(a, b, err_msg=f)
            else:
                np.testing.assert_allclose(a, b, rtol=FLOAT_RTOL, atol=1e-9, err_msg=f)


@pytest.mark.parametrize("tick", [0, 3, 5])
def test_tick_sweep_on_reference_draws_matches_reference(tick):
    """The profile a tick records, swept on the reference's own buffers for
    it (pinned steps): the reference's grid, counters exactly."""
    svc = OnlineWhatIfService(base_scn(), small_config(overlap=False))
    recs = drive(svc, n_ticks=6, seed=2)
    rec = recs[tick]
    jprof = jproc.PiecewiseConstantRate(edges=rec.profile.edges, rates=rec.profile.rates)
    jbase = jscn.Scenario.of(
        j_base_scn(), arrival_process=jproc.NHPPArrivalProcess(profile=jprof),
        rate_profile=None, arrival_rate=None, sim_time=svc.config.horizon, skip_time=0.0,
    )
    over = {"expiration_threshold": list(svc.config.thresholds)}
    key = jax.random.key(17 + tick)
    R, n = svc.config.replicas, svc._steps  # the width pinned at the ceiling
    ref = jscn.sweep(jbase, over, key, replicas=R, steps=n)
    parts = reference_parts(jbase, over, key, R, n)
    port = sweep(svc._scenario(rec.profile), over, 0, replicas=R, device="cpu", steps=n,
                 staged=interop.staged_from_reference(parts, f64=True))
    assert_grids_match(port, ref)
    for m in ("cold_start_prob", "avg_server_count", "wasted_ratio", "developer_cost"):
        np.testing.assert_allclose(getattr(port, m), np.asarray(getattr(ref, m)),
                                   rtol=FLOAT_RTOL, err_msg=m)
    assert (select_threshold(port, 0.1).expiration_threshold
            == jonline.select_threshold(ref, 0.1).expiration_threshold)


# ---------------------------------------------------------------------------
# deferred sweeps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("over", [
    {"expiration_threshold": [20.0, 60.0, 180.0]},
    {"expiration_threshold": [20.0, 60.0], "sim_time": [150.0, 200.0]},
    {"slots": [16, 32], "expiration_threshold": [20.0, 60.0]},
])
def test_deferred_bitwise_equals_sync(over):
    scn = base_scn(sim_time=200.0, skip_time=0.0)
    ref = sweep(scn, over, 3, replicas=2, device="cpu")
    pend = sweep(scn, over, 3, replicas=2, device="cpu", deferred=True)
    assert isinstance(pend, PendingSweep)
    got = pend.result()
    for f in ("cold_start_prob", "developer_cost", "goodput", "avg_server_count", "ok"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    assert got.axes == ref.axes
    assert pend.result() is got  # memoised drain


def test_deferred_nhpp_bitwise_equals_sync():
    prof = PiecewiseConstantRate(edges=(50.0, 100.0), rates=(0.5, 2.0, 1.0))
    scn = base_scn(arrival_process=rproc.NHPPArrivalProcess(profile=prof), sim_time=150.0,
                   skip_time=0.0)
    over = {"expiration_threshold": [20.0, 60.0]}
    ref = sweep(scn, over, 5, replicas=2, device="cpu")
    got = sweep(scn, over, 5, replicas=2, device="cpu", deferred=True).result()
    assert_grids_match(got, ref, exact=True)


@pytest.mark.parametrize("how", ["backend", "execution"])
def test_deferred_rejects_block_backends(how):
    kw = dict(backend="ref") if how == "backend" else dict(execution=Execution(backend="ref"))
    with pytest.raises(ValueError, match="deferred=True needs an f64 scan backend"):
        sweep(base_scn(sim_time=100.0, skip_time=0.0), {"expiration_threshold": [20.0]}, 0,
              device="cpu", deferred=True, **kw)


def test_deferred_guards_raise_on_result():
    """A short stream is found where the result is read, before any grid."""
    prof = PiecewiseConstantRate(edges=(50.0,), rates=(1.0, 1.0))
    scn = base_scn(arrival_process=rproc.NHPPArrivalProcess(profile=prof), sim_time=150.0,
                   skip_time=0.0)
    over = {"expiration_threshold": [20.0]}
    with pytest.raises(RuntimeError, match="coverage"):
        sweep(scn, over, 0, replicas=2, device="cpu", steps=20)
    pend = sweep(scn, over, 0, replicas=2, device="cpu", steps=20, deferred=True)
    with pytest.raises(RuntimeError, match="coverage"):
        pend.result()
    with pytest.raises(RuntimeError, match="before sim_time"):
        sweep(base_scn(sim_time=150.0, skip_time=0.0), over, 0, replicas=2, device="cpu",
              steps=20, deferred=True).result()


# ---------------------------------------------------------------------------
# the tick loop
# ---------------------------------------------------------------------------


def test_zero_new_loads_or_segments_after_warmup():
    svc = OnlineWhatIfService(base_scn(), small_config())
    before = TRACE_COUNTS["online_tick"]
    deltas = []
    for ts in batches(6, seed=1):
        svc.observe(ts)
        snap = TRACE_COUNTS["online_tick"]
        svc.tick()
        deltas.append(TRACE_COUNTS["online_tick"] - snap)
    svc.flush()
    assert deltas[1:] == [0] * 5  # steady state: nothing paid again
    assert TRACE_COUNTS["online_tick"] == before + deltas[0]
    assert trace_total() >= 0


def test_block_backend_ticks_drain_synchronously():
    svc = OnlineWhatIfService(base_scn(), small_config(execution=Execution(backend="ref")))
    assert not svc._deferred
    for ts in batches(3, seed=2):
        svc.observe(ts)
        rec = svc.tick()
        assert rec is not None and rec.grid.backend == "ref"


def test_recommendation_bitwise_equals_offline_sweep():
    svc = OnlineWhatIfService(base_scn(), small_config())
    recs = drive(svc)
    assert len(recs) == 6
    for rec in recs[:3]:
        off = svc.offline_equivalent(rec)
        for f in ("cold_start_prob", "developer_cost", "avg_server_count"):
            np.testing.assert_array_equal(getattr(off, f), getattr(rec.grid, f), err_msg=f)
        assert select_threshold(off, svc.config.cold_slo).expiration_threshold == rec.threshold


def test_overlapped_ticks_equal_synchronous_ticks():
    a = drive(OnlineWhatIfService(base_scn(), small_config()))
    b = drive(OnlineWhatIfService(base_scn(), small_config(overlap=False)))
    assert [r.tick for r in a] == [r.tick for r in b] == list(range(6))
    for ra, rb in zip(a, b):
        assert ra.seed == rb.seed and ra.profile == rb.profile
        assert (ra.threshold, ra.applied_threshold) == (rb.threshold, rb.applied_threshold)
        np.testing.assert_array_equal(ra.grid.cold_start_prob, rb.grid.cold_start_prob)


def test_tick_seeds_are_seed_sequence_children():
    svc = OnlineWhatIfService(base_scn(), small_config(seed=9, overlap=False))
    recs = drive(svc, n_ticks=3)
    kids = np.random.SeedSequence(9).spawn(3)
    assert [r.seed for r in recs] == [int(k.generate_state(1, np.uint64)[0]) for k in kids]
    assert len(set(r.seed for r in recs)) == 3


def test_overlap_returns_previous_tick():
    svc = OnlineWhatIfService(base_scn(), small_config())
    svc.observe(np.linspace(0.5, 29.5, 40))
    assert svc.tick() is None  # tick 0 launched, nothing to drain
    svc.observe(np.linspace(30.5, 59.5, 40))
    rec = svc.tick()
    assert rec is not None and rec.tick == 0
    last = svc.flush()
    assert last.tick == 1
    assert svc.flush() is None
    assert [r.tick for r in svc.history] == [0, 1]


def test_recommendation_fields_sane():
    svc = OnlineWhatIfService(base_scn(), small_config())
    rec = drive(svc, n_ticks=3)[0]
    assert rec.threshold in svc.config.thresholds
    assert 0.0 <= rec.predicted_cold_prob <= 1.0
    assert rec.predicted_cost > 0 and rec.predicted_goodput > 0
    assert rec.headroom == pytest.approx(32 - rec.predicted_avg_replicas)
    assert rec.rate_mean > 0
    assert isinstance(rec.profile, PiecewiseConstantRate)
    assert rec.grid.backend == "scan_ref" and not rec.degraded


def test_ema_blending():
    """EMA: the second estimate is alpha * new + (1 - alpha) * previous."""
    cfg = small_config(ema_alpha=0.25, n_bins=2, bin_width=50.0)
    svc = OnlineWhatIfService(base_scn(), cfg)
    svc.observe(np.linspace(0.1, 99.9, 100))
    p1 = svc.estimate()
    e1 = np.asarray(svc._ema).copy()
    ts2 = np.linspace(100.1, 200.0, 300)
    svc.observe(ts2)
    p2 = svc.estimate()
    fitted = PiecewiseConstantRate.fit(np.minimum(ts2 - 100.0, np.nextafter(100.0, 0.0)),
                                       bin_width=50.0, n_bins=2)
    expect = 0.25 * np.asarray(fitted.rates) + 0.75 * e1
    np.testing.assert_allclose(np.asarray(p2.rates), expect, rtol=1e-12)
    assert p1.edges == p2.edges


def test_estimate_clamps_to_ceiling():
    cfg = small_config(rate_ceiling=2.0, ema_alpha=1.0)
    svc = OnlineWhatIfService(base_scn(), cfg)
    svc.observe(np.sort(np.random.default_rng(0).uniform(0, cfg.span, 2000)))
    assert max(svc.estimate().rates) <= 2.0


def test_observe_validates_stream_order():
    svc = OnlineWhatIfService(base_scn(), small_config())
    svc.observe([1.0, 2.0])
    with pytest.raises(ValueError, match="stream order"):
        svc.observe([0.5])
    with pytest.warns(RuntimeWarning, match="out-of-order"):
        svc.observe([5.0, 4.0])
    assert list(svc._buf[-2:]) == [4.0, 5.0]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the second offence stays silent
        svc.observe([7.0, 6.0])
    with pytest.raises(ValueError, match="finite"):
        svc.observe([np.nan])
    with pytest.raises(ValueError, match=">= 0"):
        svc.observe([-1.0])
    with pytest.raises(ValueError, match="duplicate"):
        svc.observe([8.0, 8.0])
    with pytest.raises(ValueError, match="stream order"):
        svc.observe([7.0])  # replays the stream head exactly


def test_observe_trace_and_rolling_window_prune():
    svc = OnlineWhatIfService(base_scn(), small_config(n_bins=2, bin_width=10.0))
    svc.observe_trace(rproc.TraceArrivalProcess(timestamps=tuple(np.linspace(0.5, 99.5, 50))))
    assert svc.now == pytest.approx(99.5)
    assert (svc._buf >= 99.5 - 20.0).all()


@pytest.mark.parametrize("kw, match", [
    (dict(rate_ceiling=0.0), "rate_ceiling"),
    (dict(rate_ceiling=1.0, ema_alpha=0.0), "ema_alpha"),
    (dict(rate_ceiling=1.0, n_bins=0), "n_bins"),
    (dict(rate_ceiling=1.0, thresholds=()), "thresholds"),
    (dict(rate_ceiling=1.0, bin_width=0.0), "bin_width"),
    (dict(rate_ceiling=1.0, rate_floor=0.0), "rate_floor"),
])
def test_config_validation_matches_reference(kw, match):
    with pytest.raises(ValueError, match=match) as port:
        OnlineConfig(**kw)
    with pytest.raises(ValueError, match=match) as ref:
        jonline.OnlineConfig(**kw)
    assert str(port.value) == str(ref.value)


def test_service_validation():
    with pytest.raises(TypeError, match="OnlineConfig"):
        OnlineWhatIfService(base_scn(), dict(rate_ceiling=1.0))
    with pytest.raises(ValueError, match="skip_time"):
        OnlineWhatIfService(base_scn(), small_config(skip_time=150.0))


def test_replay_profile_covers_horizon():
    prof = rproc.SinusoidalRate(base=2.0, amplitude=0.3, period=40.0)
    ts = replay_arrivals(prof, 300.0, seed=0)
    assert len(ts) > 300  # ~600 expected
    assert (np.diff(ts) >= 0).all() and ts[-1] < 300.0
    np.testing.assert_array_equal(ts, replay_arrivals(prof, 300.0, seed=0))


def test_replay_validation():
    with pytest.raises(ValueError, match="seed"):
        replay_arrivals(rproc.SinusoidalRate(2.0, 0.3, 40.0), 100.0)
    with pytest.raises(TypeError, match="replay_arrivals"):
        replay_arrivals(ExpSimProcess(rate=1.0), 100.0)
    with pytest.raises(ValueError, match="t_end"):
        replay_arrivals(rproc.SinusoidalRate(2.0, 0.3, 40.0), 0.0, seed=0)


def test_service_applies_hysteresis():
    recs = drive(OnlineWhatIfService(base_scn(), small_config(patience=3)))
    assert len({r.applied_threshold for r in recs[:2]}) == 1
    gov = ThresholdGovernor(patience=3)
    assert [gov.update(r.threshold) for r in recs] == [r.applied_threshold for r in recs]


# ---------------------------------------------------------------------------
# degraded ticks and checkpoints (the reference's online chaos tests)
# ---------------------------------------------------------------------------


def chaos_base(faults=True):
    return Scenario(
        arrival_process=ExpSimProcess(rate=1.0),
        warm_service_process=ExpSimProcess(rate=0.5),
        cold_service_process=ExpSimProcess(rate=1.0 / 3.0),
        expiration_threshold=60.0, max_concurrency=20, sim_time=100.0, skip_time=0.0,
        faults=FaultModel(crash_rate=0.01,
                          capacity=CapacityProfile(edges=(40.0,), values=(20.0, 4.0)))
        if faults else None,
    )


def chaos_config():
    return OnlineConfig(rate_ceiling=4.0, n_bins=4, bin_width=10.0, overlap=False,
                        thresholds=(30.0, 120.0), replicas=2, device="cpu")


def test_degraded_tick_holds_last_good_recommendation():
    svc = OnlineWhatIfService(chaos_base(), chaos_config())
    rng = np.random.default_rng(7)
    svc.observe(np.cumsum(rng.exponential(1.0, 60)))
    r0 = svc.tick()
    assert not r0.degraded
    before = trace_total()
    r1 = svc.tick()  # the ingest stalled
    assert trace_total() == before
    assert r1.degraded and "stalled" in r1.degraded_reason
    assert (r1.threshold, r1.applied_threshold, r1.predicted_cold_prob) == (
        r0.threshold, r0.applied_threshold, r0.predicted_cold_prob)
    assert r1.tick == 1 and svc.history[-1] is r1


def test_non_finite_grid_degrades_the_tick(monkeypatch):
    svc = OnlineWhatIfService(chaos_base(faults=False), chaos_config())
    rng = np.random.default_rng(8)
    svc.observe(np.cumsum(rng.exponential(1.0, 40)))
    r0 = svc.tick()
    real = rscn.sweep

    def poisoned(*args, **kw):
        grid = real(*args, **kw)
        grid.ok = np.zeros_like(grid.ok)
        return grid

    monkeypatch.setattr("repro_torch.serving.online.scenario_sweep", poisoned)
    svc.observe(svc.now + np.cumsum(rng.exponential(1.0, 20)))
    r1 = svc.tick()
    assert r1.degraded and "non-finite" in r1.degraded_reason
    assert r1.threshold == r0.threshold and r1.seed == r0.seed


def test_checkpoint_restore_resumes_bitwise():
    base, cfg = chaos_base(faults=False), chaos_config()
    svc = OnlineWhatIfService(base, cfg)
    rng = np.random.default_rng(3)
    svc.observe(np.cumsum(rng.exponential(1.0, 50)))
    svc.tick()
    snap = svc.checkpoint()
    assert snap["version"] == 1 and snap["n_children_spawned"] == 1
    clone = OnlineWhatIfService(base, cfg)
    clone.restore(snap)
    more = svc.now + np.cumsum(rng.exponential(1.0, 30))
    svc.observe(more)
    clone.observe(more)
    ra, rb = svc.tick(), clone.tick()
    assert (ra.threshold, ra.applied_threshold, ra.seed) == (rb.threshold, rb.applied_threshold,
                                                             rb.seed)
    assert float(ra.rate_mean) == float(rb.rate_mean)
    np.testing.assert_array_equal(ra.grid.cold_start_prob, rb.grid.cold_start_prob)


def test_restore_rejects_unknown_version():
    svc = OnlineWhatIfService(chaos_base(faults=False), chaos_config())
    with pytest.raises(ValueError, match="version"):
        svc.restore({"version": 99})


# ---------------------------------------------------------------------------
# the fleet service
# ---------------------------------------------------------------------------


def fleet_service(**kw):
    fleet = fleet_of(["thumbnail", "crypto-sign"], n_cluster=24, sim_time=500.0,
                     skip_time=0.0, slots=16)
    return OnlineFleetWhatIfService(fleet, small_config(rate_ceiling=3.0, sim_time=150.0, **kw))


def drive_fleet(svc, n_ticks=4):
    rng = np.random.default_rng(5)
    recs = []
    for i in range(n_ticks):
        for name, rate in [("thumbnail", 0.6), ("crypto-sign", 0.2)]:
            n = max(1, rng.poisson(rate * 30.0 * (1 + 0.4 * np.sin(i))))
            svc.observe(name, np.sort(i * 30.0 + rng.uniform(0.0, 30.0, n)))
        snap = TRACE_COUNTS["online_tick"]
        recs.append((svc.tick(), TRACE_COUNTS["online_tick"] - snap))
    return recs


def test_fleet_ticks_pay_nothing_again_after_warmup():
    recs = drive_fleet(fleet_service())
    assert [d for _, d in recs[1:]] == [0] * 3


def test_fleet_recommendation_shape():
    svc = fleet_service()
    recs = [r for r, _ in drive_fleet(svc, 3)]
    rec = recs[-1]
    assert set(rec.plans) == {"thumbnail", "crypto-sign"}
    assert set(rec.thresholds.values()) <= set(svc.config.thresholds)
    assert rec.predicted_total_replicas == pytest.approx(
        sum(p.predicted_avg_replicas for p in rec.plans.values()))
    assert rec.headroom == pytest.approx(24 - rec.predicted_total_replicas)
    assert [r.tick for r in recs] == [0, 1, 2] and rec.grid.backend == "scan_ref"
    kids = np.random.SeedSequence(0).spawn(3)
    assert rec.seed == int(kids[2].generate_state(1, np.uint64)[0])


def test_fleet_observe_validation():
    svc = fleet_service()
    with pytest.raises(KeyError, match="thumbnail"):
        svc.observe("nope", [1.0])
    with pytest.raises(ValueError, match="finite"):
        svc.observe("thumbnail", [np.inf])
    with pytest.raises(ValueError, match="sorted"):
        svc.observe("thumbnail", [2.0, 1.0])
    with pytest.raises(TypeError, match="FleetScenario"):
        OnlineFleetWhatIfService(base_scn(), small_config())
