"""The port's fused draws on the f64 engine (backend ``"scan_ref"``, the
plain version of kernel 8's fused path) against the reference: ``run()``
and ``sweep()`` with ``Execution(draws="fused")`` against the JAX package's
fused f64 scan on the reference's keys (``interop.fused_keys_from_reference``),
decision for decision against the pure-Python oracle ``simulate_pyref`` on
the f64 materialized streams, NHPP thinning with both profile kinds, the
layers (fail-only reliability, windows, the histogram, oldest routing) and
the reference's refusals.  The CUDA kernel's fused path is held to the
plain version in ``test_torch_cuda.py``.

Tolerances: counters equal; the f64 sums (integrals, response sums,
lifespans, window integrals, histogram bins) within rtol 1e-9 of the JAX
scan: the frameworks' f64 log, cos, exp and pow differ in the last bits,
which moves a sample by an ulp and each sum by a few."""

import jax
import numpy as np
import pytest
import torch

from repro.core import Execution as JExecution
from repro.core import ExpSimProcess as JExp
from repro.core import FailurePolicy as JFailurePolicy
from repro.core import Reliability as JReliability
from repro.core import Scenario as JScenario
from repro.core import drawplan as jdp
from repro.core import processes as jproc
from repro.core import scenario as jscenario
from repro.core.pyref import simulate_pyref
import repro_torch as rt
from repro_torch import interop
from repro_torch.core import drawplan as dp
from repro_torch.core import processes as rproc
from repro_torch.kernels.ref64 import scan_sweep_ref

SUM_RTOL = 1e-9
COUNTS = ("n_cold", "n_warm", "n_reject", "lifespan_count")
SUMS = ("time_running", "time_idle", "sum_cold_resp", "sum_warm_resp", "lifespan_sum")
RELY_COUNTS = ("n_timeout", "n_fail", "n_abandon")
J_FUSED = JExecution(backend="scan", draws="fused")
P_FUSED = rt.Execution(backend="scan_ref", draws="fused", device="cpu")


def _jscn(**kw):
    d = dict(arrival_process=JExp(rate=0.8), warm_service_process=JExp(rate=0.5),
             cold_service_process=JExp(rate=0.4), expiration_threshold=10.0, sim_time=400.0,
             skip_time=20.0, slots=16)
    d.update(kw)
    return JScenario(**d)


def _run_keys(key, R, fail=False):
    return interop.fused_keys_from_reference(
        [{k: np.asarray(v) for k, v in jdp.stream_row_keys(key, R, fail=fail).items()}])


def _sweep_keys(key, cells, R, fail):
    """The reference sweep's keys: its chained split walk over the draw
    cells, each cell's stream_row_keys."""
    parts = []
    for _ in range(cells):
        key, sub = jax.random.split(key)
        parts.append({k: np.asarray(v)
                      for k, v in jdp.stream_row_keys(sub, R, fail=fail).items()})
    return interop.fused_keys_from_reference(parts)


def _held(a, b, extra=()):
    """Summary ``b`` (the port's) against ``a`` (the reference's)."""
    for f in COUNTS + tuple(extra):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), getattr(b, f), err_msg=f)
    for f in SUMS:
        np.testing.assert_allclose(getattr(b, f), np.asarray(getattr(a, f)), rtol=SUM_RTOL,
                                   err_msg=f)
    if a.windows is not None:
        for f in ("n_cold", "n_warm", "n_arrivals"):
            np.testing.assert_array_equal(getattr(b.windows, f),
                                          np.asarray(getattr(a.windows, f)), err_msg=f)
        for f in ("time_running", "time_idle"):
            np.testing.assert_allclose(getattr(b.windows, f), np.asarray(getattr(a.windows, f)),
                                       rtol=SUM_RTOL, atol=1e-9, err_msg=f)
    if a.histogram is not None:
        np.testing.assert_allclose(b.histogram, np.asarray(a.histogram), rtol=SUM_RTOL,
                                   atol=1e-9)


RUN_CASES = {
    "exp": dict(),
    "families": dict(arrival_process=jproc.WeibullSimProcess(1.5, 1.3),
                     warm_service_process=jproc.GaussianSimProcess(2.0, 0.5),
                     cold_service_process=jproc.LogNormalSimProcess(0.3, 0.6)),
    "pareto_det": dict(arrival_process=jproc.ParetoSimProcess(2.5, 0.6),
                       warm_service_process=jproc.DeterministicSimProcess(1.1)),
    "windows_histogram": dict(window_bounds=(0.0, 50.0, 51.0, 200.0, 400.0),
                              track_histogram=True, hist_bins=9),
    "oldest": dict(routing="oldest"),
    "fail_only": dict(reliability=JReliability(failure=JFailurePolicy(p_fail=0.15,
                                                                      t_timeout=4.0))),
    "nhpp_sinusoid": dict(rate_profile=jproc.SinusoidalRate(0.8, 0.7, 150.0, 0.4)),
    "nhpp_piecewise_layers": dict(
        rate_profile=jproc.PiecewiseConstantRate((40.0, 90.0, 200.0), (1.2, 0.2, 0.9, 0.4)),
        window_bounds=(0.0, 100.0, 250.0, 400.0), track_histogram=True, hist_bins=7,
        reliability=JReliability(failure=JFailurePolicy(p_fail=0.1))),
}


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_fused_run_matches_the_jax_fused_scan(case):
    kw = dict(RUN_CASES[case])
    if "rate_profile" in kw:
        kw["arrival_process"] = None
    j = _jscn(**kw)
    key, R = jax.random.key(len(case)), 3
    fail = j.reliability is not None
    ref = jscenario.run(j, key, replicas=R, execution=J_FUSED).summary
    port = rt.run(interop.scenario_from_reference(j), 0, replicas=R, execution=P_FUSED,
                  fused_keys=_run_keys(key, R, fail)).summary
    _held(ref, port, RELY_COUNTS if fail else ())
    assert port.n_warm.sum() > 0 and port.n_cold.sum() > 0


@pytest.mark.parametrize("case", ["exp", "fail_only", "nhpp_sinusoid"])
def test_fused_sweep_matches_the_jax_fused_scan(case):
    kw = dict(RUN_CASES[case])
    if "rate_profile" in kw:
        kw["arrival_process"] = None
        over = {"expiration_threshold": [5.0, 30.0], "sim_time": [300.0, 400.0]}
        cells = 2
    else:
        over = {"expiration_threshold": [5.0, 30.0], "arrival_rate": [0.5, 1.1]}
        cells = 4
    j = _jscn(**kw)
    key, R = jax.random.key(17), 2
    fail = j.reliability is not None
    jg = jscenario.sweep(j, over=over, key=key, replicas=R, execution=J_FUSED)
    pg = rt.sweep(interop.scenario_from_reference(j), over, 0, replicas=R, execution=P_FUSED,
                  fused_keys=_sweep_keys(key, cells, R, fail))
    assert pg.shape == tuple(np.shape(jg.cold_start_prob)) and pg.execution.draws == "fused"
    for a, b in zip(jg.summaries.ravel(), pg.summaries.ravel()):
        _held(a, b, RELY_COUNTS if fail else ())


def test_fused_scan_decision_exact_vs_pyref():
    """tests/test_drawplan.py:190-218 on the port: the plain fused scan
    replays event for event against the oracle on the f64 materialized
    streams."""
    s = _jscn()
    key, n, R = jax.random.key(21), 700, 3
    keys = _run_keys(key, R)
    res = rt.run(interop.scenario_from_reference(s), 0, replicas=R, steps=n, execution=P_FUSED,
                 fused_keys=keys).summary
    f64 = torch.float64
    streams = {name: dp.materialize_stream("exp", keys[name], (rate, 0.0), n, dtype=f64)
               for name, rate in (("arrival", 0.8), ("warm", 0.5), ("cold", 0.4))}
    assert all(x.dtype == f64 for x in streams.values())
    jstreams = {name: np.asarray(jdp.materialize_stream(
        "exp", jdp.stream_row_keys(key, R)[name], (rate, 0.0), n, np.float64))
        for name, rate in (("arrival", 0.8), ("warm", 0.5), ("cold", 0.4))}
    for name in streams:
        np.testing.assert_allclose(streams[name].numpy(), jstreams[name], rtol=1e-14)
    for r in range(R):
        ref = simulate_pyref(streams["arrival"][r].numpy(), streams["warm"][r].numpy(),
                             streams["cold"][r].numpy(), s.expiration_threshold,
                             s.max_concurrency, s.sim_time, s.skip_time)
        assert int(res.n_cold[r]) == ref.n_cold
        assert int(res.n_warm[r]) == ref.n_warm
        assert int(res.n_reject[r]) == ref.n_reject


def test_fused_plain_equals_staged_plain_on_materialized_draws():
    """The f64 fused path against the f64 staged path fed its own draws:
    the arrival gaps as the f64 timestamps the scan's clock adds up
    (prestamped), and deterministic service times that f32 holds exactly,
    so both runs make every decision on the same numbers."""
    R, M, K = 3, 16, 300
    rng = np.random.default_rng(4)
    keys = [torch.from_numpy(rng.integers(0, 1 << 32, (R, 2), dtype=np.uint64).astype(
        np.uint32)) for _ in range(3)]
    params = [torch.tensor(np.tile(p, (R, 1)), dtype=torch.float64)
              for p in ((0.9, 0.0), (1.25, 0.0), (2.5, 0.0))]
    dists = ("exp", "det", "det")
    pool = (torch.zeros((R, M), dtype=torch.bool), torch.full((R, M), -1e30, dtype=torch.float64),
            torch.full((R, M), -1e30, dtype=torch.float64))
    kw = dict(t_exp=12.0, t_end=250.0, skip=10.0, max_concurrency=1000, hist_bins=5,
              window_bounds=torch.tensor([[0.0, 60.0, 61.0, 400.0]] * R, dtype=torch.float64))
    fused = scan_sweep_ref(*pool, None, None, None, **kw, fused_keys=tuple(keys),
                           fused_params=tuple(params), fused_dists=dists, fused_k=K)
    draws = [dp.materialize_stream(d, k, p, K, dtype=torch.float64)
             for d, k, p in zip(dists, keys, params)]
    times = torch.zeros((R, K), dtype=torch.float64)
    t = torch.zeros((R,), dtype=torch.float64)
    for k in range(K):  # the clock as the scan adds it, one gap at a time
        t = t + draws[0][:, k]
        times[:, k] = t
    staged = scan_sweep_ref(*pool, times, draws[1].float(), draws[2].float(), **kw,
                            prestamped=True)
    for name, a, b in zip(fused._fields, fused, staged):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("profile", [
    rproc.SinusoidalRate(0.9, 0.8, 86400.0, 0.2),
    rproc.PiecewiseConstantRate((100.0, 300.0), (0.5, 2.0, 1.0)),
])
def test_profile_blocks_evaluate_the_profile(profile):
    t = torch.tensor(np.random.default_rng(0).uniform(0.0, 2e5, 5000))
    np.testing.assert_array_equal(rproc.block_rate(profile.block(), t).numpy(),
                                  profile.rate(t).numpy())
    spec, params = dp._lower_process(rproc.NHPPArrivalProcess(profile), "arrival")
    assert spec.kind == "nhpp" and spec.profile == profile and params[0] == profile.max_rate()


def test_thinning_keeps_the_accepted_share():
    """NHPP thinning on the fused path routes arrivals at the profile's mean
    rate, not the envelope's: a piecewise profile whose envelope is 4x its
    mean, over 20 replicas."""
    prof = rproc.PiecewiseConstantRate((500.0,), (0.25, 1.0))
    scn = rt.Scenario(arrival_process=rproc.NHPPArrivalProcess(prof),
                      warm_service_process=rproc.ExpSimProcess(rate=2.0),
                      cold_service_process=rproc.ExpSimProcess(rate=1.0),
                      expiration_threshold=5.0, sim_time=1000.0, skip_time=0.0, slots=16,
                      window_bounds=(0.0, 500.0, 1000.0))
    s = rt.run(scn, 3, replicas=20, execution=P_FUSED).summary
    per_window = s.windows.n_arrivals.mean(0)
    # 125 and 500 expected; 4 standard errors of a Poisson mean over 20 rows
    np.testing.assert_allclose(per_window, [125.0, 500.0], atol=4 * np.sqrt(500.0 / 20))


def test_the_reference_refusals():
    base = _jscn()
    pscn = interop.scenario_from_reference(base)
    from repro.core.faults import FaultModel as JFaults
    from repro.core.reliability import RetryPolicy as JRetry

    retry = JReliability(failure=JFailurePolicy(p_fail=0.1), retry=JRetry(max_retries=2))
    cases = {
        "retries": _jscn(reliability=retry),
        "gamma": _jscn(arrival_process=jproc.GammaSimProcess(2.0, 1.0)),
        "faults": _jscn(faults=JFaults(crash_rate=0.01)),
    }
    for name, j in cases.items():
        with pytest.raises(ValueError) as ref:
            jscenario.run(j, jax.random.key(0), replicas=1, execution=J_FUSED)
        with pytest.raises(ValueError) as port:
            rt.run(interop.scenario_from_reference(j), 0, replicas=1, execution=P_FUSED)
        assert str(port.value).split(";")[0].split("(")[0] == \
            str(ref.value).split(";")[0].split("(")[0], name
    # fused NHPP on a block backend: the reference's message
    day = _jscn(arrival_process=None, rate_profile=jproc.SinusoidalRate(0.8, 0.5, 300.0))
    with pytest.raises(ValueError) as ref:
        jscenario.sweep(day, {"expiration_threshold": [5.0]}, jax.random.key(0), replicas=1,
                        execution=JExecution(backend="ref", draws="fused"))
    with pytest.raises(ValueError) as port:
        rt.sweep(interop.scenario_from_reference(day), {"expiration_threshold": [5.0]}, 0,
                 replicas=1, execution=rt.Execution(backend="ref", draws="fused",
                                                    device="cpu"))
    assert str(port.value) == str(ref.value)
    # mixed families, or two profiles, across draw cells
    over = {"arrival_process": [JExp(rate=0.8), jproc.WeibullSimProcess(1.5, 1.3)]}
    with pytest.raises(ValueError) as ref:
        jscenario.sweep(base, over, jax.random.key(0), replicas=1, execution=J_FUSED)
    pover = {"arrival_process": [interop.process_from_reference(p)
                                 for p in over["arrival_process"]]}
    with pytest.raises(ValueError) as port:
        rt.sweep(pscn, pover, 0, replicas=1, execution=P_FUSED)
    assert "distribution families or rate profiles" in str(ref.value)
    assert "distribution families or rate profiles" in str(port.value)
    profiles = [rproc.SinusoidalRate(0.8, 0.5, 300.0), rproc.SinusoidalRate(0.8, 0.6, 300.0)]
    with pytest.raises(ValueError, match="rate profiles"):
        rt.sweep(interop.scenario_from_reference(day), {"profile": profiles}, 0, replicas=1,
                 execution=P_FUSED)
    # the par and temporal engines draw no fused samples
    for engine in ("par", "temporal"):
        with pytest.raises(ValueError, match="cannot draw fused samples"):
            rt.run(pscn, 0, replicas=1, engine=engine, execution=P_FUSED)
