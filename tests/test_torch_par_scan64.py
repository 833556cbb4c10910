"""The f64 engine's concurrency-value scan on the CPU (backend
``"scan_ref"``, the plain f64 version of ``csrc/par_scan_event_step.cu``)
against the JAX package's ``ParServerlessSimulator`` on the reference's own
buffers: c = 1, 3 and 8, with rejections, the histogram, reliability and
retries, prestamped timestamps; through the class and through
``run(engine="par")``.  Counters and response sums equal, the integrals
(∫running, ∫idle, ∫in-flight), lifespans and histogram bins within
``RTOL``."""

import jax
import numpy as np
import pytest
import torch

import repro.core.processes as jproc
from repro.core import Scenario as JScenario
from repro.core import par_simulator as jpar
from repro.core import simulator as jsim
from repro.core.reliability import (
    FailurePolicy as JFail,
    Reliability as JRely,
    RetryPolicy as JRetry,
)
from repro_torch import interop
from repro_torch.core import par_simulator as rpar
from repro_torch.core import scenario as rscn
from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS
from repro_torch.kernels.par_scan_event_step import par_scan_sweep
from repro_torch.kernels.ref64 import par_scan_sweep_ref

RTOL = 1e-12
COUNTERS = ("n_cold", "n_warm", "n_reject", "lifespan_count", "overflow",
            "sum_cold_resp", "sum_warm_resp")
FLOATS = ("time_running", "time_idle", "time_in_flight", "lifespan_sum")
RELY = ("n_timeout", "n_fail", "n_retry", "n_abandon")


def _jax_base(**kw):
    d = dict(
        arrival_process=jproc.ExpSimProcess(rate=2.0),
        warm_service_process=jproc.ExpSimProcess(rate=1 / 1.991),
        cold_service_process=jproc.ExpSimProcess(rate=1 / 2.244),
        expiration_threshold=20.0,
        sim_time=250.0,
        skip_time=10.0,
        slots=24,
    )
    d.update(kw)
    return JScenario(**d)


def assert_par(port, ref, rtol=RTOL):
    for f in COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(port, f)), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    for f in FLOATS:
        np.testing.assert_allclose(np.asarray(getattr(port, f)), np.asarray(getattr(ref, f)),
                                   rtol=rtol, atol=1e-9, err_msg=f)
    for f in RELY:
        a, b = getattr(port, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)
    assert (port.histogram is None) == (ref.histogram is None)
    if ref.histogram is not None:
        np.testing.assert_allclose(port.histogram, np.asarray(ref.histogram), rtol=rtol,
                                   atol=1e-9)


CASES = {
    "c1": dict(c=1),
    "c3": dict(c=3),
    "c8": dict(c=8, track_histogram=True, hist_bins=6),
    "c3_tight": dict(c=3, max_concurrency=2, expiration_threshold=5.0),
    "c3_hist": dict(c=3, track_histogram=True, hist_bins=5),
    "c3_fail": dict(c=3, reliability=JRely(failure=JFail(p_fail=0.1, t_timeout=3.0))),
    "c3_retries": dict(c=3, max_concurrency=3, reliability=JRely(
        failure=JFail(p_fail=0.2, t_timeout=2.0),
        retry=JRetry(max_retries=2, backoff_jitter=0.5))),
    "c8_nhpp": dict(c=8, arrival_process=None, rate_profile=jproc.SinusoidalRate(
        base=2.0, amplitude=0.7, period=80.0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_par_scan_ref_matches_jax(case):
    kw = dict(CASES[case])
    c = kw.pop("c")
    jscn_ = _jax_base(concurrency_value=c, **kw)
    key = jax.random.key(5)
    R, n = 3, jscn_.steps_needed()
    if jscn_.reliability is not None:
        samples, extras = jsim.draw_reliability_stream(jscn_, key, R, n)
        jsamples = part = (tuple(samples), tuple(extras))
    else:
        jsamples = part = tuple(jsim.draw_workload_samples(jscn_, key, R, n))
    ref = jpar.ParServerlessSimulator(jscn_, c).run(key, replicas=R, samples=jsamples)
    staged = interop.staged_from_reference([part], f64=True)
    pscn = interop.scenario_from_reference(jscn_)
    port = rpar.ParServerlessSimulator(pscn, c, device="cpu").run(0, replicas=R, staged=staged)
    assert_par(port, ref)
    res = rscn.run(pscn, 0, replicas=R, engine="par", device="cpu", backend="scan_ref",
                   staged=staged)
    assert_par(res.summary, ref, rtol=0.0)
    assert np.isfinite(res.summary.avg_instance_occupancy)
    if case == "c3_tight":
        assert ref.n_reject.sum() > 0
    if case == "c3_retries":
        assert ref.n_retry.sum() > 0


def test_par_at_c1_makes_the_pool_scans_decisions():
    jscn_ = _jax_base()
    parts = [tuple(jsim.draw_workload_samples(jscn_, jax.random.key(1), 2,
                                              jscn_.steps_needed()))]
    staged = interop.staged_from_reference(parts, f64=True)
    pscn = interop.scenario_from_reference(jscn_)
    par = rscn.run(pscn, 0, replicas=2, engine="par", device="cpu", backend="scan_ref",
                   staged=staged).summary
    one = rscn.run(pscn, 0, replicas=2, device="cpu", backend="scan_ref", staged=staged).summary
    for f in ("n_cold", "n_warm", "n_reject", "lifespan_count"):
        np.testing.assert_array_equal(getattr(par, f), getattr(one, f))
    # at c = 1 every running instance holds one request
    np.testing.assert_allclose(par.time_in_flight, par.time_running, rtol=1e-12)


def test_par_wrapper_runs_the_plain_version_on_cpu_tensors():
    rng = np.random.default_rng(2)
    R, K = 2, 300
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    args = (f32(rng.exponential(0.5, (R, K))), f32(rng.exponential(2.0, (R, K))),
            f32(rng.exponential(2.5, (R, K))))
    kw = dict(t_exp=10.0, t_end=120.0, skip=5.0, max_concurrency=5, concurrency=4, slots=6,
              hist_bins=4)
    LAUNCH_COUNTS.clear()
    a, b = par_scan_sweep(*args, **kw), par_scan_sweep_ref(*args, **kw)
    assert not LAUNCH_COUNTS["par_scan_sweep"]
    for x, y in zip(a, b):
        if x is not None:
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert a.finish.shape == (R, 6, 4)


def test_par_block_backends_refuse_histograms_and_reliability():
    jbase = _jax_base(concurrency_value=3, track_histogram=True)
    with pytest.raises(ValueError) as ref:
        import repro.core.scenario as jscn
        jscn.run(jbase, jax.random.key(0), replicas=1, engine="par", backend="ref")
    pscn = interop.scenario_from_reference(jbase)
    with pytest.raises(ValueError) as port:
        rscn.run(pscn, 0, replicas=1, engine="par", device="cpu", backend="ref")
    assert str(port.value) == str(ref.value)
    rely = interop.scenario_from_reference(_jax_base(
        concurrency_value=3, reliability=JRely(failure=JFail(p_fail=0.1))))
    with pytest.raises(ValueError, match="scan backend"):
        rscn.run(rely, 0, replicas=1, engine="par", device="cpu", backend="ref")
    s = rscn.run(rely, 0, replicas=2, engine="par", device="cpu", backend="scan_ref").summary
    assert s.n_fail.sum() > 0


@pytest.mark.parametrize("c,hist,rely,retries,prestamped,max_c", [
    (1, 0, False, False, False, 1000),
    (3, 6, False, False, True, 1000),
    (3, 0, True, True, True, 2),  # rejections and retries
    (40, 5, True, False, False, 1000),  # rows split over the lanes on the card
])
def test_par_scan_ref_chunks_continue_one_call(c, hist, rely, retries, prestamped, max_c):
    rng = np.random.default_rng(9)
    R, K, M = 4, 260, 10
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)
    f64 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64)
    gaps = rng.exponential(0.5, (R, K)).astype(np.float32)
    seq = {"arr": f64(np.cumsum(gaps.astype(np.float64), 1)) if prestamped else f32(gaps),
           "warms": f32(rng.exponential(2.0, (R, K))), "colds": f32(rng.exponential(2.5, (R, K)))}
    kw = dict(t_exp=f64(rng.uniform(3.0, 9.0, R)), t_end=f64(rng.uniform(60.0, 110.0, R)),
              skip=f64(rng.uniform(0.0, 10.0, R)), max_concurrency=max_c, concurrency=c,
              slots=M, prestamped=prestamped, hist_bins=hist)
    if rely:
        kw.update(t_timeout=f64(rng.uniform(1.0, 4.0, R)), p_fail=f64(rng.uniform(0, 0.3, R)))
        seq["fail_u"] = f32(rng.uniform(size=(R, K)))
    if retries:
        seq["is_first"] = torch.tensor(rng.uniform(size=(R, K)) < 0.5)
        child = np.where(rng.uniform(size=(R, K)) < 0.8,
                         np.arange(K)[None, :] + 1 + rng.integers(0, 40, (R, K)), 1 << 30)
        seq["child_pos"] = torch.tensor(child.astype(np.int32))
    named = lambda d: {n: v for n, v in d.items() if n not in ("arr", "warms", "colds")}
    whole = par_scan_sweep_ref(seq["arr"], seq["warms"], seq["colds"], **kw, **named(seq))
    assert whole.acc[:, 1].sum() > 0
    floats = [3, 4, 7, 10] + list(range(11 + (4 if rely else 0), whole.acc.shape[1]))
    for cuts in ([37, 101, 101, 200], [1, 32, 64, K]):
        state, lo = None, 0
        for hi in cuts + [K]:
            part = {n: v[:, lo:hi] for n, v in seq.items()}
            state = par_scan_sweep_ref(part["arr"], part["warms"], part["colds"], **kw,
                                       **named(part), state0=state, first_event=lo, events=K,
                                       flush=hi == K)
            lo = hi
        for name, a, b in zip(whole._fields, whole, state):
            if name == "acc":
                exact = [j for j in range(a.shape[1]) if j not in floats]
                torch.testing.assert_close(a[:, exact], b[:, exact], rtol=0, atol=0)
                torch.testing.assert_close(a[:, floats], b[:, floats], rtol=1e-12, atol=1e-12)
            elif a is not None:
                torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
