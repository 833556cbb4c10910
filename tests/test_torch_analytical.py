"""The port's ``run()`` (its plain versions, on the CPU) against closed
forms, as ``tests/test_analytical.py`` holds the reference's engines:
Little's law, M/G/inf insensitivity across Gamma, log-normal and Pareto
service, the Erlang-B loss limit, the light-traffic cold-start limit, the
deterministic regimes and the wasted-capacity bound; and the port's copy
of ``analytical.py`` against the reference's."""

import math

import numpy as np
import pytest

from repro.core import analytical as jana
from repro_torch.core import analytical as ana
from repro_torch.core import processes as rproc
from repro_torch.core.scenario import Scenario, run


def _run(cfg, seed=0, replicas=4):
    return run(cfg, seed, replicas=replicas, device="cpu", backend="ref").summary


def base_cfg(**kw):
    d = dict(
        arrival_process=rproc.ExpSimProcess(rate=1.0),
        warm_service_process=rproc.ExpSimProcess(rate=0.5),
        cold_service_process=rproc.ExpSimProcess(rate=0.45),
        expiration_threshold=30.0,
        sim_time=4000.0,
        skip_time=100.0,
        slots=64,
    )
    d.update(kw)
    return Scenario(**d)


def test_littles_law_running_count():
    s = _run(base_cfg())
    # cold starts are rare here: E[S] is about the warm mean
    np.testing.assert_allclose(s.avg_running_count, ana.littles_law_running(1.0, 2.0), rtol=0.05)


# service families of mean 2.0 s (cold ones 10% slower), from light to
# heavy tails: M/G/inf's running count depends on the mean alone
SERVICES = {
    "gamma_k0.5": rproc.GammaSimProcess(shape_k=0.5, scale=4.0),
    "gamma_k4": rproc.GammaSimProcess(shape_k=4.0, scale=0.5),
    "lognormal": rproc.LogNormalSimProcess(mu=math.log(2.0) - 0.32, sigma=0.8),
    "pareto": rproc.ParetoSimProcess(alpha=3.0, x_m=4.0 / 3.0),
    "deterministic": rproc.DeterministicSimProcess(interval=2.0),
}


@pytest.mark.parametrize("name", list(SERVICES))
def test_mginf_insensitivity(name):
    warm = SERVICES[name]
    assert warm.mean() == pytest.approx(2.0, rel=1e-12)
    cfg = base_cfg(warm_service_process=warm, cold_service_process=warm.with_rate(1 / 2.2),
                   sim_time=2000.0)
    s = _run(cfg, seed=1, replicas=8)
    np.testing.assert_allclose(s.avg_running_count, ana.littles_law_running(1.0, 2.0),
                               rtol=0.06)


@pytest.mark.parametrize("service", ["exp", "gamma"])
def test_erlang_b_loss_limit(service):
    """T_exp -> 0 with m instances: an M/G/m/m loss system, rejection =
    Erlang-B, whatever the service distribution."""
    m = 3
    svc = (rproc.ExpSimProcess(rate=0.5) if service == "exp"
           else rproc.GammaSimProcess(shape_k=2.0, scale=1.0))
    cfg = base_cfg(
        expiration_threshold=1e-6,
        max_concurrency=m,
        slots=m,
        sim_time=4000.0,
        warm_service_process=svc,
        cold_service_process=svc,  # = warm: a pure loss system
    )
    s = _run(cfg, replicas=8)
    np.testing.assert_allclose(s.rejection_prob, ana.erlang_b(2.0, m), rtol=0.08)


def test_light_traffic_cold_prob():
    """lambda * T_exp small: p_cold = exp(-lambda T_exp) (single-instance renewal)."""
    cfg = base_cfg(
        arrival_process=rproc.ExpSimProcess(rate=0.05),
        warm_service_process=rproc.ExpSimProcess(rate=2.0),
        cold_service_process=rproc.ExpSimProcess(rate=1.8),
        expiration_threshold=10.0,
        sim_time=60000.0,
    )
    s = _run(cfg, replicas=8)
    np.testing.assert_allclose(s.cold_start_prob,
                               ana.single_instance_renewal_cold_prob(0.05, 10.0), rtol=0.12)


@pytest.mark.parametrize("interval,t_exp,service", [(10.0, 3.0, 2.0), (4.0, 3.0, 2.0),
                                                    (1.0, 3.0, 2.5)])
def test_deterministic_regimes(interval, t_exp, service):
    """D/D/inf: every arrival cold past s + T_exp, else only the first
    ceil(s/d) instances' starts."""
    det = rproc.DeterministicSimProcess
    cfg = base_cfg(arrival_process=det(interval=interval),
                   warm_service_process=det(interval=service),
                   cold_service_process=det(interval=service), expiration_threshold=t_exp,
                   sim_time=2000.0, skip_time=0.0)
    s = _run(cfg, replicas=2)
    expected = ana.deterministic_cold_start_prob(interval, t_exp, service)
    if expected == 1.0:
        assert s.cold_start_prob == 1.0
    else:
        # the first ceil(s/d) arrivals start instances, then none
        first = math.ceil(service / interval)
        assert s.n_cold.tolist() == [first] * 2
        assert s.cold_start_prob == pytest.approx(0.0, abs=first / s.n_requests.min())


@pytest.mark.parametrize("seed", [0, 1])
def test_cold_prob_monotone_in_threshold(seed):
    probs = [_run(base_cfg(expiration_threshold=t, sim_time=3000.0), seed=seed).cold_start_prob
             for t in (2.0, 10.0, 60.0)]
    assert probs[0] >= probs[1] - 0.02
    assert probs[1] >= probs[2] - 0.02


def test_wasted_ratio_below_the_bound():
    s = _run(base_cfg(arrival_process=rproc.ExpSimProcess(rate=0.2)))
    assert 0.0 < s.avg_wasted_ratio <= ana.utilization_bound(0.2, 2.0, 30.0)


def test_nhpp_littles_law_over_whole_periods():
    """Under a sinusoidal NHPP over whole periods, the running count's time
    average is the mean rate (``base``) times E[S]."""
    cfg = base_cfg(arrival_process=None,
                   rate_profile=rproc.SinusoidalRate(base=1.0, amplitude=0.8, period=1000.0),
                   sim_time=2000.0, skip_time=0.0)
    s = _run(cfg, seed=3, replicas=8)
    np.testing.assert_allclose(s.avg_running_count, ana.littles_law_running(1.0, 2.0),
                               rtol=0.05)


@pytest.mark.parametrize(
    "fn,args",
    [
        ("littles_law_running", (0.9, 1.991)),
        ("mginf_busy_distribution", (0.9, 2.0, 3)),
        ("deterministic_cold_start_prob", (4.0, 3.0, 2.0)),
        ("single_instance_renewal_cold_prob", (0.05, 10.0)),
        ("erlang_b", (2.0, 3)),
        ("erlang_b", (12.5, 20)),
        ("utilization_bound", (0.9, 2.0, 600.0)),
    ],
)
def test_closed_forms_equal_the_reference(fn, args):
    assert getattr(ana, fn)(*args) == getattr(jana, fn)(*args)


def test_erlang_b_and_mginf_values():
    np.testing.assert_allclose(ana.erlang_b(2.0, 3), 0.21052631578, rtol=1e-9)
    pk = [ana.mginf_busy_distribution(1.5, 2.0, k) for k in range(40)]
    np.testing.assert_allclose(sum(pk), 1.0, rtol=1e-12)
    np.testing.assert_allclose(sum(k * p for k, p in enumerate(pk)), 3.0, rtol=1e-12)
