"""The port's samplers (moments against ``mean()`` and ``with_rate``), the
reference interop (scenario round trip, staged buffers, refusals) and the
package's import hygiene and kernel-build plumbing."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core.processes as jproc
from repro.core import Reliability, RetryPolicy, Scenario as JScenario
from repro.core.faults import FaultModel
from repro_torch import interop
from repro_torch.core import processes as rproc
from repro_torch.kernels import _build

N = 200_000
# relative tolerance on a sample mean of N draws: every family below has
# a coefficient of variation under 1, so 2% is above 8 standard errors
MEAN_RTOL = 0.02

FAMILIES = [
    rproc.ExpSimProcess(rate=2.0),
    rproc.DeterministicSimProcess(interval=0.5),
    rproc.GaussianSimProcess(mu=2.0, sigma=0.3),
    rproc.WeibullSimProcess(shape_k=1.5, scale=2.0),
    rproc.LogNormalSimProcess(mu=0.2, sigma=0.5),
    rproc.ParetoSimProcess(alpha=3.0, x_m=1.0),
]


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("proc", FAMILIES, ids=lambda p: type(p).__name__)
def test_sample_moments_and_with_rate(proc):
    x = proc.sample(_gen(0), (4, N // 4), "cpu")
    assert x.dtype == torch.float32 and x.shape == (4, N // 4)
    assert float(x.min()) >= rproc._EPS
    np.testing.assert_allclose(float(x.double().mean()), proc.mean(), rtol=MEAN_RTOL)
    rated = proc.with_rate(0.25)
    assert type(rated) is type(proc)
    np.testing.assert_allclose(rated.mean(), 4.0, rtol=1e-12)
    y = rated.sample(_gen(1), (N,), "cpu")
    np.testing.assert_allclose(float(y.double().mean()), 4.0, rtol=MEAN_RTOL)


@pytest.mark.parametrize("proc", FAMILIES[:1] + FAMILIES[3:], ids=lambda p: type(p).__name__)
def test_sampling_is_seeded(proc):
    a = proc.sample(_gen(3), (64,), "cpu")
    out = torch.empty(64)
    proc.sample_into(out, _gen(3))
    assert torch.equal(a, out)
    assert not torch.equal(a, proc.sample(_gen(4), (64,), "cpu"))
    with pytest.raises(ValueError, match="f32"):
        proc.sample_into(torch.empty(4, dtype=torch.float64), _gen(3))


def _jax_scenario(**kw):
    d = dict(
        arrival_process=jproc.WeibullSimProcess(shape_k=1.5, scale=2.0),
        warm_service_process=jproc.LogNormalSimProcess(mu=0.2, sigma=0.5),
        cold_service_process=jproc.ParetoSimProcess(alpha=3.0, x_m=1.0),
        expiration_threshold=120.0,
        max_concurrency=40,
        sim_time=5e3,
        skip_time=50.0,
        slots=48,
    )
    d.update(kw)
    return JScenario(**d)


def test_scenario_round_trips_from_reference():
    ref = _jax_scenario(arrival_rate=0.7)
    port = interop.scenario_from_reference(ref)
    assert type(port.arrival_process).__name__ == "WeibullSimProcess"
    np.testing.assert_allclose(port.arrival_process.mean(), 1 / 0.7, rtol=1e-12)
    back = {}
    for f in dataclasses.fields(port):
        v = getattr(port, f.name)
        if isinstance(v, rproc.SimProcess):
            v = getattr(jproc, type(v).__name__)(**dataclasses.asdict(v))
        elif f.name == "billing":
            v = type(ref.billing)(**dataclasses.asdict(v))
        back[f.name] = v
    assert JScenario(**back) == ref
    assert port.steps_needed() == ref.steps_needed()


REFERENCE_FAMILIES = [
    jproc.GammaSimProcess(shape_k=2.0, scale=1.0),
    jproc.BatchArrivalProcess(base=jproc.ExpSimProcess(rate=1.0), batch_size=2),
    jproc.NHPPArrivalProcess(profile=jproc.PiecewiseConstantRate(
        edges=(100.0,), rates=(0.5, 1.0))),
    jproc.NHPPArrivalProcess(profile=jproc.SinusoidalRate(base=0.9, amplitude=0.5,
                                                          period=600.0, phase=0.2)),
    jproc.MMPPArrivalProcess(rate_low=0.3, rate_high=3.0, switch_rate=0.01),
    jproc.TraceArrivalProcess(timestamps=(0.5, 1.0, 1.0, 2.5, 4.0)),
    jproc.EmpiricalSimProcess(durations=(0.5, 1.5, 2.0)),
]


@pytest.mark.parametrize("process", REFERENCE_FAMILIES[:3], ids=lambda p: type(p).__name__)
def test_unported_families_name_their_roadmap_item(process):
    # each family converts from the reference and matches it, nested
    # fields (Batch's base, NHPP's profile) included
    scn = interop.scenario_from_reference(_jax_scenario(arrival_process=process))
    _assert_same_process(scn.arrival_process, process)


def _assert_same_process(port, ref):
    assert type(port).__name__ == type(ref).__name__
    assert type(port).__module__ == "repro_torch.core.processes"
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _assert_same_process(a, b)
        elif isinstance(a, tuple):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b, np.float64))
        else:
            assert a == b and type(a) is type(b) or float(a) == float(b)
    if isinstance(port, rproc.SimProcess):
        assert port.mean() == pytest.approx(ref.mean(), rel=1e-12)
    else:
        assert port.max_rate() == ref.max_rate()


@pytest.mark.parametrize("process", REFERENCE_FAMILIES, ids=lambda p: type(p).__name__)
def test_every_family_converts_from_the_reference(process):
    port = interop.process_from_reference(process)
    _assert_same_process(port, process)
    assert isinstance(port, rproc.ArrivalTimeProcess) == isinstance(
        process, jproc.ArrivalTimeProcess)


def test_scenario_refuses_unported_family():
    from repro_torch.core.scenario import Scenario

    # a reference process handed to the port is refused, pointing at interop
    with pytest.raises(TypeError, match="scenario_from_reference"):
        Scenario(
            arrival_process=jproc.GammaSimProcess(shape_k=2.0, scale=1.0),
            warm_service_process=rproc.ExpSimProcess(rate=1.0),
            cold_service_process=rproc.ExpSimProcess(rate=1.0),
        )
    with pytest.raises(TypeError, match="scenario_from_reference"):
        Scenario(
            arrival_process=jproc.ExpSimProcess(rate=1.0),
            warm_service_process=rproc.ExpSimProcess(rate=1.0),
            cold_service_process=rproc.ExpSimProcess(rate=1.0),
        )
    with pytest.raises(TypeError, match="scenario_from_reference"):
        Scenario(
            rate_profile=jproc.SinusoidalRate(base=1.0, amplitude=0.5, period=10.0),
            warm_service_process=rproc.ExpSimProcess(rate=1.0),
            cold_service_process=rproc.ExpSimProcess(rate=1.0),
        )


def test_reference_custom_process_is_refused():
    custom = jproc.CustomSimProcess(fn=lambda key, shape: None, mean_value=1.0)
    with pytest.raises(TypeError, match="fn\\(generator, shape, device\\)"):
        interop.process_from_reference(custom)
    with pytest.raises(TypeError, match="CustomSimProcess"):
        interop.scenario_from_reference(_jax_scenario(warm_service_process=custom))


def test_rate_profile_scenario_round_trips_from_reference():
    prof = jproc.PiecewiseConstantRate.fit(
        np.sort(np.random.default_rng(0).uniform(0, 3000.0, 400)), bin_width=600.0)
    ref = JScenario(rate_profile=prof, warm_service_process=jproc.ExpSimProcess(rate=1.0),
                    cold_service_process=jproc.ExpSimProcess(rate=0.5), sim_time=2000.0)
    port = interop.scenario_from_reference(ref)
    assert port.prestamped and ref.prestamped
    _assert_same_process(port.arrival_process, ref.arrival_process)
    assert port.rate_profile == port.arrival_process.profile
    assert port.steps_needed() == ref.steps_needed()


def test_reference_reliability_is_refused():
    # the reference's policies and fault model are carried across; a policy
    # that is not a Reliability is refused
    rel = Reliability(retry=RetryPolicy(max_retries=2, backoff_base=0.5))
    scn = interop.scenario_from_reference(_jax_scenario(reliability=rel))
    assert scn.reliability.retry.max_retries == 2
    assert scn.reliability.retry.backoff_base == 0.5
    with pytest.raises(TypeError, match="Reliability"):
        interop.reliability_from_reference(rel.retry)
    scn = interop.scenario_from_reference(_jax_scenario(faults=FaultModel(crash_rate=0.1)))
    assert type(scn.faults).__module__ == "repro_torch.core.faults"
    assert scn.faults.crash_rate == 0.1 and scn.faults.capacity is None


def test_staged_from_reference_concatenates_draw_cells():
    rng = np.random.default_rng(0)
    parts = [tuple(rng.random((3, 7)) for _ in range(3)) for _ in range(2)]
    dts, warms, colds = interop.staged_from_reference(parts)
    assert dts.shape == (6, 7) and dts.dtype == torch.float32
    np.testing.assert_array_equal(colds[3:].numpy(), parts[1][2].astype(np.float32))
    with pytest.raises(ValueError):
        interop.staged_from_reference([])


def test_port_imports_no_jax():
    code = (
        "import sys, repro_torch, repro_torch.interop, repro_torch.kernels.ref, "
        "repro_torch.kernels.faas_event_step, repro_torch.kernels.par_event_step, "
        "repro_torch.kernels._build, repro_torch.core.temporal, "
        "repro_torch.core.par_simulator, repro_torch.core.reliability, "
        "repro_torch.core.metrics, repro_torch.core.cost, repro_torch.core.analytical, "
        "repro_torch.core.processes, repro_torch.data.workload\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_build_names_missing_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


@pytest.mark.parametrize("name", ["faas_event_step", "par_event_step"])
def test_build_target_tracks_sources_and_flags(monkeypatch, name):
    a = _build._target(name)
    assert a.parent == _build.build_dir() and a.name.startswith(f"{name}-")
    assert (_build.CSRC / f"{name}.cu").is_file()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._target(name) != a


# ---------------------------------------------------------------------------
# Gamma, batch, custom and empirical samplers against their closed forms
# ---------------------------------------------------------------------------

N_KS = 100_000
KS_PVALUE = 1e-3  # seeded draws: a fixed p-value, far from this floor


@pytest.mark.parametrize("k", [0.5, 2.0])
def test_gamma_matches_closed_form(k):
    from scipy import stats

    proc = rproc.GammaSimProcess(shape_k=k, scale=1.5)
    x = proc.sample(_gen(5), (4, N_KS // 4), "cpu").double().numpy().ravel()
    n = x.size
    mean, var = k * 1.5, k * 1.5**2
    assert abs(x.mean() - mean) <= 4 * np.sqrt(var / n)
    # the sample variance's standard error: sqrt((mu4 - var^2) / n), mu4 = 3k(k+2) scale^4
    mu4 = 3 * k * (k + 2) * 1.5**4
    assert abs(x.var() - var) <= 4 * np.sqrt((mu4 - var**2) / n)
    assert stats.kstest(x, stats.gamma(k, scale=1.5).cdf).pvalue > KS_PVALUE
    assert proc.mean() == mean
    np.testing.assert_allclose(proc.with_rate(0.5).mean(), 2.0, rtol=1e-12)
    a = proc.sample(_gen(6), (300,), "cpu")
    assert torch.equal(a, proc.sample(_gen(6), (300,), "cpu"))
    assert float(a.min()) >= rproc._EPS


def test_gamma_rejection_rounds_cover_every_entry():
    out = torch.full((7, 33), -1.0)
    rproc.standard_gamma_(out, 0.3, _gen(1))
    assert bool((out >= 0).all()) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="shape must be > 0"):
        rproc.standard_gamma_(out, 0.0, _gen(1))


def test_batch_arrivals_zero_gaps_inside_a_batch():
    proc = rproc.BatchArrivalProcess(base=rproc.ExpSimProcess(rate=0.5), batch_size=3)
    x = proc.sample(_gen(2), (4, 30_001), "cpu")
    flat = x.numpy().ravel()
    heads = np.arange(flat.size) % 3 == 0  # the flattened buffer's batch heads
    assert (flat[~heads] == 0.0).all() and (flat[heads] >= rproc._EPS).all()
    n = heads.sum()
    assert abs(flat[heads].mean() - 2.0) <= 4 * 2.0 / np.sqrt(n)
    assert proc.mean() == pytest.approx(2.0 / 3)
    rated = proc.with_rate(3.0)
    assert type(rated.base) is rproc.ExpSimProcess and rated.mean() == pytest.approx(1 / 3)
    # the same layout as the reference's batch sampler
    ref = jproc.BatchArrivalProcess(base=jproc.ExpSimProcess(rate=0.5), batch_size=3)
    rx = np.asarray(ref.sample(__import__("jax").random.key(0), (4, 31)))
    np.testing.assert_array_equal(rx == 0, proc.sample(_gen(3), (4, 31), "cpu").numpy() == 0)
    # a batch nested in a batch: zeros where the reference has them, and a
    # head of the outer one on an inner zero clamped to _EPS as there
    nested = rproc.BatchArrivalProcess(base=rproc.BatchArrivalProcess(
        base=rproc.ExpSimProcess(rate=0.5), batch_size=2), batch_size=3)
    rnested = jproc.BatchArrivalProcess(base=jproc.BatchArrivalProcess(
        base=jproc.ExpSimProcess(rate=0.5), batch_size=2), batch_size=3)
    y = nested.sample(_gen(3), (4, 31), "cpu").numpy()
    ry = np.asarray(rnested.sample(__import__("jax").random.key(0), (4, 31)))
    np.testing.assert_array_equal(ry == 0, y == 0)
    np.testing.assert_array_equal(ry == np.float32(rproc._EPS), y == np.float32(rproc._EPS))


def test_custom_process_draws_from_its_generator():
    def fn(generator, shape, device):
        return torch.rand(shape, generator=generator, device=device) * 2.0 - 0.5

    proc = rproc.CustomSimProcess(fn=fn, mean_value=0.5)
    x = proc.sample(_gen(4), (2, 50), "cpu")
    raw = fn(_gen(4), (2, 50), "cpu")
    assert torch.equal(x, raw.clamp_min(rproc._EPS))
    assert proc.mean() == 0.5 and hash(proc) == hash(proc)


def test_empirical_resamples_the_durations():
    d = (0.5, 1.5, 2.0, 8.0)
    proc = rproc.EmpiricalSimProcess(durations=d)
    x = proc.sample(_gen(7), (N_KS,), "cpu").numpy()
    vals, counts = np.unique(x, return_counts=True)
    np.testing.assert_array_equal(vals, np.asarray(d, np.float32))
    # each value's share within 4 standard errors of 1/4
    assert (np.abs(counts / N_KS - 0.25) <= 4 * np.sqrt(0.25 * 0.75 / N_KS)).all()
    assert proc.mean() == 3.0
    rated = proc.with_rate(1.0)
    np.testing.assert_allclose(rated.mean(), 1.0, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(rated.durations) / np.asarray(d), 1 / 3, rtol=1e-12)
    with pytest.raises(ValueError, match="positive and non-empty"):
        rproc.EmpiricalSimProcess(durations=())
    with pytest.raises(ValueError, match="positive and non-empty"):
        rproc.EmpiricalSimProcess(durations=(1.0, -1.0))
