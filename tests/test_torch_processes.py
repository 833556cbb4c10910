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


@pytest.mark.parametrize(
    "process",
    [
        jproc.GammaSimProcess(shape_k=2.0, scale=1.0),
        jproc.BatchArrivalProcess(base=jproc.ExpSimProcess(rate=1.0), batch_size=2),
        jproc.NHPPArrivalProcess(profile=jproc.PiecewiseConstantRate(
            edges=(100.0,), rates=(0.5, 1.0))),
    ],
    ids=lambda p: type(p).__name__,
)
def test_unported_families_name_their_roadmap_item(process):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item 3"):
        interop.scenario_from_reference(_jax_scenario(arrival_process=process))


def test_scenario_refuses_unported_family():
    from repro_torch.core.scenario import Scenario

    with pytest.raises(NotImplementedError, match="Queue A item 3"):
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
        "repro_torch.core.metrics, repro_torch.core.cost\n"
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
