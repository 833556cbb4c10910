"""The port's serving path against the JAX reference: the platform, the
workload generator, the keep-alive planner and the launcher.

The platform and the generator are numpy code in both packages: on the same
requests and service-time functions they must agree exactly.  The planners
draw their workloads differently (torch generators against ``jax.random``),
so they must pick the same threshold for SLOs that lie away from the
boundaries between candidates, and their predicted cold-start probability
must agree within ``SIGMAS`` binomial standard errors of the difference of
two independent estimates over the requests a cell simulates.
"""

import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.core.execution import Execution
from repro.data import workload as jwork
from repro.serving import platform as jplat
from repro.serving import autoscale as jauto
from repro.serving.autoscale import plan_expiration_threshold as jplan
from repro_torch.core.execution import Execution as PortExecution
from repro_torch.data import workload as pwork
from repro_torch.launch import serve
from repro_torch.serving import autoscale as pauto
from repro_torch.serving import platform as pplat
from repro_torch.serving.autoscale import (
    FleetPlan,
    PlanResult,
    ThresholdGovernor,
    plan_expiration_threshold,
    plan_fleet_thresholds,
    select_threshold,
)

SIGMAS = 5.0


def _service_fns(seed):
    """Service times as a function of the request alone, so that both
    platforms see the same times whatever order they ask in."""
    def draw(kind):
        return lambda r: float(np.random.default_rng([seed, kind, r.request_id]).exponential(
            3.0 if kind else 1.0))
    return draw(1), draw(0)


@pytest.mark.parametrize("t_exp,max_conc", [(20.0, 1000), (5.0, 2), (200.0, 3)])
def test_platform_matches_jax(t_exp, max_conc):
    horizon = 3000.0
    cold, warm = _service_fns(11)
    reqs = list(pwork.poisson_arrivals(0.7, horizon, seed=3))
    jreqs = [jwork.Request(r.arrival_time, r.request_id) for r in reqs]
    obs = pplat.ServerlessPlatform(cold, warm, expiration_threshold=t_exp,
                                   max_concurrency=max_conc).run(reqs, horizon)
    ref = jplat.ServerlessPlatform(cold, warm, expiration_threshold=t_exp,
                                   max_concurrency=max_conc).run(jreqs, horizon)
    assert [dataclasses.astuple(r) for r in obs.records] == [
        dataclasses.astuple(r) for r in ref.records]
    for f in ("instance_seconds_running", "instance_seconds_idle", "replicas_created",
              "cold_start_prob", "rejection_prob", "avg_response_time",
              "avg_running_replicas", "avg_total_replicas", "wasted_ratio"):
        assert getattr(obs, f) == getattr(ref, f), f
    if max_conc == 2:
        assert obs.rejection_prob > 0


def test_platform_reaps_replica_objects():
    made = []
    plat = pplat.ServerlessPlatform(lambda r: 1.0, lambda r: 1.0, expiration_threshold=5.0,
                                    replica_factory=lambda: made.append(1) or object())
    reqs = [pwork.Request(t, i) for i, t in enumerate([1.0, 2.5, 100.0])]
    m = plat.run(reqs, 200.0)
    assert m.replicas_created == 2 and len(made) == 2
    assert [r.cold for r in m.records] == [True, False, True]
    assert len(plat._live_objects) == 1  # the first replica was reaped


@pytest.mark.parametrize("rate,horizon,seed", [(0.2, 2000.0, 0), (3.0, 500.0, 7)])
def test_poisson_arrivals_match_jax(rate, horizon, seed):
    p = [(r.arrival_time, r.request_id) for r in pwork.poisson_arrivals(rate, horizon, seed)]
    j = [(r.arrival_time, r.request_id) for r in jwork.poisson_arrivals(rate, horizon, seed)]
    assert p == j and len(p) > 10


# (generator name, arguments before the horizon, horizon, keyword seed or None)
NON_POISSON = [
    ("deterministic_arrivals", (0.7,), 300.0, None),
    ("deterministic_arrivals", (13.0,), 2000.0, None),
    ("batch_arrivals", (0.2, 3), 2000.0, 0),
    ("batch_arrivals", (3.0, 5), 500.0, 7),
    ("mmpp_arrivals", (0.3, 3.0, 1 / 60), 2000.0, 0),
    ("mmpp_arrivals", (0.05, 1.0, 1 / 200), 5000.0, 7),
]


@pytest.mark.parametrize("name,args,horizon,seed", NON_POISSON)
def test_non_poisson_arrivals_match_jax(name, args, horizon, seed):
    kw = {} if seed is None else {"seed": seed}
    p = [(r.arrival_time, r.request_id)
         for r in getattr(pwork, name)(*args, horizon, **kw)]
    j = [(r.arrival_time, r.request_id)
         for r in getattr(jwork, name)(*args, horizon, **kw)]
    assert p == j and len(p) > 10
    assert all(a[0] <= b[0] <= horizon for a, b in zip(p, p[1:]))


# rate 0.05/s, warm 2 s, cold 5 s over 2e4 s: the JAX reference predicts
# cold-start probabilities 0.28, 0.12, 0.057, 0.028, 0.010, 0.005 at the
# candidates 30 ... 1200 s; each SLO below lies between two of them
PLAN = dict(arrival_rate=0.05, warm_time=2.0, cold_time=5.0, sim_time=2e4, replicas=8)


@pytest.mark.parametrize("slo,expected", [(0.2, 60.0), (0.08, 120.0), (0.04, 300.0)])
def test_planner_matches_jax(slo, expected):
    plan = plan_expiration_threshold(cold_slo=slo, device="cpu",
                                     execution=PortExecution(backend="ref"), **PLAN)
    ref = jplan(cold_slo=slo, execution=Execution(backend="ref"), **PLAN)
    assert isinstance(plan, PlanResult)
    assert plan.expiration_threshold == ref.expiration_threshold == expected
    n = PLAN["arrival_rate"] * PLAN["sim_time"] * PLAN["replicas"]
    p = ref.predicted_cold_prob
    tol = SIGMAS * math.sqrt(2 * p * (1 - p) / n)
    assert abs(plan.predicted_cold_prob - p) <= tol
    assert plan.predicted_cold_prob <= slo
    assert plan.predicted_goodput is None and plan.predicted_cost > 0
    assert 0 < plan.predicted_wasted_ratio < 1 and plan.predicted_avg_replicas > 0


def test_select_threshold_takes_the_largest_when_none_meets():
    class Grid:
        cold_start_prob = np.array([0.5, 0.4])
        def axis(self, name):
            return (10.0, 20.0)
        def sel(self, expiration_threshold):
            return dataclasses.make_dataclass("Cell", [
                "cold_start_prob", "avg_server_count", "wasted_ratio", "goodput",
                "developer_cost"])(0.4, 2.0, 0.5, 1.0, 3.0)
    assert select_threshold(Grid(), 0.1).expiration_threshold == 20.0


def test_planner_reliability_raises():
    # a failure model is planned under now (tests/test_torch_reliability.py);
    # what is not a Reliability is refused
    with pytest.raises(ValueError, match="must be a Reliability"):
        plan_expiration_threshold(0.1, 1.0, 2.0, 0.05, device="cpu", reliability=object())


def test_serve_main_runs_on_cpu(capsys):
    plan, obs = serve.main(["--device", "cpu", "--width", "smoke", "--horizon", "1500",
                            "--rate", "0.3", "--prompt-len", "12", "--new-tokens", "4",
                            "--batch", "2"])
    out = capsys.readouterr().out
    assert "[serve] cold" in out and "[serve] threshold" in out and "[serve] observed" in out
    assert plan.expiration_threshold in (30.0, 60.0, 120.0, 300.0, 600.0, 1200.0)
    assert len(obs.records) > 100 and 0 <= obs.cold_start_prob <= 1


def test_serving_modules_import_no_jax():
    code = (
        "import sys, repro_torch.launch.serve, repro_torch.serving.engine, "
        "repro_torch.serving.platform, repro_torch.serving.autoscale, "
        "repro_torch.data.workload, repro_torch.kernels.ops, "
        "repro_torch.kernels.flash_attention, repro_torch.kernels.decode_attention, "
        "repro_torch.kernels.ssd_scan, repro_torch.kernels.rglru_scan, "
        "repro_torch.models.ssm, repro_torch.models.rglru, repro_torch.models.scans, "
        "repro_torch.models.model, repro_torch.configs, repro_torch.interop, "
        "repro_torch.core.reliability, repro_torch.core.metrics, repro_torch.serving, "
        "repro_torch.serving.online, repro_torch.core.whatif\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# ---------------------------------------------------------------------------
# the threshold governor and the fleet planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("patience, deadband", [(1, 0.0), (2, 0.0), (3, 0.0), (2, 0.5),
                                                (1, 0.3), (4, 1.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_governor_matches_reference(patience, deadband, seed):
    """numpy-seeded proposal streams with runs and flips: the same applied
    sequence and the same hysteresis state after every update."""
    rng = np.random.default_rng(seed)
    values = np.array([30.0, 60.0, 120.0, 300.0, 600.0, 1200.0])
    runs = rng.integers(1, 5, 40)
    proposals = np.repeat(rng.choice(values, len(runs)), runs)
    port, ref = ThresholdGovernor(patience, deadband), jauto.ThresholdGovernor(patience, deadband)
    for x in proposals:
        assert port.update(x) == ref.update(x)
        assert (port.applied, port._candidate, port._streak) == (
            ref.applied, ref._candidate, ref._streak)


@pytest.mark.parametrize("kw", [dict(patience=0), dict(deadband=-0.1)])
def test_governor_validation_matches_reference(kw):
    with pytest.raises(ValueError) as port:
        ThresholdGovernor(**kw)
    with pytest.raises(ValueError) as ref:
        jauto.ThresholdGovernor(**kw)
    assert str(port.value) == str(ref.value)


def test_governor_patience_and_deadband():
    g = ThresholdGovernor(patience=2)
    assert [g.update(x) for x in (60.0, 120.0, 60.0, 120.0, 120.0)] == [60.0] * 4 + [120.0]
    g = ThresholdGovernor(patience=1, deadband=0.5)
    assert [g.update(x) for x in (100.0, 120.0, 200.0)] == [100.0, 100.0, 200.0]


GREEDY_NAMES = ["thumbnail", "crypto-sign", "ml-inference"]
GREEDY_THRESHOLDS = (30.0, 60.0, 120.0, 300.0)
# per function (cold-start probability, average replicas, wasted ratio) on
# GREEDY_THRESHOLDS; the SLO 0.03 picks indices 3, 3, 2 at stage 1 (total 12.5)
GREEDY_TABLES = [
    ([0.2, 0.1, 0.05, 0.01], [1.0, 2.0, 3.0, 5.0], [0.1, 0.2, 0.3, 0.4]),
    ([0.3, 0.2, 0.04, 0.02], [2.0, 2.5, 4.0, 6.0], [0.2, 0.3, 0.4, 0.5]),
    ([0.1, 0.05, 0.03, 0.01], [1.0, 1.5, 1.5, 1.5], [0.3, 0.4, 0.5, 0.6]),
]


def _stub_sweep(calls):
    import types

    def stub(*args, **kw):
        cold, avg, wasted = GREEDY_TABLES[len(calls)]
        calls.append(kw)
        return types.SimpleNamespace(cold_start_prob=np.array(cold),
                                     avg_server_count=np.array(avg),
                                     wasted_ratio=np.array(wasted))

    return stub


@pytest.mark.parametrize("n_cluster, feasible, lateral", [
    (20.0, True, False),  # fits at stage 1
    (9.0, True, False),  # greedy steps down
    (4.2, True, True),  # a lateral step before the last saving one
    (2.0, False, True),  # every function at the floor: infeasible
])
def test_fleet_greedy_matches_reference(monkeypatch, n_cluster, feasible, lateral):
    """Both planners on the same per-function tables (each module's sweep
    replaced by a stub grid): the same thresholds, feasibility, total and
    headroom."""
    from repro.data.catalog import fleet_of as j_fleet_of
    from repro_torch.data.catalog import fleet_of

    port_calls, ref_calls = [], []
    monkeypatch.setattr(pauto, "scenario_sweep", _stub_sweep(port_calls))
    monkeypatch.setattr(jauto, "scenario_sweep", _stub_sweep(ref_calls))
    port = plan_fleet_thresholds(fleet_of(GREEDY_NAMES, n_cluster=n_cluster), 0.03,
                                 candidate_thresholds=GREEDY_THRESHOLDS, device="cpu")
    ref = jauto.plan_fleet_thresholds(j_fleet_of(GREEDY_NAMES, n_cluster=n_cluster), 0.03,
                                      candidate_thresholds=GREEDY_THRESHOLDS)
    assert len(port_calls) == len(ref_calls) == 3
    assert isinstance(port, FleetPlan)
    assert port.thresholds == ref.thresholds
    assert port.feasible == ref.feasible == feasible
    assert port.predicted_total_replicas == ref.predicted_total_replicas
    assert port.cluster_headroom == ref.cluster_headroom == n_cluster - port.predicted_total_replicas
    assert port.n_cluster == ref.n_cluster
    for name in GREEDY_NAMES:
        assert dataclasses.asdict(port.plans[name]) == dataclasses.asdict(ref.plans[name])
    # the lateral branch ran where the third function left index 2 for a
    # step that freed nothing
    assert (port.thresholds["ml-inference"] < 120.0) == lateral
    seeds = [c["seed"] for c in port_calls]
    kids = np.random.SeedSequence(0).spawn(3)
    assert seeds == [pauto.child_seed(k) for k in kids] and len(set(seeds)) == 3


def test_fleet_plan_on_the_cpu():
    from repro_torch.data.catalog import fleet_of

    fleet = fleet_of(["thumbnail", "crypto-sign"], n_cluster=3.0, slots=16)
    plan = plan_fleet_thresholds(fleet, 0.01, candidate_thresholds=(30.0, 300.0),
                                 sim_time=400.0, replicas=2, device="cpu")
    assert set(plan.thresholds) == {"thumbnail", "crypto-sign"}
    assert plan.predicted_total_replicas == pytest.approx(
        sum(p.predicted_avg_replicas for p in plan.plans.values()))
    assert plan.feasible == (plan.predicted_total_replicas <= 3.0)
    again = plan_fleet_thresholds(fleet, 0.01, candidate_thresholds=(300.0, 30.0),
                                  sim_time=400.0, replicas=2, device="cpu")
    assert again == plan  # the candidates are sorted first
