"""The port's platform-fault layer against the reference: ``FaultModel`` and
``CapacityProfile`` validation, the plain ``faas_sweep_ref`` with crashes
and capacity churn (alone, with reliability and with retries) against the
JAX mirror and the Pallas kernel in interpret mode on the same numpy
buffers, the eviction tie rule and non-integer ceilings, crashes past the
horizon, interrupted attempts that trigger their retry, ``run()``/
``sweep()`` on the reference's own buffers against the JAX ``backend="ref"``
front door, the inert model, the crash stream beside the others,
conservation, the capability errors and ``reliability_report``'s fault
block.  The CUDA kernel is held against the plain version in
``test_torch_cuda.py``."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ExpSimProcess, Scenario as JScenario
from repro.core import faults as jfaults
from repro.core import reliability as jrel
from repro.core import scenario as jscn
from repro.core.metrics import reliability_report as j_reliability_report
from repro.core.simulator import draw_crash_uniforms as j_draw_crash
from repro.core.simulator import draw_reliability_stream as j_draw_rely
from repro.core.simulator import draw_workload_samples as j_draw_workload
from repro.kernels import ref as jref
from repro.kernels.faas_event_step import faas_sweep_pallas
from repro_torch import interop
from repro_torch.core import faults as rfaults
from repro_torch.core import scenario as rscn
from repro_torch.core import simulator as rsim
from repro_torch.core.execution import Execution
from repro_torch.core.metrics import reliability_report
from repro_torch.kernels import faas_event_step as fes
from repro_torch.kernels import ref as rref
from test_torch_reliability import _jax_kw, _port, combo_kwargs, kernel_inputs

# acc columns 3-4 sum each event's run/idle time over the M slots in
# torch's and XLA's orders, and the lifetimes -log(1 - u) / rate may round
# one ulp apart between torch's and XLA's CPU log: the integrals agree
# within the last places of f32 over a few hundred events; every other
# column is a count or a per-row sequential sum of identical values
INTEGRAL_RTOL = 1e-5
FLOAT_RTOL = 1e-5
COUNTERS = ("n_cold", "n_warm", "n_reject", "sum_cold_resp", "sum_warm_resp", "overflow",
            "n_crash", "n_evict", "n_interrupt")
INTEGRALS = ("time_running", "time_idle")

# (crashes, capacity, reliability, retries): every fault path set
PATHS = [(c, k, rel, ret)
         for c, k in ((True, False), (False, True), (True, True))
         for rel, ret in ((False, False), (True, False), (True, True))]
PATH_IDS = [f"{'crash' if c else ''}{'+' if c and k else ''}{'cap' if k else ''}"
            f"-{'retry' if ret else 'rely' if rel else 'base'}" for c, k, rel, ret in PATHS]


def fault_kwargs(inp, seed, K, crashes, capacity):
    """Per-row crash rates and a crash uniform per event; a capacity
    profile per row stepping 6 -> 1.5 -> 8 inside the horizon (the
    non-integer ceiling evicts ceil(live - 1.5))."""
    rng = np.random.default_rng(seed)
    R = inp["t_exp"].shape[0]
    horizon = float(inp["t_end"].max())
    kw = {}
    if crashes:
        kw["crash_rate"] = rng.uniform(0.01, 0.1, R).astype(np.float32)
        kw["crash_u"] = rng.random((R, K)).astype(np.float32)
    if capacity:
        kw["cap_edges"] = np.sort(rng.uniform(0.2, 0.8, (R, 2)) * horizon, 1).astype(np.float32)
        kw["cap_values"] = np.tile(np.float32([6.0, 1.5, 8.0]), (R, 1))
    return kw


def path_inputs(seed, crashes, capacity, reliability, retries):
    inp = kernel_inputs(seed)
    samples, kw = combo_kwargs(inp, False, reliability, retries)
    kw.update(fault_kwargs(inp, seed + 100, samples[0].shape[1], crashes, capacity))
    return inp, samples, kw


def assert_plain_matches(port, ref):
    """Pools, clock and every count equal; the integrals within the rtol."""
    for a, b in zip(port[:4], ref[:4]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    acc_p, acc_r = np.asarray(port[4]), np.asarray(ref[4])
    assert acc_p.shape == acc_r.shape
    exact = [c for c in range(acc_p.shape[1]) if c not in (3, 4)]
    np.testing.assert_array_equal(acc_p[:, exact], acc_r[:, exact])
    np.testing.assert_allclose(acc_p[:, 3:5], acc_r[:, 3:5], rtol=INTEGRAL_RTOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

BAD_MODELS = [
    ("CapacityProfile", dict(edges=(1.0,), values=(1.0,))),
    ("CapacityProfile", dict(edges=(0.0,), values=(1.0, 2.0))),
    ("CapacityProfile", dict(edges=(2.0, 1.0), values=(1.0, 2.0, 3.0))),
    ("CapacityProfile", dict(edges=(1.0,), values=(1.0, -2.0))),
    ("CapacityProfile", dict(edges=(1.0,), values=(1.0, float("inf")))),
    ("FaultModel", dict(crash_rate=-0.1)),
    ("FaultModel", dict(crash_rate=float("nan"))),
]


@pytest.mark.parametrize("cls,kw", BAD_MODELS)
def test_model_validation_matches_reference(cls, kw):
    with pytest.raises(ValueError) as ref_err:
        getattr(jfaults, cls)(**kw)
    with pytest.raises(ValueError) as port_err:
        getattr(rfaults, cls)(**kw)
    assert str(port_err.value) == str(ref_err.value)


def test_model_properties_match_reference():
    for kw in (dict(), dict(crash_rate=0.5),
               dict(capacity=dict(edges=(3.0, 9.0), values=(4.0, 2.5, 7.0)))):
        cap = kw.pop("capacity", None)
        ref = jfaults.FaultModel(**kw, capacity=None if cap is None
                                 else jfaults.CapacityProfile(**cap))
        port = interop.faults_from_reference(ref)
        for f in ("crashes", "cap_steps", "enabled"):
            assert getattr(port, f) == getattr(ref, f), f
        if cap is not None:
            for t in (0.0, 2.9, 3.0, 8.0, 9.0, 1e9):
                assert port.capacity.value(t) == ref.capacity.value(t)
            assert port.capacity.floor == ref.capacity.floor == 2.5
    with pytest.raises(TypeError, match="CapacityProfile"):
        rfaults.FaultModel(capacity=(1.0, 2.0))
    with pytest.raises(TypeError, match="FaultModel"):
        interop.faults_from_reference(jfaults.CapacityProfile(edges=(), values=(1.0,)))


# ---------------------------------------------------------------------------
# the plain version against the JAX mirror and the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("crashes,capacity,reliability,retries", PATHS, ids=PATH_IDS)
def test_plain_matches_jax_mirror(crashes, capacity, reliability, retries):
    inp, samples, kw = path_inputs(11, crashes, capacity, reliability, retries)
    port = _port(inp, samples, kw, 100)
    ref = jref.faas_sweep_ref(
        *map(jnp.asarray, inp["state"]), jnp.asarray(inp["t_exp"]),
        *map(jnp.asarray, samples), max_concurrency=100, **_jax_kw(kw, 0),
    )
    assert_plain_matches(port, ref)
    faults = port[4][:, -3:].sum(0)
    if crashes:
        assert faults[0] > 0 and faults[2] > 0  # crashes and interrupted attempts
        doom = port.doom
        assert doom.shape == inp["state"][0].shape and np.isfinite(doom).any()
    if capacity:
        assert faults[1] > 0  # evictions
    assert (port.act is not None, port.doom is not None) == (retries, crashes)


@pytest.mark.parametrize("crashes,capacity,reliability,retries", PATHS, ids=PATH_IDS)
def test_plain_matches_pallas_interpret(crashes, capacity, reliability, retries):
    inp, samples, kw = path_inputs(12, crashes, capacity, reliability, retries)
    port = _port(inp, samples, kw, 100)
    K = samples[0].shape[1]
    ref = faas_sweep_pallas(
        *map(jnp.asarray, inp["state"]), jnp.asarray(inp["t_exp"]),
        *map(jnp.asarray, samples), max_concurrency=100,
        reliability=reliability, retries=retries,
        block_r=8, block_k=K // 2 if K % 2 == 0 else K, interpret=True,
        **_jax_kw(kw, 0),
    )
    assert_plain_matches(port, ref)


def _prestamped(times, warm, R=1, M=8):
    """One prestamped row of the given arrival times with one service time
    for all, from empty pools."""
    K = len(times)
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))
    state = (torch.zeros(R, M), torch.full((R, M), -1e30), torch.full((R, M), -1e30),
             torch.zeros(R))
    samples = (f32(np.tile(times, (R, 1))), f32(np.full((R, K), warm)),
               f32(np.full((R, K), warm)))
    return state, samples


def _both(state, samples, t_exp, **kw):
    """The port's plain version and the JAX mirror on the same inputs."""
    port = rref.faas_sweep_ref(*state, torch.tensor([t_exp] * state[0].shape[0]), *samples,
                               prestamped=True, **kw)
    to_j = lambda x: jnp.asarray(x.numpy()) if isinstance(x, torch.Tensor) else x
    ref = jref.faas_sweep_ref(*map(to_j, state), jnp.full(state[0].shape[0], t_exp,
                                                           jnp.float32),
                              *map(to_j, samples), prestamped=True,
                              **{k: to_j(v) for k, v in kw.items()})
    port = port.apply(lambda x: x.numpy())
    assert_plain_matches(port, ref)
    return port


def test_eviction_breaks_creation_ties_on_the_lower_slot():
    # four cold starts at the same instant (equal creation times) in slots
    # 0-3; the ceiling steps to 2.5 at 1.8, so at 2.0 ceil(4 - 2.5) = 2 of
    # the tied idle instances go: the lower slots, which count as newer;
    # the arrival at 2.0 then goes warm on slot 2, the lowest survivor
    state, samples = _prestamped([1.0, 1.0, 1.0, 1.0, 2.0, 3.0], 0.5)
    edges, values = torch.tensor([[1.8]]), torch.tensor([[10.0, 2.5]])
    out = _both(state, samples, 100.0, t_end=2.5, max_concurrency=10,
                cap_edges=edges, cap_values=values)
    alive, creation, busy, _, acc = out[:5]
    np.testing.assert_array_equal(alive[0, :4], [0, 0, 1, 1])
    assert (creation[0, :4] == 1.0).all()
    assert busy[0, 2] == 2.5 and busy[0, 3] == 1.5  # slot 2 served the 2.0 arrival
    cold, warm, reject = acc[0, :3]
    assert (cold, warm, reject) == (4, 1, 0)
    assert acc[0, -3:].tolist() == [0.0, 2.0, 0.0]  # two evictions


def test_crash_past_the_horizon_is_not_counted():
    # one instance cold-started at t = 1 lives 50 s (u = 1 - exp(-50 r)):
    # it dies at 51, seen by the arrival at 60; counted as a crash only
    # when 51 lies inside the horizon
    rate = 0.02
    u = np.float32(-np.expm1(-50.0 * rate))
    state, samples = _prestamped([1.0, 45.0, 60.0], 2.0)
    kw = dict(crash_rate=torch.tensor([rate]), crash_u=torch.tensor([[u, 0.5, 0.5]]),
              max_concurrency=10)
    counted = {}
    for t_end in (40.0, 55.0):
        out = _both(state, samples, 100.0, t_end=t_end, **kw)
        doom = out.doom
        assert abs(doom[0, 0] - 51.0) < 1e-3  # the stamped crash clock
        counted[t_end] = out[4][0, -3]
    assert counted == {40.0: 0.0, 55.0: 1.0}


def test_interrupted_attempt_triggers_its_retry():
    # attempt 0 (first, child 1) starts cold at t = 1 for 3 s; its instance
    # dies at 3 < 4, so the attempt is interrupted and switches on attempt
    # 1 at t = 5, which a fresh cold start serves; without the crash the
    # retry stays off
    rate = 0.5
    u = np.float32(-np.expm1(-2.0 * rate))  # a 2 s lifetime
    state, samples = _prestamped([1.0, 5.0, 9.0], 3.0)
    rely = dict(t_timeout=torch.tensor([100.0]), p_fail=torch.tensor([0.0]),
                fail_u=torch.ones(1, 3), is_first=torch.tensor([[1.0, 0.0, 1.0]]),
                child_pos=torch.tensor([[1.0, float(1 << 30), float(1 << 30)]]))
    crash = dict(crash_rate=torch.tensor([rate]), crash_u=torch.tensor([[u, 0.9999, 0.9999]]))
    on = _both(state, samples, 100.0, t_end=20.0, max_concurrency=10, **rely, **crash)
    off = _both(state, samples, 100.0, t_end=20.0, max_concurrency=10, **rely)
    act_on, acc_on = on.act, on.acc
    assert act_on[0].tolist() == [0.0, 1.0, 0.0]
    assert off.act[0].tolist() == [0.0, 0.0, 0.0]
    # RELY columns 8-11 (timeout, fail, retry, abandon), fault columns 12-14
    assert acc_on[0, 10] == 1.0 and acc_on[0, 12] == 1.0 and acc_on[0, 14] == 1.0
    # the retry found its instance dead (cold); attempt 2 reuses the retry's
    assert acc_on[0, :2].tolist() == [2.0, 1.0]


def test_zero_crash_rate_gives_infinite_lifetimes():
    # a row of a fault grid whose crash rate is 0 never crashes, even from a
    # zero uniform (where -log(1 - 0) / 0 would be NaN)
    life = rref.lifetime(torch.tensor([0.0, 0.3, 0.0]), torch.tensor([0.0, 0.0, 2.0]))
    assert life.tolist()[:2] == [float("inf")] * 2 and life[2].item() == 0.0


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def test_wrapper_runs_plain_version_on_cpu_tensors():
    inp, samples, kw = path_inputs(13, True, True, True, True)
    before = dict(fes.LAUNCH_COUNTS)
    via = _port(inp, samples, kw, 3, fn=fes.faas_sweep)
    for a, b in zip(via, _port(inp, samples, kw, 3)):
        np.testing.assert_array_equal(a, b)
    assert dict(fes.LAUNCH_COUNTS) == before  # no kernel ran


@pytest.mark.parametrize(
    "change,match",
    [
        (dict(crash_rate=None), "come together"),
        (dict(cap_edges=None), "come together"),
        (dict(window_bounds="w"), "windowed metrics"),
        (dict(grid_times="g"), "grid columns"),
        (dict(cap_edges="reversed"), "strictly increasing"),
        (dict(cap_edges="from zero"), "must be positive"),
    ],
)
def test_wrapper_refuses_fault_combinations(change, match):
    inp, samples, kw = path_inputs(14, True, True, False, False)
    edges = kw["cap_edges"]
    kw = dict(kw, **change)
    # the profile's edges are checked on CPU tensors too (one check,
    # kernels.ref.check_fault_inputs, for both block wrappers)
    if change.get("cap_edges") == "reversed":
        kw["cap_edges"] = np.ascontiguousarray(edges[:, ::-1])
    if change.get("cap_edges") == "from zero":
        kw["cap_edges"] = np.concatenate([np.zeros_like(edges[:, :1]), edges[:, 1:]], 1)
    if "window_bounds" in change:
        kw["window_bounds"] = inp["window_bounds"]
    if "grid_times" in change:
        kw["grid_times"] = inp["window_bounds"]
    with pytest.raises(ValueError, match=match):
        _port(inp, samples, kw, 3, fn=fes.faas_sweep)


def test_launch_keys_name_the_fault_paths():
    assert fes.launch_key(False, False, False, False, faults=True) == "faas_sweep_fault"
    assert fes.launch_key(False, False, True, False, faults=True) == "faas_sweep_rely_fault"
    assert fes.launch_key(False, False, True, True, faults=True) == "faas_sweep_retry_fault"


# ---------------------------------------------------------------------------
# run() and sweep() on the reference's own buffers
# ---------------------------------------------------------------------------

ACTIVE = jfaults.FaultModel(
    crash_rate=0.01,
    capacity=jfaults.CapacityProfile(edges=(90.0, 160.0), values=(30.0, 2.5, 30.0)),
)
RELY = {
    "fail": jrel.Reliability(failure=jrel.FailurePolicy(p_fail=0.1, t_timeout=4.0)),
    "retry": jrel.Reliability(
        failure=jrel.FailurePolicy(p_fail=0.1, t_timeout=4.0),
        retry=jrel.RetryPolicy(max_retries=2, backoff_base=1.0, backoff_jitter=0.3),
    ),
}


def _jax_base(faults=ACTIVE, reliability=None, **kw):
    d = dict(
        arrival_process=ExpSimProcess(rate=0.9),
        warm_service_process=ExpSimProcess(rate=0.5),
        cold_service_process=ExpSimProcess(rate=1.0 / 3.0),
        expiration_threshold=40.0,
        max_concurrency=25,
        sim_time=240.0,
        skip_time=20.0,
        slots=32,
        faults=faults,
        reliability=reliability,
    )
    d.update(kw)
    return JScenario(**d)


def reference_part(scn, key, replicas, n, crashes):
    """The reference's draws of one draw cell under ``key``: the base or
    reliability buffers, and its crash uniforms (None without crashes)."""
    if scn.reliability is not None:
        smp, ext = j_draw_rely(scn, key, replicas, n)
        part = tuple(map(np.asarray, smp)) + tuple(map(np.asarray, ext))
    else:
        part = tuple(map(np.asarray, j_draw_workload(scn, key, replicas, n)))
    crash = np.asarray(j_draw_crash(key, replicas, part[0].shape[1])) if crashes else None
    return part, crash


def assert_summary(port, ref):
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), err_msg=f)
    for f in INTEGRALS:
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f), rtol=FLOAT_RTOL)
    for f in ("availability", "interrupt_prob", "goodput", "cold_start_prob",
              "rejection_prob"):
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f), rtol=FLOAT_RTOL,
                                   err_msg=f)
    np.testing.assert_array_equal(port.n_completions, ref.n_completions)
    assert reliability_report(port) == pytest.approx(j_reliability_report(ref), rel=FLOAT_RTOL)


RUN_KINDS = {
    "crash": dict(faults=jfaults.FaultModel(crash_rate=0.02)),
    "cap": dict(faults=dataclasses.replace(ACTIVE, crash_rate=0.0)),
    "both": dict(),
    "both_fail": dict(reliability=RELY["fail"]),
    "both_retry": dict(reliability=RELY["retry"]),
}


@pytest.mark.parametrize("kind", list(RUN_KINDS))
def test_run_matches_reference(kind):
    base = _jax_base(**RUN_KINDS[kind])
    key = jax.random.key(9)
    n = base.steps_needed()
    ref = jscn.run(base, key, replicas=3, backend="ref", steps=n)
    part, crash = reference_part(base, key, 3, n, base.faults.crashes)
    staged = interop.staged_from_reference(
        [part], crash_u=None if crash is None else [crash])
    port = rscn.run(interop.scenario_from_reference(base), 0, replicas=3,
                    device="cpu", staged=staged, backend="ref")
    assert_summary(port.summary, ref.summary)
    assert port.to_dict().keys() <= ref.to_dict().keys()
    s = port.summary
    if base.faults.crashes:
        assert s.n_crash.sum() > 0 and s.n_interrupt.sum() > 0 and s.availability < 1.0
    if base.faults.capacity is not None:
        assert s.n_evict.sum() > 0


def test_sweep_matches_reference_in_one_launch(monkeypatch):
    over = {
        "crash_rate": [0.0, 0.005, 0.03],
        "expiration_threshold": [20.0, 120.0],
        "capacity": [jfaults.CapacityProfile(edges=(90.0, 160.0), values=(30.0, v, 30.0))
                     for v in (2.5, 8.0)],
    }
    base = _jax_base()
    R, n = 2, base.steps_needed()
    key = jax.random.key(3)
    ref = jscn.sweep(base, over, key, replicas=R, backend="ref", steps=n)
    parts, crashes, k = [], [], key
    for thr in over["expiration_threshold"]:  # the reference's chained draw walk
        k, sub = jax.random.split(k)
        part, crash = reference_part(JScenario.of(base, expiration_threshold=thr), sub, R,
                                     n, True)
        parts.append(part)
        crashes.append(crash)
    staged = interop.staged_from_reference(parts, crash_u=crashes)
    calls = []
    real = rref.faas_sweep_ref

    def counting(*a, **kw):
        calls.append(a[0].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(rref, "faas_sweep_ref", counting)
    port_over = dict(over, capacity=[interop.faults_from_reference(
        jfaults.FaultModel(capacity=c)).capacity for c in over["capacity"]])
    port = rscn.sweep(interop.scenario_from_reference(base), port_over, 0, replicas=R,
                      device="cpu", staged=staged, backend="ref")
    assert calls == [3 * 2 * 2 * R]  # one launch for the whole grid
    assert port.shape == ref.shape == (3, 2, 2)
    for idx in np.ndindex(port.shape):
        assert_summary(port.summaries[idx], ref.summaries[idx])
    np.testing.assert_allclose(port.availability, ref.availability, rtol=FLOAT_RTOL)
    # zero crash rate: no crash and no interruption; a tighter dip evicts more
    assert (port.availability[0] == 1.0).all()
    evict = np.vectorize(lambda s: s.n_evict.sum())(port.summaries)
    assert (evict[:, :, 0] >= evict[:, :, 1]).all() and evict[:, :, 0].sum() > 0


# ---------------------------------------------------------------------------
# the port's own draws: the inert model, the streams, conservation
# ---------------------------------------------------------------------------


def _port_scn(faults=None, reliability=None, **kw):
    scn = interop.scenario_from_reference(_jax_base(faults=None, **kw))
    rel = None if reliability is None else interop.reliability_from_reference(reliability)
    flt = None if faults is None else interop.faults_from_reference(faults)
    return rscn.Scenario.of(scn, faults=flt, reliability=rel)


@pytest.mark.parametrize("reliability", [None, "retry"])
def test_inert_fault_model_is_a_noop(reliability):
    rel = None if reliability is None else RELY[reliability]
    plain = _port_scn(reliability=rel)
    inert = rscn.Scenario.of(plain, faults=rfaults.FaultModel())
    a = rscn.run(plain, 4, replicas=3, device="cpu", backend="ref").summary
    b = rscn.run(inert, 4, replicas=3, device="cpu", backend="ref").summary
    for f in COUNTERS[:6] + INTEGRALS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert b.n_crash is None and b.availability == 1.0
    over = {"expiration_threshold": [20.0, 90.0]}
    ga = rscn.sweep(plain, over, 4, replicas=2, device="cpu", backend="ref")
    gb = rscn.sweep(inert, over, 4, replicas=2, device="cpu", backend="ref")
    for f in ("cold_start_prob", "avg_server_count", "availability", "goodput"):
        np.testing.assert_array_equal(getattr(ga, f), getattr(gb, f), err_msg=f)


def test_faults_leave_the_base_and_reliability_streams_unchanged():
    n = 400
    for rel, width in ((None, 3), (RELY["fail"], 4), (RELY["retry"], 6)):
        plain = _port_scn(reliability=rel)
        faulty = rscn.Scenario.of(plain, faults=rfaults.FaultModel(crash_rate=0.1))
        a = rsim.run_samples(plain, 11, 3, n, None, "cpu")
        b = rsim.run_samples(faulty, 11, 3, n, None, "cpu")
        assert len(a) == width and len(b) == width + 1
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        crash = b[-1]
        assert crash.shape == a[0].shape  # the attempt table's width with retries
        assert 0.0 <= float(crash.min()) and float(crash.max()) < 1.0
        assert not torch.equal(crash, a[0])
    gens = rsim.cell_generators(11, 2, "cpu", rsim.FAULT_STREAMS)
    assert len(gens[0]) == 8 and rsim.CRASH_STREAM == 7


@pytest.mark.parametrize("reliability", [None, "fail"])
def test_mass_conservation(reliability):
    # every arrival lands in one bucket: completion, interruption,
    # rejection (and with reliability timeout or failure)
    rel = None if reliability is None else RELY[reliability]
    s = rscn.run(_port_scn(faults=ACTIVE, reliability=rel, sim_time=400.0), 21,
                 replicas=3, device="cpu", backend="ref").summary
    total = s.n_completions + s.n_interrupt + s.n_reject
    if rel is not None:
        total = total + s.n_timeout + s.n_fail
    np.testing.assert_array_equal(s.n_requests, total)
    assert s.n_interrupt.sum() > 0 and s.n_evict.sum() > 0
    assert 0.0 <= s.availability <= 1.0


def test_capacity_step_evicts_the_warm_pool_surplus():
    # four overlapping cold starts build a 4-deep warm pool; a step of the
    # ceiling to 1 evicts exactly the surplus 3 at the next arrival, which
    # then starts warm (the reference's deterministic trace, as staged gaps)
    gaps = np.float32([1.0, 0.5, 0.5, 0.5, 57.5] + [100.0] * 3)[None]
    ten = np.full_like(gaps, 10.0)
    scn = rscn.Scenario.of(
        _port_scn(), expiration_threshold=200.0, max_concurrency=16, sim_time=70.0,
        skip_time=0.0, slots=16,
        faults=rfaults.FaultModel(capacity=rfaults.CapacityProfile(edges=(50.0,),
                                                                   values=(30.0, 1.0))),
    )
    s = rscn.run(scn, 0, replicas=1, device="cpu", staged=(gaps, ten, ten), backend="ref").summary
    assert (s.n_cold[0], s.n_evict[0], s.n_warm[0], s.n_reject[0], s.n_crash[0]) == (
        4, 3, 1, 0, 0)


# ---------------------------------------------------------------------------
# capability errors and the report
# ---------------------------------------------------------------------------


def test_capability_errors_match_reference():
    port = _port_scn(faults=ACTIVE)
    with pytest.raises(ValueError, match="faults_backends"):
        rscn.run(port, 0, replicas=1, device="cpu", engine="temporal", backend="ref")
    with pytest.raises(ValueError, match="faults_backends"):
        rscn.run(port, 0, replicas=1, device="cpu", engine="par", backend="ref")
    with pytest.raises(ValueError, match="draws='fused' does not serve platform faults"):
        rscn.run(port, 0, replicas=1, device="cpu", execution=Execution(draws="fused",
                                                                        backend="ref"))
    with pytest.raises(ValueError, match="draws='fused' does not serve platform faults"):
        rscn.sweep(port, {"crash_rate": [0.1]}, 0, device="cpu",
                   execution=Execution(draws="fused", backend="ref"))
    flt = interop.faults_from_reference(ACTIVE)
    for kw, ref_kw in ((dict(window_bounds=(0.0, 100.0, 200.0)),
                        dict(window_bounds=(0.0, 100.0, 200.0))),
                       (dict(track_histogram=True), dict(track_histogram=True))):
        with pytest.raises(ValueError) as ref_err:
            _jax_base(**ref_kw)
        with pytest.raises(ValueError) as port_err:
            rscn.Scenario.of(port, faults=flt, **kw)
        assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="must be a FaultModel"):
        rscn.Scenario.of(port, faults=ACTIVE)  # a reference model is converted first
    with pytest.raises(ValueError, match="needs Scenario.faults="):
        rscn.sweep(_port_scn(), {"crash_rate": [0.1]}, 0, device="cpu", backend="ref")
    with pytest.raises(ValueError, match="finite and >= 0"):
        rscn.sweep(port, {"crash_rate": [-1.0]}, 0, device="cpu", backend="ref")
    with pytest.raises(TypeError, match="CapacityProfile"):
        rscn.sweep(port, {"capacity": [3.0]}, 0, device="cpu", backend="ref")
    with pytest.raises(ValueError, match="share a step count"):
        rscn.sweep(port, {"capacity": [rfaults.CapacityProfile((5.0,), (1.0, 2.0)),
                                       rfaults.CapacityProfile((), (1.0,))]}, 0, device="cpu",
                   backend="ref")
    with pytest.raises(ValueError, match="windowed metrics"):
        rscn.sweep(port, {"window_bounds": [(0.0, 100.0)]}, 0, device="cpu", backend="ref")


def test_reliability_report_fault_block():
    # a fault run without reliability has a report; a plain run has none
    s = rscn.run(_port_scn(faults=ACTIVE), 2, replicas=2, device="cpu", backend="ref").summary
    rep = reliability_report(s)
    assert rep["crashes"] == s.n_crash.sum() and rep["evictions"] == s.n_evict.sum()
    assert rep["interrupted"] == s.n_interrupt.sum() and rep["availability"] == s.availability
    assert rep["timeouts"] == rep["failures"] == rep["retries"] == 0.0
    assert rep["completions"] == (s.n_cold + s.n_warm - s.n_interrupt).sum()
    with pytest.raises(ValueError, match="reliability or fault"):
        reliability_report(rscn.run(_port_scn(), 2, replicas=2, device="cpu",
                                    backend="ref").summary)
    # the same keys and values as the reference on the same counters
    zeros = np.zeros(2)
    for rely in (False, True):
        extra = dict(n_timeout=zeros + 1, n_fail=zeros + 2, n_retry=zeros,
                     n_abandon=zeros + 1) if rely else {}
        counts = dict(n_cold=zeros + 5, n_warm=zeros + 40, n_reject=zeros + 3,
                      time_running=zeros + 10, time_idle=zeros + 20,
                      sum_cold_resp=zeros, sum_warm_resp=zeros, lifespan_sum=zeros,
                      lifespan_count=zeros, measured_time=100.0, n_crash=zeros + 4,
                      n_evict=zeros + 6, n_interrupt=zeros + 3, **extra)
        from repro.core.simulator import SimulationSummary as JSummary
        assert reliability_report(rsim.SimulationSummary(**counts)) == pytest.approx(
            j_reliability_report(JSummary(**counts)))


def test_grid_axes_are_named_like_the_reference():
    assert set(rscn._FAULT_AXES) == set(jscn._FAULT_AXES)
    assert set(rscn._PARAM_FIELDS) == set(jscn._PARAM_FIELDS)
    assert list(itertools.chain(rscn._RELY_AXES)) == list(jscn._RELY_AXES)
