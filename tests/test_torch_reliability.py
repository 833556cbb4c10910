"""The port's reliability layer against the reference: the policies'
validation, ``build_attempt_table`` in torch against the JAX function, the
plain ``faas_sweep_ref`` with timeouts, failures and retries against the
JAX mirror and the Pallas kernel in interpret mode, ``run()``/``sweep()``
on the reference's own attempt tables against the JAX ``backend="ref"``
grid, and the layer's invariants, refusals and planner.  The CUDA kernel
is held against the plain version in ``test_torch_cuda.py``."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ExpSimProcess, Scenario as JScenario
from repro.core import reliability as jrel
from repro.core import scenario as jscn
from repro.core.cost import cost_per_completion as j_cost_per_completion
from repro.core.metrics import reliability_report as j_reliability_report
from repro.core.simulator import draw_reliability_stream as j_draw_rely
from repro.kernels import ref as jref
from repro.kernels.faas_event_step import faas_sweep_pallas
from repro.serving.autoscale import plan_expiration_threshold as j_plan
from repro_torch import interop
from repro_torch.core import reliability as rrel
from repro_torch.core import scenario as rscn
from repro_torch.core import simulator as rsim
from repro_torch.core.cost import cost_per_completion
from repro_torch.core.metrics import reliability_report
from repro_torch.kernels import faas_event_step as fes
from repro_torch.kernels.ref import faas_sweep_ref
from repro_torch.serving.autoscale import plan_expiration_threshold

# acc columns 3-4 sum each event's run/idle time over the M slots; torch and
# XLA associate that sum differently, so they agree to the last places of
# f32 over a few hundred events; every other column is a count or a
# per-row sequential sum of identical values: equal bit for bit
INTEGRAL_RTOL = 1e-5
FLOAT_RTOL = 1e-5
COUNTERS = ("n_cold", "n_warm", "n_reject", "sum_cold_resp", "sum_warm_resp",
            "overflow", "n_timeout", "n_fail", "n_retry", "n_abandon")
INTEGRALS = ("time_running", "time_idle")


# ---------------------------------------------------------------------------
# policies and the attempt table
# ---------------------------------------------------------------------------

BAD_POLICIES = [
    ("FailurePolicy", dict(p_fail=1.0)),
    ("FailurePolicy", dict(p_fail=-0.1)),
    ("FailurePolicy", dict(t_timeout=0.0)),
    ("RetryPolicy", dict(max_retries=-1)),
    ("RetryPolicy", dict(max_retries=1.5)),
    ("RetryPolicy", dict(backoff_base=0.0)),
    ("RetryPolicy", dict(backoff_mult=-1.0)),
    ("RetryPolicy", dict(backoff_jitter=1.0)),
]


@pytest.mark.parametrize("cls,kw", BAD_POLICIES)
def test_policy_validation_matches_reference(cls, kw):
    with pytest.raises(ValueError) as ref_err:
        getattr(jrel, cls)(**kw)
    with pytest.raises(ValueError) as port_err:
        getattr(rrel, cls)(**kw)
    assert str(port_err.value) == str(ref_err.value)


def test_reliability_container_and_sentinels():
    assert rrel.NO_TIMEOUT == jrel.NO_TIMEOUT and rrel.NO_CHILD == jrel.NO_CHILD
    assert np.float32(rrel.NO_CHILD) == rrel.NO_CHILD  # exact in f32
    assert not rrel.Reliability().enabled
    assert rrel.Reliability(retry=rrel.RetryPolicy(max_retries=1)).enabled
    assert rrel.FailurePolicy().timeout_or_inf == rrel.NO_TIMEOUT
    with pytest.raises(ValueError, match="FailurePolicy"):
        rrel.Reliability(failure=jrel.FailurePolicy())
    with pytest.raises(ValueError, match="max_retries > 0"):
        rrel.build_attempt_table(torch.zeros(1, 1), *[torch.zeros(1, 1, 1)] * 4,
                                 rrel.RetryPolicy())


def _table_inputs(seed, J, R=5, N=300):
    rng = np.random.default_rng(seed)
    t0 = np.cumsum(rng.exponential(1.0, (R, N)).astype(np.float32).astype(np.float64), 1)
    return (
        t0,
        rng.exponential(2.0, (R, N, J + 1)).astype(np.float32),
        rng.exponential(2.5, (R, N, J + 1)).astype(np.float32),
        rng.random((R, N, J + 1)).astype(np.float32),
        rng.random((R, N, J)),
    )


@pytest.mark.parametrize(
    "J,base,mult,jitter",
    [(1, 2.0, 2.0, 0.3), (2, 2.0, 2.0, 0.3), (3, 0.7, 1.5, 0.9), (2, 1e-3, 3.3, 0.0)],
)
def test_attempt_table_matches_jax(J, base, mult, jitter):
    inp = _table_inputs(J, J)
    kw = dict(max_retries=J, backoff_base=base, backoff_mult=mult, backoff_jitter=jitter)
    ref = jrel.build_attempt_table(*map(jnp.asarray, inp), jrel.RetryPolicy(**kw))
    port = rrel.build_attempt_table(*map(torch.from_numpy, inp), rrel.RetryPolicy(**kw))
    for name, a, b in zip(("times", "warms", "colds", "fail_u", "is_first", "child_pos"),
                          ref, port):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    # every retry's child is a later position (stable sort, backoffs > 0)
    child = port[5].long()
    has = child < rrel.NO_CHILD
    pos = torch.arange(child.shape[1]).expand_as(child)
    assert bool((child[has] > pos[has]).all())


# ---------------------------------------------------------------------------
# the plain version against the JAX mirror and the Pallas kernel
# ---------------------------------------------------------------------------


def kernel_inputs(seed, R=16, M=16, N=96, J=2, rate=0.8, W=4, backoff=0.5):
    """numpy-seeded inputs of one retry launch: an attempt table (absolute
    times, prestamped), per-row reliability parameters, irregular window
    bounds inside the horizon, per-row thresholds, horizons and warm-ups."""
    rng = np.random.default_rng(seed)
    t0, w, c, f, ju = _table_inputs(seed, J, R, N)
    pol = rrel.RetryPolicy(max_retries=J, backoff_base=backoff, backoff_jitter=0.3)
    times, warms, colds, fail, first, child = (
        x.numpy() for x in rrel.build_attempt_table(*map(torch.from_numpy, (t0, w, c, f, ju)), pol)
    )
    horizon = t0[:, -1].min()
    f32 = lambda x: np.asarray(x, np.float32)
    return dict(
        state=(f32(np.zeros((R, M))), f32(np.full((R, M), -1e30)),
               f32(np.full((R, M), -1e30)), f32(np.zeros(R))),
        t_exp=f32(10 * rng.uniform(0.5, 1.5, R)),
        samples=(f32(times), warms, colds),
        t_end=f32(horizon * rng.uniform(0.5, 0.9, R)),
        skip=f32(horizon * rng.uniform(0.0, 0.1, R)),
        window_bounds=f32(np.sort(rng.uniform(0, horizon, (R, W + 1)), axis=1)),
        t_timeout=f32(rng.uniform(1.0, 5.0, R)),
        p_fail=f32(rng.uniform(0.0, 0.3, R)),
        fail_u=fail,
        is_first=f32(first),
        child_pos=f32(child),
        gaps=f32(np.diff(t0, axis=1, prepend=0.0)),
        fail_gaps=f32(rng.random((R, N))),
    )


# (windows, reliability, retries): every combination the scan engine reaches
COMBOS = [(True, False, False), (False, True, False), (True, True, False),
          (False, True, True), (True, True, True)]


def combo_kwargs(inp, windows, reliability, retries):
    """The optional inputs of a combination; without retries the stream is
    the gap stream, run as gaps."""
    kw = dict(t_end=inp["t_end"], skip=inp["skip"], prestamped=retries)
    N = inp["gaps"].shape[1]
    samples = inp["samples"] if retries else (
        (inp["gaps"],) + tuple(np.ascontiguousarray(x[:, :N]) for x in inp["samples"][1:]))
    if windows:
        kw["window_bounds"] = inp["window_bounds"]
    if reliability:
        kw.update(t_timeout=inp["t_timeout"], p_fail=inp["p_fail"],
                  fail_u=inp["fail_u"] if retries else inp["fail_gaps"])
    if retries:
        kw.update(is_first=inp["is_first"], child_pos=inp["child_pos"])
    return samples, kw


def integral_cols(acc_cols, W):
    """Columns that sum over the M slots per event: 3-4 and each window's
    two integral columns."""
    return [3, 4] + [8 + 3 * W + j for j in range(2 * W)]


def assert_plain_matches(port, ref, W):
    for a, b in zip(port[:4], ref[:4]):  # final pool state and clock
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    acc_p, acc_r = np.asarray(port[4]), np.asarray(ref[4])
    assert acc_p.shape == acc_r.shape
    integ = integral_cols(acc_p.shape[1], W)
    exact = [c for c in range(acc_p.shape[1]) if c not in integ]
    np.testing.assert_array_equal(acc_p[:, exact], acc_r[:, exact])
    np.testing.assert_allclose(acc_p[:, integ], acc_r[:, integ], rtol=INTEGRAL_RTOL)


def _port(inp, samples, kw, max_c, fn=faas_sweep_ref):
    t = lambda x: torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x
    out = fn(*map(t, inp["state"]), t(inp["t_exp"]), *map(t, samples),
             max_concurrency=max_c, **{k: t(v) for k, v in kw.items()})
    return out.apply(lambda o: o.numpy())


def _jax_kw(kw, W):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    return dict(jkw, n_windows=W)


@pytest.mark.parametrize("windows,reliability,retries", COMBOS)
@pytest.mark.parametrize("max_c", [3, 100])
def test_plain_matches_jax_mirror(windows, reliability, retries, max_c):
    inp = kernel_inputs(1)
    samples, kw = combo_kwargs(inp, windows, reliability, retries)
    W = inp["window_bounds"].shape[1] - 1 if windows else 0
    port = _port(inp, samples, kw, max_c)
    ref = jref.faas_sweep_ref(
        *map(jnp.asarray, inp["state"]), jnp.asarray(inp["t_exp"]),
        *map(jnp.asarray, samples), max_concurrency=max_c, **_jax_kw(kw, W),
    )
    assert_plain_matches(port, ref, W)
    acc = port[4]
    if reliability:
        rely = acc[:, -4:].sum(0)
        assert rely[0] > 0 and rely[1] > 0  # timeouts and failures happen
        if retries:
            assert rely[2] > 0  # retries are processed
            assert port.act.shape == samples[0].shape and port.doom is None
    if max_c == 3:
        assert acc[:, 2].sum() > 0  # rejections happen


@pytest.mark.parametrize("windows,reliability,retries", COMBOS)
def test_plain_matches_pallas_interpret(windows, reliability, retries):
    inp = kernel_inputs(2)
    samples, kw = combo_kwargs(inp, windows, reliability, retries)
    W = inp["window_bounds"].shape[1] - 1 if windows else 0
    port = _port(inp, samples, kw, 3)
    K = samples[0].shape[1]
    ref = faas_sweep_pallas(
        *map(jnp.asarray, inp["state"]), jnp.asarray(inp["t_exp"]),
        *map(jnp.asarray, samples), max_concurrency=3,
        reliability=reliability, retries=retries,
        block_r=8, block_k=K // 2 if K % 2 == 0 else K, interpret=True,
        **_jax_kw(kw, W),
    )
    assert_plain_matches(port, ref, W)


def test_activation_plane_is_the_triggered_children():
    inp = kernel_inputs(3)
    samples, kw = combo_kwargs(inp, False, True, True)
    out = _port(inp, samples, kw, 3)
    act, acc = out.act, out.acc
    # an activated event is a retry (not a first attempt), and every
    # processed retry was activated
    first = inp["is_first"] > 0
    assert not (act[first] > 0).any()
    assert act.sum() >= acc[:, 10].sum() > 0


def test_trivial_policy_is_a_noop():
    inp = kernel_inputs(4)
    samples, base_kw = combo_kwargs(inp, True, False, False)
    plain = _port(inp, samples, base_kw, 3)
    kw = dict(base_kw, t_timeout=np.float32(rrel.NO_TIMEOUT), p_fail=np.float32(0.0),
              fail_u=inp["fail_gaps"])
    rely = _port(inp, samples, kw, 3)
    for a, b in zip(plain[:4], rely[:4]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rely[4][:, :-4], plain[4])
    timeouts, fails, retries, abandons = rely[4][:, -4:].sum(0)
    assert timeouts == fails == retries == 0
    assert abandons == plain[4][:, 2].sum()  # only rejections give up


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def test_wrapper_runs_plain_version_on_cpu_tensors():
    inp = kernel_inputs(5)
    samples, kw = combo_kwargs(inp, True, True, True)
    before = dict(fes.LAUNCH_COUNTS)
    via = _port(inp, samples, kw, 3, fn=fes.faas_sweep)
    for a, b in zip(via, _port(inp, samples, kw, 3)):
        np.testing.assert_array_equal(a, b)
    assert dict(fes.LAUNCH_COUNTS) == before  # no kernel ran


@pytest.mark.parametrize(
    "drop,match",
    [("p_fail", "come together"), ("child_pos", "come together"),
     ("rely", "retries need")],
)
def test_wrapper_wants_whole_input_sets(drop, match):
    inp = kernel_inputs(6, R=8, M=4, N=8)
    samples, kw = combo_kwargs(inp, False, True, True)
    if drop == "rely":
        for k in ("t_timeout", "p_fail", "fail_u"):
            kw.pop(k)
    else:
        kw.pop(drop)
    with pytest.raises(ValueError, match=match):
        _port(inp, samples, kw, 3, fn=fes.faas_sweep)


def test_launch_keys_name_each_path():
    assert fes.launch_key(False, False, False, False) == "faas_sweep"
    assert fes.launch_key(True, False, False, False) == "faas_sweep_grid"
    assert fes.launch_key(False, True, False, False) == "faas_sweep_win"
    assert fes.launch_key(False, False, True, False) == "faas_sweep_rely"
    assert fes.launch_key(False, False, True, True) == "faas_sweep_retry"
    assert fes.launch_key(False, True, True, True) == "faas_sweep_win_retry"


# ---------------------------------------------------------------------------
# run() and sweep() on the reference's own attempt tables
# ---------------------------------------------------------------------------


def _jax_base(reliability, **kw):
    d = dict(
        arrival_process=ExpSimProcess(rate=0.9),
        warm_service_process=ExpSimProcess(rate=1 / 1.991),
        cold_service_process=ExpSimProcess(rate=1 / 2.244),
        expiration_threshold=60.0,
        sim_time=200.0,
        skip_time=20.0,
        slots=16,
        reliability=reliability,
    )
    d.update(kw)
    return JScenario(**d)


RELY = {
    "fail": jrel.Reliability(failure=jrel.FailurePolicy(p_fail=0.1, t_timeout=4.0)),
    "retry": jrel.Reliability(
        failure=jrel.FailurePolicy(p_fail=0.1, t_timeout=4.0),
        retry=jrel.RetryPolicy(max_retries=2, backoff_base=1.0, backoff_jitter=0.3),
    ),
}


def reference_parts(base, over, key, replicas, n_steps):
    """The reference sweep's chained draw walk with its reliability
    extras: one ``(samples, extras)`` per draw cell, in product order."""
    draw_names = [n for n in over if n in jscn._DRAW_FIELDS]
    max_sim = float(max(over.get("sim_time", (base.sim_time,))))
    parts = []
    for combo in itertools.product(*[over[n] for n in draw_names]):
        c = base
        for n, v in zip(draw_names, combo):
            c = jscn._apply_axis(c, n, v)
        key, sub = jax.random.split(key)
        smp, ext = j_draw_rely(JScenario.of(c, sim_time=max_sim), sub, replicas, n_steps)
        parts.append((tuple(map(np.asarray, smp)), tuple(map(np.asarray, ext))))
    return parts


def assert_summary(port, ref):
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), err_msg=f)
    for f in INTEGRALS:
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f), rtol=FLOAT_RTOL)
    assert port.measured_time == ref.measured_time
    for f in ("goodput", "retry_amplification", "timeout_prob", "failure_prob",
              "cold_start_prob", "rejection_prob"):
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f), rtol=FLOAT_RTOL,
                                   err_msg=f)
    np.testing.assert_array_equal(port.n_completions, ref.n_completions)
    assert reliability_report(port) == pytest.approx(j_reliability_report(ref), rel=FLOAT_RTOL)


@pytest.mark.parametrize("kind", ["fail", "retry"])
@pytest.mark.parametrize("max_c", [1000, 2])
def test_sweep_matches_reference_grid(kind, max_c):
    over = {
        "t_timeout": [1.5, 6.0],
        "expiration_threshold": [20.0, 120.0],
        "p_fail": [0.0, 0.2],
    }
    if kind == "retry":
        over["backoff_base"] = [0.5, 3.0]
    base = _jax_base(RELY[kind], max_concurrency=max_c)
    R, n = 2, base.steps_needed()
    key = jax.random.key(3)
    ref = jscn.sweep(base, over, key, replicas=R, backend="ref", steps=n)
    staged = interop.staged_from_reference(reference_parts(base, over, key, R, n))
    assert len(staged) == (6 if kind == "retry" else 4)
    port = rscn.sweep(interop.scenario_from_reference(base), over, 0, replicas=R,
                      device="cpu", staged=staged, backend="ref")
    assert port.axes == ref.axes and port.shape == ref.shape
    for idx in np.ndindex(port.shape):
        assert_summary(port.summaries[idx], ref.summaries[idx])
    for f in ("goodput", "cold_start_prob", "developer_cost", "avg_server_count"):
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f), rtol=FLOAT_RTOL)
    cell = port.summaries[(0,) * len(over)]
    ref_cell = ref.summaries[(0,) * len(over)]
    np.testing.assert_allclose(cost_per_completion(cell), j_cost_per_completion(ref_cell),
                               rtol=FLOAT_RTOL)
    if max_c == 2:
        assert (port.rejection_prob > 0).all()


@pytest.mark.parametrize("kind", ["fail", "retry"])
def test_run_matches_reference(kind):
    base = _jax_base(RELY[kind], sim_time=300.0, max_concurrency=3)
    key = jax.random.key(9)
    n = base.steps_needed()
    ref = jscn.run(base, key, replicas=3, backend="ref", steps=n)
    smp, ext = j_draw_rely(base, key, 3, n)
    staged = interop.staged_from_reference(
        [(tuple(map(np.asarray, smp)), tuple(map(np.asarray, ext)))])
    port = rscn.run(interop.scenario_from_reference(base), 0, replicas=3,
                    device="cpu", staged=staged, backend="ref")
    assert_summary(port.summary, ref.summary)
    assert port.to_dict().keys() <= ref.to_dict().keys()
    assert port.summary.n_retry.sum() > 0 if kind == "retry" else port.summary.n_retry.sum() == 0


# ---------------------------------------------------------------------------
# the port's own draws: invariants and the base stream
# ---------------------------------------------------------------------------


def _port_scn(kind=None, **kw):
    rel = None if kind is None else interop.reliability_from_reference(RELY[kind])
    return rscn.Scenario.of(interop.scenario_from_reference(_jax_base(None, **kw)),
                            reliability=rel)


@pytest.mark.parametrize("max_c", [1000, 2])
def test_every_attempt_is_served_or_rejected(max_c):
    grid = rscn.sweep(_port_scn("retry", max_concurrency=max_c, skip_time=0.0),
                      {"t_timeout": [1.0, 8.0]}, 5, replicas=4, device="cpu", backend="ref")
    for s in grid.summaries.ravel():
        first = s.n_attempts - s.n_retry
        # every first attempt within the horizon is processed (skip = 0)
        assert (first > 0).all() and (s.n_retry > 0).all()
        # a trigger either switches on a retry or gives up
        triggers = s.n_timeout + s.n_fail + s.n_reject
        np.testing.assert_array_less(s.n_abandon, triggers + 1)
        assert (s.n_completions + s.n_timeout + s.n_fail == s.n_cold + s.n_warm).all()
        assert s.retry_amplification >= 1.0


def test_base_draws_unchanged_by_reliability():
    n = 500
    plain = rsim.cell_generators(11, 2, "cpu")
    rely = rsim.cell_generators(11, 2, "cpu", rsim.RELY_STREAMS)
    scn = _port_scn("fail")
    for g3, g7 in zip(plain, rely):
        assert len(g7) == 7
        a = rsim.draw_workload_samples(scn, g3, 3, n, "cpu")
        b, (fail,) = rsim.draw_reliability_stream(scn, g7, 3, n, "cpu")
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert fail.shape == (3, n) and 0.0 <= float(fail.min()) and float(fail.max()) < 1.0
    # with retries the first attempts replay the base stream: its times,
    # warm and cold draws
    gens = rsim.cell_generators(11, 1, "cpu", rsim.RELY_STREAMS)[0]
    base = rsim.draw_workload_samples(scn, rsim.cell_generators(11, 1, "cpu")[0], 3, n, "cpu")
    scn_r = _port_scn("retry", sim_time=100.0)
    (times, warms, colds), (fail, first, child) = rsim.draw_reliability_stream(
        scn_r, gens, 3, n, "cpu")
    assert times.shape == (3, 3 * n)
    keep = first > 0
    clock = torch.cumsum(base[0].double(), 1).float()
    for r in range(3):
        assert torch.equal(times[r][keep[r]], clock[r])
        assert torch.equal(warms[r][keep[r]], base[1][r])
        assert torch.equal(colds[r][keep[r]], base[2][r])
    assert bool((times[:, 1:] >= times[:, :-1]).all())  # sorted


def test_trivial_reliability_keeps_the_base_metrics():
    over = {"expiration_threshold": [20.0, 120.0]}
    plain = rscn.sweep(_port_scn(None), over, 2, replicas=3, device="cpu", backend="ref")
    trivial = rscn.sweep(
        rscn.Scenario.of(_port_scn(None), reliability=rrel.Reliability()),
        over, 2, replicas=3, device="cpu", backend="ref")
    for a, b in zip(plain.summaries.ravel(), trivial.summaries.ravel()):
        for f in ("n_cold", "n_warm", "n_reject", "time_running", "time_idle",
                  "sum_cold_resp", "sum_warm_resp"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (b.n_timeout == 0).all() and (b.n_fail == 0).all()


def test_run_draws_reliability_on_the_port():
    res = rscn.run(_port_scn("retry", max_concurrency=3), 4, replicas=3, device="cpu",
                   backend="ref")
    s = res.summary
    assert (s.n_retry > 0).all() and (s.n_timeout > 0).any()
    assert res.to_dict()["n_retries"] == int(s.n_retry.sum())
    assert s.retry_amplification > 1.0


# ---------------------------------------------------------------------------
# refusals and the planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["temporal", "par"])
def test_other_engines_refuse_reliability(engine):
    with pytest.raises(ValueError, match="scan backend"):
        rscn.run(_port_scn("fail"), 0, replicas=2, device="cpu", engine=engine, backend="ref")


@pytest.mark.parametrize("axis", ["t_timeout", "p_fail", "backoff_base"])
def test_reliability_axes_need_a_policy(axis):
    with pytest.raises(ValueError, match="Scenario.reliability="):
        rscn.sweep(_port_scn(None), {axis: [1.0]}, 0, device="cpu", backend="ref")


@pytest.mark.parametrize("axis,value", [("t_timeout", 0.0), ("p_fail", 1.0)])
def test_reliability_axis_values_are_checked(axis, value):
    with pytest.raises(ValueError, match=axis):
        rscn.sweep(_port_scn("fail"), {axis: [value]}, 0, device="cpu", backend="ref")


def test_scenario_checks_the_policy_type():
    with pytest.raises(ValueError, match="must be a Reliability"):
        rscn.Scenario.of(_port_scn(None), reliability=RELY["fail"])


@pytest.mark.parametrize("name", ["fused_keys", "fused_fail_keys", "crash_rate", "cap_values"])
def test_fused_and_fault_inputs_still_refused(name):
    inp = kernel_inputs(7, R=8, M=4, N=8)
    samples, kw = combo_kwargs(inp, False, True, False)
    # fused inputs beside staged samples are refused (the fused path is
    # chosen by fused_dists); a fault input without its partner (crash_u,
    # cap_edges) is refused
    err, match = ((ValueError, "need fused_dists") if name.startswith("fused")
                  else (ValueError, "come together"))
    with pytest.raises(err, match=match):
        _port(inp, samples, dict(kw, **{name: np.ones(8, np.float32)}), 3,
              fn=fes.faas_sweep)


def test_staged_reliability_buffers_are_checked():
    scn = _port_scn("retry", sim_time=100.0)
    with pytest.raises(ValueError, match="6 buffers"):
        rscn.run(scn, 0, replicas=2, device="cpu",
                 staged=(torch.ones(2, 5),) * 4, backend="ref")
    short = tuple(torch.ones(2, 6) for _ in range(6))
    with pytest.raises(RuntimeError, match="before sim_time"):
        rscn.run(scn, 0, replicas=2, device="cpu", staged=short, backend="ref")


def test_planner_under_a_failure_model():
    rel = RELY["retry"]
    kw = dict(candidate_thresholds=(30.0, 120.0, 600.0), sim_time=2000.0, seed=0,
              replicas=2)
    port = plan_expiration_threshold(0.5, 1.0, 2.0, 0.05, device="cpu",
                                     reliability=interop.reliability_from_reference(rel), **kw)
    plain = plan_expiration_threshold(0.5, 1.0, 2.0, 0.05, device="cpu", **kw)
    ref = j_plan(0.5, 1.0, 2.0, 0.05, reliability=rel, **kw)
    assert plain.predicted_goodput is None
    # completions per second: near the 0.5/s offered, less what is given up
    assert np.isfinite(port.predicted_goodput) and 0.3 < port.predicted_goodput < 0.6
    # other draws than the reference's: the plan agrees in kind
    assert port.expiration_threshold in kw["candidate_thresholds"]
    assert abs(port.predicted_goodput - ref.predicted_goodput) < 0.1
