"""The port's fused draw path against the reference: the threefry bitstream
(the hex goldens of ``tests/test_drawplan.py`` and ``repro.core.drawplan.
threefry2x32`` bit for bit), the transforms against the JAX functions on
the same uniforms, the port's own key schedule, the plain fused path
against the plain staged path on materialized draws, and ``run()`` /
``sweep()`` with ``Execution(draws="fused")`` against the JAX package's
fused ``ref`` backend on the reference's keys.  The CUDA kernel's fused
path is held against the plain version in ``test_torch_cuda.py``."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Execution as JExecution
from repro.core import ExpSimProcess as JExp
from repro.core import FailurePolicy as JFailurePolicy
from repro.core import Reliability as JReliability
from repro.core import Scenario as JScenario
from repro.core import drawplan as jdp
from repro.core import scenario as jscenario
import repro_torch as rt
from repro_torch import interop
from repro_torch.core import drawplan as dp
from repro_torch.core import scenario as rscn
from repro_torch.kernels import faas_event_step as fes
from repro_torch.kernels.ref import faas_sweep_ref

fh = float.fromhex
# the f32 integrals (acc columns 3-4 and the windows') and response sums:
# torch and XLA sum the M slots in other orders, and their libms round the
# draws' last bits differently, so the sums may part in the last places
INTEGRAL_RTOL = 1e-5
# sample_dist against the JAX function on the same uniforms: torch's and
# XLA's CPU log/cos/exp/pow differ in the last bits (up to a few ulp; 16
# for the Gaussian near zero), at most a relative 1.9e-6 measured
SAMPLE_RTOL = 4e-6

FAMILIES = {
    "exp": (0.8, 0.0),
    "det": (1.3, 0.0),
    "gauss": (2.0, 0.7),
    "weibull": (1.5, 2.2),
    "lognorm": (0.3, 0.9),
    "pareto": (2.5, 1.2),
}


def _keys(rng, n):
    return rng.integers(0, 1 << 32, (n, 2), dtype=np.uint64).astype(np.uint32)


# ---------------------------------------------------------------------------
# (a), (b), (c): the bitstream and the transforms
# ---------------------------------------------------------------------------


def test_event_uniform_goldens():
    """The reference's pinned uniforms for a fixed key (tests/test_drawplan.py)."""
    u0, u1 = dp.event_uniforms(dp.words(0x243F6A88), dp.words(0x85A308D3), torch.arange(4))
    want0 = [fh("0x1.c95ef80000000p-2"), fh("0x1.14a5440000000p-1"),
             fh("0x1.f335780000000p-2"), fh("0x1.9c50880000000p-1")]
    want1 = [fh("0x1.3e41400000000p-2"), fh("0x1.83ee300000000p-2"),
             fh("0x1.4957800000000p-6"), fh("0x1.52d8c80000000p-2")]
    assert u0.dtype == torch.float32
    np.testing.assert_array_equal(u0.double().numpy(), want0)
    np.testing.assert_array_equal(u1.double().numpy(), want1)


def test_threefry_matches_the_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    k = _keys(rng, 10_000)
    c = _keys(rng, 10_000)
    c[:200, 0] = np.uint32(0xFFFFFFFF) - np.arange(200, dtype=np.uint32)  # counters near 2^32-1
    c[200:400, 1] = np.uint32(0xFFFFFFFF)
    want = jdp.threefry2x32(k[:, 0], k[:, 1], c[:, 0], c[:, 1])
    got = dp.threefry2x32(*(dp.words(x) for x in (k[:, 0], k[:, 1], c[:, 0], c[:, 1])))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64), g.numpy())
    u_want = jdp.uniform_from_bits(np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(u_want), dp.uniform_from_bits(got[0]).numpy())


@pytest.mark.parametrize("kind", list(FAMILIES))
def test_sample_dist_matches_the_reference(kind):
    rng = np.random.default_rng(1)
    n = 200_000
    # uniforms on the generator's own grid, its two ends included
    u0 = (rng.integers(0, 1 << 23, n) / 2.0**23).astype(np.float32)
    u1 = (rng.integers(0, 1 << 23, n) / 2.0**23).astype(np.float32)
    u0[:2], u1[:2] = (0.0, 1 - 2.0**-23), (0.0, 1 - 2.0**-23)
    p0, p1 = (np.full(n, v, np.float32) for v in FAMILIES[kind])
    want = np.asarray(jdp.sample_dist(kind, jnp.asarray(u0), jnp.asarray(u1),
                                      jnp.asarray(p0), jnp.asarray(p1)))
    got = dp.sample_dist(kind, *(torch.from_numpy(x) for x in (u0, u1, p0, p1))).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    if kind == "det":
        np.testing.assert_array_equal(got, want)
    assert (np.abs(got - want) <= SAMPLE_RTOL * np.maximum(1.0, np.abs(want))).all()


def test_materialize_stream_matches_the_reference():
    rng = np.random.default_rng(2)
    keys = _keys(rng, 6)
    for kind, params in list(FAMILIES.items()) + [("uniform", (0.0, 0.0))]:
        got = dp.materialize_stream(kind, torch.from_numpy(keys), params, 300).numpy()
        want = np.asarray(jdp.materialize_stream(kind, keys, params, 300))
        assert got.shape == (6, 300)
        assert (np.abs(got - want) <= SAMPLE_RTOL * np.maximum(1.0, np.abs(want))).all(), kind


# ---------------------------------------------------------------------------
# (d): the port's key schedule
# ---------------------------------------------------------------------------


def _scn(**kw):
    d = dict(
        arrival_process=rt.ExpSimProcess(rate=0.8),
        warm_service_process=rt.ExpSimProcess(rate=0.5),
        cold_service_process=rt.ExpSimProcess(rate=0.4),
        expiration_threshold=20.0, sim_time=500.0, skip_time=10.0, slots=32,
    )
    d.update(kw)
    return rt.Scenario(**d)


def test_key_schedule_properties():
    one = dp.stream_row_keys(5, 0, 4)
    # a cell's keys do not depend on the grid: cell 0 of a 3-cell grid
    st = rscn.fused_state([_scn(), _scn(expiration_threshold=5.0), _scn()], 5, 4, 100, "cpu")
    for i, s in enumerate(("arrival", "warm", "cold")):
        k = st["keys"][i]
        assert k.dtype == torch.uint32 and tuple(k.shape) == (12, 2)
        np.testing.assert_array_equal(k[:4].view(torch.int32).numpy().view(np.uint32), one[s])
        np.testing.assert_array_equal(
            k[8:].view(torch.int32).numpy().view(np.uint32), dp.stream_row_keys(5, 2, 4)[s])
    # the failure stream leaves the base streams bit for bit
    with_fail = dp.stream_row_keys(5, 0, 4, fail=True)
    assert set(with_fail) == {"arrival", "warm", "cold", "fail"} and set(one) == set(dp.STREAMS[:3])
    for s in one:
        np.testing.assert_array_equal(with_fail[s], one[s])
    # a replica's key does not depend on the replica count
    np.testing.assert_array_equal(dp.stream_row_keys(5, 0, 9)["warm"][:4], one["warm"])
    # every key of a grid is distinct, across streams, cells and seeds
    allk = np.concatenate([v for d in range(8) for seed in (5, 6)
                           for v in dp.stream_row_keys(seed, d, 64, fail=True).values()])
    assert allk.dtype == np.uint32
    assert len({tuple(r) for r in allk}) == len(allk)


def test_param_axis_repeats_keys_and_params():
    """Param cells share their draw cell's keys: rows (draw, param, replica)."""
    inp = rscn.sweep_inputs(_scn(), {"expiration_threshold": [5.0, 20.0],
                                     "sim_time": [300.0, 400.0, 500.0]},
                            3, replicas=2, device="cpu", draws="fused")
    assert inp.samples == () and inp.fused["n_steps"] > 0
    keys = inp.fused["keys"][0].view(torch.int32)
    assert tuple(keys.shape) == (12, 2)
    cells = keys.reshape(2, 3, 2, 2)
    for j in range(3):
        assert torch.equal(cells[:, j], cells[:, 0])
    assert not torch.equal(cells[0, 0], cells[1, 0])
    np.testing.assert_array_equal(inp.fused["params"][0][:, 0].numpy(), np.float32(0.8))


# ---------------------------------------------------------------------------
# (e): the plain fused path is the plain staged path with its draws inline
# ---------------------------------------------------------------------------


def _fused_inputs(seed, R=9, M=8, K=160):
    rng = np.random.default_rng(seed)
    keys = [torch.from_numpy(_keys(rng, R)) for _ in range(4)]
    params = [torch.tensor(np.stack([np.full(R, p0) * rng.uniform(0.9, 1.1, R),
                                     np.full(R, p1)], 1), dtype=torch.float32)
              for p0, p1 in ((1.2, 0.0), (1.5, 2.2), (0.3, 0.9))]
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)
    horizon = K * 1.2
    return dict(
        state=(torch.zeros((R, M)), torch.full((R, M), -1e30), torch.full((R, M), -1e30),
               torch.zeros(R)),
        t_exp=f32(10 * rng.uniform(0.5, 1.5, R)), keys=keys, params=params,
        dists=("exp", "weibull", "lognorm"),
        t_end=f32(horizon * rng.uniform(0.5, 0.9, R)),
        skip=f32(horizon * rng.uniform(0.0, 0.1, R)),
        window_bounds=f32(np.tile(np.linspace(0, 0.6 * horizon, 7), (R, 1))),
        t_timeout=f32(rng.uniform(1.0, 5.0, R)), p_fail=f32(np.full(R, 0.15)),
    )


@pytest.mark.parametrize("windows,reliability", [(False, False), (True, False),
                                                 (False, True), (True, True)])
def test_plain_fused_equals_plain_staged_on_materialized_draws(windows, reliability):
    inp = _fused_inputs(3)
    K = 160
    kw = dict(t_end=inp["t_end"], skip=inp["skip"], max_concurrency=4)
    if windows:
        kw["window_bounds"] = inp["window_bounds"]
    fkw = dict(kw, fused_keys=tuple(inp["keys"][:3]), fused_params=tuple(inp["params"]),
               fused_dists=inp["dists"], fused_k=K)
    bufs = [dp.materialize_stream(d, k, (p[:, 0], p[:, 1]), K)
            for d, k, p in zip(inp["dists"], inp["keys"], inp["params"])]
    if reliability:
        rkw = dict(t_timeout=inp["t_timeout"], p_fail=inp["p_fail"])
        fkw.update(rkw, fused_fail_keys=inp["keys"][3])
        kw.update(rkw, fail_u=dp.materialize_stream("uniform", inp["keys"][3], None, K))
    before = dict(fes.LAUNCH_COUNTS)
    fused = fes.faas_sweep(*inp["state"], inp["t_exp"], None, None, None, **fkw)
    assert dict(fes.LAUNCH_COUNTS) == before  # CPU tensors: the plain version
    staged = faas_sweep_ref(*inp["state"], inp["t_exp"], *bufs, **kw)
    for a, b in zip(fused[:5], staged[:5]):
        assert torch.equal(a, b)
    assert fused[5:] == staged[5:] == (None, None)  # no activation plane, no crash clocks
    acc = fused[4]
    assert acc[:, 0].sum() > 0 and acc[:, 2].sum() > 0  # cold starts and rejections
    if reliability:
        assert acc[:, -3].sum() > 0  # failures


# ---------------------------------------------------------------------------
# (f): run() and sweep() against the JAX package's fused ref backend
# ---------------------------------------------------------------------------


def _jscn(**kw):
    d = dict(
        arrival_process=JExp(rate=0.8), warm_service_process=JExp(rate=0.5),
        cold_service_process=JExp(rate=0.4), expiration_threshold=20.0,
        sim_time=500.0, skip_time=10.0, slots=32,
    )
    d.update(kw)
    return JScenario(**d)


def _ref_keys(key, cells, replicas, fail):
    """The reference sweep's keys: its chained split walk over the draw
    cells, each cell's stream_row_keys."""
    parts = []
    for _ in range(cells):
        key, sub = jax.random.split(key)
        parts.append({k: np.asarray(v)
                      for k, v in jdp.stream_row_keys(sub, replicas, fail=fail).items()})
    return interop.fused_keys_from_reference(parts)


def _held(jgrid, pgrid, fields=("n_cold", "n_warm", "n_reject")):
    assert pgrid.shape == tuple(np.shape(jgrid.cold_start_prob))
    for a, b in zip(jgrid.summaries.ravel(), pgrid.summaries.ravel()):
        for f in fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        for f in ("time_running", "time_idle", "sum_cold_resp", "sum_warm_resp"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=INTEGRAL_RTOL,
                                       err_msg=f)
        if a.windows is not None:
            np.testing.assert_array_equal(a.windows.n_arrivals, b.windows.n_arrivals)
            np.testing.assert_array_equal(a.windows.n_cold, b.windows.n_cold)
            np.testing.assert_allclose(a.windows.time_running, b.windows.time_running,
                                       rtol=INTEGRAL_RTOL, atol=1e-4)


def test_fused_sweep_with_windows_matches_the_reference():
    """tests/test_drawplan.py's padded-tail grid: 6 rows, 250 events, windows."""
    s = _jscn(sim_time=120.0, skip_time=5.0, window_bounds=(0.0, 30.0, 80.0, 120.0))
    over = {"expiration_threshold": [5.0, 15.0, 40.0], "arrival_rate": [0.6, 1.1]}
    key = jax.random.key(11)
    j = jscenario.sweep(s, over=over, key=key, replicas=1, steps=250,
                        execution=JExecution(backend="ref", draws="fused", block_k=128))
    p = rt.sweep(interop.scenario_from_reference(s), over, 0, replicas=1, steps=250,
                 device="cpu", execution=rt.Execution(draws="fused", backend="ref"),
                 fused_keys=_ref_keys(key, 6, 1, False))
    _held(j, p)
    np.testing.assert_array_equal(p.windowed_arrivals, np.asarray(j.windowed_arrivals))
    assert p.to_dict()["draws"] == "fused" and p.execution.draws == "fused"


def test_fused_reliability_sweep_matches_the_reference():
    """tests/test_drawplan.py's failure-stream grid: n_fail equal."""
    rel = JReliability(failure=JFailurePolicy(p_fail=0.1, t_timeout=6.0))
    s = _jscn(sim_time=150.0, skip_time=5.0, reliability=rel)
    over = {"expiration_threshold": [10.0, 30.0], "arrival_rate": [0.5, 1.0]}
    key = jax.random.key(41)
    j = jscenario.sweep(s, over=over, key=key, replicas=2, steps=300,
                        execution=JExecution(backend="ref", draws="fused"))
    p = rt.sweep(interop.scenario_from_reference(s), over, 0, replicas=2, steps=300,
                 device="cpu", execution=rt.Execution(draws="fused", backend="ref"),
                 fused_keys=_ref_keys(key, 4, 2, True))
    _held(j, p, ("n_cold", "n_warm", "n_reject", "n_fail", "n_timeout", "n_abandon"))
    assert sum(int(x.n_fail.sum()) for x in p.summaries.ravel()) > 0


def test_fused_run_matches_the_reference():
    """tests/test_drawplan.py's f32 decision-exact run: 3 replicas x 700 events."""
    s = _jscn(sim_time=400.0, skip_time=20.0)
    key = jax.random.key(22)
    j = jscenario.run(s, key, replicas=3, steps=700,
                      execution=JExecution(backend="ref", draws="fused"))
    fk = interop.fused_keys_from_reference(
        [{k: np.asarray(v) for k, v in jdp.stream_row_keys(key, 3).items()}])
    p = rt.run(interop.scenario_from_reference(s), 0, replicas=3, steps=700, device="cpu",
               execution=rt.Execution(draws="fused", backend="ref"), fused_keys=fk)
    for f in ("n_cold", "n_warm", "n_reject"):
        np.testing.assert_array_equal(getattr(j.summary, f), getattr(p.summary, f))
    np.testing.assert_allclose(p.summary.time_running, j.summary.time_running,
                               rtol=INTEGRAL_RTOL)


def test_fused_run_draws_its_own_keys():
    scn = _scn(reliability=rt.Reliability(rt.FailurePolicy(p_fail=0.1, t_timeout=3.0)))
    a = rt.run(scn, 4, replicas=3, device="cpu", execution=rt.Execution(draws="fused",
                                                                        backend="ref"))
    b = rt.run(scn, 4, replicas=3, device="cpu", execution=rt.Execution(draws="fused",
                                                                        backend="ref"))
    c = rt.run(scn, 5, replicas=3, device="cpu", execution=rt.Execution(draws="fused",
                                                                        backend="ref"))
    np.testing.assert_array_equal(a.summary.n_cold, b.summary.n_cold)
    assert not np.array_equal(a.summary.time_running, c.summary.time_running)
    assert a.summary.n_fail.sum() > 0 and a.summary.n_timeout.sum() > 0
    # the keys seed gives are the handed keys' contract
    keys = {k: torch.from_numpy(v) for k, v in dp.stream_row_keys(4, 0, 3, fail=True).items()}
    d = rt.run(scn, 99, replicas=3, device="cpu", execution=rt.Execution(draws="fused",
                                                                         backend="ref"),
               fused_keys=keys)
    np.testing.assert_array_equal(d.summary.time_running, a.summary.time_running)


def test_fused_coverage_guard_reads_the_final_clock():
    with pytest.raises(RuntimeError, match="before sim_time"):
        rt.run(_scn(), 0, replicas=2, steps=50, device="cpu",
               execution=rt.Execution(draws="fused", backend="ref"))


# ---------------------------------------------------------------------------
# (g): refusals
# ---------------------------------------------------------------------------

FUSED = rt.Execution(draws="fused", backend="ref")


def test_unknown_draws_mode_is_refused():
    with pytest.raises(ValueError, match="draws mode"):
        rt.Execution(draws="bogus", backend="ref")


@pytest.mark.parametrize("engine", ["temporal", "par"])
def test_other_engines_refuse_fused_draws(engine):
    with pytest.raises(ValueError, match="fused"):
        rt.run(_scn(), 0, replicas=2, device="cpu",
               execution=rt.Execution(engine=engine, draws="fused", backend="ref"))


def test_retries_do_not_lower():
    rel = rt.Reliability(rt.FailurePolicy(p_fail=0.1, t_timeout=6.0),
                         rt.RetryPolicy(max_retries=2, backoff_base=1.0))
    with pytest.raises(ValueError, match="retry"):
        rt.sweep(_scn(reliability=rel), {"expiration_threshold": [10.0]}, 0, replicas=1,
                 steps=300, device="cpu", execution=FUSED)
    with pytest.raises(ValueError, match="retry"):
        rt.run(_scn(reliability=rel), 0, replicas=1, device="cpu", execution=FUSED)


def test_mixed_families_across_draw_cells_are_refused():
    with pytest.raises(ValueError, match="staged"):
        rt.sweep(_scn(sim_time=120.0, skip_time=5.0),
                 {"warm_service_process": [rt.ExpSimProcess(rate=0.5),
                                           rt.WeibullSimProcess(1.5, 2.0)]},
                 0, replicas=1, steps=250, device="cpu", execution=FUSED)


def test_a_process_without_a_draw_spec_is_refused():
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class Custom(rt.SimProcess):
        def _fill(self, out, generator):
            out.fill_(1.0)

        def mean(self):
            return 1.0

    with pytest.raises(ValueError, match="staged"):
        rt.run(_scn(warm_service_process=Custom()), 0, replicas=1, device="cpu",
               execution=FUSED)


def test_faults_are_refused_with_fused_draws():
    # fused draws serve no platform faults (the crash stream is staged), as
    # in the reference: not at the front door, and not in the kernel beside
    # the fused inputs; a fault model must be the port's FaultModel
    with pytest.raises(ValueError, match="must be a FaultModel"):
        _scn(faults=object())
    faulty = _scn(faults=rt.FaultModel(crash_rate=0.1))
    with pytest.raises(ValueError, match="draws='fused' does not serve platform faults"):
        rt.sweep(faulty, {"crash_rate": [0.1]}, 0, device="cpu", execution=FUSED)
    inp = _fused_inputs(4)
    with pytest.raises(ValueError, match="fused draws do not serve platform faults"):
        fes.faas_sweep(*inp["state"], inp["t_exp"], None, None, None, max_concurrency=4,
                       fused_keys=tuple(inp["keys"][:3]), fused_params=tuple(inp["params"]),
                       fused_dists=inp["dists"], fused_k=10, crash_rate=0.1,
                       crash_u=torch.ones(9, 10))


def test_draw_inputs_are_checked():
    with pytest.raises(ValueError, match="fused_keys"):
        rt.run(_scn(), 0, replicas=2, steps=50, device="cpu",
               execution=FUSED, staged=(torch.ones(2, 50),) * 3)
    with pytest.raises(ValueError, match="draws='fused'"):
        rt.sweep(_scn(), {"expiration_threshold": [5.0]}, 0, replicas=2, device="cpu",
                 fused_keys={}, backend="ref")
    keys = {k: torch.from_numpy(v) for k, v in dp.stream_row_keys(0, 0, 2).items()}
    with pytest.raises(ValueError, match="missing"):
        rt.run(_scn(reliability=rt.Reliability(rt.FailurePolicy(p_fail=0.1))), 0,
               replicas=2, device="cpu", execution=FUSED, fused_keys=keys)
    with pytest.raises(ValueError, match=r"uint32 \[3, 2\]"):
        rt.run(_scn(), 0, replicas=3, device="cpu", execution=FUSED, fused_keys=keys)
    with pytest.raises(ValueError, match="uint32"):
        rt.run(_scn(), 0, replicas=2, device="cpu", execution=FUSED,
               fused_keys={k: v.long() for k, v in keys.items()})


def test_wrapper_checks_fused_structure():
    inp = _fused_inputs(5)
    args = (*inp["state"], inp["t_exp"])
    fkw = dict(max_concurrency=4, fused_keys=tuple(inp["keys"][:3]),
               fused_params=tuple(inp["params"]), fused_dists=inp["dists"], fused_k=20)
    dts = torch.ones(9, 20)
    cases = [
        (dict(), (dts, None, None), "no staged samples"),
        (dict(fused_dists=("exp", "gamma", "exp")), (None,) * 3, "fused_dists"),
        (dict(fused_keys=tuple(inp["keys"][:2])), (None,) * 3, "three each"),
        (dict(prestamped=True), (None,) * 3, "prestamped"),
        (dict(grid_times=torch.ones(9, 3)), (None,) * 3, "grid columns"),
        (dict(t_timeout=1.0, p_fail=0.1), (None,) * 3, "fused_fail_keys"),
        (dict(t_timeout=1.0, p_fail=0.1, fused_fail_keys=inp["keys"][3],
              is_first=torch.ones(9, 20), child_pos=torch.ones(9, 20)), (None,) * 3,
         "retry streams"),
    ]
    for extra, samples, match in cases:
        with pytest.raises(ValueError, match=match):
            fes.faas_sweep(*args, *samples, **dict(fkw, **extra))
    with pytest.raises(ValueError, match="need fused_dists"):
        fes.faas_sweep(*args, dts, dts, dts, max_concurrency=4,
                       fused_keys=tuple(inp["keys"][:3]))


def test_launch_keys_of_the_fused_paths():
    assert fes.launch_key(False, False, False, False, True) == "faas_sweep_fused"
    assert fes.launch_key(False, True, False, False, True) == "faas_sweep_win_fused"
    assert fes.launch_key(False, False, True, False, True) == "faas_sweep_rely_fused"
    assert fes.launch_key(False, True, True, False, True) == "faas_sweep_win_rely_fused"
    assert fes.launch_key(False, True, True, False) == "faas_sweep_win_rely"


def test_staged_sweep_reports_its_draws():
    g = rt.sweep(_scn(sim_time=100.0, skip_time=5.0), {"expiration_threshold": [5.0]}, 0,
                 replicas=1, device="cpu", backend="ref")
    assert g.to_dict()["draws"] == "staged"


# ---------------------------------------------------------------------------
# (h): the port's draw module imports no JAX
# ---------------------------------------------------------------------------


def test_drawplan_imports_no_jax():
    code = (
        "import sys, repro_torch.core.drawplan, repro_torch.core.scenario, "
        "repro_torch.kernels.faas_event_step, repro_torch.interop\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
