"""The port's fleet engine against the reference: the plain PyTorch
``fleet_sweep_ref`` vs the JAX mirror ``kernels.ref.fleet_sweep_ref`` and
the Pallas ``fleet_sweep_pallas`` in interpret mode (the same numpy inputs,
laid out in the reference's 8-row blocks); ``fleet_run``/``fleet_sweep``
on the reference's own merged streams vs the JAX ``backend="ref"`` front
door field by field; the one-function fleet vs ``run()``; conservation and
the capacity cap; the catalog; the pointed errors.  The CUDA kernel itself
is held against the plain version in ``test_torch_cuda.py``."""

import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fleet as jfleet
from repro.core.processes import ExpSimProcess as JExp
from repro.data import catalog as jcat
from repro.kernels import ref as jref
from repro.kernels.faas_event_step import fleet_sweep_pallas
from repro_torch import interop
from repro_torch.core import execution as rexec
from repro_torch.core import fleet as rfleet
from repro_torch.core import scenario as rscn
from repro_torch.data import catalog as rcat
from repro_torch.kernels import fleet_event_step as fles
from repro_torch.kernels.ref import FLEET_ACC_COLS, _ref_fleet_rows, fleet_sweep_ref

# per-function sums of identically computed values, and the queue and peak
# columns: equal bit for bit across frameworks
EXACT_COLS = [0, 1, 2, 5, 6, 7, 8, 9, 10, 11, 12]
# columns 3-4 sum each event's run/idle time over a function's M slots;
# torch and XLA associate those M-sums differently, so each event's sum may
# differ in its last place and the difference accumulates over K <= 512
# f32 additions
INTEGRAL_RTOL = 1e-5
INTEGRAL_COLS = [3, 4]
NEG = -1e30
BLOCK = 8  # the reference's rows per fleet

# (F, queue_depth, prestamped, n_cluster, limits)
CASES = [
    (1, 0, False, math.inf, 1000),
    (1, 2, False, 3.0, 1000),  # a queue behind a binding cluster
    (3, 2, True, 4.0, (3, 2, 5)),
    (3, 0, False, 5.0, 1000),  # a merged stream in gap mode
    (8, 0, True, math.inf, 2),  # every function's limit binds
    (8, 2, True, 6.0, 1000),
]


def _inputs(seed, F, ncl, limits, prestamped, *, streams=2, cells=2, K=256, M=16):
    """One merged stream per replica and ``cells`` per-fleet parameter sets;
    fleet (c, r) reads stream row r."""
    rng = np.random.default_rng(seed)
    rate = 1.2
    gaps = rng.exponential(1 / rate, (streams, K))
    times = np.cumsum(gaps, axis=1) if prestamped else gaps
    N = cells * streams
    horizon = K / rate
    f32 = lambda x: np.asarray(x, np.float32)
    return dict(
        t_exp=f32(rng.uniform(3.0, 25.0, (N, F))),
        limit=f32(np.broadcast_to(np.asarray(limits, np.float64), (N, F))),
        ncl=f32(np.full(N, 1e30 if math.isinf(ncl) else ncl)),
        t_end=f32(horizon * rng.uniform(0.6, 0.9, N)),
        skip=f32(horizon * rng.uniform(0.0, 0.1, N)),
        stream=np.tile(np.arange(streams), cells),
        times=f32(times),
        fids=rng.integers(0, F, (streams, K)).astype(np.uint8),
        warms=f32(rng.exponential(2.0, (streams, K))),
        colds=f32(rng.exponential(2.5, (streams, K))),
        M=M,
    )


def _port(inp, Q, prestamped, fn=fleet_sweep_ref):
    t = lambda k: torch.from_numpy(np.array(inp[k]))
    acc, qleft = fn(
        t("t_exp"), t("limit"), t("ncl"), t("t_end"), t("skip"), t("stream"),
        t("times"), t("fids"), t("warms"), t("colds"),
        slots=inp["M"], queue_depth=Q, prestamped=prestamped,
    )
    return acc.numpy(), qleft.numpy()


def _blocks(inp):
    """The reference's layout: fleet n is rows [8n, 8n+8), row f function
    f (padded functions get limit 0), the stream copied into every row."""
    N, F = inp["t_exp"].shape
    pad = lambda a, fill: np.concatenate(
        [a, np.full((N, BLOCK - F), fill, np.float32)], axis=1
    ).reshape(-1)
    per_fleet = lambda a: np.repeat(a, BLOCK)
    rows = lambda a: np.repeat(a[inp["stream"]], BLOCK, axis=0)
    return (
        jnp.asarray(pad(inp["t_exp"], 1.0)),
        jnp.asarray(pad(inp["limit"], 0.0)),
        jnp.asarray(per_fleet(inp["ncl"])),
        jnp.asarray(per_fleet(inp["t_end"])),
        jnp.asarray(per_fleet(inp["skip"])),
        jnp.asarray(rows(inp["times"])),
        jnp.asarray(rows(inp["fids"]).astype(np.float32)),
        jnp.asarray(rows(inp["warms"])),
        jnp.asarray(rows(inp["colds"])),
    )


def _from_blocks(acc, qt, N, F):
    acc = np.asarray(acc).reshape(N, BLOCK, FLEET_ACC_COLS)[:, :F]
    if qt is None:
        return acc, np.zeros((N, F), np.float32)
    qleft = (np.asarray(qt) > NEG * 0.5).sum(1).reshape(N, BLOCK)[:, :F]
    return acc, qleft.astype(np.float32)


def _assert_same(port, ref):
    (acc_p, q_p), (acc_r, q_r) = port, ref
    assert acc_p.shape == acc_r.shape
    np.testing.assert_array_equal(acc_p[..., EXACT_COLS], acc_r[..., EXACT_COLS])
    np.testing.assert_allclose(
        acc_p[..., INTEGRAL_COLS], acc_r[..., INTEGRAL_COLS], rtol=INTEGRAL_RTOL
    )
    np.testing.assert_array_equal(q_p, q_r)


@pytest.mark.parametrize("F,Q,prestamped,ncl,limits", CASES)
def test_plain_matches_jax_mirror(F, Q, prestamped, ncl, limits):
    inp = _inputs(10 + F + Q, F, ncl, limits, prestamped)
    port = _port(inp, Q, prestamped)
    acc, qt = jref.fleet_sweep_ref(
        *_blocks(inp), slots=inp["M"], queue_depth=Q, block_r=BLOCK,
        prestamped=prestamped,
    )
    _assert_same(port, _from_blocks(acc, qt, *inp["t_exp"].shape))
    acc_p, qleft = port
    assert acc_p[..., 8].sum() > 0 and acc_p[..., 0].sum() > 0
    if not math.isinf(ncl) or limits != 1000:
        assert acc_p[..., 2].sum() + acc_p[..., 9].sum() > 0  # something binds
    if Q:
        assert acc_p[..., 10].sum() > 0  # queued arrivals were served
    # the peak is the fleet's: every function carries it, within the cap
    assert (acc_p[..., 12] == acc_p[:, :1, 12]).all()
    assert acc_p[..., 12].max() <= min(ncl, 8 * 16)


@pytest.mark.parametrize("F,Q,prestamped,ncl,limits", [CASES[2], CASES[4], CASES[5]])
def test_plain_matches_pallas_interpret(F, Q, prestamped, ncl, limits):
    inp = _inputs(20 + F, F, ncl, limits, prestamped)
    acc, qt = fleet_sweep_pallas(
        *_blocks(inp), slots=inp["M"], queue_depth=Q, block_r=BLOCK, block_k=128,
        interpret=True, prestamped=prestamped,
    )
    _assert_same(_port(inp, Q, prestamped), _from_blocks(acc, qt, *inp["t_exp"].shape))


def test_wrapper_runs_plain_version_on_cpu_tensors():
    inp = _inputs(3, 3, 4.0, 1000, True)
    before = dict(fles.LAUNCH_COUNTS)
    via = _port(inp, 2, True, fn=fles.fleet_sweep)
    for a, b in zip(via, _port(inp, 2, True)):
        np.testing.assert_array_equal(a, b)
    assert dict(fles.LAUNCH_COUNTS) == before  # no kernel ran


def test_fault_inputs_are_refused():
    inp = _inputs(4, 1, math.inf, 1000, False)
    for name in ("crash_rate", "crash_u", "cap_edges", "cap_values"):
        with pytest.raises(NotImplementedError, match="Queue A item 4"):
            _port(inp, 0, False, fn=lambda *a, **k: fleet_sweep_ref(
                *a, **k, **{name: torch.ones(1)}))
        with pytest.raises(NotImplementedError, match="Queue A item 4"):
            _port(inp, 0, False, fn=lambda *a, **k: fles.fleet_sweep(
                *a, **k, **{name: torch.ones(1)}))


# ---------------------------------------------------------------------------
# the front door on the reference's own merged streams
# ---------------------------------------------------------------------------


def _jfn(name, rate, warm, cold, t_exp, limit):
    return jfleet.FleetFunction(
        name=name,
        arrival_process=JExp(rate=rate),
        warm_service_process=JExp(rate=1.0 / warm),
        cold_service_process=JExp(rate=1.0 / cold),
        expiration_threshold=t_exp,
        max_concurrency=limit,
    )


def hetero_fleet(n_cluster=6.0, queue_depth=2, sim_time=400.0):
    """tests/test_fleet.py's shape: 4 heterogeneous functions under a
    binding shared capacity, with queues."""
    fns = (
        _jfn("hot", 1.0, 1.5, 3.0, 30.0, 4),
        _jfn("slow", 0.5, 4.0, 6.0, 60.0, 3),
        _jfn("chatty", 2.0, 0.5, 1.5, 20.0, 5),
        _jfn("batch", 0.3, 8.0, 10.0, 90.0, 2),
    )
    return jfleet.FleetScenario(
        functions=fns, n_cluster=n_cluster, queue_depth=queue_depth,
        sim_time=sim_time, skip_time=0.0, slots=16,
    )


COUNTERS = ("n_cold", "n_warm", "n_reject", "sum_cold_resp", "sum_warm_resp", "overflow")
INTEGRALS = ("time_running", "time_idle")
FLEET_ARRAYS = ("arrivals", "enqueued", "queue_served", "queue_wait_sum",
                "queue_left", "peak_cluster")


def _assert_fleet_summary(p, r):
    assert p.functions == r.functions
    for sp, sr in zip(p.summaries, r.summaries):
        for f in COUNTERS:
            np.testing.assert_array_equal(getattr(sp, f), np.asarray(getattr(sr, f)), err_msg=f)
        for f in INTEGRALS:
            np.testing.assert_allclose(getattr(sp, f), np.asarray(getattr(sr, f)),
                                       rtol=INTEGRAL_RTOL, err_msg=f)
        assert sp.measured_time == sr.measured_time
    for f in FLEET_ARRAYS:
        np.testing.assert_array_equal(getattr(p, f), np.asarray(getattr(r, f)), err_msg=f)
    assert p.n_cluster == r.n_cluster and p.measured_time == r.measured_time
    np.testing.assert_allclose(p.cold_start_prob, r.cold_start_prob, rtol=1e-6)
    np.testing.assert_allclose(p.queue_wait_avg, r.queue_wait_avg, rtol=1e-6)
    np.testing.assert_allclose(p.avg_cluster_occupancy, r.avg_cluster_occupancy,
                               rtol=INTEGRAL_RTOL)


def _reference_staged(jf, key, replicas, max_sim):
    staged = jfleet._stage_fleet(jf, key, replicas, None, max_sim)
    return interop.fleet_staged_from_reference(staged)


@pytest.mark.parametrize("queue_depth", [2, 0])
def test_fleet_run_matches_reference(queue_depth):
    jf = hetero_fleet(queue_depth=queue_depth)
    key = jax.random.key(1)
    ref = jfleet.fleet_run(jf, key, replicas=2, backend="ref")
    port = rfleet.fleet_run(
        interop.fleet_from_reference(jf), 0, replicas=2, device="cpu",
        staged=_reference_staged(jf, key, 2, jf.sim_time),
    )
    _assert_fleet_summary(port.summary, ref.summary)
    np.testing.assert_allclose(port.developer_cost, ref.developer_cost, rtol=1e-5)
    np.testing.assert_allclose(port.provider_cost, ref.provider_cost, rtol=1e-5)
    assert port.summary.max_peak_cluster == jf.n_cluster  # the cap binds
    if queue_depth:
        assert port.summary.enqueued.sum() > 0


def test_catalog_sweep_matches_reference():
    names = ["thumbnail", "compression", "ml-inference"]
    jf = jcat.fleet_of(names, n_cluster=6, sim_time=300.0, skip_time=20.0, slots=16)
    over = {"expiration_threshold": [30.0, (20.0, 60.0, 120.0)],
            "n_cluster": [3.0, math.inf]}
    key = jax.random.key(2)
    ref = jfleet.fleet_sweep(jf, over, key, replicas=2, backend="ref")
    port = rfleet.fleet_sweep(
        interop.fleet_from_reference(jf), over, 0, replicas=2, device="cpu",
        staged=_reference_staged(jf, key, 2, jf.sim_time),
    )
    assert port.axes == ref.axes and port.shape == (2, 2, 3)
    assert port.backend == "ref"
    for idx in np.ndindex(port.shape):
        for f in COUNTERS:
            np.testing.assert_array_equal(
                getattr(port.summaries[idx], f), np.asarray(getattr(ref.summaries[idx], f)),
                err_msg=f"{f} at {idx}",
            )
    for m in ("cold_start_prob", "rejection_prob", "peak_cluster", "queue_wait_avg"):
        np.testing.assert_allclose(getattr(port, m), getattr(ref, m), rtol=1e-6, err_msg=m)
    for m in ("avg_server_count", "wasted_ratio", "cluster_utilization",
              "developer_cost", "provider_cost"):
        np.testing.assert_allclose(getattr(port, m), getattr(ref, m), rtol=INTEGRAL_RTOL,
                                   err_msg=m)
    assert port.ok.all()
    # the binding cluster caps the peak; the unbounded one does not
    assert port.peak_cluster[:, 0].max() == 3.0 and port.peak_cluster[:, 1].max() > 3.0
    a, b = port.sel(function="compression"), port.sel(function=1)
    for m in port._METRIC_FIELDS:
        np.testing.assert_array_equal(getattr(a, m), getattr(b, m), err_msg=m)
    assert a.shape == (2, 2) and "function" not in a.axes
    with pytest.raises(KeyError):
        port.sel(function="nope")
    with pytest.raises(KeyError):
        port.sel(function=3)


# ---------------------------------------------------------------------------
# the port on its own draws
# ---------------------------------------------------------------------------


def _port_fleet(**kw):
    return interop.fleet_from_reference(hetero_fleet(**kw))


def test_one_function_fleet_makes_run_decisions():
    fn = rfleet.FleetFunction(
        name="solo",
        arrival_process=rscn.ExpSimProcess(rate=1.0),
        warm_service_process=rscn.ExpSimProcess(rate=1 / 1.5),
        cold_service_process=rscn.ExpSimProcess(rate=1 / 3.0),
        expiration_threshold=20.0,
        max_concurrency=3,
    )
    fleet = rfleet.FleetScenario(functions=(fn,), sim_time=300.0, skip_time=20.0, slots=16)
    scn = fn.as_scenario(sim_time=300.0, skip_time=20.0, slots=16)
    one = rfleet.fleet_run(fleet, 5, replicas=3, device="cpu").summary["solo"]
    single = rscn.run(scn, 5, replicas=3, device="cpu").summary
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(one, f), getattr(single, f), err_msg=f)
    for f in INTEGRALS:
        np.testing.assert_allclose(getattr(one, f), getattr(single, f), rtol=INTEGRAL_RTOL)
    assert single.n_reject.sum() > 0  # the limit binds


@pytest.mark.parametrize("queue_depth", [0, 3])
def test_conservation_and_capacity(queue_depth):
    fleet = _port_fleet(n_cluster=5.0, queue_depth=queue_depth, sim_time=300.0)
    s = rfleet.fleet_run(fleet, 4, replicas=3, device="cpu").summary
    cold = np.stack([x.n_cold for x in s.summaries])
    warm = np.stack([x.n_warm for x in s.summaries])
    rej = np.stack([x.n_reject for x in s.summaries])
    # skip_time = 0: every arrival is counted once, served, rejected or left queued
    np.testing.assert_array_equal(s.arrivals, cold + warm + rej + s.queue_left)
    np.testing.assert_array_equal(s.enqueued, s.queue_served + s.queue_left)
    assert s.peak_cluster.max() == 5.0  # binding, never exceeded
    assert (s.queue_served <= s.enqueued).all()
    if queue_depth:
        assert s.queue_served.sum() > 0 and (s.queue_wait_avg >= 0).all()
    else:
        assert s.enqueued.sum() == 0 and s.queue_left.sum() == 0


def test_staging_merges_in_f64_then_casts():
    fleet = _port_fleet(sim_time=200.0)
    st = rfleet._stage_fleet(fleet, 7, 2, None, 200.0, "cpu")
    assert st["prestamped"] and st["times"].dtype == torch.float32
    assert st["fids"].dtype == torch.uint8
    assert (st["times"][:, 1:] >= st["times"][:, :-1]).all()
    K = sum(f.as_scenario(sim_time=200.0, skip_time=0.0, slots=16).steps_needed()
            for f in fleet.functions)
    assert st["times"].shape == (2, K)
    # function f's stream is its own generator's draws, in order
    from repro_torch.core.simulator import cell_generators, draw_workload_samples
    gens = cell_generators(7, 4, "cpu")[2]
    scn = fleet.functions[2].as_scenario(sim_time=200.0, skip_time=0.0, slots=16)
    arr, warms, _ = draw_workload_samples(scn, gens, 2, scn.steps_needed(), "cpu")
    mine = st["fids"] == 2
    np.testing.assert_array_equal(
        st["times"][0][mine[0]].numpy(), arr[0].double().cumsum(0).float().numpy()
    )
    np.testing.assert_array_equal(st["warms"][1][mine[1]].numpy(), warms[1].numpy())
    with pytest.raises(RuntimeError, match="ended before sim_time"):
        rfleet.fleet_run(fleet, 7, replicas=2, device="cpu", steps=20)


def test_sweep_is_one_launch_and_seeded():
    calls = []

    @rexec.register_backend("counting_ref", engines=("scan", "fleet"))
    def _counting(*a, **k):
        calls.append(tuple(a[0].shape))
        return _ref_fleet_rows(*a, **k)

    fleet = _port_fleet(sim_time=150.0)
    over = {"expiration_threshold": [10.0, 50.0, 90.0], "sim_time": [100.0, 150.0]}
    a = rfleet.fleet_sweep(fleet, over, 3, replicas=2, backend="counting_ref", device="cpu")
    assert calls == [(3 * 2 * 2, 4)]  # one launch: cells x replicas fleets
    assert a.shape == (3, 2, 4) and a.backend == "counting_ref"
    b = rfleet.fleet_sweep(fleet, over, 3, replicas=2, device="cpu")
    c = rfleet.fleet_sweep(fleet, over, 4, replicas=2, device="cpu")
    np.testing.assert_array_equal(a.avg_server_count, b.avg_server_count)
    assert not np.array_equal(a.avg_server_count, c.avg_server_count)


def test_catalog_matches_reference():
    assert rcat.catalog_names() == jcat.catalog_names()
    for name in jcat.catalog_names():
        assert interop.fleet_from_reference(jcat.fleet_of([name])) == rcat.fleet_of([name])
    kw = dict(n_cluster=24, queue_depth=2, skip_time=20.0, slots=32,
              overrides={"thumbnail": {"rate": 2.0}})
    names = list(jcat.catalog_names())
    assert interop.fleet_from_reference(jcat.fleet_of(names, **kw)) == rcat.fleet_of(names, **kw)
    with pytest.raises(KeyError, match="unknown catalog function"):
        rcat.get_function("nope")
    fleet = rcat.fleet_of(names).with_rates({"graph-bfs": 0.3})
    assert fleet.functions[-1].arrival_process.rate == 0.3
    with pytest.raises(KeyError, match="unknown function"):
        fleet.with_rates({"nope": 1.0})


def test_pointed_errors():
    fleet = _port_fleet(sim_time=100.0)
    kw = dict(replicas=1, device="cpu")
    fn = fleet.functions[0]
    nine = dataclasses.replace(
        fleet, functions=tuple(dataclasses.replace(fn, name=f"f{i}") for i in range(9))
    )
    with pytest.raises(ValueError, match="at most 8 functions.*Queue A item 2"):
        rfleet.fleet_run(nine, 0, **kw)
    with pytest.raises(NotImplementedError, match="Queue A item 4"):
        dataclasses.replace(fleet, faults=object())
    with pytest.raises(ValueError, match="fleet-capable combinations: engine='scan'"):
        rfleet.fleet_run(fleet, 0, engine="par", **kw)
    with pytest.raises(ValueError, match="fleet-capable"):
        rfleet.fleet_sweep(fleet, {"n_cluster": [2.0]}, 0, engine="temporal", **kw)
    with pytest.raises(NotImplementedError, match="Queue A item 2"):
        rfleet.fleet_run(fleet, 0, backend="scan", **kw)
    with pytest.raises(ValueError, match="compile-time"):
        rfleet.fleet_sweep(fleet, {"queue_depth": [1, 2]}, 0, **kw)
    with pytest.raises(ValueError, match="unknown fleet sweep axis"):
        rfleet.fleet_sweep(fleet, {"arrival_rate": [1.0]}, 0, **kw)
    with pytest.raises(ValueError, match="length-4"):
        rfleet.fleet_sweep(fleet, {"expiration_threshold": [(1.0, 2.0)]}, 0, **kw)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        rfleet.fleet_run(fleet, 0, backend="cuda", **kw)
    with pytest.raises(ValueError, match="staged"):
        rfleet.fleet_run(fleet, 0, staged={"times": torch.ones(1, 5)}, **kw)
    with pytest.raises(RuntimeError, match="overflow"):
        rfleet.fleet_run(dataclasses.replace(fleet, slots=1), 0, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rfleet.fleet_run(fleet, 0, replicas=1)


def test_new_modules_import_no_jax():
    code = (
        "import sys, repro_torch, repro_torch.core.fleet, repro_torch.data.catalog, "
        "repro_torch.kernels.fleet_event_step, repro_torch.interop\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
