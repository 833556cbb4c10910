"""The port's slice end to end on the CPU: ``sweep``/``run`` on the
reference's own sample buffers against the JAX ``backend="ref"`` grid,
cell by cell and axis by axis; the axis partition, launch count, guards
and refusals of the port's front door."""

import itertools

import jax
import numpy as np
import pytest
import torch

import repro.core.processes as jproc
from repro.core import ExpSimProcess, Scenario as JScenario
from repro.core import scenario as jscn
from repro.core.simulator import draw_workload_samples as j_draw
from repro_torch import interop
from repro_torch.core import execution as rexec
from repro_torch.core import processes as rproc
from repro_torch.core import scenario as rscn
from repro_torch.kernels.ref import _ref_sweep_rows

# float metrics built from the run/idle integrals (acc columns 3-4): the
# per-event M-sums associate differently in torch and XLA, so they agree
# to the last places of f32, not bit for bit
FLOAT_RTOL = 1e-5
COUNTERS = ("n_cold", "n_warm", "n_reject", "sum_cold_resp", "sum_warm_resp", "overflow")
INTEGRALS = ("time_running", "time_idle")


def _jax_base(**kw):
    d = dict(
        arrival_process=ExpSimProcess(rate=0.9),
        warm_service_process=ExpSimProcess(rate=1 / 1.991),
        cold_service_process=ExpSimProcess(rate=1 / 2.244),
        expiration_threshold=60.0,
        sim_time=300.0,
        skip_time=20.0,
        slots=16,
    )
    d.update(kw)
    return JScenario(**d)


def _reference_parts(base, over, key, replicas, n_steps):
    """The reference sweep's chained draw walk (one split per draw cell,
    in the product order of the draw axes)."""
    draw_names = [n for n in over if n in jscn._DRAW_FIELDS]
    max_sim = float(max(over.get("sim_time", (base.sim_time,))))
    parts = []
    for combo in itertools.product(*[over[n] for n in draw_names]):
        c = base
        for n, v in zip(draw_names, combo):
            c = jscn._apply_axis(c, n, v)
        key, sub = jax.random.split(key)
        c_sim = JScenario.of(c, sim_time=max_sim)
        parts.append(tuple(np.asarray(x) for x in j_draw(c_sim, sub, replicas, n_steps)))
    return parts


def _assert_summary(port, ref):
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), err_msg=f)
    for f in INTEGRALS:
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f), rtol=FLOAT_RTOL)
    assert port.measured_time == ref.measured_time
    assert port.cold_start_prob == ref.cold_start_prob
    assert port.rejection_prob == ref.rejection_prob


@pytest.mark.parametrize("max_c", [1000, 3])
def test_sweep_matches_reference_grid(max_c):
    # non-canonical axis order: a param axis first, then two draw axes
    over = {
        "sim_time": [150.0, 300.0],
        "arrival_rate": [0.5, 1.2],
        "expiration_threshold": [20.0, 200.0],
    }
    base = _jax_base(max_concurrency=max_c)
    R = 3
    n = max(
        JScenario.of(base, arrival_rate=r, sim_time=300.0).steps_needed()
        for r in over["arrival_rate"]
    )
    key = jax.random.key(11)
    ref = jscn.sweep(base, over, key, replicas=R, backend="ref", steps=n)
    staged = interop.staged_from_reference(_reference_parts(base, over, key, R, n))
    port = rscn.sweep(
        interop.scenario_from_reference(base), over, 0,
        replicas=R, device="cpu", staged=staged,
        backend="ref",
    )
    assert port.axes == ref.axes and port.shape == ref.shape == (2, 2, 2)
    assert port.backend == "ref" and port.ok.all()
    for idx in np.ndindex(port.shape):
        _assert_summary(port.summaries[idx], ref.summaries[idx])
    for f in ("cold_start_prob", "rejection_prob"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    for f in ("avg_server_count", "avg_running_count", "avg_idle_count",
              "wasted_ratio", "avg_response_time", "developer_cost",
              "provider_cost", "goodput", "availability"):
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f), rtol=FLOAT_RTOL)
    if max_c == 3:
        assert (port.rejection_prob > 0).any()
    cell = dict(sim_time=300.0, arrival_rate=1.2, expiration_threshold=20.0)
    _assert_summary(port.cell(**cell), ref.cell(**cell))
    np.testing.assert_allclose(
        port.sel(arrival_rate=0.5).avg_server_count,
        ref.sel(arrival_rate=0.5).avg_server_count,
        rtol=FLOAT_RTOL,
    )


def test_run_matches_reference():
    base = _jax_base(sim_time=400.0)
    key = jax.random.key(5)
    n = base.steps_needed()
    ref = jscn.run(base, key, replicas=4, backend="ref", steps=n)
    parts = [tuple(np.asarray(x) for x in j_draw(base, key, 4, n))]
    port = rscn.run(
        interop.scenario_from_reference(base), 0, replicas=4, device="cpu",
        staged=interop.staged_from_reference(parts),
        backend="ref",
    )
    _assert_summary(port.summary, ref.summary)
    assert port.to_dict().keys() <= ref.to_dict().keys()
    np.testing.assert_allclose(
        port.cost.developer_total, ref.cost.developer_total, rtol=FLOAT_RTOL
    )


def _port_base(**kw):
    return interop.scenario_from_reference(_jax_base(**kw))


def test_sweep_is_one_launch_per_static_combo():
    calls = []

    @rexec.register_backend("counting_ref")
    def _counting(*a, **k):
        calls.append(a[0].shape[0])
        return _ref_sweep_rows(*a, **k)

    over = {
        "max_concurrency": [2, 50],
        "expiration_threshold": [20.0, 200.0],
        "arrival_rate": [0.5, 1.0],
        "skip_time": [0.0, 10.0],
    }
    grid = rscn.sweep(_port_base(sim_time=120.0), over, 3, replicas=2,
                      backend="counting_ref", device="cpu")
    assert calls == [2 * 2 * 2 * 2, 2 * 2 * 2 * 2]  # one launch per static value
    assert grid.shape == (2, 2, 2, 2) and grid.backend == "counting_ref"
    # the static axis really changed the program: fewer rejections at 50
    rej = grid.rejection_prob
    assert (rej[0] >= rej[1]).all() and rej[0].sum() > rej[1].sum()


def test_sweep_is_seeded():
    over = {"arrival_rate": [0.5, 1.0], "sim_time": [80.0, 120.0]}
    scn = _port_base(sim_time=120.0)
    a = rscn.sweep(scn, over, 7, replicas=2, device="cpu", backend="ref")
    b = rscn.sweep(scn, over, 7, replicas=2, device="cpu", backend="ref")
    c = rscn.sweep(scn, over, 8, replicas=2, device="cpu", backend="ref")
    np.testing.assert_array_equal(a.avg_server_count, b.avg_server_count)
    assert not np.array_equal(a.avg_server_count, c.avg_server_count)
    # param cells share their draw cell's buffers (common random numbers)
    inp = rscn.sweep_inputs(scn, over, 7, replicas=2, device="cpu")
    dts = inp.samples[0]
    assert dts.shape[0] == 2 * 2 * 2
    assert torch.equal(dts[0:2], dts[2:4]) and not torch.equal(dts[0:2], dts[4:6])
    assert list(inp.sim_rows) == [80.0, 80.0, 120.0, 120.0] * 2


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; the default device resolves to it")
    scn = _port_base()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rscn.sweep(scn, {"arrival_rate": [0.5]}, 0, backend="ref")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rscn.run(scn, 0, backend="ref")


def test_plan_resolution_and_registry_errors():
    assert rexec.Execution(device="cpu", backend="ref").resolve()[0].name == "ref"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        rexec.Execution(backend="cuda", device="cpu").resolve()
    with pytest.raises(ValueError, match=r"registered backends: \[.*'cuda'.*'ref'"):
        rexec.resolve_backend("bogus")
    with pytest.raises(
        ValueError, match=r"registered engines: \['scan', 'temporal', 'par'\]"
    ):
        rexec.Execution(engine="bogus", device="cpu", backend="ref").resolve()
    with pytest.raises(TypeError):
        rexec.plan_of("ref")


def test_guards():
    scn = _port_base(sim_time=200.0)
    with pytest.raises(RuntimeError, match="ended before sim_time"):
        rscn.run(scn, 0, replicas=2, device="cpu", steps=20, backend="ref")
    tight = _port_base(slots=2, max_concurrency=100, sim_time=200.0)
    with pytest.raises(RuntimeError, match="overflow"):
        rscn.sweep(tight, {"arrival_rate": [2.0]}, 0, replicas=2, device="cpu", backend="ref")
    with pytest.raises(ValueError, match="staged buffers"):
        rscn.run(scn, 0, replicas=3, device="cpu",
                 staged=(torch.ones(2, 5), torch.ones(2, 5), torch.ones(2, 5)), backend="ref")


def test_grid_selection_and_export():
    over = {"expiration_threshold": [20.0, 200.0], "arrival_rate": [0.5, 1.0]}
    grid = rscn.sweep(_port_base(sim_time=120.0), over, 1, replicas=2, device="cpu", backend="ref")
    one = grid.sel(arrival_rate=1.0)
    assert list(one.axes) == ["expiration_threshold"] and one.shape == (2,)
    assert one.avg_server_count[1] == grid.avg_server_count[1, 1]
    assert grid.cell(expiration_threshold=20.0, arrival_rate=0.5) is grid.summaries[0, 0]
    with pytest.raises(KeyError, match="axes"):
        grid.axis("bogus")
    with pytest.raises(KeyError, match="values"):
        grid.sel(arrival_rate=3.0)
    d = grid.to_dict()
    assert d["axes"] == {k: list(v) for k, v in over.items()}
    assert d["device"] == "cpu" and np.asarray(d["ok"]).all()


@pytest.mark.parametrize(
    "kw,item",
    [
        (dict(faults=object()), "platform faults"),
        (dict(track_histogram=True), "f64 engine"),
        (dict(routing="oldest"), "f64 engine"),
        (dict(rate_profile=object()), "RateProfile"),
    ],
)
def test_scenario_refuses_later_layers(kw, item):
    base = _port_base()
    if item == "platform faults":
        # platform faults are ported: a fault model must be a FaultModel
        with pytest.raises(ValueError, match="must be a FaultModel"):
            rscn.Scenario.of(base, **kw)
        return
    if item == "RateProfile":
        # rate profiles are ported: a profile beside an arrival process is
        # the reference's refusal, and a non-RateProfile is refused
        with pytest.raises(ValueError) as ref:
            JScenario.of(_jax_base(), rate_profile=jproc.SinusoidalRate(1.0, 0.5, 10.0))
        with pytest.raises(ValueError, match="not both") as port:
            rscn.Scenario.of(base, rate_profile=rproc.SinusoidalRate(1.0, 0.5, 10.0))
        assert str(port.value) == str(ref.value)
        with pytest.raises(TypeError, match="must be a repro_torch RateProfile"):
            rscn.Scenario.of(base, arrival_process=None, **kw)
        return
    # histograms and oldest-first routing are the f64 engine's: the
    # scenario builds, the block backends refuse it with the reference's
    # message, and backend="scan_ref" serves it
    scn = rscn.Scenario.of(base, **kw)
    with pytest.raises(ValueError) as ref:
        jscn.run(JScenario.of(_jax_base(), **kw), jax.random.key(0), replicas=1,
                 backend="ref")
    with pytest.raises(ValueError) as port:
        rscn.run(scn, 0, replicas=1, device="cpu", backend="ref")
    assert str(port.value) == str(ref.value)
    res = rscn.run(scn, 0, replicas=2, device="cpu", backend="scan_ref")
    assert np.isfinite(res.avg_server_count)
    if "track_histogram" in kw:
        np.testing.assert_allclose(res.summary.histogram.sum(1), res.summary.measured_time)


@pytest.mark.parametrize(
    "axis",
    ["capacity", "profile", "crash_rate", "scan_unroll", "hist_bins"],
)
def test_sweep_refuses_later_axes(axis):
    if axis in ("capacity", "crash_rate"):
        # the fault axes are ported: they need Scenario.faults, as in the
        # reference
        with pytest.raises(ValueError, match="needs Scenario.faults="):
            rscn.sweep(_port_base(), {axis: [1.0]}, 0, device="cpu", backend="ref")
        return
    if axis == "profile":
        # the profile axis is ported: a value that is not a RateProfile is
        # the reference's TypeError
        with pytest.raises(TypeError) as ref:
            jscn.sweep(_jax_base(), {axis: [1.0]}, jax.random.key(0), backend="ref")
        with pytest.raises(TypeError, match="expected RateProfile") as port:
            rscn.sweep(_port_base(), {axis: [1.0]}, 0, device="cpu", backend="ref")
        assert str(port.value) == str(ref.value)
        return
    # the f64 engine's knobs are static axes, as in the reference: on the
    # block backends (which ignore them) and on backend="scan_ref" without
    # a histogram every value gives the same cells
    over = {axis: [1, 2], "expiration_threshold": [20.0]}
    for backend in ("ref", "scan_ref"):
        grid = rscn.sweep(_port_base(), over, 0, replicas=2, device="cpu", backend=backend)
        assert grid.shape == (2, 1)
        np.testing.assert_array_equal(grid.cold_start_prob[0], grid.cold_start_prob[1])
        np.testing.assert_array_equal(grid.avg_server_count[0], grid.avg_server_count[1])


def test_sweep_rejects_unknown_axis():
    with pytest.raises(ValueError, match="sweepable fields"):
        rscn.sweep(_port_base(), {"bogus": [1.0]}, 0, device="cpu", backend="ref")
