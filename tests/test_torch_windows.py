"""The port's metric windows against the reference: the plain
``faas_sweep_ref`` with irregular window bounds against the JAX mirror and
the Pallas kernel in interpret mode (narrow windows several to an
interval, windows past the horizon, before the first arrival), and
``sweep()`` with ``window_bounds`` on the reference's own buffers against
the JAX ``backend="ref"`` grid; the windowed fields, the static axis,
conservation and the refusals.  The CUDA kernel is held against the plain
version in ``test_torch_cuda.py``."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ExpSimProcess, Scenario as JScenario
from repro.core import scenario as jscn
from repro.core.simulator import draw_workload_samples as j_draw
from repro.kernels import ref as jref
from repro.kernels.faas_event_step import faas_sweep_pallas
from repro_torch import interop
from repro_torch.core import scenario as rscn
from repro_torch.kernels.ref import faas_sweep_ref

# each window's integral columns sum the M slots' terms per event, as
# columns 3-4 do: torch and XLA associate the sum differently
INTEGRAL_RTOL = 1e-5
FLOAT_RTOL = 1e-5
IRREGULAR = (0.0, 60.0, 150.0, 350.0, 400.0)  # widths 60 / 90 / 200 / 50


def window_rows(kind, R, horizon, rng):
    """[R, W+1] bounds: irregular inside the horizon, narrow (several per
    inter-arrival gap), or reaching past the horizon and starting late."""
    if kind == "irregular":
        return np.sort(rng.uniform(0, horizon, (R, 5)), axis=1)
    if kind == "narrow":
        return np.tile(np.linspace(0.0, horizon, 241), (R, 1))
    return np.tile(np.array([horizon * 0.3, horizon * 0.5, horizon * 1.5, horizon * 3.0]),
                   (R, 1))


def _inputs(seed, kind, R=16, M=16, K=200, rate=0.8):
    rng = np.random.default_rng(seed)
    horizon = K / rate
    f32 = lambda x: np.asarray(x, np.float32)
    return dict(
        state=(f32(np.zeros((R, M))), f32(np.full((R, M), -1e30)),
               f32(np.full((R, M), -1e30)), f32(np.zeros(R))),
        t_exp=f32(10 * rng.uniform(0.5, 1.5, R)),
        samples=(f32(rng.exponential(1 / rate, (R, K))),
                 f32(rng.exponential(2.0, (R, K))), f32(rng.exponential(2.5, (R, K)))),
        t_end=f32(horizon * rng.uniform(0.5, 0.9, R)),
        skip=f32(horizon * rng.uniform(0.0, 0.1, R)),
        window_bounds=f32(window_rows(kind, R, horizon, rng)),
    )


def _assert_matches(port, ref, W):
    for a, b in zip(port[:4], ref[:4]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    acc_p, acc_r = np.asarray(port[4]), np.asarray(ref[4])
    assert acc_p.shape == acc_r.shape == (acc_p.shape[0], 8 + 5 * W)
    integ = [3, 4] + list(range(8 + 3 * W, 8 + 5 * W))
    exact = [c for c in range(acc_p.shape[1]) if c not in integ]
    np.testing.assert_array_equal(acc_p[:, exact], acc_r[:, exact])
    np.testing.assert_allclose(acc_p[:, integ], acc_r[:, integ], rtol=INTEGRAL_RTOL,
                               atol=1e-6)


def _port(inp, max_c):
    t = lambda x: torch.from_numpy(np.array(x))
    out = faas_sweep_ref(
        *map(t, inp["state"]), t(inp["t_exp"]), *map(t, inp["samples"]),
        t_end=t(inp["t_end"]), skip=t(inp["skip"]), max_concurrency=max_c,
        window_bounds=t(inp["window_bounds"]),
    )
    return out.apply(lambda o: o.numpy())


def _jax_args(inp):
    return (*map(jnp.asarray, inp["state"]), jnp.asarray(inp["t_exp"]),
            *map(jnp.asarray, inp["samples"]))


def _jax_kw(inp, max_c):
    return dict(t_end=jnp.asarray(inp["t_end"]), skip=jnp.asarray(inp["skip"]),
                window_bounds=jnp.asarray(inp["window_bounds"]), max_concurrency=max_c,
                n_windows=inp["window_bounds"].shape[1] - 1)


@pytest.mark.parametrize("kind", ["irregular", "narrow", "past_horizon"])
@pytest.mark.parametrize("max_c", [3, 100])
def test_plain_matches_jax_mirror(kind, max_c):
    inp = _inputs(1, kind)
    W = inp["window_bounds"].shape[1] - 1
    port = _port(inp, max_c)
    ref = jref.faas_sweep_ref(*_jax_args(inp), **_jax_kw(inp, max_c))
    _assert_matches(port, ref, W)
    acc = port[4]
    assert acc[:, 8 + 2 * W:8 + 3 * W].sum() > 0  # windows saw arrivals
    assert acc[:, 8 + 3 * W:8 + 4 * W].sum() > 0  # and running time


@pytest.mark.parametrize("kind", ["irregular", "narrow", "past_horizon"])
def test_plain_matches_pallas_interpret(kind):
    inp = _inputs(2, kind)
    W = inp["window_bounds"].shape[1] - 1
    port = _port(inp, 3)
    ref = faas_sweep_pallas(*_jax_args(inp), **_jax_kw(inp, 3),
                            block_r=8, block_k=100, interpret=True)
    _assert_matches(port, ref, W)


def test_window_counts_follow_the_arrivals():
    inp = _inputs(3, "irregular")
    inp["skip"] = np.zeros_like(inp["skip"])
    inp["window_bounds"] = np.tile(
        np.linspace(0.0, float(inp["t_end"].max()), 9, dtype=np.float32), (16, 1))
    W = 8
    acc = _port(inp, 3)[4]
    # windows tiling [0, max t_end] hold every arrival inside each horizon,
    # rejects included, and every served one; the integrals add up too
    np.testing.assert_array_equal(acc[:, 8 + 2 * W:8 + 3 * W].sum(1), acc[:, :3].sum(1))
    np.testing.assert_array_equal(acc[:, 8 + W:8 + 2 * W].sum(1), acc[:, :2].sum(1))
    np.testing.assert_array_equal(acc[:, 8:8 + W].sum(1), acc[:, 0])
    np.testing.assert_allclose(acc[:, 8 + 3 * W:8 + 4 * W].sum(1), acc[:, 3], rtol=1e-5)
    np.testing.assert_allclose(acc[:, 8 + 4 * W:8 + 5 * W].sum(1), acc[:, 4], rtol=1e-5)


# ---------------------------------------------------------------------------
# sweep() on the reference's buffers
# ---------------------------------------------------------------------------


def _jax_base(**kw):
    d = dict(
        arrival_process=ExpSimProcess(rate=0.8),
        warm_service_process=ExpSimProcess(rate=0.5),
        cold_service_process=ExpSimProcess(rate=0.4),
        expiration_threshold=20.0,
        sim_time=400.0,
        skip_time=0.0,
        slots=32,
        window_bounds=IRREGULAR,
    )
    d.update(kw)
    return JScenario(**d)


def reference_parts(base, over, key, replicas, n_steps):
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


WINDOW_FIELDS = ("n_cold", "n_warm", "n_arrivals")


def _assert_windows(port, ref):
    np.testing.assert_array_equal(port.bounds, ref.bounds)
    for f in WINDOW_FIELDS:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), err_msg=f)
    for f in ("time_running", "time_idle"):
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f), rtol=FLOAT_RTOL,
                                   atol=1e-6)


@pytest.mark.parametrize("max_c", [1000, 2])
def test_sweep_matches_reference_grid(max_c):
    over = {"expiration_threshold": [10.0, 30.0], "skip_time": [0.0, 50.0]}
    base = _jax_base(max_concurrency=max_c)
    R, n = 2, 800
    key = jax.random.key(7)
    ref = jscn.sweep(base, over, key, replicas=R, backend="ref", steps=n)
    staged = interop.staged_from_reference(reference_parts(base, over, key, R, n))
    port = rscn.sweep(interop.scenario_from_reference(base), over, 0, replicas=R,
                      device="cpu", staged=staged, backend="ref")
    assert port.shape == ref.shape == (2, 2)
    for idx in np.ndindex(port.shape):
        _assert_windows(port.summaries[idx].windows, ref.summaries[idx].windows)
        np.testing.assert_array_equal(port.summaries[idx].n_cold, ref.summaries[idx].n_cold)
    np.testing.assert_array_equal(port.window_bounds, ref.window_bounds)
    np.testing.assert_array_equal(port.windowed_cold_prob, ref.windowed_cold_prob)
    np.testing.assert_array_equal(port.windowed_arrivals, ref.windowed_arrivals)
    np.testing.assert_allclose(port.windowed_instance_count, ref.windowed_instance_count,
                               rtol=FLOAT_RTOL)
    assert port.windowed_cold_prob.shape == (2, 2, 4)
    one = port.sel(skip_time=50.0)
    assert one.windowed_arrivals.shape == (2, 4)
    np.testing.assert_array_equal(one.windowed_arrivals, port.windowed_arrivals[:, 1])
    d = port.to_dict()
    assert d["window_bounds"] == list(IRREGULAR) and len(d["windowed_cold_prob"]) == 2


def test_windows_with_retries_match_reference():
    from repro.core import reliability as jrel
    from repro.core.simulator import draw_reliability_stream as j_draw_rely

    rel = jrel.Reliability(
        failure=jrel.FailurePolicy(p_fail=0.1, t_timeout=3.0),
        retry=jrel.RetryPolicy(max_retries=1, backoff_base=1.0),
    )
    base = _jax_base(reliability=rel, max_concurrency=3, sim_time=200.0,
                     window_bounds=(0.0, 30.0, 90.0, 200.0))
    over = {"t_timeout": [1.0, 4.0]}
    R, n = 2, base.steps_needed()
    key = jax.random.key(5)
    ref = jscn.sweep(base, over, key, replicas=R, backend="ref", steps=n)
    _, sub = jax.random.split(key)
    smp, ext = j_draw_rely(base, sub, R, n)
    staged = interop.staged_from_reference(
        [(tuple(map(np.asarray, smp)), tuple(map(np.asarray, ext)))])
    port = rscn.sweep(interop.scenario_from_reference(base), over, 0, replicas=R,
                      device="cpu", staged=staged, backend="ref")
    for idx in np.ndindex(port.shape):
        p, r = port.summaries[idx], ref.summaries[idx]
        _assert_windows(p.windows, r.windows)
        for f in ("n_timeout", "n_fail", "n_retry", "n_abandon"):
            np.testing.assert_array_equal(getattr(p, f), getattr(r, f))
    np.testing.assert_array_equal(port.windowed_arrivals, ref.windowed_arrivals)


def test_window_bounds_is_a_static_axis(monkeypatch):
    calls = []
    launch = rscn._block_launch

    def counting(*a, **k):
        calls.append(k["window_rows"].shape)
        return launch(*a, **k)

    monkeypatch.setattr(rscn, "_block_launch", counting)
    base = interop.scenario_from_reference(_jax_base(sim_time=200.0, window_bounds=None))
    over = {"window_bounds": [(0.0, 100.0, 200.0), (0.0, 50.0, 120.0, 200.0)],
            "expiration_threshold": [10.0, 30.0]}
    grid = rscn.sweep(base, over, 3, replicas=2, device="cpu", backend="ref")
    assert calls == [(4, 3), (4, 4)]  # one launch per window grid, every row in it
    assert grid.windowed_cold_prob is None and grid.window_bounds is None
    for i, wb in enumerate(over["window_bounds"]):
        for j in range(2):
            w = grid.summaries[i, j].windows
            assert tuple(w.bounds) == wb and w.n_cold.shape == (2, len(wb) - 1)
            # the windows tile [0, sim_time]: they hold every arrival
            s = grid.summaries[i, j]
            np.testing.assert_array_equal(w.n_arrivals.sum(1), s.n_requests)
    # both window grids saw the same draws: the same decisions
    np.testing.assert_array_equal(grid.cold_start_prob[0], grid.cold_start_prob[1])


def test_windowed_run_is_not_ported():
    # windowed single runs are the f64 engine's: the block backends refuse
    # them with the reference's message, backend="scan_ref" serves them
    scn = interop.scenario_from_reference(_jax_base())
    with pytest.raises(ValueError) as ref:
        jscn.run(_jax_base(), jax.random.key(0), replicas=2, backend="ref")
    with pytest.raises(ValueError, match="windowed single runs need backend='scan'") as port:
        rscn.run(scn, 0, replicas=2, device="cpu", backend="ref")
    assert str(port.value) == str(ref.value)
    res = rscn.run(scn, 0, replicas=2, device="cpu", backend="scan_ref")
    w = res.summary.windows
    assert w is not None and w.n_arrivals.shape == (2, len(scn.window_bounds) - 1)


@pytest.mark.parametrize("bounds", [(0.0,), (0.0, 10.0, 10.0), (5.0, 1.0)])
def test_window_bounds_validation_matches_reference(bounds):
    with pytest.raises(ValueError) as ref_err:
        _jax_base(window_bounds=bounds)
    port = interop.scenario_from_reference(_jax_base(window_bounds=None))
    with pytest.raises(ValueError) as port_err:
        rscn.Scenario.of(port, window_bounds=bounds)
    assert str(port_err.value) == str(ref_err.value)


def test_scenario_carries_window_bounds():
    scn = interop.scenario_from_reference(_jax_base(window_bounds=[0, 10, 25.5]))
    assert scn.window_bounds == (0.0, 10.0, 25.5)
