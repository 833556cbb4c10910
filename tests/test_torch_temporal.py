"""The port's temporal engine against the reference: the plain PyTorch
``faas_sweep_ref(grid_times=...)`` vs the JAX mirror and the Pallas kernel
in interpret mode from a non-empty pool (grid columns exact);
``run(engine="temporal")`` with initial instances on the reference's own
draws vs the JAX ``run(engine="temporal", backend="ref")``; the guards.
The CUDA kernel's grid columns are held against the plain version in
``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ExpSimProcess, Scenario as JScenario
from repro.core import scenario as jscn
from repro.core.simulator import draw_workload_samples as j_draw
from repro.core.temporal import InstanceSnapshot as JSnapshot
from repro.kernels import ref as jref
from repro.kernels.faas_event_step import faas_sweep_pallas
from repro_torch import InstanceSnapshot, interop
from repro_torch.core import scenario as rscn
from repro_torch.core.temporal import _snapshots_to_pool
from repro_torch.kernels import faas_event_step as fes
from repro_torch.kernels.ref import ACC_COLS, faas_sweep_ref

# per-row sequential sums of identically computed values, and the grid
# columns (integer counts): equal bit for bit across frameworks
EXACT_COLS = [0, 1, 2, 5, 6, 7]
# columns 3-4 sum each event's run/idle time over the M slots; torch and
# XLA associate that sum differently, so it agrees to the last places
INTEGRAL_RTOL = 1e-5

SNAPSHOTS = [(30.0, 1.5, None), (120.0, None, 20.0), (5.0, 40.0, None)]


def _inputs(seed, R=8, M=16, K=256, G=21, prestamped=False, rate=0.6):
    rng = np.random.default_rng(seed)
    dts = rng.exponential(1 / rate, (R, K))
    horizon = K / rate
    if prestamped:
        dts = np.cumsum(dts, axis=1)
        dts[:, -K // 8:] = 1e30
    f32 = lambda x: np.asarray(x, np.float32)
    alive, creation, busy = _snapshots_to_pool(
        [InstanceSnapshot(age=a, remaining=r, idle_for=i) for a, r, i in SNAPSHOTS], M
    )
    t_end = horizon * rng.uniform(0.5, 0.9, R)
    # an unsorted grid: t = 0, points past some rows' horizons, a repeat
    grid = np.concatenate([[0.0], rng.uniform(0.0, horizon, G - 2), [horizon / 3]])
    rng.shuffle(grid)
    return dict(
        state=(
            np.broadcast_to(f32(alive), (R, M)).copy(),
            np.broadcast_to(f32(creation), (R, M)).copy(),
            np.broadcast_to(f32(busy), (R, M)).copy(),
            np.zeros((R,), np.float32),
        ),
        t_exp=f32(10.0 * rng.uniform(0.5, 1.5, R)),
        samples=(
            f32(dts),
            f32(rng.exponential(2.0, (R, K))),
            f32(rng.exponential(2.5, (R, K))),
        ),
        t_end=f32(t_end),
        skip=np.zeros((R,), np.float32),
        grid=f32(np.tile(grid, (R, 1))),
    )


def _port(inp, max_c, prestamped, fn=faas_sweep_ref):
    t = lambda x: torch.from_numpy(np.array(x))
    out = fn(
        *map(t, inp["state"]), t(inp["t_exp"]), *map(t, inp["samples"]),
        t_end=t(inp["t_end"]), skip=t(inp["skip"]), max_concurrency=max_c,
        prestamped=prestamped, grid_times=t(inp["grid"]),
    )
    return out.apply(lambda o: o.numpy())


def _jax_args(inp):
    return (
        *map(jnp.asarray, inp["state"]), jnp.asarray(inp["t_exp"]),
        *map(jnp.asarray, inp["samples"]),
    )


def _jax_kw(inp, max_c, prestamped):
    return dict(
        t_end=jnp.asarray(inp["t_end"]), skip=jnp.asarray(inp["skip"]),
        grid_times=jnp.asarray(inp["grid"]), n_grid=inp["grid"].shape[1],
        max_concurrency=max_c, prestamped=prestamped,
    )


def _assert_matches(port, ref, G):
    for a, b in zip(port[:4], ref[:4]):  # final pool state and clock
        np.testing.assert_array_equal(a, np.asarray(b))
    acc_p, acc_r = port[4], np.asarray(ref[4])
    assert acc_p.shape == acc_r.shape == (acc_p.shape[0], ACC_COLS + 3 * G)
    np.testing.assert_array_equal(acc_p[:, EXACT_COLS], acc_r[:, EXACT_COLS])
    np.testing.assert_array_equal(acc_p[:, ACC_COLS:], acc_r[:, ACC_COLS:])
    np.testing.assert_allclose(acc_p[:, 3:5], acc_r[:, 3:5], rtol=INTEGRAL_RTOL)


@pytest.mark.parametrize("max_c,prestamped", [(100, False), (3, False), (100, True)])
def test_plain_grid_matches_jax_mirror(max_c, prestamped):
    inp = _inputs(1, prestamped=prestamped)
    G = inp["grid"].shape[1]
    port = _port(inp, max_c, prestamped)
    ref = jref.faas_sweep_ref(*_jax_args(inp), **_jax_kw(inp, max_c, prestamped))
    _assert_matches(port, ref, G)
    grid_cols = port[4][:, ACC_COLS:]
    assert grid_cols[:, :G].sum() > 0 and grid_cols[:, G:2 * G].sum() > 0
    # the t = 0 point reads 0 in every column (the interval is open at t)
    at0 = inp["grid"][0] == 0.0
    assert not grid_cols[:, np.concatenate([at0] * 3)].any()


def test_plain_grid_matches_pallas_interpret():
    inp = _inputs(2, K=128)
    port = _port(inp, 100, False)
    ref = faas_sweep_pallas(
        *_jax_args(inp), **_jax_kw(inp, 100, False), block_r=8, block_k=64,
        interpret=True,
    )
    _assert_matches(port, ref, inp["grid"].shape[1])


def test_wrapper_runs_plain_grid_on_cpu_tensors():
    inp = _inputs(3, K=64)
    before = dict(fes.LAUNCH_COUNTS)
    via_wrapper = _port(inp, 100, False, fn=fes.faas_sweep)
    for a, b in zip(via_wrapper, _port(inp, 100, False)):
        np.testing.assert_array_equal(a, b)
    assert dict(fes.LAUNCH_COUNTS) == before  # no kernel ran


def _jax_base(**kw):
    d = dict(
        arrival_process=ExpSimProcess(rate=0.9),
        warm_service_process=ExpSimProcess(rate=1 / 1.991),
        cold_service_process=ExpSimProcess(rate=1 / 2.244),
        expiration_threshold=60.0,
        sim_time=400.0,
        skip_time=20.0,
        slots=16,
    )
    d.update(kw)
    return JScenario(**d)


@pytest.mark.parametrize("with_grid", [True, False])
def test_run_matches_reference(with_grid):
    base = _jax_base()
    grid = np.linspace(0.0, 400.0, 17) if with_grid else None
    key = jax.random.key(3)
    n = base.steps_needed()
    ref = jscn.run(
        base, key, replicas=4, engine="temporal", backend="ref", steps=n,
        grid=grid,
        initial_instances=[JSnapshot(age=a, remaining=r, idle_for=i) for a, r, i in SNAPSHOTS],
    )
    # the temporal engine draws with skip_time forced to 0
    cfg = JScenario.of(base, skip_time=0.0)
    parts = [tuple(np.asarray(x) for x in j_draw(cfg, key, 4, n))]
    port = rscn.run(
        interop.scenario_from_reference(base), 0, replicas=4, engine="temporal",
        device="cpu", staged=interop.staged_from_reference(parts), grid=grid,
        initial_instances=[InstanceSnapshot(age=a, remaining=r, idle_for=i)
                           for a, r, i in SNAPSHOTS],
        backend="ref",
    )
    p, r = port.temporal, ref.temporal
    assert p.grid.shape == (17 if with_grid else 33,)
    np.testing.assert_array_equal(p.grid, np.asarray(r.grid))
    for f in ("running_at", "idle_at", "total_at", "cold_prob_at"):
        np.testing.assert_array_equal(getattr(p, f), np.asarray(getattr(r, f)), err_msg=f)
    for f in ("n_cold", "n_warm", "n_reject", "sum_cold_resp", "sum_warm_resp"):
        np.testing.assert_array_equal(
            getattr(port.summary, f), np.asarray(getattr(ref.summary, f)), err_msg=f
        )
    for f in ("time_running", "time_idle"):
        np.testing.assert_allclose(
            getattr(port.summary, f), np.asarray(getattr(ref.summary, f)),
            rtol=INTEGRAL_RTOL,
        )
    assert port.summary.measured_time == ref.summary.measured_time == 400.0
    assert p.steady is port.summary
    assert p.total_at[0] == 0.0 and (p.total_at[1:] > 0).all()


def test_truncated_stream_raises():
    scn = interop.scenario_from_reference(_jax_base(sim_time=800.0, skip_time=0.0))
    with pytest.raises(RuntimeError, match="ended before sim_time"):
        rscn.run(scn, 0, replicas=2, engine="temporal", device="cpu", steps=50, backend="ref")


def test_temporal_engine_has_no_sweep_and_checks_its_inputs():
    scn = interop.scenario_from_reference(_jax_base())
    with pytest.raises(ValueError, match="does not support sweep"):
        rscn.sweep(scn, {"arrival_rate": [0.5]}, 0, device="cpu",
                   execution=rscn.Execution(engine="temporal", backend="ref"))
    with pytest.raises(ValueError, match="engine='temporal'"):
        rscn.run(scn, 0, device="cpu",
                 initial_instances=[InstanceSnapshot(age=1.0, remaining=1.0)], backend="ref")
    with pytest.raises(ValueError, match="exactly one"):
        InstanceSnapshot(age=1.0, remaining=1.0, idle_for=2.0)
    with pytest.raises(ValueError, match="slots"):
        rscn.run(scn, 0, replicas=2, engine="temporal", device="cpu",
                 initial_instances=[InstanceSnapshot(age=1.0, idle_for=1.0)] * 17, backend="ref")
