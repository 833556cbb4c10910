"""The port's par engine (concurrency value > 1) against the reference: the
plain PyTorch ``faas_par_sweep_ref`` vs the JAX mirror
``kernels.ref.faas_par_sweep_ref`` and the Pallas ``par_sweep_pallas`` in
interpret mode; ``run(engine="par")`` on the reference's own draws vs the
JAX ``run(engine="par", backend="ref")``; the base engine's decisions at
c = 1; the wrapper's CPU rule.  The CUDA kernel itself is held against
the plain version in ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ExpSimProcess, Scenario as JScenario
from repro.core import scenario as jscn
from repro.core.simulator import draw_workload_samples as j_draw
from repro.kernels import ref as jref
from repro.kernels.faas_event_step import par_sweep_pallas
from repro_torch import interop
from repro_torch.core import scenario as rscn
from repro_torch.kernels import par_event_step as pes
from repro_torch.kernels.ref import faas_par_sweep_ref

# acc columns that are per-row sequential sums of identically computed
# values: equal bit for bit across frameworks
EXACT_COLS = [0, 1, 2, 5, 6, 7]
# columns 3-4 sum each event's run/idle time over the M slots and column 8
# the in-flight time over the M*c request slots; torch and XLA associate
# those sums differently (and the reference pads M to 128 lanes), so each
# event's sum may differ in its last place and the difference accumulates
# over K <= 256 f32 additions
INTEGRAL_RTOL = 1e-5
INTEGRAL_COLS = [3, 4, 8]

# (concurrency, max_concurrency, prestamped)
CASES = [
    (1, 100, False),
    (3, 100, False),
    (8, 100, False),
    (1, 2, False),  # instance cap forces rejections
    (3, 2, False),
    (3, 100, True),  # absolute timestamps with an inert 1e30 tail
]


def _inputs(seed, R=8, K=256, t_exp=10.0, prestamped=False, rate=1.5):
    rng = np.random.default_rng(seed)
    dts = rng.exponential(1 / rate, (R, K))
    horizon = K / rate
    if prestamped:
        dts = np.cumsum(dts, axis=1)
        dts[:, -K // 8:] = 1e30
    f32 = lambda x: np.asarray(x, np.float32)
    return dict(
        t_exp=f32(t_exp * rng.uniform(0.5, 1.5, R)),
        samples=(
            f32(dts),
            f32(rng.exponential(2.0, (R, K))),
            f32(rng.exponential(2.5, (R, K))),
        ),
        t_end=f32(horizon * rng.uniform(0.5, 0.9, R)),
        skip=f32(horizon * rng.uniform(0.0, 0.1, R)),
    )


def _port(inp, c, max_c, prestamped, slots=8, fn=faas_par_sweep_ref):
    t = lambda x: torch.from_numpy(np.array(x))
    out = fn(
        t(inp["t_exp"]), *map(t, inp["samples"]),
        t_end=t(inp["t_end"]), skip=t(inp["skip"]), max_concurrency=max_c,
        concurrency=c, slots=slots, prestamped=prestamped,
    )
    return [o.numpy() for o in out]


def _jax_kw(inp, c, max_c, prestamped, slots=8):
    return dict(
        t_end=jnp.asarray(inp["t_end"]), skip=jnp.asarray(inp["skip"]),
        max_concurrency=max_c, concurrency=c, slots=slots, prestamped=prestamped,
    )


def _assert_acc(acc_p, acc_r):
    acc_r = np.asarray(acc_r)
    assert acc_p.shape == acc_r.shape == (acc_p.shape[0], 9)
    np.testing.assert_array_equal(acc_p[:, EXACT_COLS], acc_r[:, EXACT_COLS])
    np.testing.assert_allclose(
        acc_p[:, INTEGRAL_COLS], acc_r[:, INTEGRAL_COLS], rtol=INTEGRAL_RTOL
    )


@pytest.mark.parametrize("c,max_c,prestamped", CASES)
def test_plain_matches_jax_mirror(c, max_c, prestamped):
    inp = _inputs(1, prestamped=prestamped)
    port = _port(inp, c, max_c, prestamped)
    ref = jref.faas_par_sweep_ref(
        jnp.asarray(inp["t_exp"]), *map(jnp.asarray, inp["samples"]),
        **_jax_kw(inp, c, max_c, prestamped),
    )
    _assert_acc(port[4], ref)
    alive, creation, finish, t_final, acc = port
    assert finish.shape == (8, c, 8) and alive.shape == creation.shape == (8, 8)
    if max_c == 2:
        assert acc[:, 2].sum() > 0  # the case does exercise rejections
    if c > 1 and max_c == 100:
        assert acc[:, 8].sum() > acc[:, 3].sum()  # requests share instances


@pytest.mark.parametrize("c,max_c,prestamped", [CASES[1], CASES[3], CASES[5]])
def test_plain_matches_pallas_interpret(c, max_c, prestamped):
    inp = _inputs(2, K=128, prestamped=prestamped)
    port = _port(inp, c, max_c, prestamped)
    ref = par_sweep_pallas(
        jnp.asarray(inp["t_exp"]), *map(jnp.asarray, inp["samples"]),
        **_jax_kw(inp, c, max_c, prestamped), block_r=8, block_k=64,
        interpret=True,
    )
    _assert_acc(port[4], ref)


def test_cold_starts_reuse_expired_slots():
    """A short keep-alive makes cold starts land on slots whose stale
    finishes are still in the row: the sub-slot is read before the wipe."""
    inp = _inputs(3, t_exp=0.5, rate=0.8)
    c, slots = 3, 4
    port = _port(inp, c, 100, False, slots=slots)
    ref = jref.faas_par_sweep_ref(
        jnp.asarray(inp["t_exp"]), *map(jnp.asarray, inp["samples"]),
        **_jax_kw(inp, c, 100, False, slots=slots),
    )
    _assert_acc(port[4], ref)
    assert (port[4][:, 0] > 4 * slots).all()  # every row re-used its slots
    assert port[4][:, 7].sum() == 0


def _jax_base(**kw):
    d = dict(
        arrival_process=ExpSimProcess(rate=1.5),
        warm_service_process=ExpSimProcess(rate=1 / 1.991),
        cold_service_process=ExpSimProcess(rate=1 / 2.244),
        expiration_threshold=30.0,
        sim_time=300.0,
        skip_time=20.0,
        slots=16,
    )
    d.update(kw)
    return JScenario(**d)


def _reference_run(base, key_seed, replicas, **kw):
    key = jax.random.key(key_seed)
    n = base.steps_needed()
    ref = jscn.run(base, key, replicas=replicas, backend="ref", steps=n, **kw)
    parts = [tuple(np.asarray(x) for x in j_draw(base, key, replicas, n))]
    return ref, interop.staged_from_reference(parts)


@pytest.mark.parametrize("c,max_c", [(3, 1000), (8, 1000), (2, 2)])
def test_run_matches_reference(c, max_c):
    base = _jax_base(concurrency_value=c, max_concurrency=max_c)
    ref, staged = _reference_run(base, 5, 4, engine="par")
    port = rscn.run(
        interop.scenario_from_reference(base), 0, replicas=4, engine="par",
        device="cpu", staged=staged,
        backend="ref",
    )
    p, r = port.summary, ref.summary
    assert type(p).__name__ == "ParSimulationSummary"
    for f in ("n_cold", "n_warm", "n_reject", "sum_cold_resp", "sum_warm_resp",
              "overflow"):
        np.testing.assert_array_equal(getattr(p, f), np.asarray(getattr(r, f)), err_msg=f)
    for f in ("time_running", "time_idle", "time_in_flight"):
        np.testing.assert_allclose(
            getattr(p, f), np.asarray(getattr(r, f)), rtol=INTEGRAL_RTOL, err_msg=f
        )
    assert p.measured_time == r.measured_time
    assert p.cold_start_prob == r.cold_start_prob
    assert p.rejection_prob == r.rejection_prob
    for f in ("avg_in_flight", "avg_instance_occupancy", "avg_server_count",
              "avg_response_time"):
        np.testing.assert_allclose(getattr(p, f), getattr(r, f), rtol=INTEGRAL_RTOL)
    assert port.temporal is None
    if max_c == 2:
        assert p.rejection_prob > 0


def test_c1_makes_the_base_engine_decisions():
    base = _jax_base(sim_time=400.0)
    ref, staged = _reference_run(base, 7, 3)
    scn = interop.scenario_from_reference(base)
    one = rscn.run(scn, 0, replicas=3, device="cpu", staged=staged, backend="ref")
    par = rscn.run(scn, 0, replicas=3, engine="par", device="cpu", staged=staged, backend="ref")
    for f in ("n_cold", "n_warm", "n_reject"):
        np.testing.assert_array_equal(getattr(par.summary, f), getattr(one.summary, f))
        np.testing.assert_array_equal(
            getattr(one.summary, f), np.asarray(getattr(ref.summary, f))
        )
    np.testing.assert_allclose(
        par.summary.time_running, one.summary.time_running, rtol=INTEGRAL_RTOL
    )
    # at c = 1 every running instance holds exactly one request
    np.testing.assert_allclose(
        par.summary.time_in_flight, par.summary.time_running, rtol=INTEGRAL_RTOL
    )


def test_wrapper_runs_plain_version_on_cpu_tensors():
    inp = _inputs(4)
    before = dict(pes.LAUNCH_COUNTS)
    via_wrapper = _port(inp, 3, 2, False, fn=pes.par_sweep)
    for a, b in zip(via_wrapper, _port(inp, 3, 2, False)):
        np.testing.assert_array_equal(a, b)
    assert dict(pes.LAUNCH_COUNTS) == before  # no kernel ran


def test_par_engine_has_no_sweep():
    scn = interop.scenario_from_reference(_jax_base(concurrency_value=3))
    with pytest.raises(ValueError, match="does not support sweep"):
        rscn.sweep(scn, {"arrival_rate": [0.5]}, 0, device="cpu",
                   execution=rscn.Execution(engine="par", backend="ref"))
    with pytest.raises(ValueError, match="engine='temporal'"):
        rscn.run(scn, 0, engine="par", device="cpu", grid=[0.0, 1.0], backend="ref")
