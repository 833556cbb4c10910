"""The port's f32 block engine against the reference: the plain PyTorch
``faas_sweep_ref`` vs the JAX mirror ``kernels.ref.faas_sweep_ref``, the
Pallas kernel in interpret mode and the event-driven ``simulate_pyref``
oracle; the kernel wrapper's CPU rule, refusals and launch count.  The
CUDA kernel itself is held against the plain version in
``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pyref import simulate_pyref
from repro.kernels import ref as jref
from repro.kernels.faas_event_step import faas_sweep_pallas
from repro_torch.kernels import faas_event_step as fes
from repro_torch.kernels.ref import faas_par_sweep_ref, faas_sweep_ref

# acc columns that are per-row sequential sums of identically computed
# values: equal bit for bit across frameworks
EXACT_COLS = [0, 1, 2, 5, 6, 7]
# columns 3-4 sum each event's run/idle time over the M slots; torch and
# XLA associate that sum differently, so each event's sum may differ in its
# last place and the difference accumulates over K <= 256 f32 additions
INTEGRAL_RTOL = 1e-5

CASES = [
    (10.0, 100, False),
    (3.0, 4, False),  # max_concurrency forces rejections
    (50.0, 2, False),
    (30.0, 100, True),  # absolute timestamps with an inert 1e30 tail
]


def _inputs(seed, R=16, M=16, K=256, t_exp=10.0, prestamped=False, rate=0.6):
    rng = np.random.default_rng(seed)
    dts = rng.exponential(1 / rate, (R, K))
    horizon = K / rate
    if prestamped:
        dts = np.cumsum(dts, axis=1)
        dts[:, -K // 8:] = 1e30
    f32 = lambda x: np.asarray(x, np.float32)
    return dict(
        state=(
            np.zeros((R, M), np.float32),
            np.full((R, M), -1e30, np.float32),
            np.full((R, M), -1e30, np.float32),
            np.zeros((R,), np.float32),
        ),
        t_exp=f32(t_exp * rng.uniform(0.5, 1.5, R)),
        samples=(
            f32(dts),
            f32(rng.exponential(2.0, (R, K))),
            f32(rng.exponential(2.5, (R, K))),
        ),
        t_end=f32(horizon * rng.uniform(0.5, 0.9, R)),
        skip=f32(horizon * rng.uniform(0.0, 0.1, R)),
    )


def _port(inp, max_c, prestamped, fn=faas_sweep_ref):
    t = lambda x: torch.from_numpy(np.array(x))
    out = fn(
        *map(t, inp["state"]), t(inp["t_exp"]), *map(t, inp["samples"]),
        t_end=t(inp["t_end"]), skip=t(inp["skip"]),
        max_concurrency=max_c, prestamped=prestamped,
    )
    return out.apply(lambda o: o.numpy())


def _assert_matches(port, ref):
    for a, b in zip(port[:4], ref[:4]):  # final pool state and clock
        np.testing.assert_array_equal(a, np.asarray(b))
    acc_p, acc_r = port[4], np.asarray(ref[4])
    np.testing.assert_array_equal(acc_p[:, EXACT_COLS], acc_r[:, EXACT_COLS])
    np.testing.assert_allclose(acc_p[:, 3:5], acc_r[:, 3:5], rtol=INTEGRAL_RTOL)


@pytest.mark.parametrize("t_exp,max_c,prestamped", CASES)
def test_plain_matches_jax_mirror(t_exp, max_c, prestamped):
    inp = _inputs(1, t_exp=t_exp, prestamped=prestamped)
    port = _port(inp, max_c, prestamped)
    ref = jref.faas_sweep_ref(
        *map(jnp.asarray, inp["state"]), jnp.asarray(inp["t_exp"]),
        *map(jnp.asarray, inp["samples"]),
        t_end=jnp.asarray(inp["t_end"]), skip=jnp.asarray(inp["skip"]),
        max_concurrency=max_c, prestamped=prestamped,
    )
    _assert_matches(port, ref)
    if max_c <= 4:
        assert port[4][:, 2].sum() > 0  # the case does exercise rejections


@pytest.mark.parametrize("t_exp,max_c,prestamped", [CASES[1], CASES[3]])
def test_plain_matches_pallas_interpret(t_exp, max_c, prestamped):
    inp = _inputs(2, t_exp=t_exp, prestamped=prestamped)
    port = _port(inp, max_c, prestamped)
    ref = faas_sweep_pallas(
        *map(jnp.asarray, inp["state"]), jnp.asarray(inp["t_exp"]),
        *map(jnp.asarray, inp["samples"]),
        t_end=jnp.asarray(inp["t_end"]), skip=jnp.asarray(inp["skip"]),
        max_concurrency=max_c, prestamped=prestamped,
        block_r=8, block_k=128, interpret=True,
    )
    _assert_matches(port, ref)


def test_counters_match_event_driven_oracle():
    inp = _inputs(7, t_exp=10.0)
    inp["t_end"] = np.full_like(inp["t_end"], np.inf)
    inp["skip"] = np.zeros_like(inp["skip"])
    out = _port(inp, 100, False)
    t_final, acc = out.t, out.acc
    dts, warms, colds = inp["samples"]
    for r in range(dts.shape[0]):
        ref = simulate_pyref(
            dts[r], warms[r], colds[r], float(inp["t_exp"][r]), 100,
            float(t_final[r]) + 1.0, 0.0,
        )
        assert (int(acc[r, 0]), int(acc[r, 1]), int(acc[r, 2])) == (
            ref.n_cold, ref.n_warm, ref.n_reject,
        )


@pytest.mark.parametrize("engine", ["pool", "par"])
@pytest.mark.parametrize("t_exp,max_c,prestamped", CASES[:2] + CASES[3:])
def test_plain_run_continues_in_chunks_bit_for_bit(engine, t_exp, max_c, prestamped):
    # a run split into chunks of events, each started from the last one's
    # pool, clock and accumulator (acc0 / state0), equals one call
    inp = _inputs(5, t_exp=t_exp, prestamped=prestamped)
    t = lambda x: torch.from_numpy(np.array(x))
    samples, t_exp_r = [t(x) for x in inp["samples"]], t(inp["t_exp"])
    kw = dict(t_end=t(inp["t_end"]), skip=t(inp["skip"]), max_concurrency=max_c,
              prestamped=prestamped)
    if engine == "pool":
        start = tuple(map(t, inp["state"]))

        def run(st, part):
            return faas_sweep_ref(*(start if st is None else st[:4]), t_exp_r, *part,
                                  acc0=None if st is None else st[4], **kw)[:5]
    else:
        kw.update(concurrency=3, slots=16)

        def run(st, part):
            return faas_par_sweep_ref(t_exp_r, *part, state0=st, **kw)
    whole = run(None, samples)
    st = None
    for lo in (0, 1, 60, 200):  # chunks of 1, 59, 140 and 56 events
        hi = {0: 1, 1: 60, 60: 200, 200: None}[lo]
        st = run(st, [x[:, lo:hi] for x in samples])
    for a, b in zip(whole, st):
        assert torch.equal(a, b)


@pytest.mark.parametrize("path", ["windows", "reliability", "crashes", "crashes_capacity",
                                  "capacity_grid"])
def test_plain_paths_continue_in_chunks_bit_for_bit(path):
    # the optional paths without retries or fused draws also continue from
    # the last chunk's pool, clock, accumulator and crash clocks (doom0)
    rng = np.random.default_rng(9)
    R, M, K = 12, 8, 150
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)
    samples = [t(rng.exponential(1 / 0.6, (R, K))), t(rng.exponential(2.0, (R, K))),
               t(rng.exponential(2.5, (R, K)))]
    start = (torch.zeros(R, M), torch.full((R, M), -1e30), torch.full((R, M), -1e30),
             torch.zeros(R))
    t_exp = t(30.0 * rng.uniform(0.5, 1.5, R))
    kw = dict(t_end=t(200.0 * rng.uniform(0.5, 0.9, R)), skip=t(rng.uniform(0, 10, R)),
              max_concurrency=5)
    events = {}
    if path == "windows":
        kw["window_bounds"] = t(np.tile(np.linspace(0.0, 240.0, 5), (R, 1)))
    if path == "reliability":
        kw.update(t_timeout=t(np.full(R, 3.0)), p_fail=t(np.full(R, 0.2)))
        events["fail_u"] = t(rng.uniform(size=(R, K)))
    if path.startswith("crashes"):
        kw["crash_rate"] = t(np.full(R, 0.03))
        events["crash_u"] = t(rng.uniform(size=(R, K)))
    if path.endswith(("capacity", "capacity_grid")):
        kw.update(cap_edges=t(np.tile([60.0, 120.0], (R, 1))),
                  cap_values=t(np.tile([5.0, 1.0, 4.0], (R, 1))))
    if path == "capacity_grid":
        del kw["cap_edges"], kw["cap_values"]
        kw["grid_times"] = t(np.tile(np.linspace(0.0, 180.0, 7), (R, 1)))
    whole = faas_sweep_ref(*start, t_exp, *samples, **kw, **events)
    st = None
    for lo, hi in ((0, 1), (1, 60), (60, 149), (149, K)):
        part = dict(kw, **{k: v[:, lo:hi] for k, v in events.items()})
        st = faas_sweep_ref(*(start if st is None else st[:4]), t_exp,
                            *(x[:, lo:hi] for x in samples),
                            acc0=None if st is None else st.acc,
                            doom0=None if st is None else st.doom, **part)
    for name, a, b in zip(whole._fields, whole, st):
        assert (a is None and b is None) or torch.equal(a, b), name
    if path.endswith("capacity"):
        assert whole.acc[:, -2].sum() > 0  # evictions happened


def test_wrapper_runs_plain_version_on_cpu_tensors():
    inp = _inputs(3, t_exp=3.0)
    before = dict(fes.LAUNCH_COUNTS)
    via_wrapper = _port(inp, 4, False, fn=fes.faas_sweep)
    for a, b in zip(via_wrapper, _port(inp, 4, False)):
        np.testing.assert_array_equal(a, b)
    assert dict(fes.LAUNCH_COUNTS) == before  # no kernel ran


PARTNER = {"crash_rate": "crash_u", "crash_u": "crash_rate", "cap_edges": "cap_values",
           "cap_values": "cap_edges"}


@pytest.mark.parametrize("name", ["crash_rate", "crash_u", "cap_edges", "cap_values"])
def test_wrapper_refuses_later_features(name):
    # the platform-fault inputs come in pairs: one alone is refused, and
    # with its partner the wrapper runs the fault path (on CPU tensors the
    # plain version), which appends the 3 fault columns
    inp = _inputs(4, R=8, M=4, K=8)
    faults = dict(crash_rate=torch.full((8,), 0.05), crash_u=torch.full((8, 8), 0.5),
                  cap_edges=torch.full((8, 1), 5.0), cap_values=torch.full((8, 2), 2.0))
    pair = {k: faults[k] for k in (name, PARTNER[name])}
    with pytest.raises(ValueError, match="come together"):
        _port(inp, 4, False, fn=lambda *a, **k: fes.faas_sweep(*a, **k, **{name: faults[name]}))
    out = _port(inp, 4, False, fn=lambda *a, **k: fes.faas_sweep(*a, **k, **pair))
    base = _port(inp, 4, False)
    assert out[4].shape == (8, base[4].shape[1] + 3)
    assert out.act is None and (out.doom is not None) == ("crash_u" in pair)


def test_wrapper_rejects_unknown_keyword():
    inp = _inputs(4, R=8, M=4, K=8)
    with pytest.raises(TypeError, match="bogus"):
        _port(inp, 4, False, fn=lambda *a, **k: fes.faas_sweep(*a, **k, bogus=1))
