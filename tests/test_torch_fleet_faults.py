"""The port's fleet fault path against the reference: the plain
``fleet_sweep_ref`` with crashes and capacity churn vs the JAX mirror and
the Pallas ``fleet_sweep_pallas`` in interpret mode (the same numpy inputs,
laid out in the reference's 8-row blocks) at F = 1, 3 and 8; the
fleet-wide eviction tie rule; ``fleet_run``/``fleet_sweep`` on the
reference's own merged streams and crash uniforms vs the JAX
``backend="ref"`` front door; the inert model; the one-function fleet vs
``run()``; conservation and the ceilings; the pointed errors.  The CUDA
kernel is held against the plain version in ``test_torch_cuda.py``."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.core import fleet as jfleet
from repro.core.simulator import draw_crash_uniforms as j_draw_crash
from repro.kernels import ref as jref
from repro.kernels.faas_event_step import fleet_sweep_pallas
from repro_torch import interop
from repro_torch.core import faults as rfaults
from repro_torch.core import fleet as rfleet
from repro_torch.core import scenario as rscn
from repro_torch.kernels import fleet_event_step as fles
from repro_torch.kernels import ref as rref
from repro_torch.kernels.ref import FAULT_COLS, FLEET_ACC_COLS, fleet_sweep_ref
from test_torch_fleet import BLOCK, _blocks, _inputs, hetero_fleet

# per-function counts and sums of identically computed values are equal
# bit for bit; columns 3-4 sum each event's run/idle time over a function's
# M slots in torch's and XLA's orders, and the lifetimes may round one ulp
# apart between torch's and XLA's CPU log, so they agree within the last
# places of f32 over K <= 512 events
COLS = FLEET_ACC_COLS + FAULT_COLS
EXACT_COLS = [c for c in range(COLS) if c not in (3, 4)]
INTEGRAL_RTOL = 1e-5

# (F, prestamped, n_cluster, crashes, capacity)
CASES = [
    (1, False, math.inf, True, True),
    (3, True, 9.0, True, False),
    (3, False, 9.0, False, True),
    (8, True, 14.0, True, True),
]
CASE_IDS = [f"F{c[0]}-{'crash' if c[3] else ''}{'+' if c[3] and c[4] else ''}"
            f"{'cap' if c[4] else ''}" for c in CASES]


def fault_inputs(inp, seed, crashes, capacity):
    """Per-fleet crash rates, one crash uniform per stream event, and a
    per-fleet ceiling stepping 10 -> 3.5 -> 12 inside the horizon."""
    rng = np.random.default_rng(seed)
    N = inp["t_exp"].shape[0]
    S, K = inp["times"].shape
    horizon = float(inp["t_end"].max())
    kw = {}
    if crashes:
        kw["crash_rate"] = rng.uniform(0.01, 0.08, N).astype(np.float32)
        kw["crash_u"] = rng.random((S, K)).astype(np.float32)
    if capacity:
        kw["cap_edges"] = np.sort(rng.uniform(0.2, 0.8, (N, 2)) * horizon, 1).astype(np.float32)
        kw["cap_values"] = np.tile(np.float32([10.0, 3.5, 12.0]), (N, 1))
    return kw


def _port(inp, kw, prestamped, fn=fleet_sweep_ref):
    t = lambda x: torch.from_numpy(np.array(x))
    out = fn(
        *(t(inp[k]) for k in ("t_exp", "limit", "ncl", "t_end", "skip", "stream", "times",
                              "fids", "warms", "colds")),
        slots=inp["M"], prestamped=prestamped, **{k: t(v) for k, v in kw.items()},
    )
    return [o.numpy() for o in out]


def _fault_blocks(inp, kw):
    """The fault inputs in the reference's layout: per-fleet values on each
    of its 8 rows, the stream's crash uniforms copied into every row."""
    out = {}
    if "crash_u" in kw:
        out["crash_rate"] = jnp.asarray(np.repeat(kw["crash_rate"], BLOCK))
        out["crash_u"] = jnp.asarray(np.repeat(kw["crash_u"][inp["stream"]], BLOCK, axis=0))
    if "cap_values" in kw:
        out["cap_edges"] = jnp.asarray(np.repeat(kw["cap_edges"], BLOCK, axis=0))
        out["cap_values"] = jnp.asarray(np.repeat(kw["cap_values"], BLOCK, axis=0))
    return out


def _assert_same(acc_p, acc_r):
    N, F = acc_p.shape[:2]
    acc_r = np.asarray(acc_r).reshape(N, BLOCK, COLS)[:, :F]
    assert acc_p.shape == acc_r.shape
    np.testing.assert_array_equal(acc_p[..., EXACT_COLS], acc_r[..., EXACT_COLS])
    np.testing.assert_allclose(acc_p[..., 3:5], acc_r[..., 3:5], rtol=INTEGRAL_RTOL)


@pytest.mark.parametrize("F,prestamped,ncl,crashes,capacity", CASES, ids=CASE_IDS)
def test_plain_matches_jax_mirror(F, prestamped, ncl, crashes, capacity):
    inp = _inputs(30 + F, F, ncl, 1000, prestamped)
    kw = fault_inputs(inp, 40 + F, crashes, capacity)
    port = _port(inp, kw, prestamped)
    acc, _ = jref.fleet_sweep_ref(
        *_blocks(inp), **_fault_blocks(inp, kw), slots=inp["M"], block_r=BLOCK,
        prestamped=prestamped,
    )
    _assert_same(port[0], acc)
    acc_p = port[0]
    faults = acc_p[..., FLEET_ACC_COLS:].sum((0, 1))
    if crashes:
        assert faults[0] > 0 and faults[2] > 0  # crashes and interrupted arrivals
        doom = port[2]
        assert doom.shape == (*inp["t_exp"].shape, inp["M"]) and np.isfinite(doom).any()
    if capacity:
        assert faults[1] > 0  # evictions
    assert len(port) == 2 + int(crashes)
    # the peak stays within the cluster and the highest ceiling
    assert acc_p[..., 12].max() <= min(ncl, 12.0 if capacity else math.inf, F * inp["M"])


@pytest.mark.parametrize("F,prestamped,ncl,crashes,capacity", CASES[1:], ids=CASE_IDS[1:])
def test_plain_matches_pallas_interpret(F, prestamped, ncl, crashes, capacity):
    inp = _inputs(50 + F, F, ncl, 1000, prestamped)
    kw = fault_inputs(inp, 60 + F, crashes, capacity)
    acc, _ = fleet_sweep_pallas(
        *_blocks(inp), **_fault_blocks(inp, kw), slots=inp["M"], block_r=BLOCK,
        block_k=128, interpret=True, prestamped=prestamped,
    )
    _assert_same(_port(inp, kw, prestamped)[0], acc)


def test_eviction_ranks_the_fleet_by_flat_id_on_ties():
    # two functions cold-start two instances each at the same instant
    # (equal creation times); the ceiling steps to 1.5, so ceil(4 - 1.5) =
    # 3 of the tied idle instances go, the lowest flat ids f * M + m first:
    # function 0's two and function 1's slot 0; function 1's slot 1 stays
    M = 4
    times = np.float32([[1.0, 1.0, 1.0, 1.0, 2.0, 3.0]])
    fids = np.uint8([[0, 0, 1, 1, 1, 1]])
    t = lambda x: torch.from_numpy(np.asarray(x))
    half = np.full_like(times, 0.5)
    args = (t(np.float32([[100.0, 100.0]])), t(np.float32([[10.0, 10.0]])),
            t(np.float32([1e30])), t(np.float32([2.5])), t(np.float32([0.0])),
            t(np.int64([0])), t(times), t(fids), t(half), t(half))
    cap = dict(cap_edges=t(np.float32([[1.8]])), cap_values=t(np.float32([[10.0, 1.5]])))
    acc, _ = fleet_sweep_ref(*args, slots=M, prestamped=True, **cap)
    # function 1's 2.0 arrival found its slot-1 instance warm
    assert acc[0, :, 0].tolist() == [2.0, 2.0] and acc[0, :, 1].tolist() == [0.0, 1.0]
    assert acc[0, :, FLEET_ACC_COLS + 1].tolist() == [2.0, 1.0]  # evictions by function
    to_j = lambda x: jnp.asarray(np.repeat(np.asarray(x), BLOCK, axis=0))
    pad = lambda a, fill: jnp.asarray(np.concatenate(
        [np.asarray(a), np.full((1, BLOCK - 2), fill, np.float32)], 1).reshape(-1))
    ref, _ = jref.fleet_sweep_ref(
        pad(args[0], 1.0), pad(args[1], 0.0), to_j(np.repeat(1e30, 1)), to_j([2.5]),
        to_j([0.0]), to_j(times), to_j(fids.astype(np.float32)), to_j(half), to_j(half),
        cap_edges=to_j(cap["cap_edges"]), cap_values=to_j(cap["cap_values"]),
        slots=M, block_r=BLOCK, prestamped=True,
    )
    _assert_same(acc.numpy(), ref)


def test_wrapper_runs_plain_version_on_cpu_tensors():
    inp = _inputs(70, 3, 9.0, 1000, True)
    kw = fault_inputs(inp, 71, True, True)
    before = dict(fles.LAUNCH_COUNTS)
    via = _port(inp, kw, True, fn=fles.fleet_sweep)
    for a, b in zip(via, _port(inp, kw, True)):
        np.testing.assert_array_equal(a, b)
    assert dict(fles.LAUNCH_COUNTS) == before  # no kernel ran


@pytest.mark.parametrize("fn", [fleet_sweep_ref, fles.fleet_sweep], ids=["ref", "wrapper"])
def test_fault_inputs_are_checked(fn):
    inp = _inputs(72, 3, 9.0, 1000, False)
    kw = fault_inputs(inp, 73, True, True)
    t = lambda x: torch.from_numpy(np.array(x))
    args = [t(inp[k]) for k in ("t_exp", "limit", "ncl", "t_end", "skip", "stream", "times",
                                "fids", "warms", "colds")]
    faults = {k: t(v) for k, v in kw.items()}
    with pytest.raises(ValueError, match="queue_depth"):
        fn(*args, slots=inp["M"], queue_depth=2, **faults)
    if fn is fles.fleet_sweep:
        with pytest.raises(ValueError, match="come together"):
            fn(*args, slots=inp["M"], **dict(faults, crash_u=None))
        with pytest.raises(ValueError, match="come together"):
            fn(*args, slots=inp["M"], **dict(faults, cap_values=None))
        with pytest.raises(ValueError, match="strictly increasing"):
            fn(*args, slots=inp["M"], **dict(faults, cap_edges=faults["cap_edges"].flip(1)))


# ---------------------------------------------------------------------------
# the front door on the reference's own merged streams
# ---------------------------------------------------------------------------

ACTIVE = jfaults.FaultModel(
    crash_rate=0.01,
    capacity=jfaults.CapacityProfile(edges=(150.0, 280.0), values=(6.0, 2.5, 6.0)),
)
COUNTERS = ("n_cold", "n_warm", "n_reject", "sum_cold_resp", "sum_warm_resp", "overflow",
            "n_crash", "n_evict", "n_interrupt")


def _reference_staged(jf, key, replicas):
    staged = jfleet._stage_fleet(jf, key, replicas, None, jf.sim_time)
    if jf.faults is not None and jf.faults.crashes:
        staged["crash_u"] = np.asarray(j_draw_crash(key, replicas, staged["times"].shape[1]))
    return interop.fleet_staged_from_reference(staged)


@pytest.mark.parametrize(
    "faults",
    [ACTIVE, jfaults.FaultModel(crash_rate=0.02),
     dataclasses.replace(ACTIVE, crash_rate=0.0)],
    ids=["both", "crash", "cap"],
)
def test_fleet_run_matches_reference(faults):
    jf = hetero_fleet(queue_depth=0)
    jf = dataclasses.replace(jf, faults=faults)
    key = jax.random.key(2)
    ref = jfleet.fleet_run(jf, key, replicas=2, backend="ref")
    port = rfleet.fleet_run(interop.fleet_from_reference(jf), 0, replicas=2, device="cpu",
                            staged=_reference_staged(jf, key, 2), backend="ref")
    p, r = port.summary, ref.summary
    for sp, sr in zip(p.summaries, r.summaries):
        for f in COUNTERS:
            np.testing.assert_array_equal(getattr(sp, f), np.asarray(getattr(sr, f)),
                                          err_msg=f)
        for f in ("time_running", "time_idle"):
            np.testing.assert_allclose(getattr(sp, f), np.asarray(getattr(sr, f)),
                                       rtol=INTEGRAL_RTOL)
        np.testing.assert_allclose(sp.availability, sr.availability, rtol=1e-6)
    np.testing.assert_array_equal(p.peak_cluster, np.asarray(r.peak_cluster))
    crashes = sum(s.n_crash.sum() for s in p.summaries)
    evictions = sum(s.n_evict.sum() for s in p.summaries)
    assert (crashes > 0) == faults.crashes and (evictions > 0) == (faults.capacity is not None)


def test_fleet_sweep_runs_the_fault_path_in_one_launch(monkeypatch):
    jf = dataclasses.replace(hetero_fleet(queue_depth=0), faults=ACTIVE)
    fleet = interop.fleet_from_reference(jf)
    over = {"expiration_threshold": [10.0, 60.0], "n_cluster": [4.0, 8.0]}
    calls = []
    real = rref.fleet_sweep_ref

    def counting(*a, **kw):
        calls.append((tuple(a[0].shape), sorted(k for k in kw if kw[k] is not None)))
        return real(*a, **kw)

    monkeypatch.setattr(rref, "fleet_sweep_ref", counting)
    grid = rfleet.fleet_sweep(fleet, over, 3, replicas=2, device="cpu", backend="ref")
    monkeypatch.undo()
    faults = ["cap_edges", "cap_values", "crash_rate", "crash_u"]
    assert calls == [((2 * 2 * 2, 4), faults + ["prestamped", "queue_depth", "slots"])]
    assert grid.shape == (2, 2, 4) and grid.ok.all()
    assert (grid.availability <= 1.0).all() and (grid.availability < 1.0).any()
    for c in np.ndindex(grid.shape[:2]):
        run = rfleet.fleet_run(dataclasses.replace(
            fleet, n_cluster=over["n_cluster"][c[1]],
            functions=tuple(dataclasses.replace(f, expiration_threshold=over[
                "expiration_threshold"][c[0]]) for f in fleet.functions)),
            3, replicas=2, device="cpu", backend="ref")
        for f, s in enumerate(run.summary.summaries):
            for name in COUNTERS:
                np.testing.assert_array_equal(getattr(grid.summaries[c + (f,)], name),
                                              getattr(s, name), err_msg=name)


# ---------------------------------------------------------------------------
# the port's own draws
# ---------------------------------------------------------------------------


def test_inert_fault_model_is_a_noop():
    fleet = interop.fleet_from_reference(hetero_fleet(queue_depth=2))
    inert = dataclasses.replace(fleet, faults=rfaults.FaultModel())  # queues allowed
    a = rfleet.fleet_run(fleet, 5, replicas=2, device="cpu", backend="ref").summary
    b = rfleet.fleet_run(inert, 5, replicas=2, device="cpu", backend="ref").summary
    for sa, sb in zip(a.summaries, b.summaries):
        for f in COUNTERS[:6] + ("time_running", "time_idle"):
            np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f), err_msg=f)
        assert sb.n_crash is None and sb.availability == 1.0
    np.testing.assert_array_equal(a.queue_served, b.queue_served)


def test_one_function_fleet_is_run_under_faults():
    jf = jfleet.FleetScenario(
        functions=(hetero_fleet().functions[0],), sim_time=300.0, skip_time=10.0, slots=16,
        faults=ACTIVE,
    )
    fleet = interop.fleet_from_reference(jf)
    fn = fleet.functions[0]
    scn = rscn.Scenario.of(fn.as_scenario(sim_time=300.0, skip_time=10.0, slots=16),
                           faults=fleet.faults)
    a = rfleet.fleet_run(fleet, 8, replicas=3, device="cpu", backend="ref").summary.summaries[0]
    b = rscn.run(scn, 8, replicas=3, device="cpu", backend="ref").summary
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.n_crash.sum() > 0 and a.n_evict.sum() > 0


def test_conservation_and_the_ceiling():
    jf = dataclasses.replace(hetero_fleet(queue_depth=0, n_cluster=8.0), faults=ACTIVE)
    s = rfleet.fleet_run(interop.fleet_from_reference(jf), 4, replicas=3,
                         device="cpu", backend="ref").summary
    for f, fs in enumerate(s.summaries):
        # every arrival lands in one bucket, and a served one either
        # completes or is interrupted
        np.testing.assert_array_equal(s.arrivals[f], fs.n_cold + fs.n_warm + fs.n_reject)
        np.testing.assert_array_equal(fs.n_completions + fs.n_interrupt,
                                      fs.n_cold + fs.n_warm)
    assert s.max_peak_cluster <= 6.0  # the highest ceiling binds below n_cluster


def test_fleet_scenario_checks_faults():
    fleet = interop.fleet_from_reference(hetero_fleet(queue_depth=2))
    flt = interop.faults_from_reference(ACTIVE)
    with pytest.raises(ValueError, match="must be a FaultModel"):
        dataclasses.replace(fleet, faults=object())
    with pytest.raises(ValueError) as ref_err:
        dataclasses.replace(hetero_fleet(queue_depth=2), faults=ACTIVE)
    with pytest.raises(ValueError) as port_err:
        dataclasses.replace(fleet, faults=flt)
    assert str(port_err.value) == str(ref_err.value)
    jf = dataclasses.replace(hetero_fleet(queue_depth=0), faults=ACTIVE)
    assert interop.fleet_from_reference(jf).faults == flt
    with pytest.raises(ValueError, match="crash_u"):
        rfleet.fleet_run(interop.fleet_from_reference(jf), 0, replicas=2, device="cpu",
                         staged=_reference_staged(dataclasses.replace(jf, faults=None),
                                                  jax.random.key(0), 2), backend="ref")
