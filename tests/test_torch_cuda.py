"""The CUDA kernels against their plain PyTorch versions on the card: the
simulator's event-loop kernels and the serving path's attention kernels.

Needs an NVIDIA GPU and nvcc; every test skips without a visible GPU.
This file imports no JAX, so on a machine without JAX it runs alone:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.kernels import faas_event_step as fes  # noqa: E402
from repro_torch.kernels import par_event_step as pes  # noqa: E402
from repro_torch.kernels.ref import faas_par_sweep_ref, faas_sweep_ref  # noqa: E402

# per-row sequential sums of identically computed values: equal bit for bit
EXACT_COLS = [0, 1, 2, 5, 6, 7]
# columns 3-4: the kernel sums each event's run/idle time over the M slots
# in a warp-tree order, torch in its own; the last-place differences
# accumulate over K = 300 f32 additions
INTEGRAL_RTOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda", 0)


def _inputs(dev, seed, R, M, K, t_exp, prestamped, rate=0.6):
    rng = np.random.default_rng(seed)
    dts = rng.exponential(1 / rate, (R, K))
    horizon = K / rate
    if prestamped:
        dts = np.cumsum(dts, axis=1)
        dts[:, -K // 8:] = 1e30
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    args = (
        torch.zeros((R, M), dtype=torch.float32, device=dev),
        torch.full((R, M), -1e30, dtype=torch.float32, device=dev),
        torch.full((R, M), -1e30, dtype=torch.float32, device=dev),
        torch.zeros((R,), dtype=torch.float32, device=dev),
        t(t_exp * rng.uniform(0.5, 1.5, R)),
        t(dts),
        t(rng.exponential(2.0, (R, K))),
        t(rng.exponential(2.5, (R, K))),
    )
    kw = dict(t_end=t(horizon * rng.uniform(0.5, 0.9, R)),
              skip=t(horizon * rng.uniform(0.0, 0.1, R)))
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize(
    "M,t_exp,max_c,prestamped",
    [
        (40, 10.0, 100, False),
        (40, 3.0, 4, False),  # rejections
        (7, 50.0, 100, False),  # one slot per lane, slots past M masked
        (130, 30.0, 1000, True),  # five slots per lane, absolute timestamps
    ],
)
def test_kernel_matches_plain(cuda_device, M, t_exp, max_c, prestamped):
    args, kw = _inputs(cuda_device, 5, 37, M, 300, t_exp, prestamped)
    kw.update(max_concurrency=max_c, prestamped=prestamped)
    before = fes.LAUNCH_COUNTS["faas_sweep"]
    out_k = fes.faas_sweep(*args, **kw).apply(lambda o: o.cpu().numpy())
    assert fes.LAUNCH_COUNTS["faas_sweep"] == before + 1
    out_p = faas_sweep_ref(*args, **kw).apply(lambda o: o.cpu().numpy())
    for a, b in zip(out_k[:4], out_p[:4]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out_k[4][:, EXACT_COLS], out_p[4][:, EXACT_COLS])
    np.testing.assert_allclose(out_k[4][:, 3:5], out_p[4][:, 3:5], rtol=INTEGRAL_RTOL)


@pytest.mark.cuda
def test_wrapper_checks_inputs(cuda_device):
    args, kw = _inputs(cuda_device, 6, 8, 8, 64, 10.0, False)
    state, t_exp, (dts, warms, colds) = args[:4], args[4], args[5:]
    with pytest.raises(ValueError, match="contiguous"):
        fes.faas_sweep(*state, t_exp, dts.t().contiguous().t(), warms, colds,
                       max_concurrency=4)
    with pytest.raises(ValueError, match="float32"):
        fes.faas_sweep(*state, t_exp, dts.double(), warms, colds, max_concurrency=4)
    with pytest.raises(ValueError, match="shape"):
        fes.faas_sweep(*state, t_exp, dts[:, :10].contiguous(), warms, colds,
                       max_concurrency=4)


# ---------------------------------------------------------------------------
# the par kernel and the grid columns of faas_sweep
# ---------------------------------------------------------------------------

# column 8 sums each event's in-flight time over the M*c request slots:
# the kernel per lane then by warp tree, torch in its own order
PAR_INTEGRAL_COLS = [3, 4, 8]


def _par_inputs(dev, seed, R, K, t_exp, prestamped, rate=1.5, shift=0.0):
    rng = np.random.default_rng(seed)
    dts = rng.exponential(1 / rate, (R, K))
    horizon = K / rate
    if prestamped:
        dts = np.cumsum(dts, axis=1)
        dts[:, -K // 8:] = 1e30
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    args = (
        t(t_exp * rng.uniform(0.5, 1.5, R)),
        t(dts),
        t(rng.exponential(2.0, (R, K)) - shift),
        t(rng.exponential(2.5, (R, K))),
    )
    kw = dict(t_end=t(horizon * rng.uniform(0.5, 0.9, R)),
              skip=t(horizon * rng.uniform(0.0, 0.1, R)))
    return args, kw


def _par_case(M, c, t_exp, max_c, prestamped, rate=1.5, shift=0.0, id=None):
    return pytest.param(M, c, t_exp, max_c, prestamped, rate, shift,
                        id=id or f"{M}-{c}-{t_exp}-{max_c}-{prestamped}")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "M,c,t_exp,max_c,prestamped,rate,shift",
    [
        _par_case(40, 1, 10.0, 100, False),
        _par_case(40, 3, 10.0, 4, False),  # rejections
        _par_case(7, 80, 30.0, 100, False),  # one slot per lane, 80 sub-slots
        _par_case(130, 3, 30.0, 1000, True),  # five slots per lane, absolute timestamps
        _par_case(4, 3, 0.5, 100, False),  # cold starts into expired, stale slots
        # c at and past a warp's width, arrivals fast enough that several
        # instances are live: a pass over a row spans one, two, three words a lane
        _par_case(64, 32, 30.0, 100, False, rate=40.0, id="c32-several-live"),
        _par_case(64, 33, 30.0, 100, False, rate=40.0, id="c33-several-live"),
        _par_case(64, 80, 30.0, 100, False, rate=100.0, id="c80-several-live"),
        # the last c the owner lane walks alone, and the first spread over lanes
        _par_case(64, 3, 30.0, 100, False, rate=20.0, id="c3-owner-walk"),
        _par_case(64, 4, 30.0, 100, False, rate=20.0, id="c4-spread"),
        # warm services below zero: a warm request replaces the instance's
        # maximal finish with a smaller one, so busy falls
        _par_case(16, 4, 10.0, 100, False, rate=3.0, shift=1.5, id="busy-falls"),
    ],
)
def test_par_kernel_matches_plain(cuda_device, M, c, t_exp, max_c, prestamped, rate, shift):
    args, kw = _par_inputs(cuda_device, 8, 37, 300, t_exp, prestamped, rate, shift)
    kw.update(max_concurrency=max_c, concurrency=c, slots=M, prestamped=prestamped)
    before = pes.LAUNCH_COUNTS["par_sweep"]
    out_k = [o.cpu().numpy() for o in pes.par_sweep(*args, **kw)]
    assert pes.LAUNCH_COUNTS["par_sweep"] == before + 1
    out_p = [o.cpu().numpy() for o in faas_par_sweep_ref(*args, **kw)]
    for a, b in zip(out_k[:4], out_p[:4]):  # alive, creation, finish, t
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out_k[4][:, EXACT_COLS], out_p[4][:, EXACT_COLS])
    np.testing.assert_allclose(
        out_k[4][:, PAR_INTEGRAL_COLS], out_p[4][:, PAR_INTEGRAL_COLS],
        rtol=INTEGRAL_RTOL,
    )
    if rate > 10:  # several instances took requests in most rows
        assert (out_k[0].sum(1) >= 2).mean() > 0.5
    if shift:  # some warm service ended before it started
        assert (args[2].cpu().numpy() < 0).any() and out_k[4][:, 1].sum() > 0


def _shuffled(times, rows, lo, hi, seed):
    """``times`` with events [lo, hi) of ``rows`` in a random order: the
    prestamped clock goes back and forth there."""
    g = torch.Generator().manual_seed(seed)
    out = times.clone()
    for r in rows:
        perm = torch.randperm(hi - lo, generator=g).to(times.device) + lo
        out[r, lo:hi] = times[r, perm]
    return out


def _clock_goes_back(times, rows, skip, t_end):
    """Whether the clock clipped to [skip, t_end] goes back in each row."""
    hi = torch.minimum(torch.maximum(times[rows], skip[:, None]), t_end[:, None])
    return (hi[:, 1:] < hi[:, :-1]).any(1).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("faults", [False, True])
def test_par_and_fleet_recount_a_clock_that_goes_back(cuda_device, faults):
    # the kernels accrue the integrals per state span; where the clipped
    # clock goes back, the plain version counts the interval it went back
    # over again, and so must they: every output as the plain version's
    if not faults:
        args, kw = _par_inputs(cuda_device, 12, 16, 300, 10.0, True, rate=3.0)
        times = _shuffled(args[1], range(0, 16, 2), 100, 140, 0)  # even rows
        assert _clock_goes_back(times, slice(0, 16, 2), kw["skip"][::2], kw["t_end"][::2]).all()
        kw.update(max_concurrency=100, concurrency=3, slots=16, prestamped=True)
        out_k = [o.cpu().numpy() for o in pes.par_sweep(args[0], times, *args[2:], **kw)]
        out_p = [o.cpu().numpy() for o in faas_par_sweep_ref(args[0], times, *args[2:], **kw)]
        for a, b in zip(out_k[:4], out_p[:4]):  # alive, creation, finish, t
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(out_k[4][:, EXACT_COLS], out_p[4][:, EXACT_COLS])
        np.testing.assert_allclose(out_k[4][:, PAR_INTEGRAL_COLS],
                                   out_p[4][:, PAR_INTEGRAL_COLS], rtol=INTEGRAL_RTOL)
        assert np.isfinite(out_k[4]).all()
    fargs, fkw = _fleet_inputs(cuda_device, 16, 3, 4.0, 1000, True, 16)
    fargs = list(fargs)
    fargs[6] = _shuffled(fargs[6], (0, 1), 50, 90, 1)  # stream rows 0 and 1
    N, (S, K) = fargs[0].shape[0], fargs[6].shape
    sel = fargs[5] <= 1  # the fleets that read those rows
    assert _clock_goes_back(fargs[6][fargs[5][sel]], slice(None), fargs[4][sel],
                            fargs[3][sel]).all()
    cols = FLEET_EXACT_COLS
    if faults:
        rng = np.random.default_rng(17)
        t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=cuda_device)
        horizon = float(fargs[3].max())
        fkw.update(crash_rate=t(rng.uniform(0.01, 0.05, N)), crash_u=t(rng.random((S, K))),
                   cap_edges=t(np.sort(rng.uniform(0.2, 0.8, (N, 2)), 1) * horizon),
                   cap_values=t(np.tile([12.0, 6.5, 16.0], (N, 1))))
        cols = [c for c in range(16) if c not in (3, 4)]
    out_f = [o.cpu().numpy() for o in fles.fleet_sweep(*fargs, **fkw)]
    out_r = [o.cpu().numpy() for o in fleet_sweep_ref(*fargs, **fkw)]
    np.testing.assert_array_equal(out_f[0][..., cols], out_r[0][..., cols])
    np.testing.assert_allclose(out_f[0][..., 3:5], out_r[0][..., 3:5], rtol=INTEGRAL_RTOL)
    for a, b in zip(out_f[1:], out_r[1:]):  # queue lengths, crash clocks
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(out_f[0]).all()
    # faas_sweep, whose rows accrue the same way: with metric windows (the
    # cursor recounts the windows the clock went back over) and with crashes
    # and a ceiling, on even rows whose times are shuffled
    args, kw = _inputs(cuda_device, 18, 16, 16, 300, 10.0, True)
    times = _shuffled(args[5], range(0, 16, 2), 100, 140, 2)
    assert _clock_goes_back(times, slice(0, 16, 2), kw["skip"][::2], kw["t_end"][::2]).all()
    args = args[:5] + (times,) + args[6:]
    kw.update(max_concurrency=100, prestamped=True)
    horizon = float(kw["t_end"].max())
    W = 0
    if faults:
        kw.update(_fault_kw(cuda_device, 19, 16, 300, True, True, horizon))
    else:
        W = 5
        rng = np.random.default_rng(19)
        kw["window_bounds"] = torch.tensor(np.sort(rng.uniform(0, horizon, (16, W + 1)), 1),
                                           dtype=torch.float32, device=cuda_device)
    out = _held_rely(fes.faas_sweep(*args, **kw), faas_sweep_ref(*args, **kw), W)
    assert np.isfinite(out[4]).all()


@pytest.mark.cuda
def test_faas_grid_columns_match_plain(cuda_device):
    R, M, K, G = 37, 40, 300, 45
    args, kw = _inputs(cuda_device, 9, R, M, K, 10.0, False)
    rng = np.random.default_rng(10)
    # a non-empty pool: a third of the slots live, some running at t = 0
    alive = (rng.uniform(size=(R, M)) < 0.3).astype(np.float32)
    creation = np.where(alive > 0, -rng.uniform(0, 100, (R, M)), -1e30)
    busy = np.where(alive > 0, rng.uniform(-20, 5, (R, M)), -1e30)
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=cuda_device)
    args = (t(alive), t(creation), t(busy)) + args[3:]
    horizon = K / 0.6
    grid = np.concatenate([[0.0], rng.uniform(0, horizon, G - 1)])
    rng.shuffle(grid)
    kw.update(max_concurrency=100, grid_times=t(np.tile(grid, (R, 1))))
    before = fes.LAUNCH_COUNTS["faas_sweep_grid"]
    out_k = fes.faas_sweep(*args, **kw).apply(lambda o: o.cpu().numpy())
    assert fes.LAUNCH_COUNTS["faas_sweep_grid"] == before + 1
    out_p = faas_sweep_ref(*args, **kw).apply(lambda o: o.cpu().numpy())
    for a, b in zip(out_k[:4], out_p[:4]):
        np.testing.assert_array_equal(a, b)
    assert out_k[4].shape == (R, 8 + 3 * G)
    np.testing.assert_array_equal(out_k[4][:, EXACT_COLS], out_p[4][:, EXACT_COLS])
    np.testing.assert_array_equal(out_k[4][:, 8:], out_p[4][:, 8:])
    np.testing.assert_allclose(out_k[4][:, 3:5], out_p[4][:, 3:5], rtol=INTEGRAL_RTOL)
    assert out_k[4][:, 8:8 + G].sum() > 0


@pytest.mark.cuda
def test_new_wrappers_refuse_past_their_caps(cuda_device):
    args, kw = _par_inputs(cuda_device, 11, 8, 64, 10.0, False)
    with pytest.raises(ValueError, match="M\\*c must be"):
        pes.par_sweep(*args, **kw, max_concurrency=10, concurrency=1000, slots=64)
    fargs, fkw = _inputs(cuda_device, 12, 8, 8, 64, 10.0, False)
    too_many = torch.zeros((8, fes.MAX_GRID + 1), device=cuda_device)
    with pytest.raises(ValueError, match="grid points"):
        fes.faas_sweep(*fargs, **fkw, max_concurrency=4, grid_times=too_many)


@pytest.mark.cuda
def test_run_engines_launch_the_kernels(cuda_device):
    import repro_torch as rt

    scn = rt.Scenario(
        arrival_process=rt.ExpSimProcess(rate=2.0),
        warm_service_process=rt.ExpSimProcess(rate=1 / 1.991),
        cold_service_process=rt.ExpSimProcess(rate=1 / 2.244),
        expiration_threshold=60.0, sim_time=600.0, skip_time=50.0, slots=32,
        concurrency_value=3,
    )
    fes.LAUNCH_COUNTS.clear()
    par = rt.run(scn, 0, replicas=16, engine="par", backend="cuda")
    tmp = rt.run(scn, 0, replicas=16, engine="temporal", grid=[0.0, 300.0, 600.0],
                 initial_instances=[rt.InstanceSnapshot(age=30.0, remaining=1.5)], backend="cuda")
    assert fes.LAUNCH_COUNTS["par_sweep"] == 1
    assert fes.LAUNCH_COUNTS["faas_sweep_grid"] == 1
    assert np.isfinite(par.summary.avg_in_flight) and par.summary.avg_in_flight > 0
    assert tmp.temporal.total_at[0] == 0.0 and tmp.temporal.total_at[2] > 0


# ---------------------------------------------------------------------------
# the fleet kernel
# ---------------------------------------------------------------------------

from repro_torch.core.fleet import live_bound  # noqa: E402
from repro_torch.kernels import fleet_event_step as fles  # noqa: E402
from repro_torch.kernels.ref import fleet_sweep_ref  # noqa: E402

# fleet columns that are per-function sums of identically computed values,
# the queue columns and the peak: equal bit for bit
FLEET_EXACT_COLS = [0, 1, 2, 5, 6, 7, 8, 9, 10, 11, 12]


def _fleet_inputs(dev, seed, F, ncl, limits, prestamped, M, streams=9, cells=3, K=400,
                  rate=1.2, whole_seconds=False):
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1 / rate, (streams, K))
    if whole_seconds:  # arrivals on whole seconds, several at once: creation ties
        gaps = np.diff(np.floor(np.cumsum(gaps, axis=1)), axis=1, prepend=0.0)
    N = streams * cells
    horizon = K / rate
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    args = (
        t(rng.uniform(3.0, 25.0, (N, F))),
        t(np.broadcast_to(np.asarray(limits, np.float64), (N, F))),
        t(np.full(N, 1e30 if ncl is None else ncl)),
        t(horizon * rng.uniform(0.6, 0.9, N)),
        t(horizon * rng.uniform(0.0, 0.1, N)),
        torch.arange(streams, device=dev).repeat(cells),
        t(np.cumsum(gaps, axis=1) if prestamped else gaps),
        torch.tensor(rng.integers(0, F, (streams, K)), dtype=torch.uint8, device=dev),
        t(rng.exponential(2.0, (streams, K))),
        t(rng.exponential(2.5, (streams, K))),
    )
    return args, dict(slots=M, prestamped=prestamped)


def _host_bound(args, M):
    """The live-instance bound the front door passes (core/fleet.py)."""
    return live_bound(args[2].cpu().numpy(), args[1].cpu().numpy(), M)


def _fleet_case(F, Q, prestamped, ncl, limits, M, rate=1.2, id=None):
    return pytest.param(F, Q, prestamped, ncl, limits, M, rate, id=id)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "F,Q,prestamped,ncl,limits,M,rate",
    [
        # two slots per lane, slots past M masked
        _fleet_case(1, 0, False, None, 1000, 40, id="1-0-False-None-1000-40"),
        # a queue behind a binding cluster
        _fleet_case(1, 2, False, 3.0, 1000, 16, id="1-2-False-3.0-1000-16"),
        # F padded to 4 in the bitmap
        _fleet_case(3, 2, True, 4.0, (3, 2, 5), 64, id="3-2-True-4.0-limits2-64"),
        # every function's limit binds
        _fleet_case(8, 0, True, None, 2, 16, id="8-0-True-None-2-16"),
        _fleet_case(8, 2, True, 6.0, 1000, 16, id="8-2-True-6.0-1000-16"),
        # the catalog benchmark's layout
        _fleet_case(8, 0, True, 24.0, 1000, 64, id="8-0-True-24.0-1000-64"),
        # the live table exactly full (one entry a lane), and one past (two)
        _fleet_case(8, 0, True, 32.0, 1000, 64, rate=6.0, id="table-full"),
        _fleet_case(8, 0, True, 33.0, 1000, 64, rate=6.0, id="table-one-past-full"),
        # an unbounded cluster whose limits let hundreds live (16 entries a lane)
        _fleet_case(8, 0, True, None, 1000, 64, rate=40.0, id="unbounded-hundreds"),
    ],
)
def test_fleet_kernel_matches_plain(cuda_device, F, Q, prestamped, ncl, limits, M, rate):
    args, kw = _fleet_inputs(cuda_device, 13 + F + Q, F, ncl, limits, prestamped, M,
                             rate=rate)
    kw["queue_depth"] = Q
    acc_p, q_p = (o.cpu().numpy() for o in fleet_sweep_ref(*args, **kw))
    # the front door's table (the host bound) and the widest (F * M)
    for bound in (_host_bound(args, M), None):
        before = fles.LAUNCH_COUNTS["fleet_sweep"]
        acc_k, q_k = (o.cpu().numpy() for o in fles.fleet_sweep(*args, **kw, live_bound=bound))
        assert fles.LAUNCH_COUNTS["fleet_sweep"] == before + 1
        np.testing.assert_array_equal(acc_k[..., FLEET_EXACT_COLS],
                                      acc_p[..., FLEET_EXACT_COLS])
        np.testing.assert_allclose(acc_k[..., 3:5], acc_p[..., 3:5], rtol=INTEGRAL_RTOL)
        np.testing.assert_array_equal(q_k, q_p)
    assert acc_k[..., 0].sum() > 0 and acc_k[..., 8].sum() > 0
    if Q:
        assert acc_k[..., 10].sum() > 0
    if rate > 1.2:  # the table filled as far as the case says
        peak = acc_k[..., 12].max()
        assert peak == ncl if ncl is not None else peak > 64


@pytest.mark.cuda
def test_fleet_table_past_its_bound_gives_nan(cuda_device):
    # a bound below the true live count: the fleets that outgrow the table
    # say so with NaN outputs, the others are untouched
    args, kw = _fleet_inputs(cuda_device, 15, 8, 40.0, 1000, True, 64, rate=6.0)
    acc_k, q_k = (o.cpu().numpy() for o in fles.fleet_sweep(*args, **kw, live_bound=32))
    acc_p, q_p = (o.cpu().numpy() for o in fleet_sweep_ref(*args, **kw))
    over = acc_p[:, 0, 12] > 32
    assert over.any() and (~over).any()
    assert np.isnan(acc_k[over]).all() and np.isnan(q_k[over]).all()
    np.testing.assert_array_equal(acc_k[~over][..., FLEET_EXACT_COLS],
                                  acc_p[~over][..., FLEET_EXACT_COLS])


@pytest.mark.cuda
def test_fleet_wrapper_checks_inputs(cuda_device):
    args, kw = _fleet_inputs(cuda_device, 14, 3, 4.0, 5, True, 16)
    args = list(args)
    launches = fles.LAUNCH_COUNTS["fleet_sweep"]

    def call(i=None, x=None, **more):
        a = list(args)
        if i is not None:
            a[i] = x
        return fles.fleet_sweep(*a, **{**kw, **more})

    with pytest.raises(ValueError, match="uint8"):
        call(7, args[7].int())
    with pytest.raises(ValueError, match="contiguous"):
        call(6, args[6].t().contiguous().t())
    with pytest.raises(ValueError, match="shape"):
        call(8, args[8][:, :10].contiguous())
    with pytest.raises(ValueError, match="is on cpu"):  # no CPU fallback
        call(0, args[0].cpu())
    with pytest.raises(ValueError, match="queue_depth"):
        call(queue_depth=fles.MAX_QUEUE + 1)
    with pytest.raises(ValueError, match="registers"):
        call(slots=512)
    with pytest.raises(ValueError, match="come together"):  # crash_u is missing
        call(crash_rate=args[2])
    crash_u = torch.rand(args[6].shape, device=cuda_device)
    with pytest.raises(ValueError, match="queue"):
        call(queue_depth=2, crash_rate=args[2], crash_u=crash_u)
    with pytest.raises(ValueError, match="shape"):
        call(crash_rate=args[2], crash_u=crash_u[:, :10].contiguous())
    assert fles.LAUNCH_COUNTS["fleet_sweep"] == launches  # nothing launched
    # the launch reads nothing back: a fleet whose stream row lies past the
    # stream's rows reads no stream and gets NaN outputs; the others are
    # untouched
    bad = args[5].clone()
    bad[0] = args[6].shape[0]
    acc_b, q_b = (o.cpu().numpy() for o in call(5, bad))
    acc_g, q_g = (o.cpu().numpy() for o in call())
    assert np.isnan(acc_b[0]).all() and np.isnan(q_b[0]).all()
    np.testing.assert_array_equal(acc_b[1:], acc_g[1:])
    np.testing.assert_array_equal(q_b[1:], q_g[1:])
    assert fles.LAUNCH_COUNTS["fleet_sweep"] == launches + 2


@pytest.mark.cuda
def test_fleet_front_door_launches_the_kernel(cuda_device):
    import repro_torch as rt
    from repro_torch.data.catalog import fleet_of

    fleet = fleet_of(["thumbnail", "compression", "ml-inference"], n_cluster=4,
                     queue_depth=2, sim_time=600.0, skip_time=20.0, slots=16)
    fles.LAUNCH_COUNTS.clear()
    res = rt.fleet_run(fleet, 0, replicas=16, backend="cuda")
    grid = rt.fleet_sweep(fleet, {"expiration_threshold": [30.0, 300.0],
                                  "n_cluster": [4.0, 8.0]}, 0, replicas=16, backend="cuda")
    assert fles.LAUNCH_COUNTS["fleet_sweep"] == 2
    assert res.summary.max_peak_cluster <= 4.0 and res.summary.enqueued.sum() > 0
    assert grid.shape == (2, 2, 3) and grid.ok.all()
    cpu = rt.fleet_sweep(fleet, {"expiration_threshold": [30.0, 300.0],
                                 "n_cluster": [4.0, 8.0]}, 0, replicas=16, device="cpu",
                         backend="ref")
    # the draws differ by device (torch generators), so compare statistics
    assert abs(float(grid.cold_start_prob.mean()) - float(cpu.cold_start_prob.mean())) < 0.1


# ---------------------------------------------------------------------------
# attention kernels (serving path)
# ---------------------------------------------------------------------------

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS,
    flash_attention,
    kernel_tiles,
)
from repro_torch.models.attention import (  # noqa: E402
    decode_attention_ref,
    flash_attention_ref,
)
from repro_torch.models.model import build_model  # noqa: E402

# kernel vs plain on the card: f32 within 1e-4 (sums in other orders, expf
# and tanhf against torch's, both within an ulp or two); bf16 within 2e-2
# (a few bf16 ulps of an O(1) output: the output's own rounding, and the
# plain decode version rounds the normalised p where the kernel rounds the
# unnormalised one)
ATT_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _randn(dev, dtype, seed, *shapes):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(s, generator=g).to(dev, dtype) for s in shapes]


def _att_close(out, ref, dtype):
    err = (out.float() - ref.float()).abs()
    lim = ATT_TOL[dtype] * (1 + ref.float().abs())
    assert bool((err <= lim).all()), f"max |diff| {err.max().item():.3e}"


def _flash_plain(q, k, v, kw):
    """The plain version in the kernel's tiles (kernel_tiles): the same
    running maxima."""
    q_chunk, kv_chunk = kernel_tiles(q.shape[-1], q.dtype)
    return flash_attention_ref(q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,T,Hq,Hkv,D,kw",
    [
        (2, 200, 200, 4, 4, 64, dict(causal=True)),  # G = 1, ragged tiles
        (1, 256, 256, 8, 2, 128, dict(causal=True, window=100)),  # G = 4
        (1, 130, 130, 8, 1, 256, dict(causal=True, softcap=30.0)),  # G = 8
        (2, 192, 192, 8, 2, 64, dict(causal=True, prefix_len=70)),
        (1, 100, 150, 4, 2, 64, dict(causal=False)),  # S != T
        (1, 64, 64, 4, 1, 160, dict(causal=True)),
        (1, 96, 96, 8, 1, 32, dict(causal=True, window=20, softcap=10.0)),
    ],
)
def test_flash_attention_matches_plain(cuda_device, dtype, B, S, T, Hq, Hkv, D, kw):
    q, k, v = _randn(cuda_device, dtype, S + D, (B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D))
    before = fes.LAUNCH_COUNTS["flash_attention"]
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fes.LAUNCH_COUNTS["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    _att_close(out, _flash_plain(q, k, v, kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,T,Hq,Hkv,D,window,softcap,lens",
    [
        (3, 300, 4, 4, 64, 0, 0.0, [1, 150, 300]),  # G = 1, ragged T
        (4, 4096, 32, 8, 64, 0, 0.0, [1, 2049, 4096, 777]),  # the serving shape
        (2, 1000, 16, 2, 128, 200, 0.0, [1000, 517]),  # G = 8, window
        (2, 512, 8, 1, 256, 0, 30.0, [1, 512]),
        (1, 129, 8, 8, 160, 50, 20.0, [129]),
    ],
)
def test_decode_attention_matches_plain(cuda_device, dtype, B, T, Hq, Hkv, D, window,
                                        softcap, lens):
    q, k, v = _randn(cuda_device, dtype, T + D, (B, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D))
    cl = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = fes.LAUNCH_COUNTS["decode_attention"]
    out = decode_attention(q, k, v, cl, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert fes.LAUNCH_COUNTS["decode_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    _att_close(out, decode_attention_ref(q, k, v, cl, window=window, softcap=softcap), dtype)


@pytest.mark.cuda
def test_attention_wrappers_check_inputs(cuda_device):
    q, k, v = _randn(cuda_device, torch.float32, 0, (1, 8, 4, 64), (1, 8, 2, 64), (1, 8, 2, 64))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        v[..., :48].contiguous())
    with pytest.raises(ValueError, match="is torch.bfloat16"):
        flash_attention(q, k.bfloat16(), v)
    kb, vb = k.bfloat16(), v.bfloat16()
    shifted = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:]
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention(shifted.view(q.shape), kb, vb)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="int32"):
        decode_attention(q[:, 0].contiguous(), k, v, torch.tensor([3], device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_runs_the_attention_kernels(cuda_device, dtype):
    """A small model on the card: the kernels against the same model
    under kernel_backend("ref"), teacher-forced, and one launch of each
    kernel per layer and step."""
    import dataclasses

    # the smoke config's head_dim of 16 is below the kernels' 32: widen it
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), compute_dtype=dtype,
                              d_model=128, n_heads=4, n_kv_heads=1, head_dim=64)
    m = build_model(cfg, seed=1, device=cuda_device)
    g = torch.Generator(device="cpu").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), generator=g).to(cuda_device)
    feed = torch.randint(0, cfg.vocab_size, (2, 4), generator=g).to(cuda_device)
    logits = {}
    with torch.inference_mode():
        for backend in (None, "ref"):
            fes.LAUNCH_COUNTS.clear()
            with ops.kernel_backend(backend):
                lg, caches, cl = m.prefill({"tokens": tokens}, 128)
                out = [lg]
                for i in range(feed.shape[1]):
                    lg, caches, cl = m.decode_step(feed[:, i:i + 1], caches, cl)
                    out.append(lg)
            logits[backend] = torch.cat(out, dim=1).float()
            n = cfg.n_layers if backend is None else 0
            assert fes.LAUNCH_COUNTS["flash_attention"] == n
            assert fes.LAUNCH_COUNTS["decode_attention"] == n * feed.shape[1]
    k, r = logits[None], logits["ref"]
    rel = ((k - r).norm() / r.norm()).item()
    assert rel <= (1e-5 if dtype == "float32" else 2e-2), rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,T,Hq,Hkv,D,kw",
    [
        (1, 300, 300, 16, 1, 256, dict(causal=True, window=128)),  # recurrentgemma's MQA
        (2, 130, 130, 16, 1, 256, dict(causal=True, window=2048)),  # window past S
    ],
)
def test_flash_attention_at_recurrentgemma_shapes(cuda_device, dtype, B, S, T, Hq, Hkv, D, kw):
    q, k, v = _randn(cuda_device, dtype, S + 7, (B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D))
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    _att_close(out, _flash_plain(q, k, v, kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_over_a_full_ring(cuda_device, dtype):
    """recurrentgemma's local layers decode over a ring of T slots that is
    full from the first step (cache_len = T, window 0), D = 256, G = 16."""
    B, T, Hq, Hkv, D = 2, 512, 16, 1, 256
    q, k, v = _randn(cuda_device, dtype, 11, (B, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D))
    cl = torch.full((B,), T, dtype=torch.int32, device=cuda_device)
    out = decode_attention(q, k, v, cl)
    torch.cuda.synchronize()
    _att_close(out, decode_attention_ref(q, k, v, cl), dtype)


# the bf16 kernels' edges: tiles of 192 or 128 query rows and 128 or 64 keys
# (kernel_tiles) for prefill; splits of whole 64-key tiles for decode
@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,S,T,Hq,Hkv,D,kw",
    [
        (1, 129, 129, 4, 2, 64, dict(causal=True)),  # S, T past a tile by one
        (1, 257, 257, 8, 2, 128, dict(causal=True, window=100)),
        (2, 257, 257, 4, 1, 256, dict(causal=True)),
        (1, 640, 640, 4, 1, 256, dict(causal=True)),  # query tiles cross 2-3 key tiles
        (1, 640, 640, 8, 2, 64, dict(causal=True)),
        (1, 300, 300, 16, 1, 256, dict(causal=True, window=100)),  # G = 16, window < S
        (2, 300, 300, 4, 2, 64, dict(causal=True, prefix_len=150)),  # prefix crosses a tile
        (1, 300, 300, 4, 1, 256, dict(causal=True, prefix_len=100)),
        (1, 100, 333, 4, 2, 128, dict(causal=False)),  # S != T
        (1, 257, 70, 4, 2, 64, dict(causal=False, softcap=20.0)),
    ],
)
def test_flash_attention_bf16_tile_edges(cuda_device, B, S, T, Hq, Hkv, D, kw):
    q, k, v = _randn(cuda_device, torch.bfloat16, S + T + D, (B, S, Hq, D), (B, T, Hkv, D),
                     (B, T, Hkv, D))
    before = fes.LAUNCH_COUNTS["flash_attention"]
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fes.LAUNCH_COUNTS["flash_attention"] == before + 1
    _att_close(out, _flash_plain(q, k, v, kw), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_attention_bf16_every_head_dim(cuda_device, D):
    """Each head_dim reaches the wgmma kernel: 128- or 64-byte swizzle, one
    to eight column blocks."""
    q, k, v = _randn(cuda_device, torch.bfloat16, D, (2, 200, 4, D), (2, 200, 2, D),
                     (2, 200, 2, D))
    before = fes.LAUNCH_COUNTS["flash_attention"]
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fes.LAUNCH_COUNTS["flash_attention"] == before + 1
    _att_close(out, _flash_plain(q, k, v, dict(causal=True)), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,T,Hq,Hkv,D,window,lens",
    [
        (3, 300, 8, 2, 64, 0, [0, 5, 0]),  # cache_len 0 reads nothing: zeros
        (2, 300, 8, 2, 128, 0, [300, 300]),  # cache_len = T, a ragged last tile
        (2, 64, 4, 1, 64, 0, [64, 1]),  # one tile: one split
        (2, 65, 4, 1, 64, 0, [65, 64]),  # a second, one-key tile
        (2, 2048, 16, 1, 256, 0, [2048, 2048]),  # G = 16, D = 256, a full ring
        (2, 1024, 32, 8, 64, 300, [1024, 900]),  # the window crosses splits
        (1, 500, 32, 1, 64, 0, [500]),  # G = 32: two 16-row groups
    ],
)
def test_decode_attention_bf16_split_edges(cuda_device, B, T, Hq, Hkv, D, window, lens):
    q, k, v = _randn(cuda_device, torch.bfloat16, T + D + 1, (B, Hq, D), (B, T, Hkv, D),
                     (B, T, Hkv, D))
    cl = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = fes.LAUNCH_COUNTS["decode_attention"]
    out = decode_attention(q, k, v, cl, window=window)
    torch.cuda.synchronize()
    assert fes.LAUNCH_COUNTS["decode_attention"] == before + 1
    live = cl > 0
    assert bool((out[~live] == 0).all())
    if bool(live.any()):
        ref = decode_attention_ref(q[live], k[live], v[live], cl[live], window=window)
        _att_close(out[live], ref, torch.bfloat16)


# ---------------------------------------------------------------------------
# scan kernels (Mamba-2 and Griffin prefill)
# ---------------------------------------------------------------------------

from repro_torch.kernels.rglru_scan import launch_plan, rglru_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models.scans import rglru_scan_ref, ssd_chunked_ref  # noqa: E402

# ssd_scan against its plain version at the model's chunk: the kernel scans
# in 64-token chunks, so its cumulative decays are summed over 64 tokens
# where the plain version's are summed over up to 256, and exp(cum_t -
# cum_s) rounds differently; on the CPU the plain version at 64 and at 256
# differ by up to 7e-4 x (1 + |y|) per element at strong decay (dA of -1 to
# -13 a token) and by under 1e-5 in relative L2
SSD_TOL, SSD_REL_L2 = 2e-3, 1e-4


def _ssd_inputs(dev, seed, B, L, H, P, N, G, scale=1.0, bias=0.5):
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g)
    dt = torch.nn.functional.softplus(r(B, L, H) * scale + bias)
    A = -torch.exp(torch.rand(H, generator=g))
    return [t.to(dev) for t in (r(B, L, H, P), dt, A, r(B, L, G, N), r(B, L, G, N))]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,L,H,P,N,G,chunk",
    [
        (2, 256, 4, 64, 128, 1, 64),  # tests/test_kernels.py's shapes
        (2, 256, 4, 64, 128, 2, 128),
        (2, 256, 4, 64, 128, 1, 256),
        (2, 200, 4, 64, 128, 2, 64),  # ragged L
        (2, 50, 4, 32, 16, 1, 16),  # the smoke model's widths
        (1, 77, 8, 128, 32, 4, 64),
        # one mamba2-2.7b-width head group at its length, and a group a head
        (1, 2048, 8, 64, 128, 1, 256),
        (1, 2048, 8, 64, 128, 8, 256),
    ],
)
def test_ssd_scan_matches_plain(cuda_device, B, L, H, P, N, G, chunk):
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, L + N, B, L, H, P, N, G)
    before = fes.LAUNCH_COUNTS["ssd_scan"]
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert fes.LAUNCH_COUNTS["ssd_scan"] == before + 1
    yr, sr = ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk)
    for out, ref in ((y, yr), (st, sr)):
        assert bool(torch.isfinite(out).all())
        assert bool(((out - ref).abs() <= SSD_TOL * (1 + ref.abs())).all())
        assert ((out - ref).norm() / ref.norm()).item() <= SSD_REL_L2


@pytest.mark.cuda
def test_ssd_scan_takes_views_off_16_byte_alignment(cuda_device):
    # the kernel reads x, B and C 16 bytes at a time; contiguous views that
    # start 4 bytes past an allocation's start are copied by the wrapper
    args = _ssd_inputs(cuda_device, 7, 1, 100, 4, 64, 32, 2)
    shifted = []
    for t in args:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        shifted.append(view)
    assert shifted[0].data_ptr() % 16 != 0 and shifted[0].is_contiguous()
    y, st = ssd_scan(*shifted, chunk=64)
    yr, sr = ssd_scan(*args, chunk=64)
    assert torch.equal(y, yr) and torch.equal(st, sr)


def _rglru_inputs(dev, B, L, W, with_h0):
    g = torch.Generator(device="cpu").manual_seed(L + W)
    a = torch.sigmoid(torch.randn((B, L, W), generator=g)).to(dev)
    b = (0.1 * torch.randn((B, L, W), generator=g)).to(dev)
    h0 = torch.randn((B, W), generator=g).to(dev) if with_h0 else None
    return a, b, h0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,L,W,with_h0",
    [
        (2, 256, 64, False), (2, 300, 512, True), (3, 77, 4096, True), (1, 1, 100, True),
        (2, 129, 101, True),  # W % 4 != 0: the cp.async path, L past whole stages
        (2, 64, 200, False),  # W not a multiple of 32 on the TMA path
        (1, 1, 101, False),  # L = 1 on the cp.async path
        (8, 64, 4096, False),  # more warps than one wave
        (1, 2048, 4096, True),  # batch 1 at recurrentgemma-9b's width
    ],
)
def test_rglru_scan_matches_plain_bitwise(cuda_device, B, L, W, with_h0):
    """One rounded multiply and one rounded add a step on both sides."""
    a, b, h0 = _rglru_inputs(cuda_device, B, L, W, with_h0)
    assert launch_plan(B, W, a.dtype, a.data_ptr(), b.data_ptr()).path == (
        "tma" if W % 4 == 0 else "cp.async")
    before = fes.LAUNCH_COUNTS["rglru_scan"]
    y, h_last = rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert fes.LAUNCH_COUNTS["rglru_scan"] == before + 1
    yr, hr = rglru_scan_ref(a, b, h0)
    assert torch.equal(y, yr) and torch.equal(h_last, hr)


@pytest.mark.cuda
@pytest.mark.parametrize("shift_a", [True, False])
def test_rglru_scan_takes_views_off_16_byte_alignment(cuda_device, shift_a):
    # TMA needs 16-byte aligned bases: a contiguous view 4 bytes past an
    # allocation's start (b, and a or not) takes the kernel's cp.async path
    a, b, h0 = _rglru_inputs(cuda_device, 2, 100, 256, True)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    sa, sb = (shifted(a) if shift_a else a), shifted(b)
    assert sb.data_ptr() % 16 == 4 and sb.is_contiguous()
    assert launch_plan(2, 256, a.dtype, sa.data_ptr(), sb.data_ptr()).path == "cp.async"
    y, h_last = rglru_scan(sa, sb, h0)
    yr, hr = rglru_scan_ref(a, b, h0)
    assert torch.equal(y, yr) and torch.equal(h_last, hr)


@pytest.mark.cuda
def test_scan_wrappers_check_inputs(cuda_device):
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, 0, 1, 64, 4, 64, 128, 1)
    with pytest.raises(ValueError, match="float32"):
        ssd_scan(x.bfloat16(), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="head_dim P"):
        ssd_scan(x[..., :48].contiguous(), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="is on cpu"):
        ssd_scan(x, dt, A.cpu(), Bm, Cm)
    a = torch.rand((2, 8, 64), device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        rglru_scan(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(a.transpose(0, 1).contiguous().transpose(0, 1), a)
    with pytest.raises(ValueError, match="kernel_backend|needs CUDA"):
        with ops.kernel_backend("cuda"):
            ops.rglru_scan(a.cpu(), a.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_smoke_archs_launch_the_scan_kernels(cuda_device, arch):
    """A prefill and decode steps of each smoke arch on the card: the
    kernels' launches per prefill and step, and the logits against the same
    model under kernel_backend("ref"), teacher-forced, in f32."""
    import dataclasses

    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    m = build_model(cfg, seed=2, device=cuda_device)
    g = torch.Generator(device="cpu").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=g).to(cuda_device)
    feed = torch.randint(0, cfg.vocab_size, (2, 3), generator=g).to(cuda_device)
    kinds = [k for pattern, count in cfg.segments for _ in range(count) for k in pattern]
    per_prefill = {"ssd_scan": kinds.count("ssm"), "rglru_scan": kinds.count("rglru"),
                   "flash_attention": kinds.count("local")}
    logits = {}
    with torch.inference_mode():
        for backend in (None, "ref"):
            fes.LAUNCH_COUNTS.clear()
            with ops.kernel_backend(backend):
                lg, caches, cl = m.prefill({"tokens": tokens}, 48)
                counts = {k: fes.LAUNCH_COUNTS[k] for k in per_prefill}
                out = [lg]
                for i in range(feed.shape[1]):
                    lg, caches, cl = m.decode_step(feed[:, i:i + 1], caches, cl)
                    out.append(lg)
            logits[backend] = torch.cat(out, dim=1)
            if backend is None:
                assert counts == per_prefill
                assert fes.LAUNCH_COUNTS["decode_attention"] == kinds.count("local") * 3
            else:
                assert sum(fes.LAUNCH_COUNTS.values()) == 0
    k, r = logits[None], logits["ref"]
    assert ((k - r).norm() / r.norm()).item() <= 1e-4


# ---------------------------------------------------------------------------
# faas_sweep's metric windows, reliability and retries
# ---------------------------------------------------------------------------

from repro_torch.core.reliability import NO_TIMEOUT, RetryPolicy, build_attempt_table  # noqa: E402


def _rely_inputs(dev, seed, R, M, N, J, backoff, rate=0.8, windows="irregular"):
    """One launch's inputs on ``dev``: an attempt table of N base arrivals
    with J retries each (absolute times), its base gap stream, failure
    uniforms for both, per-row parameters and window bounds ("irregular"
    inside the horizon, "narrow": 240 windows, several to a gap, or
    "past": windows reaching past the horizon)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1 / rate, (R, N)).astype(np.float32)
    t0 = np.cumsum(gaps.astype(np.float64), axis=1)
    draws = [rng.exponential(2.0, (R, N, J + 1)), rng.exponential(2.5, (R, N, J + 1)),
             rng.random((R, N, J + 1)), rng.random((R, N, J))]
    table = build_attempt_table(
        torch.from_numpy(t0), *(torch.from_numpy(np.asarray(d, np.float32 if i < 3 else np.float64))
                                for i, d in enumerate(draws)),
        RetryPolicy(max_retries=J, backoff_base=backoff, backoff_jitter=0.3),
    )
    horizon = float(t0[:, -1].min())
    if windows == "narrow":
        wb = np.tile(np.linspace(0.0, horizon, 241), (R, 1))
    elif windows == "past":
        wb = np.tile(np.array([0.3, 0.5, 1.5, 3.0]) * horizon, (R, 1))
    else:
        wb = np.sort(rng.uniform(0, horizon, (R, 5)), axis=1)
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    return dict(
        state=(torch.zeros((R, M), device=dev), torch.full((R, M), -1e30, device=dev),
               torch.full((R, M), -1e30, device=dev), torch.zeros((R,), device=dev)),
        t_exp=t(10 * rng.uniform(0.5, 1.5, R)),
        table=tuple(t(x.numpy()) for x in table),
        gaps=(t(gaps), t(draws[0][:, :, 0]), t(draws[1][:, :, 0])),
        fail_gaps=t(draws[2][:, :, 0]),
        t_end=t(horizon * rng.uniform(0.5, 0.9, R)),
        skip=t(horizon * rng.uniform(0.0, 0.1, R)),
        window_bounds=t(wb),
        t_timeout=t(rng.uniform(1.0, 5.0, R)),
        p_fail=t(rng.uniform(0.0, 0.3, R)),
    )


def _rely_call(inp, windows, reliability, retries, max_c):
    """(args, kw) of one combination: retries run the table prestamped, the
    others the gap stream."""
    kw = dict(t_end=inp["t_end"], skip=inp["skip"], max_concurrency=max_c,
              prestamped=retries)
    samples = inp["table"][:3] if retries else inp["gaps"]
    if windows:
        kw["window_bounds"] = inp["window_bounds"]
    if reliability:
        kw.update(t_timeout=inp["t_timeout"], p_fail=inp["p_fail"],
                  fail_u=inp["table"][3] if retries else inp["fail_gaps"])
    if retries:
        kw.update(is_first=inp["table"][4], child_pos=inp["table"][5])
    return (*inp["state"], inp["t_exp"], *samples), kw


def _held_rely(out_k, out_p, W):
    out_k = out_k.apply(lambda o: o.cpu().numpy())
    out_p = out_p.apply(lambda o: o.cpu().numpy())
    assert len(out_k) == len(out_p)
    for a, b in zip(out_k[:4] + out_k[5:], out_p[:4] + out_p[5:]):  # state, act, doom
        np.testing.assert_array_equal(a, b)
    integ = [3, 4] + list(range(8 + 3 * W, 8 + 5 * W))
    exact = [c for c in range(out_k[4].shape[1]) if c not in integ]
    np.testing.assert_array_equal(out_k[4][:, exact], out_p[4][:, exact])
    np.testing.assert_allclose(out_k[4][:, integ], out_p[4][:, integ],
                               rtol=INTEGRAL_RTOL, atol=1e-5)
    return out_k


RELY_COMBOS = [(True, False, False), (False, True, False), (True, True, False),
               (False, True, True), (True, True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 37, 64, 300])
@pytest.mark.parametrize("windows,reliability,retries", RELY_COMBOS)
def test_rely_paths_match_plain(cuda_device, M, windows, reliability, retries):
    inp = _rely_inputs(cuda_device, 20 + M, 33, M, 150, 2, 0.5)
    args, kw = _rely_call(inp, windows, reliability, retries, 3 if M < 64 else 100)
    key = fes.launch_key(False, windows, reliability, retries)
    before = fes.LAUNCH_COUNTS[key]
    out_k = fes.faas_sweep(*args, **kw)
    assert fes.LAUNCH_COUNTS[key] == before + 1
    W = 4 if windows else 0
    acc = _held_rely(out_k, faas_sweep_ref(*args, **kw), W)[4]
    if reliability:
        assert acc[:, -4:-2].sum() > 0  # timeouts and failures
    if retries:
        assert acc[:, -2].sum() > 0  # retries processed


@pytest.mark.cuda
@pytest.mark.parametrize("J,backoff", [(1, 0.05), (2, 0.05), (1, 60.0), (2, 60.0)])
def test_retry_children_in_and_past_the_batch(cuda_device, J, backoff):
    inp = _rely_inputs(cuda_device, 30 + J, 40, 16, 200, J, backoff)
    child = inp["table"][5].long().cpu()
    pos = torch.arange(child.shape[1]).expand_as(child)
    has = child < (1 << 30)
    same = (child[has] // 32 == pos[has] // 32).float().mean().item()
    # a short backoff puts most children inside their parent's 32-event
    # batch, a long one most past it
    assert same > 0.5 if backoff < 1 else same < 0.5
    args, kw = _rely_call(inp, True, True, True, 2)
    out = _held_rely(fes.faas_sweep(*args, **kw), faas_sweep_ref(*args, **kw), 4)
    assert out.act.sum() > 0 and out.acc[:, -2].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("windows", ["narrow", "past", "unsorted"])
def test_window_cursor_matches_plain(cuda_device, windows):
    inp = _rely_inputs(cuda_device, 40, 33, 40, 200, 1, 1.0, windows=windows)
    args, kw = _rely_call(inp, True, False, False, 100)
    if windows == "unsorted":
        # absolute times in shuffled order: the clock goes back, and the
        # cursor rescans from the first window
        g = torch.Generator().manual_seed(0)
        order = torch.stack([torch.randperm(200, generator=g) for _ in range(33)])
        times = torch.cumsum(inp["gaps"][0].cpu().double(), 1).float()
        args = args[:5] + (torch.gather(times, 1, order).to(cuda_device),) + args[6:]
        kw["prestamped"] = True
    W = inp["window_bounds"].shape[1] - 1
    acc = _held_rely(fes.faas_sweep(*args, **kw), faas_sweep_ref(*args, **kw), W)[4]
    assert acc[:, 8 + 2 * W:8 + 3 * W].sum() > 0


@pytest.mark.cuda
def test_trivial_policy_is_a_noop_on_the_card(cuda_device):
    inp = _rely_inputs(cuda_device, 41, 33, 64, 200, 1, 1.0)
    args, kw = _rely_call(inp, True, False, False, 3)
    plain = fes.faas_sweep(*args, **kw).apply(lambda o: o.cpu())
    rely = fes.faas_sweep(
        *args, **kw, t_timeout=NO_TIMEOUT, p_fail=0.0, fail_u=inp["fail_gaps"]
    ).apply(lambda o: o.cpu())
    for a, b in zip(plain[:4], rely[:4]):
        assert torch.equal(a, b)
    assert torch.equal(rely[4][:, :-4], plain[4])
    assert float(rely[4][:, -4:-1].sum()) == 0.0


@pytest.mark.cuda
def test_rely_wrapper_checks_inputs(cuda_device):
    inp = _rely_inputs(cuda_device, 42, 8, 8, 40, 1, 1.0)
    args, kw = _rely_call(inp, True, True, True, 3)
    launches = dict(fes.LAUNCH_COUNTS)
    bad = inp["window_bounds"].clone()
    bad[3, 2] = bad[3, 1]
    with pytest.raises(ValueError, match="strictly increasing"):
        fes.faas_sweep(*args, **dict(kw, window_bounds=bad))
    wide = torch.arange(fes.MAX_WINDOWS + 2, dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="windows per row"):
        fes.faas_sweep(*args, **dict(kw, window_bounds=wide.expand(8, -1).contiguous()))
    with pytest.raises(ValueError, match="float32"):
        fes.faas_sweep(*args, **dict(kw, child_pos=kw["child_pos"].double()))
    with pytest.raises(ValueError, match="shape"):
        fes.faas_sweep(*args, **dict(kw, fail_u=kw["fail_u"][:, :5].contiguous()))
    with pytest.raises(ValueError, match="grid columns alone"):
        fes.faas_sweep(*args, **dict(kw, grid_times=inp["t_end"][:, None].contiguous()))
    with pytest.raises(ValueError, match="come together"):  # crash_rate is missing
        fes.faas_sweep(*args, **kw, crash_u=inp["t_end"])
    cap = dict(cap_edges=torch.tensor([[5.0, 3.0]], device=cuda_device).expand(8, 2)
               .contiguous(), cap_values=torch.ones((8, 3), device=cuda_device))
    no_windows = {k: v for k, v in kw.items() if k != "window_bounds"}
    with pytest.raises(ValueError, match="cap_edges must be positive and strictly increasing"):
        fes.faas_sweep(*args, **no_windows, **cap)
    assert dict(fes.LAUNCH_COUNTS) == launches  # nothing launched


@pytest.mark.cuda
def test_front_door_runs_reliability_on_the_kernel(cuda_device):
    import repro_torch as rt

    rel = rt.Reliability(rt.FailurePolicy(p_fail=0.05, t_timeout=4.0),
                         rt.RetryPolicy(max_retries=2, backoff_base=2.0, backoff_jitter=0.3))
    scn = rt.Scenario(
        arrival_process=rt.ExpSimProcess(rate=0.9),
        warm_service_process=rt.ExpSimProcess(rate=1 / 1.991),
        cold_service_process=rt.ExpSimProcess(rate=1 / 2.244),
        expiration_threshold=60.0, sim_time=2000.0, skip_time=50.0, slots=32,
        reliability=rel, window_bounds=(0.0, 500.0, 1200.0, 2000.0),
    )
    over = {"t_timeout": [2.0, 8.0], "expiration_threshold": [30.0, 120.0]}
    # the same staged draws on the card and on the CPU
    inp = rt.core.scenario.sweep_inputs(scn, over, 3, replicas=8, device="cpu")
    D = 2 * 8
    staged = tuple(x.reshape(2, 2, 8, -1)[:, 0].reshape(D, -1) for x in inp.samples)
    fes.LAUNCH_COUNTS.clear()
    card = rt.sweep(scn, over, 0, replicas=8, staged=tuple(x.to(cuda_device) for x in staged),
                    backend="cuda")
    assert dict(fes.LAUNCH_COUNTS) == {"faas_sweep_win_retry": 1}
    cpu = rt.sweep(scn, over, 0, replicas=8, staged=staged, device="cpu", backend="ref")
    for a, b in zip(card.summaries.ravel(), cpu.summaries.ravel()):
        for f in ("n_cold", "n_warm", "n_reject", "n_timeout", "n_fail", "n_retry",
                  "n_abandon", "sum_cold_resp", "sum_warm_resp"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(a.windows.n_arrivals, b.windows.n_arrivals)
        np.testing.assert_allclose(a.time_running, b.time_running, rtol=INTEGRAL_RTOL)
    np.testing.assert_array_equal(card.windowed_arrivals, cpu.windowed_arrivals)
    fes.LAUNCH_COUNTS.clear()
    res = rt.run(rt.Scenario.of(scn, window_bounds=None,
                                reliability=rt.Reliability(rel.failure)), 1, replicas=64,
                 backend="cuda")
    assert dict(fes.LAUNCH_COUNTS) == {"faas_sweep_rely": 1}
    assert res.summary.n_fail.sum() > 0 and np.isfinite(res.summary.goodput)


# ---------------------------------------------------------------------------
# platform faults: the fault paths of faas_sweep and fleet_sweep
# ---------------------------------------------------------------------------


def _fault_kw(dev, seed, R, K, crashes, capacity, horizon, values=(6.0, 1.5, 8.0)):
    """Per-row crash rates and a crash uniform per event; a per-row ceiling
    stepping through ``values`` (a non-integer one among them) inside the
    horizon."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    kw = {}
    if crashes:
        kw.update(crash_rate=t(rng.uniform(0.005, 0.05, R)), crash_u=t(rng.random((R, K))))
    if capacity:
        kw.update(cap_edges=t(np.sort(rng.uniform(0.2, 0.8, (R, len(values) - 1)), 1) * horizon),
                  cap_values=t(np.tile(values, (R, 1))))
    return kw


# (crashes, capacity, reliability, retries): every fault path set
FAULT_PATHS = [(c, k, rel, ret)
               for c, k in ((True, False), (False, True), (True, True))
               for rel, ret in ((False, False), (True, False), (True, True))]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 64, 300])
@pytest.mark.parametrize("crashes,capacity,reliability,retries", FAULT_PATHS)
def test_fault_paths_match_plain(cuda_device, M, crashes, capacity, reliability, retries):
    inp = _rely_inputs(cuda_device, 50 + M, 33, M, 150, 2, 0.5)
    args, kw = _rely_call(inp, False, reliability, retries, 3 if M < 64 else 100)
    horizon = float(inp["t_end"].max())
    kw.update(_fault_kw(cuda_device, M, 33, args[5].shape[1], crashes, capacity, horizon))
    key = fes.launch_key(False, False, reliability, retries, faults=True)
    before = fes.LAUNCH_COUNTS[key]
    out_k = fes.faas_sweep(*args, **kw)
    assert fes.LAUNCH_COUNTS[key] == before + 1
    # pools, the activation plane and the crash clocks equal bit for bit
    out = _held_rely(out_k, faas_sweep_ref(*args, **kw), 0)
    assert (out.act is not None, out.doom is not None) == (retries, crashes)
    faults = out[4][:, -3:].sum(0)
    assert (faults[0] > 0) == crashes and (faults[1] > 0) == capacity
    if crashes:
        assert faults[2] > 0 and np.isfinite(out.doom).any()


@pytest.mark.cuda
def test_eviction_ties_and_fractional_ceilings_on_the_card(cuda_device):
    # arrival times on whole seconds (several arrivals a second) give equal
    # creation times; the ceilings 5 -> 2.5 -> 3.5 evict ceil(live - c) of
    # the tied idle instances, the lower slots first
    R, K, M = 64, 400, 32
    rng = np.random.default_rng(60)
    times = np.floor(np.cumsum(rng.exponential(1 / 3.0, (R, K)), axis=1))
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=cuda_device)
    state = (torch.zeros((R, M), device=cuda_device),
             torch.full((R, M), -1e30, device=cuda_device),
             torch.full((R, M), -1e30, device=cuda_device),
             torch.zeros((R,), device=cuda_device))
    args = (*state, t(rng.uniform(5.0, 20.0, R)), t(times), t(rng.exponential(0.6, (R, K))),
            t(rng.exponential(0.8, (R, K))))
    horizon = float(times[:, -1].min())
    kw = dict(t_end=t(np.full(R, horizon)), skip=0.0, max_concurrency=100, prestamped=True,
              **_fault_kw(cuda_device, 61, R, K, True, True, horizon, (5.0, 2.5, 3.5)))
    out = _held_rely(fes.faas_sweep(*args, **kw), faas_sweep_ref(*args, **kw), 0)
    assert out[4][:, -2].sum() > 0  # evictions happened
    # ties arose: slots whose last cold start shares its instant with another's
    tied = [(c > -1e29).sum() - len(set(c[c > -1e29])) for c in out[1]]
    assert sum(tied) > 0


def _fault_case(F, M, crashes, capacity, stream="exp", id=None):
    return pytest.param(F, M, crashes, capacity, stream, id=id or f"{F}-{M}-{crashes}-{capacity}")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "F,M,crashes,capacity,stream",
    [
        _fault_case(1, 40, True, True), _fault_case(3, 64, True, False),
        _fault_case(3, 16, False, True), _fault_case(8, 16, True, True),
        _fault_case(8, 64, True, True),
        # arrivals on whole seconds: evictions among idle instances tied on
        # creation time (the lower flat id goes first)
        _fault_case(8, 64, False, True, "whole-seconds", id="eviction-creation-ties"),
        # crashes ten times as often on 16 slots: slots die and cold-start
        # again, each time in whichever table entry is lowest free
        _fault_case(3, 16, True, False, "churn", id="slots-reborn-in-other-lanes"),
    ],
)
def test_fleet_fault_kernel_matches_plain(cuda_device, F, M, crashes, capacity, stream):
    args, kw = _fleet_inputs(cuda_device, 70 + F, F, 4.0 * F, 1000, True, M,
                             rate=3.0 if stream == "whole-seconds" else 1.2,
                             whole_seconds=stream == "whole-seconds")
    N, (S, K) = args[0].shape[0], args[6].shape
    rng = np.random.default_rng(71 + F)
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=cuda_device)
    if crashes:
        scale = 10.0 if stream == "churn" else 1.0
        kw.update(crash_rate=t(scale * rng.uniform(0.01, 0.05, N)),
                  crash_u=t(rng.random((S, K))))
    if capacity:
        horizon = float(args[3].max())
        kw.update(cap_edges=t(np.sort(rng.uniform(0.2, 0.8, (N, 2)), 1) * horizon),
                  cap_values=t(np.tile([3.0 * F, 1.5 * F + 0.5, 4.0 * F], (N, 1))))
    out_p = [o.cpu().numpy() for o in fleet_sweep_ref(*args, **kw)]
    exact = [c for c in range(16) if c not in (3, 4)]
    # the front door's table (the host bound) and the widest (F * M)
    for bound in (_host_bound(args, M), None):
        before = fles.LAUNCH_COUNTS["fleet_sweep_fault"]
        out_k = [o.cpu().numpy() for o in fles.fleet_sweep(*args, **kw, live_bound=bound)]
        assert fles.LAUNCH_COUNTS["fleet_sweep_fault"] == before + 1
        np.testing.assert_array_equal(out_k[0][..., exact], out_p[0][..., exact])
        np.testing.assert_allclose(out_k[0][..., 3:5], out_p[0][..., 3:5], rtol=INTEGRAL_RTOL)
        for a, b in zip(out_k[1:], out_p[1:]):  # queue lengths, crash clocks
            np.testing.assert_array_equal(a, b)
    faults = out_k[0][..., 13:].sum((0, 1))
    assert (faults[0] > 0) == crashes and (faults[1] > 0) == capacity
    if stream == "churn":  # each stamped slot crashed twice and more on average
        assert faults[0] > 2 * np.isfinite(out_k[2]).sum() > 0
    if stream == "whole-seconds":
        times = args[6].cpu().numpy()
        assert (np.diff(times, axis=1) == 0).any() and faults[1] > 0


@pytest.mark.cuda
def test_front_door_runs_faults_on_the_kernel(cuda_device):
    import repro_torch as rt

    flt = rt.FaultModel(crash_rate=0.005, capacity=rt.CapacityProfile((600.0, 1200.0),
                                                                      (30.0, 2.5, 30.0)))
    scn = rt.Scenario(
        arrival_process=rt.ExpSimProcess(rate=0.9),
        warm_service_process=rt.ExpSimProcess(rate=1 / 1.991),
        cold_service_process=rt.ExpSimProcess(rate=1 / 2.244),
        expiration_threshold=60.0, sim_time=2000.0, skip_time=50.0, slots=32,
        max_concurrency=30, faults=flt,
        reliability=rt.Reliability(rt.FailurePolicy(p_fail=0.05, t_timeout=4.0)),
    )
    over = {"crash_rate": [0.001, 0.01], "expiration_threshold": [30.0, 120.0],
            "capacity": [flt.capacity, rt.CapacityProfile((600.0, 1200.0), (30.0, 8.0, 30.0))]}
    inp = rt.core.scenario.sweep_inputs(scn, over, 3, replicas=8, device="cpu")
    staged = tuple(x.reshape(2, 2, 2, 8, -1)[:, 0, 0].reshape(16, -1) for x in inp.samples)
    fes.LAUNCH_COUNTS.clear()
    card = rt.sweep(scn, over, 0, replicas=8, staged=tuple(x.to(cuda_device) for x in staged),
                    backend="cuda")
    assert dict(fes.LAUNCH_COUNTS) == {"faas_sweep_rely_fault": 1}
    cpu = rt.sweep(scn, over, 0, replicas=8, staged=staged, device="cpu", backend="ref")
    for a, b in zip(card.summaries.ravel(), cpu.summaries.ravel()):
        for f in ("n_cold", "n_warm", "n_reject", "n_timeout", "n_fail", "n_crash",
                  "n_evict", "n_interrupt", "sum_cold_resp", "sum_warm_resp"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_allclose(a.time_running, b.time_running, rtol=INTEGRAL_RTOL)
    np.testing.assert_array_equal(card.availability, cpu.availability)
    fleet = rt.FleetScenario(
        functions=(rt.FleetFunction("api", rt.ExpSimProcess(0.8), rt.ExpSimProcess(0.5),
                                    rt.ExpSimProcess(0.25), 60.0, 25),
                   rt.FleetFunction("batch", rt.ExpSimProcess(0.3), rt.ExpSimProcess(0.2),
                                    rt.ExpSimProcess(0.1), 120.0, 20)),
        n_cluster=40, sim_time=1000.0, skip_time=0.0,
        faults=rt.FaultModel(crash_rate=2e-3, capacity=rt.CapacityProfile(
            (400.0, 700.0), (40.0, 10.0, 40.0))),
    )
    # the same merged stream and crash uniforms on the card and on the CPU
    st = rt.core.fleet.fleet_inputs(fleet, {}, 1, replicas=64, device="cpu").staged
    fes.LAUNCH_COUNTS.clear()
    a = rt.fleet_run(fleet, 1, replicas=64, staged={
        k: v.to(cuda_device) if torch.is_tensor(v) else v for k, v in st.items()},
        backend="cuda").summary
    assert dict(fes.LAUNCH_COUNTS) == {"fleet_sweep_fault": 1}
    b = rt.fleet_run(fleet, 1, replicas=64, device="cpu", staged=st, backend="ref").summary
    for sa, sb in zip(a.summaries, b.summaries):
        for f in ("n_cold", "n_warm", "n_reject", "n_crash", "n_evict", "n_interrupt"):
            np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))
    assert sum(s.n_evict.sum() for s in a.summaries) > 0


# ---------------------------------------------------------------------------
# faas_sweep past the horizon: the exits deferred to one pass, batches that
# only move the clock, attempts never switched on
# ---------------------------------------------------------------------------


def _past_horizon_call(dev, case, M, path):
    """(args, kw, t_last) of a launch whose rows have a third to three fifths
    of their events past t_end: an attempt table run as gaps ("gaps"), as
    sorted times ("sorted"), as times shuffled across t_end, so that the clock
    leaves the horizon and comes back ("unsorted"), or as sorted times with a
    60 s hole after the last event inside the horizon, t_end 30 s into it
    ("late"); on the base path ("base"), with reliability and retries
    ("retry") or with those, crashes and a ceiling ("fault").  t_last is each
    row's clock at its last event before t_end."""
    inp = _rely_inputs(dev, 80 + M, 33, M, 150, 2, 0.5)
    times = inp["table"][0].cpu().double().numpy()
    R, K = times.shape
    rng = np.random.default_rng(81 + M)
    cut = (rng.uniform(0.4, 0.7, R) * K).astype(int)  # each row's first event past t_end
    later = np.arange(K)[None, :] >= cut[:, None]
    rows = np.arange(R)
    if case == "late":
        times = times + 60.0 * later
    t_last = times[rows, cut - 1]
    t_end = t_last + (30.0 if case == "late" else 0.5 * (times[rows, cut] - t_last))
    if case == "unsorted":
        for r in rows:
            lo = cut[r] - 40
            times[r, lo:lo + 80] = times[r, lo + rng.permutation(80)]
    if case == "gaps":
        times = np.diff(times, axis=1, prepend=0.0)
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    args = (*inp["state"], inp["t_exp"], t(times), *inp["table"][1:3])
    kw = dict(t_end=t(t_end), skip=inp["skip"], max_concurrency=3 if M < 64 else 100,
              prestamped=case != "gaps")
    if path != "base":
        kw.update(t_timeout=inp["t_timeout"], p_fail=inp["p_fail"], fail_u=inp["table"][3],
                  is_first=inp["table"][4], child_pos=inp["table"][5])
    if path == "fault":
        kw.update(_fault_kw(dev, 82 + M, R, K, True, True, float(t_end.max())))
        kw["crash_rate"] = 4.0 * kw["crash_rate"]
    return args, kw, t_last


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 64, 300])
@pytest.mark.parametrize("path", ["base", "retry", "fault"])
@pytest.mark.parametrize("case", ["gaps", "sorted", "unsorted", "late"])
def test_faas_past_the_horizon_matches_plain(cuda_device, case, path, M):
    args, kw, t_last = _past_horizon_call(cuda_device, case, M, path)
    key = fes.launch_key(False, False, path != "base", path != "base", faults=path == "fault")
    before = fes.LAUNCH_COUNTS[key]
    out_k = fes.faas_sweep(*args, **kw)
    assert fes.LAUNCH_COUNTS[key] == before + 1
    # pools, the final clock, the activation plane and the crash clocks bit
    # for bit, the counters too; the integrals within INTEGRAL_RTOL
    out = _held_rely(out_k, faas_sweep_ref(*args, **kw), 0)
    stream = args[5].cpu().double().numpy()
    clock = np.cumsum(stream, axis=1) if case == "gaps" else stream
    t_end = kw["t_end"].cpu().numpy()
    past = ~(clock <= t_end[:, None])
    assert past[:, -64:].all()  # whole 32-event batches past the horizon
    if case == "unsorted":  # an event inside the horizon after one past it
        assert (np.maximum.accumulate(past, axis=1) & ~past).any()
    if case == "late":
        # instances that left between the last clock inside the horizon and
        # t_end, which only the first event past t_end finds
        alive, busy = out[0], out[2]
        expire = busy + args[4].cpu().numpy()[:, None]
        lo, hi = t_last[:, None], t_end[:, None]
        assert ((alive == 0) & (busy > -1e29) & (expire > lo) & (expire <= hi)).any()
        if path == "fault":  # and crashes counted there
            doom = out.doom
            assert ((alive == 0) & (doom > lo) & (doom <= hi) & (doom < expire)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("backoff", [0.05, 60.0])
def test_retry_attempts_left_off_in_and_past_the_batch(cuda_device, backoff):
    # attempts never switched on take no routing, whether their parent sits
    # in their own 32-event batch (short backoff) or an earlier one (long)
    inp = _rely_inputs(cuda_device, 90, 40, 16, 200, 2, backoff)
    args, kw = _rely_call(inp, False, True, True, 2)
    out = _held_rely(fes.faas_sweep(*args, **kw), faas_sweep_ref(*args, **kw), 0)
    child = inp["table"][5].cpu().numpy()
    r, q = np.nonzero(child < (1 << 30))
    c = child[r, q].astype(int)
    off = out.act[r, c] == 0
    same = c // 32 == q // 32
    assert (off & same).any() if backoff < 1 else (off & ~same).any()
    assert (out.act[r, c] > 0).any()


# ---------------------------------------------------------------------------
# faas_sweep's fused draws
# ---------------------------------------------------------------------------

from repro_torch.core.drawplan import materialize_stream  # noqa: E402

# (arrival, warm, cold) families and (p0, p1): across the cases every family
# is drawn on every stream
FUSED_CASES = [
    (("exp", 0.8, 0.0), ("weibull", 1.5, 2.2), ("pareto", 3.0, 1.6)),
    (("det", 1.3, 0.0), ("gauss", 2.0, 0.5), ("lognorm", 0.5, 0.6)),
    (("gauss", 1.25, 0.3), ("exp", 0.5, 0.0), ("weibull", 0.8, 2.0)),
    (("weibull", 1.2, 1.3), ("det", 2.0, 0.0), ("gauss", 2.5, 0.8)),
    (("lognorm", 0.0, 0.5), ("pareto", 2.5, 1.2), ("exp", 0.4, 0.0)),
    (("pareto", 3.0, 0.8), ("lognorm", 0.4, 0.7), ("det", 2.4, 0.0)),
]
FUSED_PATHS = [(False, False), (True, False), (False, True), (True, True)]


def _fused_inputs(dev, seed, R, M, K, case):
    rng = np.random.default_rng(seed)
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    keys = [torch.from_numpy(rng.integers(0, 1 << 32, (R, 2), dtype=np.uint64)
                             .astype(np.uint32)).to(dev) for _ in range(4)]
    params = [t(np.stack([p0 * rng.uniform(0.9, 1.1, R), np.full(R, p1)], 1))
              for _, p0, p1 in case]
    horizon = K * 1.2
    return dict(
        state=(torch.zeros((R, M), device=dev), torch.full((R, M), -1e30, device=dev),
               torch.full((R, M), -1e30, device=dev), torch.zeros((R,), device=dev)),
        t_exp=t(10 * rng.uniform(0.5, 1.5, R)), keys=keys, params=params,
        dists=tuple(d for d, _, _ in case),
        t_end=t(horizon * rng.uniform(0.5, 0.9, R)), skip=t(horizon * rng.uniform(0.0, 0.1, R)),
        window_bounds=t(np.tile(np.linspace(0.0, 0.5 * horizon, 241), (R, 1))),
        t_timeout=t(rng.uniform(1.0, 5.0, R)), p_fail=t(np.full(R, 0.1)),
    )


def _fused_call(inp, K, windows, reliability, max_c):
    kw = dict(t_end=inp["t_end"], skip=inp["skip"], max_concurrency=max_c,
              fused_keys=tuple(inp["keys"][:3]), fused_params=tuple(inp["params"]),
              fused_dists=inp["dists"], fused_k=K)
    if windows:
        kw["window_bounds"] = inp["window_bounds"]
    if reliability:
        kw.update(t_timeout=inp["t_timeout"], p_fail=inp["p_fail"],
                  fused_fail_keys=inp["keys"][3])
    return (*inp["state"], inp["t_exp"], None, None, None), kw


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 37, 64, 300])
@pytest.mark.parametrize("path", range(4))
def test_fused_kernel_matches_plain(cuda_device, M, path):
    windows, reliability = FUSED_PATHS[path]
    for c, case in enumerate(FUSED_CASES):
        if (c + path) % 2:  # half the family cases per path, every family on every stream
            continue
        inp = _fused_inputs(cuda_device, 50 + M + c, 37, M, 301, case)
        args, kw = _fused_call(inp, 301, windows, reliability, 3 if M < 64 else 100)
        key = fes.launch_key(False, windows, reliability, False, True)
        before = fes.LAUNCH_COUNTS[key]
        out_k = fes.faas_sweep(*args, **kw)
        assert fes.LAUNCH_COUNTS[key] == before + 1
        acc = _held_rely(out_k, faas_sweep_ref(*args, **kw), 240 if windows else 0)[4]
        assert acc[:, :2].sum() > 0
        if reliability:
            assert acc[:, -3].sum() > 0  # failures


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(FUSED_CASES)))
def test_fused_kernel_equals_staged_kernel_on_materialized_draws(cuda_device, case):
    K = 997
    inp = _fused_inputs(cuda_device, 70 + case, 258, 64, K, FUSED_CASES[case])
    args, kw = _fused_call(inp, K, True, True, 100)
    fused = fes.faas_sweep(*args, **kw)
    bufs = [materialize_stream(d, k, (p[:, 0], p[:, 1]), K, cuda_device)
            for d, k, p in zip(inp["dists"], inp["keys"], inp["params"])]
    skw = {k: v for k, v in kw.items() if not k.startswith("fused")}
    skw["fail_u"] = materialize_stream("uniform", inp["keys"][3], None, K, cuda_device)
    staged = fes.faas_sweep(*args[:5], *bufs, **skw)
    for a, b in zip(fused[:5], staged[:5]):
        assert torch.equal(a, b)
    assert fused[5:] == staged[5:] == (None, None)  # no activation plane, no crash clocks


@pytest.mark.cuda
def test_fused_wrapper_checks_inputs(cuda_device):
    inp = _fused_inputs(cuda_device, 80, 8, 8, 40, FUSED_CASES[0])
    args, kw = _fused_call(inp, 40, False, True, 3)
    launches = dict(fes.LAUNCH_COUNTS)
    keys = kw["fused_keys"]
    with pytest.raises(ValueError, match="uint32"):
        fes.faas_sweep(*args, **dict(kw, fused_keys=(keys[0].long(),) + keys[1:]))
    with pytest.raises(ValueError, match="shape"):
        fes.faas_sweep(*args, **dict(kw, fused_fail_keys=keys[0][:4].contiguous()))
    with pytest.raises(ValueError, match="float32"):
        fes.faas_sweep(*args, **dict(kw, fused_params=(kw["fused_params"][0].double(),)
                                     + kw["fused_params"][1:]))
    with pytest.raises(ValueError, match="fused_dists"):
        fes.faas_sweep(*args, **dict(kw, fused_dists=("exp", "gamma", "exp")))
    with pytest.raises(ValueError, match="retry streams"):
        fes.faas_sweep(*args, **dict(kw, is_first=torch.ones((8, 40), device=cuda_device),
                                     child_pos=torch.ones((8, 40), device=cuda_device)))
    with pytest.raises(ValueError, match="grid columns"):
        fes.faas_sweep(*args, **dict(kw, grid_times=inp["t_end"][:, None].contiguous()))
    assert dict(fes.LAUNCH_COUNTS) == launches  # nothing launched


@pytest.mark.cuda
def test_front_door_runs_fused_draws_on_the_kernel(cuda_device):
    import repro_torch as rt

    scn = rt.Scenario(
        arrival_process=rt.ExpSimProcess(rate=0.9),
        warm_service_process=rt.ExpSimProcess(rate=1 / 1.991),
        cold_service_process=rt.ExpSimProcess(rate=1 / 2.244),
        expiration_threshold=60.0, sim_time=2000.0, skip_time=50.0, slots=32,
        window_bounds=(0.0, 500.0, 1200.0, 2000.0),
    )
    over = {"expiration_threshold": [30.0, 120.0], "arrival_rate": [0.5, 0.9]}
    card = rt.Execution(draws="fused", backend="cuda")
    plain = rt.Execution(draws="fused", backend="ref")  # the plain version, on the card
    fes.LAUNCH_COUNTS.clear()
    g = rt.sweep(scn, over, 3, replicas=8, execution=card)
    assert dict(fes.LAUNCH_COUNTS) == {"faas_sweep_win_fused": 1}
    assert g.to_dict()["draws"] == "fused"
    p = rt.sweep(scn, over, 3, replicas=8, execution=plain)
    for a, b in zip(g.summaries.ravel(), p.summaries.ravel()):
        for f in ("n_cold", "n_warm", "n_reject", "sum_cold_resp", "sum_warm_resp"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(a.windows.n_arrivals, b.windows.n_arrivals)
        np.testing.assert_allclose(a.time_running, b.time_running, rtol=INTEGRAL_RTOL)
    fes.LAUNCH_COUNTS.clear()
    rel = rt.Reliability(rt.FailurePolicy(p_fail=0.05, t_timeout=4.0))
    res = rt.run(rt.Scenario.of(scn, window_bounds=None, reliability=rel), 1, replicas=64,
                 execution=card)
    assert dict(fes.LAUNCH_COUNTS) == {"faas_sweep_rely_fused": 1}
    assert res.summary.n_fail.sum() > 0 and np.isfinite(res.summary.goodput)


# ---------------------------------------------------------------------------
# the prestamped paths on non-stationary streams: NHPP thinning, MMPP,
# trace replay, batch arrivals, f32 ties and PAD_TIME tails
# ---------------------------------------------------------------------------

from repro_torch.core import processes as rproc  # noqa: E402
from repro_torch.data.workload import batch_arrivals  # noqa: E402

STREAM_KINDS = ("thinned", "mmpp", "trace_ties", "f32_ties", "long_pad_tail", "batch_gaps")


def _stream(dev, kind, R, K, seed=0):
    """f32 ``[R, K]`` arrival stream of ``kind`` on ``dev`` and whether it
    is prestamped: times thinned and sorted in f64 then cast (their tail
    PAD_TIME), a recorded batch trace (exact ties), times near 1e5 s whose
    f64 gaps fall under f32's spacing (ties made by the cast), a thinned
    stream at a tenth of its envelope (a PAD_TIME tail of ~90%), or batch
    gaps (exact zeros, the gap path)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind in ("thinned", "long_pad_tail"):
        amp = 0.8 if kind == "thinned" else 0.0
        prof = rproc.SinusoidalRate(base=1.0, amplitude=amp, period=150.0)
        if kind == "long_pad_tail":
            prof = rproc.PiecewiseConstantRate(edges=(40.0,), rates=(1.0, 0.1))
        times, _ = rproc.NHPPArrivalProcess(prof).arrival_times(g, (R, K), dev)
        return times.float(), True
    if kind == "mmpp":
        times, _ = rproc.MMPPArrivalProcess(0.3, 3.0, 1 / 40).arrival_times(g, (R, K), dev)
        return times.float(), True
    if kind == "trace_ties":
        ts = tuple(r.arrival_time for r in batch_arrivals(1.0, 4, 2 * K, seed=seed))
        times, _ = rproc.TraceArrivalProcess(ts).arrival_times(None, (R, K), dev)
        return times.float().contiguous(), True
    if kind == "f32_ties":
        gaps = torch.empty((R, K), dtype=torch.float64, device=dev).exponential_(
            1.0, generator=g).mul_(0.004)
        t64 = 1e5 + gaps.cumsum(1)
        t32 = t64.float()
        assert bool((t32[:, 1:] == t32[:, :-1]).any())  # the cast made ties
        return t32, True
    proc = rproc.BatchArrivalProcess(rproc.ExpSimProcess(rate=0.6), batch_size=3)
    return proc.sample(g, (R, K), dev), False


def _horizon_rows(dev, rng, times, prestamped, R):
    """Per-row t_end and skip inside each stream's arrivals."""
    t = times.double() if prestamped else times.double().cumsum(1)
    last = torch.where(t < 1e29, t, -1.0).amax(1).cpu().numpy()
    first = t[:, 0].cpu().numpy()
    span = np.maximum(last - first, 1.0)
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    t_end = first + span * rng.uniform(0.6, 0.95, R)
    skip = first + span * rng.uniform(0.0, 0.1, R)
    return f32(t_end), f32(skip)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", STREAM_KINDS)
@pytest.mark.parametrize("M", [8, 64])
@pytest.mark.parametrize("windows", [False, True])
def test_faas_timestamp_streams_match_plain(cuda_device, kind, M, windows):
    dev, R, K = cuda_device, 37, 400
    rng = np.random.default_rng(M + len(kind))
    dts, prestamped = _stream(dev, kind, R, K)
    t_end, skip = _horizon_rows(dev, rng, dts, prestamped, R)
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    args = (torch.zeros((R, M), device=dev), torch.full((R, M), -1e30, device=dev),
            torch.full((R, M), -1e30, device=dev), torch.zeros((R,), device=dev),
            f32(20.0 * rng.uniform(0.5, 1.5, R)), dts,
            f32(rng.exponential(2.0, (R, K))), f32(rng.exponential(2.5, (R, K))))
    kw = dict(t_end=t_end, skip=skip, max_concurrency=6 if M == 8 else 1000,
              prestamped=prestamped)
    W = 0
    if windows:
        lo, hi = float(skip.min()), float(t_end.max())
        kw["window_bounds"] = f32(np.tile(np.linspace(lo, hi, 7), (R, 1)))
        W = 6
    key = fes.launch_key(False, windows, False, False)
    before = fes.LAUNCH_COUNTS[key]
    out_k = fes.faas_sweep(*args, **kw)
    assert fes.LAUNCH_COUNTS[key] == before + 1
    acc = _held_rely(out_k, faas_sweep_ref(*args, **kw), W)[4]
    assert acc[:, 0].sum() > 0 and acc[:, 1].sum() > 0  # cold and warm starts


@pytest.mark.cuda
@pytest.mark.parametrize("kind", STREAM_KINDS)
@pytest.mark.parametrize("c", [1, 3, 8])
def test_par_timestamp_streams_match_plain(cuda_device, kind, c):
    dev, R, K, M = cuda_device, 37, 400, 32
    rng = np.random.default_rng(c + len(kind))
    dts, prestamped = _stream(dev, kind, R, K, seed=1)
    t_end, skip = _horizon_rows(dev, rng, dts, prestamped, R)
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    args = (f32(20.0 * rng.uniform(0.5, 1.5, R)), dts, f32(rng.exponential(2.0, (R, K))),
            f32(rng.exponential(2.5, (R, K))))
    kw = dict(t_end=t_end, skip=skip, max_concurrency=100, concurrency=c, slots=M,
              prestamped=prestamped)
    before = pes.LAUNCH_COUNTS["par_sweep"]
    out_k = [o.cpu().numpy() for o in pes.par_sweep(*args, **kw)]
    assert pes.LAUNCH_COUNTS["par_sweep"] == before + 1
    out_p = [o.cpu().numpy() for o in faas_par_sweep_ref(*args, **kw)]
    for a, b in zip(out_k[:4], out_p[:4]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out_k[4][:, EXACT_COLS], out_p[4][:, EXACT_COLS])
    np.testing.assert_allclose(out_k[4][:, PAR_INTEGRAL_COLS], out_p[4][:, PAR_INTEGRAL_COLS],
                               rtol=INTEGRAL_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", STREAM_KINDS[:5])
def test_fleet_merged_timestamp_stream_matches_plain(cuda_device, kind):
    """A timestamp function merged in f64 with a Poisson one (function 1),
    cast after the merge, as the front door stages it."""
    dev, S, K, F, M = cuda_device, 9, 300, 2, 32
    rng = np.random.default_rng(len(kind))
    own, _ = _stream(dev, kind, S, K, seed=2)
    # function 1: Poisson over function 0's span, from its first arrival
    o64 = own.double()
    first = o64[:, :1]
    span = torch.where(o64 < 1e29, o64, -1.0).amax(1, keepdim=True) - first
    other = first + span * torch.tensor(
        np.cumsum(rng.exponential(1.0 / K, (S, K)), axis=1), device=dev)
    t64 = torch.cat([own.double(), other], 1)
    fid = torch.cat([torch.zeros((S, K), dtype=torch.uint8, device=dev),
                     torch.ones((S, K), dtype=torch.uint8, device=dev)], 1)
    times, order = torch.sort(t64, dim=1, stable=True)
    cells = 3
    N = S * cells
    t_end, skip = _horizon_rows(dev, rng, times.float(), True, S)
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    args = (f32(rng.uniform(3.0, 25.0, (N, F))), f32(np.full((N, F), 6.0)),
            f32(np.full(N, 8.0)), t_end.repeat(cells), skip.repeat(cells),
            torch.arange(S, device=dev).repeat(cells), times.float(), fid.gather(1, order),
            f32(rng.exponential(2.0, (S, 2 * K))), f32(rng.exponential(2.5, (S, 2 * K))))
    kw = dict(slots=M, prestamped=True, queue_depth=0)
    acc_p, q_p = (o.cpu().numpy() for o in fleet_sweep_ref(*args, **kw))
    before = fles.LAUNCH_COUNTS["fleet_sweep"]
    acc_k, q_k = (o.cpu().numpy() for o in fles.fleet_sweep(
        *args, **kw, live_bound=_host_bound(args, M)))
    assert fles.LAUNCH_COUNTS["fleet_sweep"] == before + 1
    np.testing.assert_array_equal(acc_k[..., FLEET_EXACT_COLS], acc_p[..., FLEET_EXACT_COLS])
    np.testing.assert_allclose(acc_k[..., 3:5], acc_p[..., 3:5], rtol=INTEGRAL_RTOL)
    assert acc_k[:, 0, 0].sum() > 0 and acc_k[:, 1, 0].sum() > 0


@pytest.mark.cuda
def test_front_doors_run_timestamp_workloads_on_the_kernels(cuda_device):
    import repro_torch as rt

    day = rt.Scenario(
        rate_profile=rt.SinusoidalRate(base=0.9, amplitude=0.7, period=1200.0),
        warm_service_process=rt.ExpSimProcess(rate=1 / 1.991),
        cold_service_process=rt.ExpSimProcess(rate=1 / 2.244),
        expiration_threshold=60.0, sim_time=2400.0, skip_time=0.0, slots=32,
        window_bounds=tuple(np.linspace(0.0, 2400.0, 9)),
    )
    over = {"profile": [rt.SinusoidalRate(0.9, a, 1200.0) for a in (0.2, 0.7)],
            "expiration_threshold": [30.0, 120.0]}
    plain = rt.Execution(backend="ref")  # the plain version, on the card
    fes.LAUNCH_COUNTS.clear()
    g = rt.sweep(day, over, 3, replicas=8, backend="cuda")
    assert dict(fes.LAUNCH_COUNTS) == {"faas_sweep_win": 1}
    p = rt.sweep(day, over, 3, replicas=8, execution=plain)
    for a, b in zip(g.summaries.ravel(), p.summaries.ravel()):
        for f in ("n_cold", "n_warm", "n_reject", "sum_cold_resp", "sum_warm_resp"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(a.windows.n_arrivals, b.windows.n_arrivals)
        np.testing.assert_allclose(a.time_running, b.time_running, rtol=INTEGRAL_RTOL)
    trace = rt.TraceArrivalProcess(tuple(
        r.arrival_time for r in batch_arrivals(0.6, 3, 2400.0, seed=4)))
    fes.LAUNCH_COUNTS.clear()
    runs = [rt.run(rt.Scenario.of(day, window_bounds=None, rate_profile=None,
                                  arrival_process=trace, concurrency_value=3), 1,
                   replicas=16, engine="par", backend="cuda"),
            rt.run(rt.Scenario.of(day, window_bounds=None, rate_profile=None,
                                  arrival_process=rt.MMPPArrivalProcess(0.3, 3.0, 1 / 300)),
                   1, replicas=16, backend="cuda"),
            rt.run(rt.Scenario.of(day, window_bounds=None), 1, replicas=16, engine="temporal",
                   backend="cuda")]
    assert dict(fes.LAUNCH_COUNTS) == {"par_sweep": 1, "faas_sweep": 1, "faas_sweep_grid": 1}
    for r in runs:
        assert np.isfinite(r.summary.avg_server_count) and r.summary.n_cold.sum() > 0


# ---------------------------------------------------------------------------
# the f64 engine's kernels (csrc/scan_event_step.cu, par_scan_event_step.cu)
# against their plain f64 versions (kernels/ref64.py): every path
# ---------------------------------------------------------------------------

from repro_torch.kernels import par_scan_event_step as pss  # noqa: E402
from repro_torch.kernels import scan_event_step as ses  # noqa: E402
from repro_torch.kernels.ref64 import (  # noqa: E402
    ScanLayout,
    par_scan_sweep_ref,
    scan_sweep_ref,
)

# the f64 sums over slots associate differently in the kernel (per-lane
# partials, a butterfly) and in torch: they agree to rounding
SCAN64_RTOL = 1e-10


def _held64(out_k, out_p, layout):
    for name, a, b in zip(out_k._fields, out_k, out_p):
        if name == "acc" or a is None:
            assert b is None or name == "acc", name
            continue
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy(), err_msg=name)
    ak, ap = out_k.acc.cpu().numpy(), out_p.acc.cpu().numpy()
    fl = layout.float_cols
    exact = [c for c in range(layout.cols) if c not in fl]
    np.testing.assert_array_equal(ak[:, exact], ap[:, exact])
    np.testing.assert_allclose(ak[:, fl], ap[:, fl], rtol=SCAN64_RTOL, atol=1e-9)


def _scan64_inputs(dev, seed, R, M, K, rate, prestamped, pool=False):
    rng = np.random.default_rng(seed)
    f64 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64, device=dev)
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    gaps = rng.exponential(1 / rate, (R, K)).astype(np.float32)
    arr = f64(np.cumsum(gaps.astype(np.float64), 1)) if prestamped else f32(gaps)
    if pool:
        live = rng.uniform(size=(R, M)) < 0.3
        alive = torch.tensor(live, device=dev)
        creation = f64(np.where(live, -rng.uniform(0, 600, (R, M)), -1e30))
        busy = f64(np.where(live, rng.uniform(-30, 5, (R, M)), -1e30))
    else:
        alive = torch.zeros((R, M), dtype=torch.bool, device=dev)
        creation = f64(np.full((R, M), -1e30))
        busy = creation.clone()
    horizon = K / rate
    args = (alive, creation, busy, arr, f32(rng.exponential(2.0, (R, K))),
            f32(rng.exponential(2.5, (R, K))))
    kw = dict(t_exp=f64(15.0 * rng.uniform(0.5, 1.5, R)),
              t_end=f64(horizon * rng.uniform(0.5, 0.9, R)),
              skip=f64(horizon * rng.uniform(0.0, 0.1, R)), prestamped=prestamped)
    return rng, args, kw, horizon


def _retry_table(rng, dev, R, K, J=2):
    """A sorted retry table: each base event's J children after it, in
    sorted positions (some past the end: dropped)."""
    first = rng.uniform(size=(R, K)) < 1 / (J + 1)
    child = np.full((R, K), 1 << 30, np.int32)
    for r in range(R):
        for k in range(K):
            if rng.uniform() < 0.8:
                child[r, k] = k + 1 + rng.integers(0, 40)
    return (torch.tensor(first, device=dev),
            torch.tensor(np.minimum(child, 1 << 30).astype(np.int32), device=dev))


SCAN64_CASES = {
    "base": dict(M=40),
    "one_slot_lane": dict(M=7, max_c=100),
    "tight": dict(M=40, max_c=4),
    "prestamped_hist": dict(M=130, prestamped=True, hist=17),
    "oldest_windows": dict(M=64, oldest=True, windows=(0.0, 30.0, 31.0, 200.0, 1e4)),
    "rely": dict(M=40, rely=True, windows=(0.0, 100.0, 300.0, 900.0)),
    "retries": dict(M=40, rely=True, retries=True, max_c=6, hist=5),
    "crashes_capacity": dict(M=300, crashes=True, capped=True, rely=True),
    "crashes_retries": dict(M=64, crashes=True, rely=True, retries=True, oldest=True),
    "grid_pool": dict(M=64, grid=61, pool=True, rely=True, retries=True, hist=9),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SCAN64_CASES))
def test_scan64_kernel_matches_plain(cuda_device, case):
    c = SCAN64_CASES[case]
    R, K, M = 45, 400, c["M"]
    rng, args, kw, horizon = _scan64_inputs(cuda_device, 11, R, M, K, 0.8,
                                            c.get("prestamped", False), c.get("pool", False))
    f64 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64, device=cuda_device)
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=cuda_device)
    kw.update(max_concurrency=c.get("max_c", 1000), hist_bins=c.get("hist", 0),
              routing="oldest" if c.get("oldest") else "newest")
    if "windows" in c:
        kw["window_bounds"] = f64(np.tile(c["windows"], (R, 1)))
    if "grid" in c:
        kw["grid_times"] = f64(np.tile(np.linspace(0.0, horizon, c["grid"]), (R, 1)))
    if c.get("rely"):
        kw.update(t_timeout=f64(rng.uniform(1.0, 6.0, R)), p_fail=f64(rng.uniform(0, 0.3, R)),
                  fail_u=f32(rng.uniform(size=(R, K))))
    if c.get("retries"):
        kw["is_first"], kw["child_pos"] = _retry_table(rng, cuda_device, R, K)
    if c.get("crashes"):
        kw.update(crash_rate=f64(np.where(np.arange(R) % 5 == 0, 0.0, 0.02)),
                  crash_u=f32(rng.uniform(size=(R, K))))
    if c.get("capped"):
        kw.update(cap_edges=f64(np.tile([60.0, 200.0], (R, 1))),
                  cap_values=f64(np.tile([9.0, 2.5, 5.0], (R, 1))))
    layout = ScanLayout(
        W=len(c["windows"]) - 1 if "windows" in c else 0, H=kw["hist_bins"],
        G=c.get("grid", 0), rely=bool(c.get("rely")),
        faults=bool(c.get("crashes") or c.get("capped")))
    before = fes.LAUNCH_COUNTS["scan_sweep"]
    out_k = ses.scan_sweep(*args, **kw)
    torch.cuda.synchronize()
    assert fes.LAUNCH_COUNTS["scan_sweep"] == before + 1
    out_p = scan_sweep_ref(*args, **kw)
    assert out_k.acc.shape == (R, layout.cols)
    _held64(out_k, out_p, layout)
    acc = out_p.acc.cpu().numpy()
    assert acc[:, 0].sum() > 0 and acc[:, 1].sum() > 0
    if case == "tight":
        assert acc[:, 2].sum() > 0
    if c.get("capped"):
        assert acc[:, layout.fault_at + 1].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "M,c,hist,rely,retries,prestamped,max_c",
    [
        (40, 1, 0, False, False, False, 1000),
        (40, 3, 6, False, False, True, 1000),
        (9, 3, 0, True, True, False, 1),  # rejections and retries
        (64, 8, 4, True, False, False, 1000),
        (16, 40, 5, True, True, True, 1000),  # rows split over the lanes
    ],
)
def test_par_scan64_kernel_matches_plain(cuda_device, M, c, hist, rely, retries, prestamped,
                                         max_c):
    R, K = 45, 400
    rng, args, kw, _ = _scan64_inputs(cuda_device, 12, R, M, K, 2.0, prestamped)
    f64 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64, device=cuda_device)
    kw.update(max_concurrency=max_c, concurrency=c, slots=M, hist_bins=hist)
    if rely:
        kw.update(t_timeout=f64(rng.uniform(1.0, 6.0, R)), p_fail=f64(rng.uniform(0, 0.3, R)),
                  fail_u=torch.tensor(rng.uniform(size=(R, K)), dtype=torch.float32,
                                      device=cuda_device))
    if retries:
        kw["is_first"], kw["child_pos"] = _retry_table(rng, cuda_device, R, K)
    before = fes.LAUNCH_COUNTS["par_scan_sweep"]
    out_k = pss.par_scan_sweep(*args[3:], **kw)
    torch.cuda.synchronize()
    assert fes.LAUNCH_COUNTS["par_scan_sweep"] == before + 1
    out_p = par_scan_sweep_ref(*args[3:], **kw)
    _held64(out_k, out_p, ScanLayout(H=hist, rely=rely, par=True))
    if max_c == 1:
        assert out_p.acc[:, 2].sum() > 0


@pytest.mark.cuda
def test_scan64_front_doors_launch_the_kernels(cuda_device):
    import repro_torch as rt

    scn = rt.Scenario(
        arrival_process=rt.ExpSimProcess(rate=0.9),
        warm_service_process=rt.ExpSimProcess(rate=1 / 1.991),
        cold_service_process=rt.ExpSimProcess(rate=1 / 2.244),
        expiration_threshold=60.0, sim_time=2000.0, skip_time=20.0, slots=32,
        track_histogram=True, hist_bins=20, routing="oldest",
    )
    fes.LAUNCH_COUNTS.clear()
    res = rt.run(scn, 0, replicas=16, backend="scan")
    ref = rt.run(scn, 0, replicas=16, backend="scan_ref")
    assert fes.LAUNCH_COUNTS["scan_sweep"] == 1
    np.testing.assert_array_equal(res.summary.n_cold, ref.summary.n_cold)
    np.testing.assert_allclose(res.summary.histogram, ref.summary.histogram, rtol=1e-10,
                               atol=1e-9)
    grid = rt.sweep(scn, {"expiration_threshold": [30.0, 90.0], "scan_unroll": [1, 4]}, 0,
                    replicas=8, backend="scan")
    # the two scan_unroll values share one launch
    assert fes.LAUNCH_COUNTS["scan_sweep"] == 2 and grid.ok.all()
    par = rt.run(rt.Scenario.of(scn, concurrency_value=3), 0, replicas=8, engine="par",
                 backend="scan")
    assert fes.LAUNCH_COUNTS["par_scan_sweep"] == 1 and np.isfinite(par.summary.avg_in_flight)
    with pytest.raises(ValueError, match="scan_ref"):
        rt.run(scn, 0, replicas=2, backend="scan", device="cpu")


# ---------------------------------------------------------------------------
# the redesigned f64 kernels (per-span accrual, an exit bound, order-key
# routing, the inert tail, the histogram credited where the count changes)
# against their plain versions on the hazards of that design
# ---------------------------------------------------------------------------

SCAN64_HAZARDS = (
    "back_timestamps",  # unsorted f64 timestamps: the clock goes back
    "negative_gaps",  # gaps below 0: the clock goes back
    "all_past",  # every event past its row's horizon
    "none_past",  # no event past it
    "past_and_back",  # timestamps past t_end inside a batch, then back inside
    "batch_arrivals",  # groups of equal timestamps
    "pool_ties",  # an initial pool of equal creations, routing "oldest"
    "capacity_ties",  # capacity evictions among equal creations
    "hist_windows",  # histogram mass, window bounds on event clocks
    "grid_on_events",  # grid points on event clocks, from a pool
    "retries",  # children inside and past their 32-event batch
    "crashes_windows",  # crash exits under windows and the histogram
    # unsorted f64 timestamps under crashes, a capacity profile, windows
    # and the histogram: the recount's crash cut, a crash exit's window
    # give-back after the clock went back, the capacity segment's cursor
    "back_crashes_capacity",
    "back_grid",  # unsorted f64 timestamps from a pool, grid points on event clocks
)
# the hazards whose clock goes back
BACK_HAZARDS = ("back_timestamps", "negative_gaps", "past_and_back", "back_crashes_capacity",
                "back_grid")


def _hazard_inputs(dev, hazard, M, R=40, K=300, seed=21):
    """Pool, samples and keyword inputs of the f64 kernels for a hazard."""
    rng = np.random.default_rng(seed)
    f64 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64, device=dev)
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    rate = 0.8
    gaps = rng.exponential(1 / rate, (R, K)).astype(np.float32)
    times = np.cumsum(gaps.astype(np.float64), 1)
    horizon = K / rate
    t_end = horizon * rng.uniform(0.5, 0.9, R)
    skip = horizon * rng.uniform(0.0, 0.1, R)
    prestamped = hazard not in ("negative_gaps", "all_past", "none_past", "pool_ties",
                                "capacity_ties", "crashes_windows")
    if hazard in ("back_timestamps", "back_crashes_capacity", "back_grid"):
        for r in range(R):
            for k in rng.choice(K - 1, K // 10, replace=False):
                times[r, k], times[r, k + 1] = times[r, k + 1], times[r, k]
            k = rng.integers(K // 4, K // 2)
            times[r, k] -= rng.uniform(5.0, 40.0)  # a jump back across events
    elif hazard == "negative_gaps":
        neg = rng.uniform(size=(R, K)) < 0.1
        gaps = np.where(neg, -rng.uniform(0.0, 3.0, (R, K)), gaps).astype(np.float32)
    elif hazard == "all_past":
        t_end, skip = np.full(R, -1.0), np.full(R, -2.0)
    elif hazard == "none_past":
        t_end = np.full(R, 1e9)
    elif hazard == "past_and_back":
        # each row's horizon inside a batch; a few events past it come back
        ends = rng.integers(40, K - 40, R)
        t_end = times[np.arange(R), ends] + 0.5
        for r in range(R):
            for k in rng.choice(np.arange(ends[r] + 2, K), 6, replace=False):
                times[r, k] = t_end[r] - rng.uniform(0.0, 30.0)
    elif hazard == "batch_arrivals":
        times = np.repeat(times[:, ::4], 4, axis=1)[:, :K]
    arr = f64(times) if prestamped else f32(gaps)
    live = rng.uniform(size=(R, M)) < (0.5 if hazard in ("pool_ties", "capacity_ties") else 0.0)
    if hazard in ("grid_on_events", "back_grid", "back_crashes_capacity"):
        live = rng.uniform(size=(R, M)) < 0.3
    creation = np.where(live, -rng.uniform(0, 300, (R, M)), -1e30)
    if hazard in ("pool_ties", "capacity_ties"):
        creation = np.where(live, -100.0 * rng.integers(1, 3, (R, M)), -1e30)
    busy = np.where(live, rng.uniform(-10, 3, (R, M)), -1e30)
    pool = (torch.tensor(live, device=dev), f64(creation), f64(busy))
    kw = dict(t_exp=f64(15.0 * rng.uniform(0.5, 1.5, R)), t_end=f64(t_end), skip=f64(skip),
              prestamped=prestamped, max_concurrency=1000, hist_bins=0)
    seq = dict(warms=f32(rng.exponential(2.0, (R, K))), colds=f32(rng.exponential(2.5, (R, K))))
    if hazard in ("back_timestamps", "negative_gaps", "past_and_back", "batch_arrivals",
                  "hist_windows", "crashes_windows", "all_past", "back_crashes_capacity"):
        kw["hist_bins"] = 12
    if hazard in ("pool_ties", "batch_arrivals"):
        kw["routing"] = "oldest"
    if hazard == "hist_windows":
        # each row's bounds on its own event clocks
        picks = np.sort(rng.choice(np.arange(1, K), 7, replace=False))
        wb = np.concatenate([np.zeros((R, 1)), times[:, picks], np.full((R, 1), 2 * horizon)], 1)
        kw["window_bounds"] = f64(np.ascontiguousarray(wb))
    elif hazard in ("crashes_windows", "back_timestamps", "negative_gaps",
                    "back_crashes_capacity"):
        kw["window_bounds"] = f64(np.tile([0.0, 20.0, 21.0, 100.0, 150.0, 1e4], (R, 1)))
    if hazard in ("grid_on_events", "back_grid"):
        picks = rng.choice(K, 20, replace=False)
        g = np.concatenate([times[:, picks], np.tile(np.linspace(0.0, horizon, 21), (R, 1))], 1)
        kw["grid_times"] = f64(np.ascontiguousarray(np.sort(g, 1)))
    if hazard == "retries":
        kw.update(t_timeout=f64(rng.uniform(1.0, 6.0, R)), p_fail=f64(rng.uniform(0.1, 0.4, R)))
        seq["fail_u"] = f32(rng.uniform(size=(R, K)))
        first = rng.uniform(size=(R, K)) < 0.4
        near = np.arange(K)[None, :] + rng.integers(1, 6, (R, K))  # inside the batch
        far = np.arange(K)[None, :] + rng.integers(30, 100, (R, K))  # past it (or K)
        child = np.where(rng.uniform(size=(R, K)) < 0.5, near, far)
        child = np.where(rng.uniform(size=(R, K)) < 0.85, child, 1 << 30)
        seq["is_first"] = torch.tensor(first, device=dev)
        seq["child_pos"] = torch.tensor(child.astype(np.int32), device=dev)
        kw["max_concurrency"] = 6
    if hazard in ("capacity_ties", "crashes_windows", "back_crashes_capacity"):
        kw.update(crash_rate=f64(np.where(np.arange(R) % 4 == 0, 0.0, 0.03)))
        seq["crash_u"] = f32(rng.uniform(size=(R, K)))
    if hazard in ("capacity_ties", "back_crashes_capacity"):
        kw.update(cap_edges=f64(np.tile([30.0, 90.0, 200.0], (R, 1))),
                  cap_values=f64(np.tile([40.0, 2.0, 7.0, 1.0], (R, 1))))
    return pool, arr, seq, kw


def _layout64(kw, par=False):
    return ScanLayout(
        W=kw["window_bounds"].shape[1] - 1 if "window_bounds" in kw else 0,
        H=kw.get("hist_bins", 0), G=kw["grid_times"].shape[1] if "grid_times" in kw else 0,
        rely="t_timeout" in kw, faults="crash_rate" in kw or "cap_values" in kw, par=par)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 64, 300, 512])
@pytest.mark.parametrize("hazard", SCAN64_HAZARDS)
def test_scan64_redesign_hazards(cuda_device, hazard, M):
    pool, arr, seq, kw = _hazard_inputs(cuda_device, hazard, M)
    args = (*pool, arr, seq.pop("warms"), seq.pop("colds"))
    kw.update(seq)
    out_k = ses.scan_sweep(*args, **kw)
    torch.cuda.synchronize()
    out_p = scan_sweep_ref(*args, **kw)
    lay = _layout64(kw)
    _held64(out_k, out_p, lay)
    acc = out_p.acc.cpu().numpy()
    if hazard == "all_past":
        assert acc[:, :3].sum() == 0
    else:
        assert acc[:, 0].sum() > 0 and acc[:, 1].sum() > 0
    if hazard in ("capacity_ties", "back_crashes_capacity"):
        assert acc[:, lay.fault_at + 1].sum() > 0  # evictions
    if hazard in ("crashes_windows", "back_crashes_capacity"):
        assert acc[:, lay.fault_at].sum() > 0  # crashes
    if hazard == "retries":
        assert out_p.act.any() and acc[:, lay.rely_at + 2].sum() > 0
    if lay.H and hazard not in BACK_HAZARDS:
        # a monotone clock: a histogram's mass is the measured time
        t_end, skip = kw["t_end"].cpu().numpy(), kw["skip"].cpu().numpy()
        mass = out_k.acc[:, lay.hist_at:lay.grid_at].sum(1).cpu().numpy()
        np.testing.assert_allclose(mass, np.maximum(t_end - np.maximum(skip, 0.0), 0.0),
                                   rtol=1e-10, atol=1e-9)


PAR64_HAZARDS = ("back_timestamps", "negative_gaps", "all_past", "none_past",
                 "past_and_back", "batch_arrivals", "retries")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 4, 33, 80])
@pytest.mark.parametrize("hazard", PAR64_HAZARDS)
def test_par_scan64_redesign_hazards(cuda_device, hazard, c):
    _, arr, seq, kw = _hazard_inputs(cuda_device, hazard, 8)
    kw = {k: v for k, v in kw.items() if k not in ("routing", "window_bounds")}
    args = (arr, seq.pop("warms"), seq.pop("colds"))
    kw.update(seq, concurrency=c, slots=64)
    out_k = pss.par_scan_sweep(*args, **kw)
    torch.cuda.synchronize()
    out_p = par_scan_sweep_ref(*args, **kw)
    _held64(out_k, out_p, _layout64(kw, par=True))
    if hazard != "all_past":
        assert out_p.acc[:, 1].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 300, 512])
@pytest.mark.parametrize("c", [1, 4, 80])
def test_par_scan64_redesign_widths(cuda_device, M, c):
    _, arr, seq, kw = _hazard_inputs(cuda_device, "back_timestamps", 8, seed=5)
    kw = {k: v for k, v in kw.items() if k not in ("routing", "window_bounds")}
    args = (arr, seq.pop("warms"), seq.pop("colds"))
    kw.update(concurrency=c, slots=M, max_concurrency=M - 3)
    out_k = pss.par_scan_sweep(*args, **kw)
    torch.cuda.synchronize()
    out_p = par_scan_sweep_ref(*args, **kw)
    _held64(out_k, out_p, _layout64(kw, par=True))


# ---------------------------------------------------------------------------
# the f64 engine's fused draws (scan_event_step.cu's FUSED path) and the f64
# fleet scan (csrc/fleet_scan_event_step.cu) against their plain versions
# ---------------------------------------------------------------------------

from repro_torch.core.processes import PiecewiseConstantRate, SinusoidalRate  # noqa: E402
from repro_torch.kernels import fleet_scan_event_step as fss  # noqa: E402
from repro_torch.kernels.ref64 import (  # noqa: E402
    FLEET64_COLS,
    FLEET64_FLOAT_COLS,
    fleet_scan_sweep_ref,
)

FUSED64_CASES = {
    "exp": dict(dists=("exp", "exp", "exp")),
    "gauss_lognorm": dict(dists=("weibull", "gauss", "lognorm")),
    "pareto_det": dict(dists=("pareto", "det", "exp")),
    "windows_hist": dict(dists=("exp", "exp", "exp"), windows=True, hist=9),
    "oldest_rely": dict(dists=("exp", "exp", "exp"), oldest=True, rely=True),
    "nhpp_sinusoid": dict(dists=("nhpp", "exp", "exp"),
                          profile=SinusoidalRate(0.8, 0.7, 150.0, 0.4)),
    "nhpp_piecewise_layers": dict(
        dists=("nhpp", "exp", "lognorm"), windows=True, hist=7, rely=True,
        profile=PiecewiseConstantRate((40.0, 90.0, 200.0), (1.2, 0.2, 0.9, 0.4))),
}
FUSED64_PARAMS = {"exp": (0.8, 0.0), "gauss": (2.0, 0.5), "lognorm": (0.3, 0.6),
                  "weibull": (1.5, 1.3), "pareto": (2.5, 0.6), "det": (1.1, 0.0)}


def _fused64_call(dev, case, M, R=40, K=400, seed=31):
    """The kernel's and the plain version's arguments for a fused case."""
    c = FUSED64_CASES[case]
    rng = np.random.default_rng(seed)
    f64 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64, device=dev)
    keys = lambda: torch.tensor(rng.integers(0, 2**32, (R, 2), dtype=np.uint64).astype(
        np.uint32), device=dev)
    prof = c.get("profile")
    params = []
    for i, d in enumerate(c["dists"]):
        p = (prof.max_rate(), 0.0) if d == "nhpp" else FUSED64_PARAMS[d]
        if i and d == "exp":
            p = (0.4 + 0.2 * i, 0.0)
        params.append(f64(np.tile(np.asarray(p) * rng.uniform(0.9, 1.1, (R, 1)), 1)))
    horizon = K / 0.8
    kw = dict(t_exp=f64(15.0 * rng.uniform(0.5, 1.5, R)),
              t_end=f64(horizon * rng.uniform(0.5, 0.9, R)),
              skip=f64(horizon * rng.uniform(0.0, 0.1, R)), max_concurrency=M - 2,
              routing="oldest" if c.get("oldest") else "newest", hist_bins=c.get("hist", 0),
              fused_keys=tuple(keys() for _ in range(3)), fused_params=tuple(params),
              fused_dists=c["dists"], fused_k=K)
    if prof is not None:
        kw["fused_profile"] = prof.block()
    if c.get("windows"):
        kw["window_bounds"] = f64(np.tile([0.0, 20.0, 21.0, 100.0, 150.0, 1e4], (R, 1)))
    if c.get("rely"):
        kw.update(t_timeout=f64(rng.uniform(1.0, 6.0, R)), p_fail=f64(rng.uniform(0.1, 0.4, R)),
                  fused_fail_keys=keys())
    pool = (torch.zeros((R, M), dtype=torch.bool, device=dev), f64(np.full((R, M), -1e30)),
            f64(np.full((R, M), -1e30)))
    return pool, kw


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 64, 300])
@pytest.mark.parametrize("case", list(FUSED64_CASES))
def test_fused_scan64_kernel_matches_plain(cuda_device, case, M):
    pool, kw = _fused64_call(cuda_device, case, M)
    ses.LAUNCH_COUNTS.clear()
    out_k = ses.scan_sweep(*pool, None, None, None, **kw)
    torch.cuda.synchronize()
    assert dict(ses.LAUNCH_COUNTS) == {"scan_sweep_fused": 1}
    out_p = scan_sweep_ref(*pool, None, None, None, **kw)
    lay = ScanLayout(W=5 if "window_bounds" in kw else 0, H=kw["hist_bins"],
                     rely="t_timeout" in kw)
    _held64(out_k, out_p, lay)
    acc = out_p.acc.cpu().numpy()
    assert acc[:, 0].sum() > 0 and acc[:, 1].sum() > 0


@pytest.mark.cuda
def test_fused_scan64_thinning_rejects_candidates(cuda_device):
    """An NHPP run routes fewer arrivals than its candidates inside the
    horizon, and the rejected ones still move the clock."""
    pool, kw = _fused64_call(cuda_device, "nhpp_sinusoid", 64)
    out = ses.scan_sweep(*pool, None, None, None, **kw)
    stamped = dict(kw, fused_profile=None, fused_dists=("exp",) + kw["fused_dists"][1:])
    every = ses.scan_sweep(*pool, None, None, None, **stamped)
    torch.cuda.synchronize()
    assert torch.equal(out.t, every.t)
    routed = out.acc[:, :3].sum()
    assert 0 < routed < every.acc[:, :3].sum()


def _fleet64_inputs(dev, seed, F, ncl, limits, prestamped, M, Q=0, streams=7, cells=3, K=400,
                    rate=1.2, back=None):
    rng = np.random.default_rng(seed)
    N = cells * streams
    f64 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64, device=dev)
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    gaps = rng.exponential(1 / rate, (streams, K)).astype(np.float32)
    times = np.cumsum(gaps.astype(np.float64), 1)
    if back == "timestamps":
        for s in range(streams):
            for k in rng.choice(K - 1, K // 10, replace=False):
                times[s, k], times[s, k + 1] = times[s, k + 1], times[s, k]
            times[s, rng.integers(K // 4, K // 2)] -= rng.uniform(5.0, 40.0)
    elif back == "negative_gaps":
        neg = rng.uniform(size=(streams, K)) < 0.1
        gaps = np.where(neg, -rng.uniform(0.0, 3.0, (streams, K)), gaps).astype(np.float32)
    horizon = K / rate
    t_end = horizon * rng.uniform(0.6, 0.9, N)
    if back == "past_and_back":
        ends = rng.integers(40, K - 40, streams)
        for s in range(streams):
            end = times[s, ends[s]]
            for k in rng.choice(np.arange(ends[s] + 2, K), 6, replace=False):
                times[s, k] = end - rng.uniform(0.0, 30.0)
        t_end = np.tile(times[np.arange(streams), ends] + 0.5, cells)
    args = (
        f64(rng.uniform(3.0, 25.0, (N, F))),
        f64(np.broadcast_to(np.asarray(limits, np.float64), (N, F)).copy()),
        f64(np.full(N, ncl)), f64(t_end), f64(horizon * rng.uniform(0.0, 0.1, N)),
        torch.tensor(np.tile(np.arange(streams), cells), device=dev),
        f64(times) if prestamped else f32(gaps),
        torch.tensor(rng.integers(0, F, (streams, K)).astype(np.uint8), device=dev),
        f32(rng.exponential(2.0, (streams, K))), f32(rng.exponential(2.5, (streams, K))),
    )
    kw = dict(slots=M, queue_depth=Q, prestamped=prestamped)
    return rng, args, kw


def _held_fleet64(out_k, out_p, faults):
    for name, a, b in zip(out_k._fields, out_k, out_p):
        if name == "acc" or a is None:
            assert (a is None) == (b is None), name
            continue
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy(), err_msg=name)
    ak, ap = out_k.acc.cpu().numpy(), out_p.acc.cpu().numpy()
    fl = list(FLEET64_FLOAT_COLS)
    exact = [c for c in range(ak.shape[-1]) if c not in fl]
    np.testing.assert_array_equal(ak[..., exact], ap[..., exact])
    np.testing.assert_allclose(ak[..., fl], ap[..., fl], rtol=SCAN64_RTOL, atol=1e-9)


FLEET64_CASES = {
    "one": dict(F=1, Q=0, prestamped=False, ncl=np.inf, limits=1000, M=16),
    "queue_binding": dict(F=3, Q=2, prestamped=True, ncl=4.0, limits=(3, 2, 5), M=16),
    "gaps_queue": dict(F=3, Q=2, prestamped=False, ncl=3.0, limits=1000, M=40),
    "eight_limits": dict(F=8, Q=0, prestamped=True, ncl=np.inf, limits=2, M=16),
    "eight_queue": dict(F=8, Q=4, prestamped=True, ncl=6.0, limits=1000, M=64),
    "nine": dict(F=9, Q=2, prestamped=True, ncl=8.0, limits=1000, M=16),
    "sixteen": dict(F=16, Q=0, prestamped=True, ncl=48.0, limits=1000, M=64),
    "wide_table": dict(F=5, Q=0, prestamped=True, ncl=np.inf, limits=1000, M=300, rate=6.0),
    "crashes": dict(F=4, Q=0, prestamped=True, ncl=12.0, limits=1000, M=16, crashes=True),
    "capacity": dict(F=4, Q=0, prestamped=True, ncl=np.inf, limits=1000, M=16,
                     capacity=(6.0, 1.5, 8.0)),
    "crashes_capacity_ties": dict(F=9, Q=0, prestamped=True, ncl=np.inf, limits=1000, M=16,
                                  crashes=True, capacity=(40.0, 2.0, 7.0), batch=4),
    "back_timestamps": dict(F=4, Q=2, prestamped=True, ncl=5.0, limits=1000, M=16,
                            back="timestamps"),
    "negative_gaps": dict(F=4, Q=0, prestamped=False, ncl=5.0, limits=1000, M=16,
                          back="negative_gaps"),
    "past_and_back": dict(F=3, Q=2, prestamped=True, ncl=5.0, limits=1000, M=16,
                          back="past_and_back"),
    "back_crashes_capacity": dict(F=4, Q=0, prestamped=True, ncl=np.inf, limits=1000, M=16,
                                  crashes=True, capacity=(6.0, 1.5, 8.0), back="timestamps"),
    # every lane of the warp owns a function's columns
    "thirty_two": dict(F=32, Q=2, prestamped=False, ncl=20.0, limits=1000, M=16, rate=6.0),
    # past 32 functions the columns stay in shared memory
    "thirty_three": dict(F=33, Q=2, prestamped=True, ncl=24.0, limits=1000, M=16, rate=6.0),
    "thirty_three_faults": dict(F=33, Q=0, prestamped=True, ncl=np.inf, limits=3, M=16,
                                rate=6.0, crashes=True, capacity=(40.0, 12.0, 30.0)),
    # a table of 4 entries a lane (live bound 65-128): entries past the
    # first leave by exits, crashes and evictions
    "table_of_four": dict(F=4, Q=0, prestamped=True, ncl=100.0, limits=1000, M=64, rate=30.0,
                          K=3000, crashes=True, capacity=(100.0, 40.0, 100.0)),
    # tables of 16 and 32 entries a lane keep the entries' integrals and
    # expiries in shared memory: crash exits, evictions, queues (function 0
    # at a limit of 1) and the tail fold and store from there
    "wide_faults": dict(F=5, Q=0, prestamped=True, ncl=np.inf, limits=1000, M=300, rate=30.0,
                        K=2000, crashes=True, capacity=(100.0, 40.0, 100.0)),
    "wide_queue": dict(F=5, Q=2, prestamped=False, ncl=np.inf, limits=(1, 1000, 1000, 1000, 1000),
                       M=300, rate=30.0, K=2000),
    "table_of_sixteen": dict(F=5, Q=2, prestamped=True, ncl=400.0,
                             limits=(1, 1000, 1000, 1000, 1000), M=300, rate=30.0, K=2000),
    "table_of_sixteen_faults": dict(F=5, Q=0, prestamped=True, ncl=400.0, limits=1000, M=300,
                                    rate=30.0, K=2000, crashes=True,
                                    capacity=(100.0, 40.0, 100.0)),
    # 3,080 fleets at L = 1: more blocks than one wave of ptxas' own register
    # choice holds on an H100, so the launch takes the instance pinned at 6
    # blocks an SM, as the catalog sweep does
    "pinned": dict(F=8, Q=0, prestamped=True, ncl=24.0, limits=1000, M=64, cells=440,
                   pinned=True),
    "pinned_queue": dict(F=8, Q=4, prestamped=True, ncl=16.0, limits=1000, M=64, rate=6.0,
                         cells=440, pinned=True),
    "pinned_faults": dict(F=8, Q=0, prestamped=True, ncl=24.0, limits=1000, M=64, cells=440,
                          crashes=True, capacity=(24.0, 6.0, 24.0), pinned=True),
}
# the table entries a lane the cases' live bounds give the kernel
FLEET64_TABLES = {"table_of_four": 4, "wide_table": 32, "wide_faults": 32, "wide_queue": 32,
                  "table_of_sixteen": 16, "table_of_sixteen_faults": 16}


def _fleet64_case(dev, case, seed=41):
    c = dict(FLEET64_CASES[case])
    rng, args, kw = _fleet64_inputs(dev, seed, c["F"], c["ncl"], c["limits"], c["prestamped"],
                                    c["M"], Q=c["Q"], K=c.get("K", 400), cells=c.get("cells", 3),
                                    rate=c.get("rate", 1.2), back=c.get("back"))
    N, (S, K) = args[0].shape[0], args[6].shape
    if c.get("batch"):
        # groups of equal timestamps: creation ties under the ceiling
        times = args[6].cpu().numpy()
        args = args[:6] + (torch.tensor(np.repeat(times[:, ::c["batch"]], c["batch"], 1)[:, :K],
                                        device=dev),) + args[7:]
    if c.get("crashes"):
        kw.update(crash_rate=torch.tensor(np.where(np.arange(N) % 3 == 0, 0.0, 0.04),
                                          device=dev),
                  crash_u=torch.tensor(rng.uniform(size=(S, K)).astype(np.float32), device=dev))
    if c.get("capacity"):
        # a fractional ceiling: the capacity's step below it still evicts
        kw.update(cap_edges=torch.tensor(np.tile([30.0, 90.0], (N, 1)), device=dev),
                  cap_values=torch.tensor(np.tile(c["capacity"], (N, 1)), device=dev))
    return args, kw, c


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FLEET64_CASES))
def test_fleet_scan_kernel_matches_plain(cuda_device, case):
    args, kw, c = _fleet64_case(cuda_device, case)
    lb = live_bound(args[2].cpu().numpy(), args[1].cpu().numpy(), kw["slots"])
    fss.LAUNCH_COUNTS.clear()
    out_k = fss.fleet_scan_sweep(*args, **kw, live_bound=lb)
    torch.cuda.synchronize()
    faults = "crash_u" in kw or "cap_values" in kw
    key = "fleet_scan_sweep_fault" if faults else "fleet_scan_sweep"
    assert dict(fss.LAUNCH_COUNTS) == {key: 1}
    res = fss.resources(args[0].shape[0], c["F"], c["M"], lb, queue_depth=c["Q"], faults=faults)
    if case in FLEET64_TABLES:
        assert res["entries"] == FLEET64_TABLES[case], res
        assert res["shared_columns"] == (FLEET64_TABLES[case] >= 16), res
    assert res["pinned"] == c.get("pinned", False), res
    out_p = fleet_scan_sweep_ref(*args, **kw)
    _held_fleet64(out_k, out_p, faults)
    acc = out_p.acc.cpu().numpy()
    assert acc[..., 0].sum() > 0 and acc[..., 1].sum() > 0
    if c["Q"]:
        assert acc[..., FLEET64_COLS - 4].sum() > 0  # enqueued
    if c.get("capacity"):
        assert acc[..., FLEET64_COLS + 1].sum() > 0  # evictions
    if c.get("crashes"):
        assert acc[..., FLEET64_COLS].sum() > 0  # crashes


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["eight_queue", "crashes_capacity_ties", "thirty_two",
                                  "thirty_three", "table_of_four", "wide_table", "wide_faults",
                                  "wide_queue", "table_of_sixteen", "table_of_sixteen_faults",
                                  "pinned_queue"])
def test_fleet_scan_reruns_bit_for_bit(cuda_device, case):
    # every column is added in a fixed order (event, then entry and lane at
    # an exit), the sums over slots too: two launches give the same bits
    args, kw, _ = _fleet64_case(cuda_device, case)
    lb = live_bound(args[2].cpu().numpy(), args[1].cpu().numpy(), kw["slots"])
    first = fss.fleet_scan_sweep(*args, **kw, live_bound=lb)
    again = fss.fleet_scan_sweep(*args, **kw, live_bound=lb)
    torch.cuda.synchronize()
    bits = lambda x: x.view(torch.int64) if x.dtype == torch.float64 else x
    for name, a, b in zip(first._fields, first, again):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(bits(a), bits(b)), name


@pytest.mark.cuda
def test_fleet_scan_table_past_its_bound_and_bad_rows_give_nan(cuda_device):
    # ~100 live instances a fleet outgrow a table of 32 entries
    args, kw, _ = _fleet64_case(cuda_device, "wide_table")
    out = fss.fleet_scan_sweep(*args, **kw, live_bound=1)
    torch.cuda.synchronize()
    assert torch.isnan(out.acc).all(-1).any()
    bad = args[:5] + (torch.full_like(args[5], 99),) + args[6:]
    out = fss.fleet_scan_sweep(*bad, **kw)
    torch.cuda.synchronize()
    assert torch.isnan(out.acc).all() and torch.isnan(out.t).all()


@pytest.mark.cuda
def test_fleet_scan_wrapper_checks_inputs(cuda_device):
    args, kw, _ = _fleet64_case(cuda_device, "queue_binding")
    with pytest.raises(ValueError, match="float64"):
        fss.fleet_scan_sweep(args[0].float(), *args[1:], **kw)
    with pytest.raises(ValueError, match="shared memory"):
        fss.fleet_scan_sweep(*args, **dict(kw, queue_depth=4000))
    with pytest.raises(ValueError, match="come together"):
        fss.fleet_scan_sweep(*args, **dict(kw, queue_depth=0), crash_rate=0.1)


@pytest.mark.cuda
def test_front_doors_run_the_f64_fleet_and_fused_kernels(cuda_device):
    import repro_torch as rt
    from repro_torch.data.catalog import fleet_of

    names = ["thumbnail", "compression", "ml-inference"]
    fleet = fleet_of(names, n_cluster=4, queue_depth=2,
                     sim_time=600.0, skip_time=20.0, slots=16)
    fes.LAUNCH_COUNTS.clear()
    res = rt.fleet_run(fleet, 0, replicas=16)  # the default: the f64 fleet scan
    grid = rt.fleet_sweep(fleet, {"expiration_threshold": [30.0, 300.0],
                                  "n_cluster": [4.0, 8.0]}, 0, replicas=16)
    assert dict(fes.LAUNCH_COUNTS) == {"fleet_scan_sweep": 2}
    assert res.summary.max_peak_cluster <= 4.0 and grid.ok.all() and grid.backend == "scan"
    cpu = rt.fleet_sweep(fleet, {"expiration_threshold": [30.0, 300.0],
                                 "n_cluster": [4.0, 8.0]}, 0, replicas=16, device="cpu")
    assert cpu.backend == "scan_ref"
    assert abs(float(grid.cold_start_prob.mean()) - float(cpu.cold_start_prob.mean())) < 0.1
    scn = rt.Scenario(arrival_process=rt.NHPPArrivalProcess(SinusoidalRate(0.9, 0.5, 600.0)),
                      warm_service_process=rt.ExpSimProcess(rate=0.5),
                      cold_service_process=rt.ExpSimProcess(rate=0.4),
                      expiration_threshold=30.0, sim_time=1200.0, skip_time=20.0, slots=32,
                      window_bounds=(0.0, 300.0, 600.0, 1200.0))
    fes.LAUNCH_COUNTS.clear()
    fused = rt.Execution(draws="fused")
    r = rt.run(scn, 2, replicas=32, execution=fused)
    g = rt.sweep(scn, {"expiration_threshold": [10.0, 60.0]}, 2, replicas=32, execution=fused)
    assert dict(fes.LAUNCH_COUNTS) == {"scan_sweep_fused": 2}
    p = rt.run(scn, 2, replicas=32, execution=rt.Execution(draws="fused", backend="scan_ref"))
    for f in ("n_cold", "n_warm", "n_reject", "sum_cold_resp", "sum_warm_resp",
              "lifespan_count"):
        np.testing.assert_array_equal(getattr(r.summary, f), getattr(p.summary, f), err_msg=f)
    assert g.ok.all() and r.summary.windows is not None


# ---------------------------------------------------------------------------
# the online what-if service: deferred sweeps and live ticks on kernels 8, 10
# ---------------------------------------------------------------------------


def _online_base(rt, **kw):
    return rt.Scenario(arrival_process=rt.ExpSimProcess(rate=0.9),
                       warm_service_process=rt.ExpSimProcess(rate=1 / 1.991),
                       cold_service_process=rt.ExpSimProcess(rate=1 / 2.244), **kw)


@pytest.mark.cuda
def test_deferred_sweep_is_the_sync_sweep_and_returns_before_the_kernel(cuda_device):
    import repro_torch as rt
    from repro_torch.core.scenario import PendingSweep

    scn = _online_base(rt, sim_time=1e5, skip_time=100.0)
    over = {"expiration_threshold": [60.0, 300.0, 600.0, 1200.0]}
    ref = rt.sweep(scn, over, 4, replicas=512)
    torch.cuda.synchronize()
    fes.LAUNCH_COUNTS.clear()
    pend = rt.sweep(scn, over, 4, replicas=512, deferred=True)
    done = torch.cuda.Event()
    done.record()
    running = not done.query()  # the launch is still on the card
    assert isinstance(pend, PendingSweep) and dict(fes.LAUNCH_COUNTS) == {"scan_sweep": 1}
    got = pend.result()
    assert running
    assert pend.result() is got
    for f in ("cold_start_prob", "avg_server_count", "developer_cost", "ok"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    for idx in np.ndindex(got.shape):
        for f in ("n_cold", "n_warm", "time_running", "time_idle", "lifespan_sum"):
            np.testing.assert_array_equal(getattr(got.summaries[idx], f),
                                          getattr(ref.summaries[idx], f), err_msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [True, False])
def test_steady_online_ticks_launch_once_and_reserve_nothing(cuda_device, overlap):
    import repro_torch as rt
    from repro_torch.core.scenario import TRACE_COUNTS
    from repro_torch.serving import OnlineConfig, OnlineWhatIfService

    cfg = OnlineConfig(rate_ceiling=4.0, n_bins=8, bin_width=30.0, replicas=64,
                       thresholds=(30.0, 120.0, 600.0), overlap=overlap)
    svc = OnlineWhatIfService(_online_base(rt), cfg)
    rng = np.random.default_rng(0)
    t, recs, rows = 0.0, [], []
    for i in range(6):
        svc.observe(np.sort(t + rng.uniform(0.0, 60.0, rng.poisson(60.0 * (1 + 0.5 * np.sin(i))))))
        t += 60.0
        fes.LAUNCH_COUNTS.clear()
        snap = TRACE_COUNTS["online_tick"]
        seg = torch.cuda.memory_stats()["segment.all.allocated"]
        rec = svc.tick()
        rows.append((dict(fes.LAUNCH_COUNTS), TRACE_COUNTS["online_tick"] - snap,
                     torch.cuda.memory_stats()["segment.all.allocated"] - seg))
        if rec is not None:
            recs.append(rec)
    if svc.flush() is not None:
        recs.append(svc.history[-1])
    assert all(r[0] == {"scan_sweep": 1} for r in rows)
    assert [r[1:] for r in rows[1:]] == [(0, 0)] * 5  # steady: nothing paid again
    assert len(recs) == 6
    off = svc.offline_equivalent(recs[-1])
    np.testing.assert_array_equal(off.cold_start_prob, recs[-1].grid.cold_start_prob)


@pytest.mark.cuda
def test_fleet_online_tick_launches_one_fleet_scan(cuda_device):
    from repro_torch.data.catalog import fleet_of
    from repro_torch.serving import OnlineConfig, OnlineFleetWhatIfService

    fleet = fleet_of(["thumbnail", "crypto-sign", "ml-inference"], n_cluster=12, slots=32)
    svc = OnlineFleetWhatIfService(fleet, OnlineConfig(rate_ceiling=3.0, n_bins=4,
                                                       bin_width=30.0, replicas=32))
    rng = np.random.default_rng(1)
    for i in range(3):
        for name in fleet.names:
            svc.observe(name, np.sort(i * 30.0 + rng.uniform(0.0, 30.0, rng.poisson(20))))
        fes.LAUNCH_COUNTS.clear()
        rec = svc.tick()
        assert dict(fes.LAUNCH_COUNTS) == {"fleet_scan_sweep": 1}
        assert rec.grid.backend == "scan" and rec.headroom == 12 - rec.predicted_total_replicas


# ---------------------------------------------------------------------------
# grid sharding: kernels 1, 8 and 10 launched once a shard, bit for bit with
# the unsharded launch
# ---------------------------------------------------------------------------

SHARD_PLANS = ("twice", "one", "every")


def _shard_plan(how):
    """Two shards on cuda:0, ``devices=1``, or every visible GPU (skipped
    on a host with one)."""
    from repro_torch.core.execution import Execution

    if how == "every":
        if torch.cuda.device_count() < 2:
            pytest.skip("needs more than one visible GPU")
        return Execution(devices=torch.cuda.device_count(), shard="grid")
    return Execution(devices=("cuda:0",) * 2 if how == "twice" else 1, shard="grid")


def _grids_equal(got, want):
    assert got.axes == want.axes
    for f in ("cold_start_prob", "rejection_prob", "avg_server_count", "wasted_ratio",
              "avg_response_time", "developer_cost", "ok"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for idx in np.ndindex(got.shape):
        g, w = got.summaries[idx], want.summaries[idx]
        for f in ("n_cold", "n_warm", "n_reject", "time_running", "time_idle",
                  "sum_cold_resp", "sum_warm_resp", "lifespan_sum", "lifespan_count",
                  "overflow"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f"{f} {idx}")
        if w.windows is not None:
            for f in ("n_cold", "n_warm", "n_arrivals", "time_running", "time_idle"):
                np.testing.assert_array_equal(getattr(g.windows, f), getattr(w.windows, f),
                                              err_msg=f"windows.{f} {idx}")


@pytest.mark.cuda
@pytest.mark.parametrize("windows", [False, True])
@pytest.mark.parametrize("backend", ["scan", "cuda"])
@pytest.mark.parametrize("how", SHARD_PLANS)
def test_sharded_sweep_is_the_unsharded_sweep(cuda_device, how, backend, windows):
    import dataclasses

    import repro_torch as rt

    plan = dataclasses.replace(_shard_plan(how), backend=backend)
    wb = (0.0, 500.0, 2500.0, 5000.0) if windows else None
    scn = _online_base(rt, sim_time=5000.0, skip_time=100.0, window_bounds=wb)
    # 3 x 2 cells x 37 replicas = 222 rows: shards split cells apart
    over = {"expiration_threshold": [60.0, 300.0, 600.0], "arrival_rate": [0.5, 0.9]}
    key = ("scan_sweep" if backend == "scan" else
           "faas_sweep_win" if windows else "faas_sweep")
    ref = rt.sweep(scn, over, 4, replicas=37, backend=backend)
    fes.LAUNCH_COUNTS.clear()
    current = torch.cuda.current_device()
    got = rt.sweep(scn, over, 4, replicas=37, execution=plan)
    assert torch.cuda.current_device() == current  # the launches restore it
    assert dict(fes.LAUNCH_COUNTS) == {key: plan.n_devices}
    assert got.execution.devices == plan.resolved_devices()
    _grids_equal(got, ref)
    if backend == "scan":
        fes.LAUNCH_COUNTS.clear()
        pend = rt.sweep(scn, over, 4, replicas=37, execution=plan, deferred=True)
        assert dict(fes.LAUNCH_COUNTS) == {key: plan.n_devices}
        _grids_equal(pend.result(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["catalog", "queued", "faults"])
@pytest.mark.parametrize("how", SHARD_PLANS)
def test_sharded_fleet_sweep_is_the_unsharded_sweep(cuda_device, how, case):
    """The catalog's 3,072 fleets take kernel 10's pinned L = 1 instance in
    one launch and the unpinned one in each half: the pin moves only the
    timing."""
    import dataclasses

    import repro_torch as rt
    from repro_torch.core.faults import CapacityProfile, FaultModel
    from repro_torch.data.catalog import catalog_names, fleet_of
    from repro_torch.kernels import fleet_scan_event_step as fss

    plan = dataclasses.replace(_shard_plan(how), backend="scan")
    queued = case == "queued"
    fleet = fleet_of(list(catalog_names()), n_cluster=16 if queued else 24,
                     queue_depth=4 if queued else 0, sim_time=1500.0, skip_time=20.0, slots=64)
    if case == "faults":
        fleet = dataclasses.replace(fleet, faults=FaultModel(
            crash_rate=2e-3, capacity=CapacityProfile(edges=(500.0, 1000.0),
                                                      values=(24.0, 6.0, 24.0))))
    over = {"expiration_threshold": [float(x) for x in np.linspace(60.0, 1200.0, 6)]}
    ref = rt.fleet_sweep(fleet, over, 5, replicas=512, backend="scan")
    fes.LAUNCH_COUNTS.clear()
    current = torch.cuda.current_device()
    got = rt.fleet_sweep(fleet, over, 5, replicas=512, execution=plan)
    assert torch.cuda.current_device() == current
    launch_key = "fleet_scan_sweep_fault" if case == "faults" else "fleet_scan_sweep"
    assert dict(fes.LAUNCH_COUNTS) == {launch_key: plan.n_devices}
    if case == "catalog" and how == "twice":
        pins = [fss.resources(n, 8, 64, 24)["pinned"] for n in (3072, 1536)]
        assert pins == [True, False]
    _grids_equal(got, ref)
    for f in ("queue_wait_avg", "cluster_utilization", "peak_cluster"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)


@pytest.mark.cuda
def test_sharded_plan_resolves_on_the_card(cuda_device):
    from repro_torch.core.execution import Execution

    n = torch.cuda.device_count()
    assert Execution(shard="grid").resolved_devices() == tuple(
        torch.device("cuda", i) for i in range(n))
    assert Execution(devices=("cuda",) * 2, shard="grid").resolve()[1] == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="CUDA devices are visible"):
        Execution(devices=n + 1, shard="grid").resolved_devices()
    with pytest.raises(ValueError, match="only"):
        Execution(devices=(f"cuda:{n}",), shard="grid").resolve()
    if n > 1:
        with pytest.raises(ValueError, match="must be the first of devices"):
            Execution(device="cuda:1", devices=("cuda:0", "cuda:1"), shard="grid").resolve()
