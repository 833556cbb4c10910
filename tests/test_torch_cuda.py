"""The CUDA kernels against their plain PyTorch versions on the card.

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
    out_k = [o.cpu().numpy() for o in fes.faas_sweep(*args, **kw)]
    assert fes.LAUNCH_COUNTS["faas_sweep"] == before + 1
    out_p = [o.cpu().numpy() for o in faas_sweep_ref(*args, **kw)]
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


def _par_inputs(dev, seed, R, K, t_exp, prestamped, rate=1.5):
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
        t(rng.exponential(2.0, (R, K))),
        t(rng.exponential(2.5, (R, K))),
    )
    kw = dict(t_end=t(horizon * rng.uniform(0.5, 0.9, R)),
              skip=t(horizon * rng.uniform(0.0, 0.1, R)))
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize(
    "M,c,t_exp,max_c,prestamped",
    [
        (40, 1, 10.0, 100, False),
        (40, 3, 10.0, 4, False),  # rejections
        (7, 80, 30.0, 100, False),  # one slot per lane, 80 sub-slots
        (130, 3, 30.0, 1000, True),  # five slots per lane, absolute timestamps
        (4, 3, 0.5, 100, False),  # cold starts into expired, stale slots
    ],
)
def test_par_kernel_matches_plain(cuda_device, M, c, t_exp, max_c, prestamped):
    args, kw = _par_inputs(cuda_device, 8, 37, 300, t_exp, prestamped)
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
    out_k = [o.cpu().numpy() for o in fes.faas_sweep(*args, **kw)]
    assert fes.LAUNCH_COUNTS["faas_sweep_grid"] == before + 1
    out_p = [o.cpu().numpy() for o in faas_sweep_ref(*args, **kw)]
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
    par = rt.run(scn, 0, replicas=16, engine="par")
    tmp = rt.run(scn, 0, replicas=16, engine="temporal", grid=[0.0, 300.0, 600.0],
                 initial_instances=[rt.InstanceSnapshot(age=30.0, remaining=1.5)])
    assert fes.LAUNCH_COUNTS["par_sweep"] == 1
    assert fes.LAUNCH_COUNTS["faas_sweep_grid"] == 1
    assert np.isfinite(par.summary.avg_in_flight) and par.summary.avg_in_flight > 0
    assert tmp.temporal.total_at[0] == 0.0 and tmp.temporal.total_at[2] > 0


# ---------------------------------------------------------------------------
# the fleet kernel
# ---------------------------------------------------------------------------

from repro_torch.kernels import fleet_event_step as fles  # noqa: E402
from repro_torch.kernels.ref import fleet_sweep_ref  # noqa: E402

# fleet columns that are per-function sums of identically computed values,
# the queue columns and the peak: equal bit for bit
FLEET_EXACT_COLS = [0, 1, 2, 5, 6, 7, 8, 9, 10, 11, 12]


def _fleet_inputs(dev, seed, F, ncl, limits, prestamped, M, streams=9, cells=3, K=400):
    rng = np.random.default_rng(seed)
    rate = 1.2
    gaps = rng.exponential(1 / rate, (streams, K))
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


@pytest.mark.cuda
@pytest.mark.parametrize(
    "F,Q,prestamped,ncl,limits,M",
    [
        (1, 0, False, None, 1000, 40),  # two slots per lane, slots past M masked
        (1, 2, False, 3.0, 1000, 16),  # a queue behind a binding cluster
        (3, 2, True, 4.0, (3, 2, 5), 64),  # F padded to 4 in the warp
        (8, 0, True, None, 2, 16),  # every function's limit binds
        (8, 2, True, 6.0, 1000, 16),
        (8, 0, True, 24.0, 1000, 64),  # the catalog benchmark's layout
    ],
)
def test_fleet_kernel_matches_plain(cuda_device, F, Q, prestamped, ncl, limits, M):
    args, kw = _fleet_inputs(cuda_device, 13 + F + Q, F, ncl, limits, prestamped, M)
    kw["queue_depth"] = Q
    before = fles.LAUNCH_COUNTS["fleet_sweep"]
    acc_k, q_k = (o.cpu().numpy() for o in fles.fleet_sweep(*args, **kw))
    assert fles.LAUNCH_COUNTS["fleet_sweep"] == before + 1
    acc_p, q_p = (o.cpu().numpy() for o in fleet_sweep_ref(*args, **kw))
    np.testing.assert_array_equal(acc_k[..., FLEET_EXACT_COLS], acc_p[..., FLEET_EXACT_COLS])
    np.testing.assert_allclose(acc_k[..., 3:5], acc_p[..., 3:5], rtol=INTEGRAL_RTOL)
    np.testing.assert_array_equal(q_k, q_p)
    assert acc_k[..., 0].sum() > 0 and acc_k[..., 8].sum() > 0
    if Q:
        assert acc_k[..., 10].sum() > 0


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
    with pytest.raises(NotImplementedError, match="Queue A item 4"):
        call(crash_rate=args[2])
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
    res = rt.fleet_run(fleet, 0, replicas=16)
    grid = rt.fleet_sweep(fleet, {"expiration_threshold": [30.0, 300.0],
                                  "n_cluster": [4.0, 8.0]}, 0, replicas=16)
    assert fles.LAUNCH_COUNTS["fleet_sweep"] == 2
    assert res.summary.max_peak_cluster <= 4.0 and res.summary.enqueued.sum() > 0
    assert grid.shape == (2, 2, 3) and grid.ok.all()
    cpu = rt.fleet_sweep(fleet, {"expiration_threshold": [30.0, 300.0],
                                 "n_cluster": [4.0, 8.0]}, 0, replicas=16, device="cpu")
    # the draws differ by device (torch generators), so compare statistics
    assert abs(float(grid.cold_start_prob.mean()) - float(cpu.cold_start_prob.mean())) < 0.1
