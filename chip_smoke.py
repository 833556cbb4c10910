#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases (any failure ends the script with a non-zero exit):

1. device: require CUDA; print the card's name and power limit;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, all started together; print ptxas' registers
   and spills for every template instance;
3. kernels vs plain versions at C=256, M=64, K=4096 from numpy seeds:
   ``faas_sweep`` over several (t_exp, max_concurrency) pairs (one with
   rejections, one prestamped); ``par_sweep`` at c = 1, 3, 80, with
   rejections and prestamped; ``faas_sweep`` with G=61 grid columns from a
   non-empty pool.  Counters, grid columns and final state must be equal;
   the integrals (acc columns 3-4, and 8 for par) within ``INTEGRAL_RTOL``;
4. the main paths through the entry points a user calls, each with the
   launch counts set to 0 just before it and read just after:
   ``sweep()`` of the paper's Table-1 workload over 16 thresholds × 8
   rates × 32 replicas and ``run()`` of Table 1 (``faas_sweep``); the
   paper's Fig. 1 workload with ``run(engine="par")`` at c = 1, 3, 80 over
   4096 replicas (``par_sweep``), c = 1 on the same draws as ``run()``;
   ``run(engine="temporal")`` of Table 1 over one hour from a two-instance
   pool, 4096 replicas, a 61-point grid (``faas_sweep`` with grid
   columns).  Every result finite, and each held to the paper;
5. timing: each kernel at its main path's full width by CUDA events (mean
   of 3 after a warm-up), held once more against its plain version on the
   same inputs (``par_sweep`` at c = 80 on the first 4096 events of the
   full-width rows), with the plain version's time and the card's bound
   for the work this data needs;
6. the kernels line (JSON), the card line, then the device line (JSON) last.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# acc columns that are per-row sums of identically computed values
EXACT_COLS = (0, 1, 2, 5, 6, 7)
# columns 3-4 sum the pool's run/idle time over M slots in a warp-tree
# order (the plain version sums in torch's order), and par's column 8 the
# in-flight time over M*c request slots; each event's sum may differ in its
# last place and the difference random-walks through K sequential f32
# additions, so bound it relative to the column's size
INTEGRAL_RTOL = 1e-4

PAPER_SERVERS = 7.6795  # Table 1: average instance count at (0.9/s, 600 s)
# the JAX reference (backend="ref", CPU) on the Fig. 1 workload, 8
# replicas: average instances at c = 1 and c = 3, requests in flight
REF_FIG1 = {1: 9.93, 3: 3.65}
REF_FIG1_IN_FLIGHT = 3.98

# H100 SXM data-sheet peaks at the full 700 W limit: f32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# f32 operations one arrival needs, counted as the kernel body does them:
# 25 on each slot (integrals 12, expiry 3, alive count 1, newest-idle
# candidate 5, free test 1, update of the chosen slot 3) and 26 on the
# row's scalars (clock 1, clipped interval 4, decisions 12, accumulators 5,
# overflow 4).  An arrival past t_end changes nothing but the clock (1
# operation); its expiries are those of one final pass at the last clock
# (3 on each slot, once per row).
OPS_PER_SLOT_EVENT = 25
OPS_PER_ROW_EVENT = 26
OPS_PER_INERT_EVENT = 1
OPS_PER_SLOT_FINAL = 3
# grid columns: 2 per event (the interval's end, the test against the next
# grid time) and 5 per slot at each grid point (expiry time, live test,
# running and idle tests, count)
GRID_OPS_PER_EVENT = 2
GRID_OPS_PER_SLOT_POINT = 5
# par_sweep: 7 on each slot (live test, alive count, capacity candidate 3,
# free test, chosen-slot test), 11 more on each live slot (expiry time 1,
# run integral 4, idle integral 5, expiry test 1), 7 on each request
# sub-slot of a live slot (busy max 1, in-flight overlap 4, in-flight test
# and count 2) and 32 on the row's scalars (the base 26, the in-flight
# accumulator and its warp sum 6)
PAR_OPS_PER_SLOT_EVENT = 7
PAR_OPS_PER_LIVE_SLOT = 11
PAR_OPS_PER_SUB_SLOT = 7
PAR_OPS_PER_ROW_EVENT = 32

KERNELS = {
    "faas_sweep": dict(
        name="faas_sweep", route="cuda",
        source="src/repro_torch/kernels/csrc/faas_event_step.cu",
        replaces="src/repro/kernels/faas_event_step.py:107",
    ),
    "faas_sweep_grid": dict(
        name="faas_sweep_grid", route="cuda",
        source="src/repro_torch/kernels/csrc/faas_event_step.cu",
        replaces="src/repro/kernels/faas_event_step.py:107",
    ),
    "par_sweep": dict(
        name="par_sweep", route="cuda",
        source="src/repro_torch/kernels/csrc/par_event_step.cu",
        replaces="src/repro/kernels/faas_event_step.py:975",
    ),
}
SOURCES = ("faas_event_step", "par_event_step")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


def table1(rt, **kw):
    d = dict(
        arrival_process=rt.ExpSimProcess(rate=0.9),
        warm_service_process=rt.ExpSimProcess(rate=1 / 1.991),
        cold_service_process=rt.ExpSimProcess(rate=1 / 2.244),
        expiration_threshold=600.0,
        max_concurrency=1000,
        sim_time=1e5,
        skip_time=100.0,
        slots=64,
    )
    d.update(kw)
    return rt.Scenario(**d)


def fig1(rt, c):
    """The paper's Fig. 1 workload (benchmarks/run.py:233-256)."""
    return table1(rt, arrival_process=rt.ExpSimProcess(rate=2.0),
                  expiration_threshold=60.0, sim_time=2e4, concurrency_value=c)


SWEEP_OVER = {
    "expiration_threshold": [30.0, 60.0, 120.0, 180.0, 240.0, 300.0, 450.0,
                             600.0, 750.0, 900.0, 1050.0, 1200.0, 1350.0,
                             1500.0, 1650.0, 1800.0],
    "arrival_rate": [0.1, 0.2, 0.3, 0.5, 0.9, 1.2, 1.5, 2.0],
}
SWEEP_REPLICAS = 32
FULL_REPLICAS = 4096  # rows of the par and temporal main paths
PAR_CS = (1, 3, 80)  # c = 3: the paper's Fig. 1; c = 80: Cloud Run's default
PAR_PLAIN_EVENTS = 4096  # c = 80 is held against its plain version on these
TEMPORAL_SIM = 3600.0
TEMPORAL_GRID = np.linspace(0.0, TEMPORAL_SIM, 61)


def bound_ms(C, M, K, n_active, G=0, grid_hits=0):
    """Least time for one faas_sweep call over ``n_active`` arrivals inside
    their rows' horizons (of C * K staged), with ``grid_hits`` of the C * G
    grid points inside a horizon: its bytes (every input read once, every
    output written once) at HBM rate, or the f32 operations this data
    needs at the f32 peak, whichever is larger."""
    nbytes = (4 * (3 * C * M + 4 * C + 3 * C * K + C * G)
              + 4 * (3 * C * M + C + (8 + 3 * G) * C))
    ops = (n_active * (M * OPS_PER_SLOT_EVENT + OPS_PER_ROW_EVENT)
           + (C * K - n_active) * OPS_PER_INERT_EVENT + C * M * OPS_PER_SLOT_FINAL)
    if G:
        ops += n_active * GRID_OPS_PER_EVENT + grid_hits * M * GRID_OPS_PER_SLOT_POINT
    return _bound(nbytes, ops)


def par_bound_ms(C, M, c, K, n_active, live_slot_events):
    """Least time for one par_sweep call: ``n_active`` arrivals inside
    their horizons, ``live_slot_events`` live instances summed over them."""
    nbytes = 4 * (3 * C + 3 * C * K) + 4 * (2 * C * M + C * c * M + C + 9 * C)
    ops = (n_active * (M * PAR_OPS_PER_SLOT_EVENT + PAR_OPS_PER_ROW_EVENT)
           + live_slot_events * (PAR_OPS_PER_LIVE_SLOT + c * PAR_OPS_PER_SUB_SLOT)
           + (C * K - n_active) * OPS_PER_INERT_EVENT)
    return _bound(nbytes, ops)


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_OPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def arrivals_in_horizon(dts, t_end, chunk=256):
    """Arrivals at or before each row's t_end (the clock summed in f64,
    so it may differ from the kernel's f32 clock by an event per row)."""
    n = 0
    for i in range(0, dts.shape[0], chunk):
        clock = dts[i:i + chunk].double().cumsum(1)
        n += int((clock <= t_end[i:i + chunk, None].double()).sum())
    return n


def fresh_pools(torch, C, M, dev):
    alive = torch.zeros((C, M), dtype=torch.float32, device=dev)
    frozen = torch.full((C, M), -1e30, dtype=torch.float32, device=dev)
    return alive, frozen, frozen, torch.zeros((C,), dtype=torch.float32, device=dev)


def held_against_plain(torch, out_k, out_p, what, integral_cols=(3, 4), exact_from=None):
    """Kernel result vs plain result: state and exact columns equal (and
    every column from ``exact_from`` on: the grid counts), the integrals
    within INTEGRAL_RTOL; returns the largest |acc difference|."""
    for i, (a, b) in enumerate(zip(out_k[:4], out_p[:4])):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: final state output {i} differs from the plain version")
    acc_k, acc_p = out_k[4], out_p[4]
    if acc_k.shape != acc_p.shape:
        raise AssertionError(f"{what}: acc shapes {acc_k.shape} vs {acc_p.shape}")
    cols = list(EXACT_COLS) + (list(range(exact_from, acc_k.shape[1])) if exact_from else [])
    for c in cols:
        if not torch.equal(acc_k[:, c], acc_p[:, c]):
            n = int((acc_k[:, c] != acc_p[:, c]).sum())
            raise AssertionError(f"{what}: acc column {c} differs in {n} rows")
    for c in integral_cols:
        err = (acc_k[:, c] - acc_p[:, c]).abs()
        lim = INTEGRAL_RTOL * acc_p[:, c].abs().clamp_min(1.0)
        if bool((err > lim).any()):
            raise AssertionError(
                f"{what}: acc column {c} off by {err.max().item():.3e} "
                f"(rtol {INTEGRAL_RTOL})"
            )
    return float((acc_k.double() - acc_p.double()).abs().max())


def timed(torch, fn, reps):
    """Mean ms of ``reps`` calls by CUDA events, after one warm-up call."""
    out = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def plain_timed(torch, fn):
    """Host ms of one call of a plain version, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def small_samples(torch, dev, rng, C, K, rate, prestamped):
    dts = rng.exponential(1 / rate, (C, K))
    if prestamped:
        dts = np.cumsum(dts, axis=1)
        dts[:, -K // 8:] = 1e30  # inert padding past the horizon
    return [
        torch.tensor(x, dtype=torch.float32, device=dev)
        for x in (dts, rng.exponential(2.0, (C, K)), rng.exponential(2.5, (C, K)))
    ]


def print_ptxas(log, kernel):
    """The registers and spills ptxas reports for each template instance
    (S slots per lane, and the grid-column instances of faas_sweep)."""
    inst = None  # the template instance the next ptxas lines are about
    for line in log.splitlines():
        m = re.search(kernel + r"ILi(\d+)E(Lb([01])E)?", line)
        if m:
            per_lane = int(m.group(1))
            inst = f"S={per_lane} (M <= {32 * per_lane})" + (
                " grid" if m.group(3) == "1" else "")
        elif inst and ("registers" in line or "spill" in line):
            print(f"  ptxas {kernel} {inst}: {line.split(':', 1)[-1].strip()}")


def main() -> int:
    t_start = time.perf_counter()
    import torch

    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    card = gpu_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.device_count()} visible", flush=True)
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    from repro_torch.core.scenario import sweep_inputs
    from repro_torch.core.simulator import cell_generators, draw_workload_samples
    from repro_torch.core.temporal import _snapshots_to_pool
    from repro_torch.kernels import _build
    from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS, faas_sweep
    from repro_torch.kernels.par_event_step import par_sweep
    from repro_torch.kernels.ref import faas_par_sweep_ref, faas_sweep_ref

    dev = torch.device("cuda", 0)
    errs = {k: 0.0 for k in KERNELS}

    # ---- 2. build
    for name, info in _build.build_all(SOURCES).items():
        print(f"build: {name} in {info['seconds']:.1f} s -> {info['path'].name}")
        print_ptxas(info["log"], {"faas_event_step": "faas_sweep_kernel",
                                  "par_event_step": "par_sweep_kernel"}[name])
    sys.stdout.flush()

    # ---- 3. kernels vs plain versions on the card, small shapes
    C, M, K = 256, 64, 4096
    plain_small_ms = None
    for case, (t_exp, max_c, prestamped) in enumerate(
        [(10.0, 100, False), (3.0, 4, False), (50.0, 2, False), (60.0, 1000, True)]
    ):
        rng = np.random.default_rng(100 + case)
        rate = 0.6
        samples = small_samples(torch, dev, rng, C, K, rate, prestamped)
        horizon = K / rate
        rows = [
            torch.tensor(x, dtype=torch.float32, device=dev)
            for x in (
                t_exp * rng.uniform(0.5, 1.5, C),
                horizon * rng.uniform(0.5, 0.9, C),
                horizon * rng.uniform(0.0, 0.1, C),
            )
        ]
        args = (*fresh_pools(torch, C, M, dev), rows[0], *samples)
        kw = dict(t_end=rows[1], skip=rows[2], max_concurrency=max_c, prestamped=prestamped)
        out_k = faas_sweep(*args, **kw)
        plain_small_ms, out_p = plain_timed(torch, lambda: faas_sweep_ref(*args, **kw))
        err = held_against_plain(torch, out_k, out_p, f"faas case {case}")
        errs["faas_sweep"] = max(errs["faas_sweep"], err)
        tot = out_k[4].sum(0).tolist()
        print(f"kernel==plain faas case {case}: t_exp~{t_exp} max_c={max_c} "
              f"prestamped={prestamped} cold={tot[0]:.0f} warm={tot[1]:.0f} "
              f"reject={tot[2]:.0f} overflow={tot[7]:.0f} max|acc diff|={err:.3e}",
              flush=True)
        if max_c == 4 and tot[2] <= 0:
            raise AssertionError("the max_concurrency=4 case made no rejections")

    for case, (c, t_exp, max_c, prestamped) in enumerate(
        [(1, 60.0, 1000, False), (3, 60.0, 1000, False), (80, 60.0, 1000, False),
         (3, 10.0, 2, False), (3, 60.0, 1000, True)]
    ):
        rng = np.random.default_rng(200 + case)
        rate = 2.0
        samples = small_samples(torch, dev, rng, C, K, rate, prestamped)
        horizon = K / rate
        rows = [
            torch.tensor(x, dtype=torch.float32, device=dev)
            for x in (
                t_exp * rng.uniform(0.5, 1.5, C),
                horizon * rng.uniform(0.5, 0.9, C),
                horizon * rng.uniform(0.0, 0.1, C),
            )
        ]
        kw = dict(t_end=rows[1], skip=rows[2], max_concurrency=max_c,
                  concurrency=c, slots=M, prestamped=prestamped)
        out_k = par_sweep(rows[0], *samples, **kw)
        ms_p, out_p = plain_timed(torch, lambda: faas_par_sweep_ref(rows[0], *samples, **kw))
        err = held_against_plain(torch, out_k, out_p, f"par case {case}",
                                 integral_cols=(3, 4, 8))
        errs["par_sweep"] = max(errs["par_sweep"], err)
        tot = out_k[4].sum(0).tolist()
        print(f"kernel==plain par case {case}: c={c} t_exp~{t_exp} max_c={max_c} "
              f"prestamped={prestamped} cold={tot[0]:.0f} warm={tot[1]:.0f} "
              f"reject={tot[2]:.0f} overflow={tot[7]:.0f} "
              f"in-flight/running={tot[8] / max(tot[3], 1e-9):.3f} "
              f"max|acc diff|={err:.3e} (plain {ms_p:.0f} ms)", flush=True)
        if max_c == 2 and tot[2] <= 0:
            raise AssertionError("the max_concurrency=2 par case made no rejections")

    # the grid columns from a non-empty pool: the temporal path's inputs
    G = TEMPORAL_GRID.size
    rng = np.random.default_rng(300)
    rate = 0.9
    samples = small_samples(torch, dev, rng, C, K, rate, False)
    horizon = K / rate
    live = rng.uniform(size=(C, M)) < 0.2
    to = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    pool = (to(live), to(np.where(live, -rng.uniform(0, 600, (C, M)), -1e30)),
            to(np.where(live, rng.uniform(-300, 5, (C, M)), -1e30)))
    grid_small = np.sort(np.concatenate([[0.0], rng.uniform(0, horizon, G - 1)]))
    kw = dict(t_end=to(horizon * rng.uniform(0.5, 0.9, C)), skip=0.0,
              max_concurrency=1000, grid_times=to(np.tile(grid_small, (C, 1))))
    args = (*pool, torch.zeros((C,), dtype=torch.float32, device=dev),
            to(60.0 * rng.uniform(0.5, 1.5, C)), *samples)
    out_k = faas_sweep(*args, **kw)
    ms_p, out_p = plain_timed(torch, lambda: faas_sweep_ref(*args, **kw))
    err = held_against_plain(torch, out_k, out_p, "faas grid case", exact_from=8)
    errs["faas_sweep_grid"] = err
    gsum = out_k[4][:, 8:].sum(0)
    print(f"kernel==plain faas grid case: C={C} M={M} K={K} G={G}, "
          f"{int(live.sum())} live instances at t=0; running counts "
          f"{gsum[:G].sum().item():.0f}, idle {gsum[G:2 * G].sum().item():.0f}, "
          f"no-idle points {gsum[2 * G:].sum().item():.0f}; grid columns and "
          f"counters equal; max|acc diff|={err:.3e} (plain {ms_p:.0f} ms)", flush=True)
    if gsum[:G].sum() <= 0 or gsum[G:2 * G].sum() <= 0:
        raise AssertionError("the grid case counted no running or no idle instance")

    # ---- 4. the main paths through the entry points a user calls
    scn = table1(rt)
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    grid = rt.sweep(scn, SWEEP_OVER, seed=0, replicas=SWEEP_REPLICAS)
    sweep_s = time.perf_counter() - t0
    sweep_launches = LAUNCH_COUNTS["faas_sweep"]
    if sweep_launches < 1:
        raise AssertionError("sweep() did not launch the faas_sweep kernel")
    if not grid.ok.all():
        raise AssertionError(f"{int((~grid.ok).sum())} sweep cells are not finite")
    servers = float(grid.sel(arrival_rate=0.9, expiration_threshold=600.0).avg_server_count)
    print(f"sweep: {grid.shape} cells x {SWEEP_REPLICAS} replicas, "
          f"{sweep_launches} launch(es), {sweep_s:.2f} s wall; "
          f"(0.9/s, 600 s) avg servers {servers:.4f} (paper {PAPER_SERVERS})", flush=True)
    if abs(servers / PAPER_SERVERS - 1) > 0.05:
        raise AssertionError("the Table-1 cell is more than 5% from the paper")

    LAUNCH_COUNTS.clear()
    res = rt.run(table1(rt, sim_time=2e5), seed=1, replicas=64)
    run_launches = LAUNCH_COUNTS["faas_sweep"]
    if run_launches < 1:
        raise AssertionError("run() did not launch the faas_sweep kernel")
    print(f"run: Table 1, 64 replicas, {run_launches} launch(es): "
          f"avg servers {res.avg_server_count:.4f} (paper {PAPER_SERVERS}), "
          f"cold start {100 * res.cold_start_prob:.3f}% (paper 0.14%)", flush=True)
    if abs(res.avg_server_count / PAPER_SERVERS - 1) > 0.05:
        raise AssertionError("run() Table 1 is more than 5% from the paper")

    # the par engine on Fig. 1, full width
    par_res, par_wall = {}, {}
    LAUNCH_COUNTS.clear()
    for c in PAR_CS:
        t0 = time.perf_counter()
        par_res[c] = rt.run(fig1(rt, c), seed=2, replicas=FULL_REPLICAS, engine="par")
        par_wall[c] = time.perf_counter() - t0
    par_launches = LAUNCH_COUNTS["par_sweep"]
    if par_launches != len(PAR_CS) or LAUNCH_COUNTS["faas_sweep"]:
        raise AssertionError(f"run(engine='par') launches: {dict(LAUNCH_COUNTS)}")
    base_c1 = rt.run(fig1(rt, 1), seed=2, replicas=FULL_REPLICAS)
    K_par = fig1(rt, 1).steps_needed()
    for c in PAR_CS:
        s = par_res[c].summary
        vals = [s.avg_server_count, s.avg_in_flight, s.avg_instance_occupancy,
                s.cold_start_prob, s.avg_response_time]
        if not np.isfinite(vals).all():
            raise AssertionError(f"run(engine='par') at c={c} is not finite: {vals}")
        ref = f" (JAX reference {REF_FIG1[c]})" if c in REF_FIG1 else ""
        print(f"par: Fig. 1, c={c}, {FULL_REPLICAS} replicas x K={K_par}: avg instances "
              f"{s.avg_server_count:.4f}{ref}, in flight {s.avg_in_flight:.4f} "
              f"(reference {REF_FIG1_IN_FLIGHT}), per running instance "
              f"{s.avg_instance_occupancy:.4f}, cold start {100 * s.cold_start_prob:.4f}%, "
              f"run() {par_wall[c]:.2f} s wall", flush=True)
    if not par_res[3].avg_server_count < par_res[1].avg_server_count:
        raise AssertionError("Fig. 1: c = 3 does not need fewer instances than c = 1")
    for f in ("n_cold", "n_warm", "n_reject"):
        if not np.array_equal(getattr(par_res[1].summary, f), getattr(base_c1.summary, f)):
            raise AssertionError(f"par at c = 1 differs from run() in {f}")
    print(f"par: c=1 makes run()'s decisions on the same draws (cold, warm, reject "
          f"equal over {FULL_REPLICAS} replicas); ratio c=1/c=3 "
          f"{par_res[1].avg_server_count / par_res[3].avg_server_count:.3f}", flush=True)

    # the temporal engine: Table 1 over one hour from a two-instance pool
    snaps = [rt.InstanceSnapshot(age=30.0, remaining=1.5),
             rt.InstanceSnapshot(age=120.0, idle_for=20.0)]
    scn_t = table1(rt, sim_time=TEMPORAL_SIM)
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    res_t = rt.run(scn_t, seed=3, replicas=FULL_REPLICAS, engine="temporal",
                   grid=TEMPORAL_GRID, initial_instances=snaps)
    temporal_wall = time.perf_counter() - t0
    temporal_launches = LAUNCH_COUNTS["faas_sweep_grid"]
    if temporal_launches < 1 or LAUNCH_COUNTS["faas_sweep"]:
        raise AssertionError(f"run(engine='temporal') launches: {dict(LAUNCH_COUNTS)}")
    tm = res_t.temporal
    for f in ("running_at", "idle_at", "total_at", "cold_prob_at"):
        if not np.isfinite(getattr(tm, f)).all():
            raise AssertionError(f"temporal {f} is not finite")
    at60 = int(np.argmin(np.abs(TEMPORAL_GRID - 60.0)))
    print(f"temporal: Table 1 over {TEMPORAL_SIM:.0f} s, {FULL_REPLICAS} replicas x "
          f"K={scn_t.steps_needed()}, G={G}, {temporal_launches} launch: total_at "
          f"60 s {tm.total_at[at60]:.4f}, {TEMPORAL_SIM:.0f} s {tm.total_at[-1]:.4f} "
          f"(paper {PAPER_SERVERS}; JAX reference 5.92 and 7.695 at 3600 s); "
          f"cold_prob_at 60 s {100 * tm.cold_prob_at[at60]:.3f}%, {TEMPORAL_SIM:.0f} s "
          f"{100 * tm.cold_prob_at[-1]:.3f}% "
          f"(reference 1.76% and 0.20%); run() {temporal_wall:.2f} s wall", flush=True)
    if abs(tm.total_at[-1] / PAPER_SERVERS - 1) > 0.05:
        raise AssertionError("temporal total_at at the horizon is more than 5% from the paper")
    if not tm.cold_prob_at[at60] > tm.cold_prob_at[-1]:
        raise AssertionError("temporal cold_prob_at(60 s) is not above its value at the horizon")

    # ---- 5. timing at the main paths' full widths, and the plain versions there
    inp = sweep_inputs(scn, SWEEP_OVER, 0, replicas=SWEEP_REPLICAS, device=dev)
    dts, warms, colds = inp.samples
    Cw, Kw = dts.shape
    row = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    args = (*fresh_pools(torch, Cw, scn.slots, dev), row(inp.thr_rows), dts, warms, colds)
    kw = dict(t_end=row(inp.sim_rows), skip=row(inp.skip_rows),
              max_concurrency=scn.max_concurrency)
    ms, out_k = timed(torch, lambda: faas_sweep(*args, **kw), reps=3)
    plain_ms, out_p = plain_timed(torch, lambda: faas_sweep_ref(*args, **kw))
    errs["faas_sweep"] = max(
        errs["faas_sweep"], held_against_plain(torch, out_k, out_p, "full width"))
    # the kernel steps every staged event; only those inside a row's
    # horizon are arrivals the sweep asked for
    events = Cw * Kw
    active = arrivals_in_horizon(dts, kw["t_end"])
    counted = int(out_k[4][:, :3].double().sum())
    b_ms, b_by = bound_ms(Cw, scn.slots, Kw, active)
    b_all_ms, _ = bound_ms(Cw, scn.slots, Kw, events)
    print(f"timing [{card}]: faas_sweep C={Cw} M={scn.slots} K={Kw}: {ms:.3f} ms; "
          f"{active} arrivals in horizon ({100 * active / events:.1f}% of the "
          f"{events} staged events; {counted} past skip) = "
          f"{active / ms * 1e3:.4e} arrivals/s, {events / ms * 1e3:.4e} events "
          f"stepped/s; bound {b_ms:.3f} ms ({b_by}), {b_all_ms:.3f} ms if "
          f"every staged event were stepped; plain version {plain_ms:.1f} ms "
          f"(max|acc diff| {errs['faas_sweep']:.3e}); plain at C={C} M={M} K={K}: "
          f"{plain_small_ms:.1f} ms", flush=True)
    print(f"end to end [{card}]: sweep() {active / sweep_s:.4e} simulated arrivals/s, "
          f"{events / sweep_s:.4e} events stepped/s ({sweep_s:.3f} s incl. draws "
          f"and assembly)", flush=True)
    results = {"faas_sweep": dict(launches=sweep_launches, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by)}
    del args, out_k, out_p, inp, dts, warms, colds

    # temporal: the grid launch at run()'s width, from its snapshot pool
    n_t = scn_t.steps_needed()
    dts, warms, colds = draw_workload_samples(
        scn_t, cell_generators(3, 1, dev)[0], FULL_REPLICAS, n_t, dev)
    Ct = FULL_REPLICAS
    pool = [torch.from_numpy(np.asarray(x, np.float32)).to(dev).expand(Ct, scn_t.slots)
            .contiguous() for x in _snapshots_to_pool(snaps, scn_t.slots)]
    full = lambda v: torch.full((Ct,), v, dtype=torch.float32, device=dev)
    args = (*pool, full(0.0), full(scn_t.expiration_threshold), dts, warms, colds)
    kw = dict(t_end=full(TEMPORAL_SIM), skip=full(0.0), max_concurrency=scn_t.max_concurrency,
              grid_times=row(np.tile(TEMPORAL_GRID, (Ct, 1))))
    ms, out_k = timed(torch, lambda: faas_sweep(*args, **kw), reps=3)
    plain_ms, out_p = plain_timed(torch, lambda: faas_sweep_ref(*args, **kw))
    errs["faas_sweep_grid"] = max(errs["faas_sweep_grid"], held_against_plain(
        torch, out_k, out_p, "temporal full width", exact_from=8))
    if not np.array_equal(out_k[4][:, 8:].double().mean(0).cpu().numpy()[:G], tm.running_at):
        raise AssertionError("the timed grid launch does not reproduce run()'s curves")
    active = arrivals_in_horizon(dts, kw["t_end"])
    hits = Ct * int((TEMPORAL_GRID > 0).sum())  # every point past t = 0 is hit once
    b_ms, b_by = bound_ms(Ct, scn_t.slots, n_t, active, G=G, grid_hits=hits)
    print(f"timing [{card}]: faas_sweep with grid C={Ct} M={scn_t.slots} K={n_t} G={G}: "
          f"{ms:.3f} ms; {active} arrivals in horizon = {active / ms * 1e3:.4e} "
          f"arrivals/s; bound {b_ms:.3f} ms ({b_by}); plain version {plain_ms:.1f} ms "
          f"(grid columns and counters equal, max|acc diff| "
          f"{errs['faas_sweep_grid']:.3e}); run() {temporal_wall:.2f} s wall = "
          f"{active / temporal_wall:.4e} arrivals in horizon/s", flush=True)
    results["faas_sweep_grid"] = dict(launches=temporal_launches, ms=ms, plain_ms=plain_ms,
                                      bound_ms=b_ms, bound_by=b_by)
    del args, out_k, out_p, dts, warms, colds, pool

    # par: one launch at run()'s width for each c, on run()'s own draws
    dts, warms, colds = draw_workload_samples(
        fig1(rt, 3), cell_generators(2, 1, dev)[0], FULL_REPLICAS, K_par, dev)
    Cp = FULL_REPLICAS
    sp = fig1(rt, 3)
    full = lambda v: torch.full((Cp,), v, dtype=torch.float32, device=dev)
    active = arrivals_in_horizon(dts, full(sp.sim_time))
    par_times = {}
    for c in PAR_CS[1:]:
        kw = dict(t_end=full(sp.sim_time), skip=full(sp.skip_time),
                  max_concurrency=sp.max_concurrency, concurrency=c, slots=sp.slots)
        ms, out_k = timed(torch, lambda: par_sweep(full(sp.expiration_threshold),
                                                   dts, warms, colds, **kw), reps=3)
        if not np.array_equal(out_k[4][:, 0].double().cpu().numpy(), par_res[c].summary.n_cold):
            raise AssertionError(f"the timed par launch at c={c} does not reproduce run()")
        # live instances at arrivals: by PASTA, the time average of the run
        live = active * par_res[c].summary.avg_server_count
        b_ms, b_by = par_bound_ms(Cp, sp.slots, c, K_par, active, live)
        if c == 3:
            plain_ms, out_p = plain_timed(torch, lambda: faas_par_sweep_ref(
                full(sp.expiration_threshold), dts, warms, colds, **kw))
            held = "full width"
        else:
            # the plain version is held to the kernel on the first events only
            part = [x[:, :PAR_PLAIN_EVENTS].contiguous() for x in (dts, warms, colds)]
            out_k = par_sweep(full(sp.expiration_threshold), *part, **kw)
            plain_ms, out_p = plain_timed(torch, lambda: faas_par_sweep_ref(
                full(sp.expiration_threshold), *part, **kw))
            held = f"first {PAR_PLAIN_EVENTS} of {K_par} events"
            del part
        err = held_against_plain(torch, out_k, out_p, f"par c={c} {held}",
                                 integral_cols=(3, 4, 8))
        errs["par_sweep"] = max(errs["par_sweep"], err)
        par_times[c] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"timing [{card}]: par_sweep c={c} C={Cp} M={sp.slots} K={K_par}: {ms:.3f} ms; "
              f"{active} arrivals in horizon = {active / ms * 1e3:.4e} arrivals/s; "
              f"bound {b_ms:.3f} ms ({b_by}; {live:.4e} live instance-events by PASTA); "
              f"plain version {plain_ms:.1f} ms on the {held} (held: max|acc diff| "
              f"{err:.3e}); run() {par_wall[c]:.2f} s wall = "
              f"{active / par_wall[c]:.4e} arrivals in horizon/s", flush=True)
        del out_k, out_p
    results["par_sweep"] = dict(launches=par_launches, **par_times[3])
    print(f"script {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 6. kernels line, card line, device line
    print(json.dumps({"kernels": [
        dict(KERNELS[k], **results[k], max_abs_err=errs[k], library_ms=None)
        for k in ("faas_sweep", "faas_sweep_grid", "par_sweep")
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
