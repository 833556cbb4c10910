#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases (any failure ends the script with a non-zero exit):

1. device: require CUDA; print the card's name and power limit;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernel vs plain version at C=256, M=64, K=4096 from numpy seeds, over
   several (t_exp, max_concurrency) pairs (one with rejections, one
   prestamped): acc columns 0, 1, 2, 5, 6, 7 and the final pool state
   must be equal, columns 3-4 within ``INTEGRAL_RTOL``;
4. the main path: ``sweep()`` of the paper's Table-1 workload over 16
   thresholds × 8 rates × 32 replicas (4096 rows, 202,699 arrivals each)
   and ``run()`` of Table 1 (sim_time 2e5, 64 replicas), through the
   kernel (launch counts), every cell finite, and the (0.9, 600) cell
   within 5% of the paper's 7.6795 average instances;
5. timing: the kernel at the sweep's full width, held once more against
   the plain version on the same inputs, with the plain version's time
   and the card's bound for the work this data needs (arrivals inside
   each row's horizon; the staged tail past it only moves the clock);
6. the kernels line (JSON), then the device line (JSON) last.
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
# order (the plain version sums in torch's order); each event's sum may
# differ in its last place and the difference random-walks through K
# sequential f32 additions, so bound it relative to the column's size
INTEGRAL_RTOL = 1e-4

PAPER_SERVERS = 7.6795  # Table 1: average instance count at (0.9/s, 600 s)

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

KERNEL = dict(
    name="faas_sweep",
    route="cuda",
    source="src/repro_torch/kernels/csrc/faas_event_step.cu",
    replaces="src/repro/kernels/faas_event_step.py:107",
)


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


SWEEP_OVER = {
    "expiration_threshold": [30.0, 60.0, 120.0, 180.0, 240.0, 300.0, 450.0,
                             600.0, 750.0, 900.0, 1050.0, 1200.0, 1350.0,
                             1500.0, 1650.0, 1800.0],
    "arrival_rate": [0.1, 0.2, 0.3, 0.5, 0.9, 1.2, 1.5, 2.0],
}
SWEEP_REPLICAS = 32


def bound_ms(C, M, K, n_active):
    """Least time for one faas_sweep call over ``n_active`` arrivals inside
    their rows' horizons (of C * K staged): its bytes (every input read
    once, every output written once) at HBM rate, or the f32 operations
    this data needs at the f32 peak, whichever is larger."""
    nbytes = 4 * (3 * C * M + 4 * C + 3 * C * K) + 4 * (3 * C * M + C + 8 * C)
    ops = (n_active * (M * OPS_PER_SLOT_EVENT + OPS_PER_ROW_EVENT)
           + (C * K - n_active) * OPS_PER_INERT_EVENT + C * M * OPS_PER_SLOT_FINAL)
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


def held_against_plain(torch, out_k, out_p, what):
    """Kernel result vs plain result: state and exact columns equal, the
    integrals within INTEGRAL_RTOL; returns the largest |acc difference|."""
    for name, a, b in zip(("alive", "creation", "busy", "t"), out_k[:4], out_p[:4]):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: final {name} differs from the plain version")
    acc_k, acc_p = out_k[4], out_p[4]
    for c in EXACT_COLS:
        if not torch.equal(acc_k[:, c], acc_p[:, c]):
            n = int((acc_k[:, c] != acc_p[:, c]).sum())
            raise AssertionError(f"{what}: acc column {c} differs in {n} rows")
    for c in (3, 4):
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
    from repro_torch.kernels import _build
    from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS, faas_sweep
    from repro_torch.kernels.ref import faas_sweep_ref

    dev = torch.device("cuda", 0)

    # ---- 2. build
    info = _build.build("faas_event_step")
    print(f"build: faas_event_step in {info['seconds']:.1f} s -> {info['path'].name}")
    slots_per_lane = None  # the template instance the next ptxas lines are about
    for line in info["log"].splitlines():
        m = re.search(r"faas_sweep_kernelILi(\d+)E", line)
        if m:
            slots_per_lane = int(m.group(1))
        elif slots_per_lane and ("registers" in line or "spill" in line):
            print(f"  ptxas S={slots_per_lane} (M <= {32 * slots_per_lane}): "
                  f"{line.split(':', 1)[-1].strip()}")
    sys.stdout.flush()

    # ---- 3. kernel vs plain version on the card, small shapes
    C, M, K = 256, 64, 4096
    phase3_err = 0.0
    plain_small_ms = None
    for case, (t_exp, max_c, prestamped) in enumerate(
        [(10.0, 100, False), (3.0, 4, False), (50.0, 2, False), (60.0, 1000, True)]
    ):
        rng = np.random.default_rng(100 + case)
        rate = 0.6
        dts = rng.exponential(1 / rate, (C, K))
        horizon = K / rate
        if prestamped:
            dts = np.cumsum(dts, axis=1)
            dts[:, -K // 8:] = 1e30  # inert padding past the horizon
        samples = [
            torch.tensor(x, dtype=torch.float32, device=dev)
            for x in (dts, rng.exponential(2.0, (C, K)), rng.exponential(2.5, (C, K)))
        ]
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = faas_sweep_ref(*args, **kw)
        torch.cuda.synchronize()
        plain_small_ms = 1e3 * (time.perf_counter() - t0)
        err = held_against_plain(torch, out_k, out_p, f"case {case}")
        phase3_err = max(phase3_err, err)
        tot = out_k[4].sum(0).tolist()
        print(f"kernel==plain case {case}: t_exp~{t_exp} max_c={max_c} "
              f"prestamped={prestamped} cold={tot[0]:.0f} warm={tot[1]:.0f} "
              f"reject={tot[2]:.0f} overflow={tot[7]:.0f} max|acc diff|={err:.3e}",
              flush=True)
        if max_c == 4 and tot[2] <= 0:
            raise AssertionError("the max_concurrency=4 case made no rejections")

    # ---- 4. the main path through the entry points a user calls
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

    # ---- 5. timing at the sweep's full width, and the plain version there
    inp = sweep_inputs(scn, SWEEP_OVER, 0, replicas=SWEEP_REPLICAS, device=dev)
    dts, warms, colds = inp.samples
    Cw, Kw = dts.shape
    row = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    args = (*fresh_pools(torch, Cw, scn.slots, dev), row(inp.thr_rows), dts, warms, colds)
    kw = dict(t_end=row(inp.sim_rows), skip=row(inp.skip_rows),
              max_concurrency=scn.max_concurrency)
    ms, out_k = timed(torch, lambda: faas_sweep(*args, **kw), reps=3)
    t0 = time.perf_counter()
    out_p = faas_sweep_ref(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    full_err = held_against_plain(torch, out_k, out_p, "full width")
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
          f"(max|acc diff| {full_err:.3e}); plain at C={C} M={M} K={K}: "
          f"{plain_small_ms:.1f} ms", flush=True)
    print(f"end to end [{card}]: sweep() {active / sweep_s:.4e} simulated arrivals/s, "
          f"{events / sweep_s:.4e} events stepped/s ({sweep_s:.3f} s incl. draws "
          f"and assembly); script {time.perf_counter() - t_start:.1f} s")

    # ---- 6. kernels line, device line
    print(card)
    print(json.dumps({"kernels": [dict(
        KERNEL, launches=sweep_launches, max_abs_err=max(full_err, phase3_err),
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
