#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases (any failure ends the script with a non-zero exit):

1. device: require CUDA; print the card's name and power limit;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, all started together in the background (phase
   3's plain versions run meanwhile); print ptxas' registers and spills for
   every template instance;
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
   full-width rows (the Table-1 sweep and ``par_sweep`` at c = 1, 3, 80 on
   their first 4096 events, the temporal launch on all its events; the
   plain versions replay chunks of ``PLAIN_GRAPH_EVENTS`` events from one
   CUDA graph, bit for bit with one eager call, as phases 9, 11 and 12's
   do but for retries), with the plain version's time and the card's bound
   for the work this data needs; ``faas_sweep``'s events past their
   horizons, and its inert tail's share of the time (the Table-1 launch with
   every horizon before the first event, scaled by that share of events);
6. fleets (``fleet_sweep``, in this order): the kernel against its plain
   version on small cases (F = 1, 3, 8; queues of 0 and 2; gap and
   prestamped streams; binding and unbounded clusters; binding limits);
   the full-width catalog sweep through ``fleet_sweep()`` (8 functions,
   ``n_cluster`` 24, 6 thresholds, 512 replicas, ``sim_time`` 1e5 s: one
   launch, the stream held once) with its peak under the cap and its 60 s
   cell held to the JAX reference constants; the same fleet queued
   (``n_cluster`` 16, ``queue_depth`` 4) through ``fleet_run()``; Table 1
   as a one-function fleet against ``run()`` on the same draws (4096
   replicas); the kernel timed at full width, held to its plain version on
   the first 4096 events of both full-width launches;
7. serving (``flash_attention``, ``decode_attention``): each kernel against
   its plain version at small shapes over every option (causal, window,
   prefix_len, softcap; D = 64, 128, 256; G = 1, 4, 8; f32 and bf16; ragged
   cache_len from 1 to T); then ``llama3.2-1b`` at full width through
   ``Replica`` (batch 4 x 2,048-token prompts, ``max_len`` 4,096, 128 new
   tokens): cold and warm times, the keep-alive plan on ``faas_sweep`` and a
   Poisson replay through ``ServerlessPlatform`` (``launch/serve.py``'s
   ``measure`` and ``plan_and_replay``); a teacher-forced prefill and 128
   decode steps with every attention call held to its plain version on the
   same inputs, 16 launches per prefill and per step; the logits against
   the same model under ``kernel_backend("ref")`` at full width with the
   depth cut to 1 layer (at 16 the random-weight model turns any rounding
   difference into uncorrelated logits, which the phase prints at 16 and 2
   layers beside the plain version against itself in another tiling); the
   path's device time by operation (``torch.profiler``); each kernel timed
   at the path's shapes beside its bound, its plain version and
   ``scaled_dot_product_attention``;
8. serving the recurrent archs (``ssd_scan``, ``rglru_scan``, and the
   attention kernels at D = 256, G = 16): each scan kernel against its plain
   version at small shapes (``ssd_scan`` at ``tests/test_kernels.py``'s
   shapes with G = 1, 2 and chunks 64-256, a ragged L and the smoke widths;
   ``rglru_scan`` at W = 64-4,096, a ragged L and L = 1, with and without
   h0, on both load paths: TMA, and ``cp.async`` for W % 4 != 0 and a view
   off 16-byte alignment; B = 1 and more warps than one wave), and
   flash/decode attention at recurrentgemma's heads, window and full ring;
   then ``mamba2-2.7b`` and ``recurrentgemma-9b`` in turn at full width
   through ``Replica`` under phase 7's traffic, ``measure`` and
   ``plan_and_replay``, launches per prefill (64 ``ssd_scan``; 26
   ``rglru_scan`` and 12 ``flash_attention``) and per step (12
   ``decode_attention``), a ``torch.profiler`` breakdown, a teacher-forced
   prefill and 128 steps with every kernel call held to its plain version
   on the same inputs, the logits against ``kernel_backend("ref")`` at full
   depth (printed) and cut to ``RECURRENT_E2E_REPS`` repetitions of the first
   segment's pattern (held), each beside the plain versions in the kernels'
   tilings against the plain versions; each replica freed before the next;
   each kernel timed at the paths' shapes beside its bound and its plain
   version;
9. metric windows, reliability and retries (``faas_sweep``'s optional
   paths, each a template instance counted under its own key): the kernel
   against its plain version at M = 8, 37, 64, 300 from numpy draws
   (irregular and 240 narrow windows, fail-only, retries at J = 1 and 2
   with children inside and past their 32-event batch, windows with
   retries, and a trivial policy bit-equal to none); then through the
   entry points, the launch counts set to 0 before each: the retry
   what-if sweep of ``benchmarks/run.py::bench_retry_sweep`` at
   ``paper_cfg``'s 2e5 s (4 timeouts x 3 thresholds x 128 replicas =
   1,536 rows x ~547,700 attempts, one launch; its peak memory; goodput
   and cold-start probability per cell within ``REF_RETRY_SIGMAS``
   standard errors of ``REF_RETRY``), phase 4's Table-1 sweep with 6
   irregular windows (its base metrics equal phase 4's), a fail-only
   ``run()`` of Table 1 over 4096 replicas (failure and timeout shares
   against their expected values), and the planner under the retry
   policy; each launch timed at full width beside its bound, and held to
   its plain version on its first 4096 events; the invariants (every
   attempt served or rejected; first attempts plus retries = attempts;
   the windows' arrivals = the horizon's);
10. fused draws (the kernel draws every sample from per-row threefry keys,
    each path a template instance counted under its own ``_fused`` key):
    the kernel against its plain version on small cases (every family on
    every stream, M = 8, 37, 64, 300, 258 rows x 509 events; base, 240
    narrow windows, reliability, both) and against the staged kernel on
    the same draws materialized by ``drawplan.materialize_stream`` (bit for
    bit); 2^26 draws of each family under two parameter sets, and of the
    staged Gamma (k = 0.5, 2), empirical and batch samplers, mean and
    variance within 4 standard errors of the closed form; then through the
    entry points, the launch counts set to 0 before each: phase 4's
    Table-1 sweep with ``Execution(draws="fused")`` (one launch, Table 1
    within 5%, each cell's instance count within 4 standard errors of the
    staged sweep's, peak memory beside the staged sweep's), the same sweep
    at 256 replicas (32,768 rows, whose staged buffers would fill the
    card), a fused fail-only ``run()`` and a fused windowed sweep (its
    windows hold the horizon's arrivals); each launch timed at full width
    beside its bound (the draws' int32, f32 and special-function work
    counted) and held to its plain version on its first 4096 events;
11. platform faults (the fault paths of ``faas_sweep`` and ``fleet_sweep``,
    counted under ``_fault`` keys): each kernel against its plain version on
    small cases, bit for bit with the crash clocks compared (crashes,
    capacity or both, alone, with reliability and with retries at M = 8 and
    64, two at M = 300; creation-time ties under a non-integer ceiling; a
    crash past t_end; an interrupted attempt that triggers its retry; fleets
    at F = 1, 3, 8); then through the entry points, the launch counts set to
    0 before each: ``benchmarks/run.py::bench_fault_sweep``'s grid at 512
    replicas (6,144 rows x 5,400 events, one launch, held to plain on all
    events, each cell's availability, cold-start probability and instance
    count within ``REF_FAULT_SIGMAS`` standard errors of ``REF_FAULT``);
    the same scenario through ``run()`` with reliability and with retries;
    phase 4's Table-1 sweep with crashes, timed against the launch without
    faults on the same events; ``examples/chaos.py``'s capacity dip at 4,096
    fleets (held to plain on all events, availability against
    ``REF_FLEET_FAULT``, peak within the ceiling); phase 6's catalog sweep
    with crashes and a dip, timed against the launch without faults, and
    with the crashes alone and the dip alone, each against the same base;
    each beside its bound;
12. non-stationary workloads (absolute timestamps thinned and sorted in f64,
    cast once, through the kernels' ``prestamped`` paths): through the
    entry points, the launch counts set to 0 before each:
    ``examples/diurnal.py``'s what-if at the scale of a real day through
    ``sweep()`` (a ``profile`` axis of 16 ``SinusoidalRate`` profiles x 4
    thresholds x 64 replicas = 4,096 rows x ~142,229 candidate events, 24
    hourly windows, one launch): its wall, the share of it that its staging
    took, the launch again on those inputs by CUDA events beside its bound, peak memory, the ``PAD_TIME`` share and
    simulated arrivals/s; the launch held to plain on its first 4096 events;
    each hour's arrivals, pooled over a profile's replicas, within
    ``HOURLY_SIGMAS`` standard errors of the profile's integral; each cell's
    whole-day cold-start probability and instance count within
    ``REF_NHPP_SIGMAS`` standard errors of ``REF_NHPP``
    (``tools/nhpp_reference.py``); then one ``run()`` of an MMPP workload
    (scan engine), of a 20,000-timestamp ``batch_arrivals`` recording
    through ``engine="par"`` at c = 3 (every replica replays it exactly) and
    of an NHPP profile through ``engine="temporal"``, and a two-function
    ``fleet_sweep()`` with one NHPP function (merged in f64), each held to
    its plain version on its first 4096 events; the sampler check (phase 10)
    covers Gamma, empirical and batch draws on the card;
13. the f64 engine (kernels 8 and 9, ``scan_sweep`` and ``par_scan_sweep``:
    the reference's default ``lax.scan`` substrate, decision for decision),
    through the entry points with ``backend="scan"``, the launch counts set
    to 0 before each: Table 1 through ``run()`` (4 replicas x 2e5 s, within
    5% of the paper) and with 6 windows (its base metrics equal); the
    Table-1 sweep (4,096 rows x 202,699 events) plain and with the
    histogram; Fig. 3's histogram (33 bins, 5e4 s: its mass is replicas x
    measured time); the routing study (newest vs oldest, the lifespan
    ratio); the retry what-if (1,536 x 547,683 attempts, within
    ``REF_RETRY_SIGMAS`` standard errors of ``REF_RETRY``); the fault sweep
    (6,144 x 5,400, ``REF_FAULT``); the diurnal sweep on f64 timestamps
    (``REF_NHPP``); the temporal engine with retries (4,096 x 3,597 base
    events, G = 61, from a two-instance pool); Fig. 1 through
    ``engine="par"`` at c = 1, 3, 80 (4,096 x 41,216; c = 1 makes the pool
    scan's decisions).  Each path is held to its plain f64 version on its
    first 4096 events (counters, state, grid columns and the activation
    plane bit for bit, sums over slots within ``SCAN64_RTOL``), the plain
    version replaying ``PLAIN_GRAPH_EVENTS``-event chunks from one CUDA
    graph (``plain64_launch``; held bit for bit to one eager call on
    ``GRAPH_CHECK_EVENTS`` events of the temporal cell with retries and of
    Fig. 1 at c = 3); the Table-1 sweep with the histogram, the diurnal
    sweep and Fig. 1 at c = 3 and 80 (as f64 timestamps) held once more on
    that prefix with each row's horizon on one of its events inside it
    (``horizon_inside``: the inert tail and the deferred exits at full rows;
    with timestamps, events past the horizon that come back inside it);
    the Table-1 launches and each par launch timed beside
    their bound (the larger of the staged bytes and the f64 work this data
    needs), with each kernel's events past their horizons and its inert
    tail's share of the time (the launch with every horizon before the
    first event, scaled by that share of events);
14. the f64 fleet scan (kernel 10, ``fleet_scan_sweep``, any number of
    functions) and the f64 engine's fused draws (kernel 8's fused path,
    ``scan_sweep_fused``), through the entry points with ``backend="scan"``,
    the launch counts set to 0 before each: phase 6's catalog sweep (3,072
    fleets x 401,579 events, one launch, the 60 s cell within
    ``REF_FLEET_SIGMAS`` standard errors of ``REF_FLEET_SCAN``, the JAX f64
    fleet scan's; peak within ``n_cluster``), timed in turns with the f32
    ``fleet_sweep``; the queued fleet; a 16-function fleet (the catalog
    twice, ``n_cluster`` 48), which the f32 kernel refuses; phase 12's
    two-function NHPP fleet on f64 merged times; the catalog with faults
    and ``examples/chaos.py``'s dip fleet (``REF_FLEET_FAULT``); the
    Table-1 sweep with ``Execution(backend="scan", draws="fused")`` (Table
    1 within 5%, each cell within 4 standard errors of phase 13's staged
    f64 sweep, peak memory beside its), the same at 256 replicas (32,768
    rows), a fused fail-only ``run()`` and windowed sweep, and the diurnal
    what-if of one profile (``SinusoidalRate(0.9, 0.8, DAY)`` x 4
    thresholds x 1,024 replicas, 24 hourly windows) thinned inline (each
    hour within ``HOURLY_SIGMAS`` of the profile's integral, each threshold
    within ``REF_NHPP_SIGMAS`` of ``REF_NHPP``; its wall beside phase 12's
    staged sweep and its staging).  Each launch is held to its plain f64
    version on its first 4096 events (the plain fleet scan and the plain
    fused scan replaying CUDA-graph chunks) and timed by CUDA events beside
    its bound (f64 work, the draws' int32 work); kernel 10's instance
    (pinned or not), registers, local memory and blocks an SM at the
    catalog, the queued fleet and the catalog with faults
    (``fleet_scan_event_step.resources``);
15. the online what-if service (kernels 8, 10 and 1 under ``serving/online.py``),
    each tick with the launch counts set to 0 before it: 15a the single-
    function service on Table 1's base (``OnlineConfig`` of the reference
    benchmark's full size at 512 replicas, 12 ticks of a numpy
    ``SinusoidalRate(1.2, 0.6, 800)`` stream from ``--seed``), overlapped
    (``sweep(deferred=True)``) beside a synchronous twin: per tick the host
    wall, ``scan_sweep``'s ms by CUDA events, the ``online_tick`` delta and
    the new allocator segments (0 after warm-up), one launch a tick, the
    raw and applied thresholds; the twins equal, the last tick's grid equal
    to ``offline_equivalent`` bit for bit, its launch held to the plain f64
    version on every event, and its cold-start probabilities within
    ``REF_ONLINE_SIGMAS`` of ``REF_ONLINE`` (``tools/online_reference.py``);
    15b the same ticks on ``Execution(backend="cuda")`` (one prestamped
    ``faas_sweep`` a tick; the last tick's launch held to the plain version
    on every event, its cold-start probabilities within
    ``REF_ONLINE_SIGMAS`` combined standard errors of 15a's); 15c the fleet service on the 8-function catalog
    (one ``fleet_scan_sweep`` a tick, its ms; each tick's total and
    headroom off its plans; the last tick relaunched and held to the plain
    fleet scan on its first 4096 events); 15d ``plan_fleet_thresholds`` on
    the catalog (8 launches; feasible means within ``n_cluster``), and the
    same plan small on the kernel and on scan_ref's plain loop; 15e
    ``sweep_legacy`` on Fig. 5's grid (16 launches) bit for bit with one
    ``sweep()``;
16. grid sharding (``Execution(devices=..., shard="grid")``) through the
    entry points, each call with the launch counts set to 0 before it and
    read after (one launch a shard): the Table-1 sweep on ``backend="scan"``
    (16a) and ``"cuda"`` (16b), the same sweep deferred (16c) and the
    catalog ``fleet_sweep`` on ``"scan"`` (16d), each unsharded and in
    ``SHARD_TWINS`` shards on cuda:0 in turns (unsharded, sharded, sharded,
    unsharded) and, where more than one GPU is visible, over every GPU:
    every cell bit for bit the unsharded grid's; each launch's device and
    CUDA-event ms (``shard_timer``) and each call's wall;
17. the kernels line (JSON), the card line, then the device line (JSON) last.

Every phase prints its wall time at its end.  ``--seed`` (default 0) seeds
phase 12's draws and recording and phase 15's streams.
"""

import argparse
import contextlib
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# every acc column is a per-row sum of identically computed values (equal
# bit for bit) except the integrals: columns 3-4 (and each metric window's
# two) sum the pool's run/idle time over M slots in a warp-tree order (the
# plain version sums in torch's order), and par's column 8 the in-flight
# time over M*c request slots; each event's sum may differ in its last
# place and the difference random-walks through K sequential f32
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

# fleet_sweep: only the live instances need per-slot work (the live set is
# a bitmask; a dead slot's state is never read), so count 11 on each live
# instance of the fleet (expiry time 1, run integral 3, idle integral 4,
# the two sums 2, expiry test 1), 5 more on each live instance of the
# acting function (idle test 2, newest candidate 3), 2 per function (its
# run/idle sums into the accumulators) and 27 on the fleet's scalars
# (clock 1, clipped interval 4, decisions 12, counters 6, peak 1, the
# lowest free slot 1, the function's and the fleet's live counts 2).  An
# event past t_end changes nothing the fleet reports but the clock (1).
FLEET_OPS_PER_LIVE_SLOT = 11
FLEET_OPS_PER_ACTING_LIVE = 5
FLEET_OPS_PER_FUNCTION_EVENT = 2
FLEET_OPS_PER_FLEET_EVENT = 27
# bytes of one event of the merged stream: time, warm, cold (f32) and fid (uint8)
FLEET_STREAM_BYTES = 13

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
    # faas_sweep's optional paths: template instances of the same kernel
    "faas_sweep_retry": dict(
        name="faas_sweep_retry", route="cuda",
        source="src/repro_torch/kernels/csrc/faas_event_step.cu",
        replaces="src/repro/kernels/faas_event_step.py:107",
    ),
    "faas_sweep_win": dict(
        name="faas_sweep_win", route="cuda",
        source="src/repro_torch/kernels/csrc/faas_event_step.cu",
        replaces="src/repro/kernels/faas_event_step.py:107",
    ),
    "faas_sweep_rely": dict(
        name="faas_sweep_rely", route="cuda",
        source="src/repro_torch/kernels/csrc/faas_event_step.cu",
        replaces="src/repro/kernels/faas_event_step.py:107",
    ),
    # fused draws: the same kernel's template instances that draw their samples
    "faas_sweep_fused": dict(
        name="faas_sweep_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/faas_event_step.cu",
        replaces="src/repro/kernels/faas_event_step.py:107",
    ),
    "faas_sweep_rely_fused": dict(
        name="faas_sweep_rely_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/faas_event_step.cu",
        replaces="src/repro/kernels/faas_event_step.py:107",
    ),
    "faas_sweep_win_fused": dict(
        name="faas_sweep_win_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/faas_event_step.cu",
        replaces="src/repro/kernels/faas_event_step.py:107",
    ),
    # platform faults: the same kernel's template instances with crash clocks
    # and capacity ceilings
    "faas_sweep_fault": dict(
        name="faas_sweep_fault", route="cuda",
        source="src/repro_torch/kernels/csrc/faas_event_step.cu",
        replaces="src/repro/kernels/faas_event_step.py:107",
    ),
    "faas_sweep_rely_fault": dict(
        name="faas_sweep_rely_fault", route="cuda",
        source="src/repro_torch/kernels/csrc/faas_event_step.cu",
        replaces="src/repro/kernels/faas_event_step.py:107",
    ),
    "faas_sweep_retry_fault": dict(
        name="faas_sweep_retry_fault", route="cuda",
        source="src/repro_torch/kernels/csrc/faas_event_step.cu",
        replaces="src/repro/kernels/faas_event_step.py:107",
    ),
    # timestamp streams (NHPP thinning) through the windowed path
    "faas_sweep_win_prestamped": dict(
        name="faas_sweep_win_prestamped", route="cuda",
        source="src/repro_torch/kernels/csrc/faas_event_step.cu",
        replaces="src/repro/kernels/faas_event_step.py:107",
    ),
    "par_sweep": dict(
        name="par_sweep", route="cuda",
        source="src/repro_torch/kernels/csrc/par_event_step.cu",
        replaces="src/repro/kernels/faas_event_step.py:975",
    ),
    "fleet_sweep": dict(
        name="fleet_sweep", route="cuda",
        source="src/repro_torch/kernels/csrc/fleet_event_step.cu",
        replaces="src/repro/kernels/faas_event_step.py:1228",
    ),
    "fleet_sweep_fault": dict(
        name="fleet_sweep_fault", route="cuda",
        source="src/repro_torch/kernels/csrc/fleet_event_step.cu",
        replaces="src/repro/kernels/faas_event_step.py:1228",
    ),
    "flash_attention": dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:28",
    ),
    "decode_attention": dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:28",
    ),
    "ssd_scan": dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:24",
    ),
    "rglru_scan": dict(
        name="rglru_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:20",
    ),
    # the f64 engine: no Pallas kernel; each replaces a lax.scan step
    "scan_sweep": dict(
        name="scan_sweep", route="cuda",
        source="src/repro_torch/kernels/csrc/scan_event_step.cu",
        replaces="src/repro/core/simulator.py:489",
    ),
    "par_scan_sweep": dict(
        name="par_scan_sweep", route="cuda",
        source="src/repro_torch/kernels/csrc/par_scan_event_step.cu",
        replaces="src/repro/core/par_simulator.py:68",
    ),
    # kernel 8's fused draws (the reference's thin= scan, simulator.py:1039)
    "scan_sweep_fused": dict(
        name="scan_sweep_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/scan_event_step.cu",
        replaces="src/repro/core/simulator.py:1039",
    ),
    # kernel 10, the f64 fleet scan (fleet.py:358 _make_fleet_step, :619
    # _fleet_flush), and its fault instances
    "fleet_scan_sweep": dict(
        name="fleet_scan_sweep", route="cuda",
        source="src/repro_torch/kernels/csrc/fleet_scan_event_step.cu",
        replaces="src/repro/core/fleet.py:358",
    ),
    "fleet_scan_sweep_fault": dict(
        name="fleet_scan_sweep_fault", route="cuda",
        source="src/repro_torch/kernels/csrc/fleet_scan_event_step.cu",
        replaces="src/repro/core/fleet.py:358",
    ),
}
SOURCES = ("faas_event_step", "par_event_step", "fleet_event_step",
           "flash_attention", "decode_attention", "ssd_scan", "rglru_scan",
           "scan_event_step", "par_scan_event_step", "fleet_scan_event_step")
# ptxas' name for each source's kernel template
KERNEL_NAMES = {"faas_event_step": "faas_sweep_kernel",
                "par_event_step": "par_sweep_kernel",
                "fleet_event_step": "fleet_sweep_kernel",
                "scan_event_step": "scan_sweep_kernel",
                "par_scan_event_step": "par_scan_kernel",
                "fleet_scan_event_step": "fleet_scan_kernel"}


# the serving phase: llama3.2-1b at full width (src/repro/configs/llama3_2_1b.py)
SERVE_ARCH = "llama3.2-1b"
SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_LEN, SERVE_NEW = 4, 2048, 4096, 128
# the launcher's defaults (launch/serve.py): 0.2 req/s over 20,000 s, 5% SLO
SERVE_RATE, SERVE_HORIZON, SERVE_SLO = 0.2, 20000.0, 0.05
# kernel vs plain on random inputs, per element: f32 within 1e-4 x
# (1 + |plain|) (other summation orders, expf/tanhf against torch's), bf16
# within 2e-2 x (1 + |plain|) (the two versions round p to bf16 at other
# points: the plain decode version rounds the normalised p, the kernel the
# unnormalised one). Over the whole output, the relative L2 distance
# ||kernel - plain|| / ||plain|| within ATT_REL_L2. On the 16-layer path the
# random-weight model's v reaches ~90, and the other rounding of p moves an
# output by up to 2^-8 max|v| however small the output itself: there each
# element is held within 2e-2 x (1 + max|v|), and every call's relative L2
# within ATT_REL_L2
ATT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ATT_REL_L2 = {"float32": 1e-4, "bfloat16": 1e-2}
# End-to-end logits. The random-weight model is chaotic in depth: its
# activations are large (|v| ~ 90, scores ~ 600 at full width), attention is
# near one-hot, and a rounding difference that moves a score past a near-tied
# one flips the attended key; two correct versions (the plain version in two
# tilings) then give uncorrelated logits at 16 layers, and drift already at 2
# (the phase prints both). So every attention call of the 16-layer path is
# held to its plain version on the same inputs, and the logits are held at
# full width with the depth cut to SERVE_E2E_LAYERS = 1, where each position's
# difference comes from that step's kernel call alone: within a relative L2
# distance (||kernel - plain|| / ||plain||) of 5e-2 at the prefill and at
# every teacher-forced decode step.
SERVE_E2E_LAYERS = 1
SERVE_LOGIT_REL = 5e-2
# decode is timed at the middle of the 128 generated tokens
DECODE_TIMED_LEN = SERVE_PROMPT + SERVE_NEW // 2
PEAK_BF16_OPS = 989e12  # dense tensor-core bf16

# the recurrent serving phase: mamba2-2.7b and recurrentgemma-9b at full
# width (src/repro/configs/mamba2_2_7b.py, recurrentgemma_9b.py) under the
# serving phase's traffic
RECURRENT_ARCHS = ("mamba2-2.7b", "recurrentgemma-9b")
# ssd_scan vs its plain version at the model's chunk: the kernel scans in
# 64-token chunks, so its cumulative decays are summed over 64 tokens where
# the plain version's are summed over up to 256 and exp(cum_t - cum_s)
# rounds differently; on the CPU the plain version at 64 and at 256 differ
# by up to 7e-4 x (1 + |y|) per element at strong decay (dA of -1 to -13 a
# token) and by under 1e-5 in relative L2. rglru_scan is held bit for bit:
# both sides round one multiply and one add a step.
SSD_TOL, SSD_REL_L2 = 2e-3, 1e-4
# End-to-end logits of the recurrent archs: at full depth the plain version
# in the kernels' tilings is as far from the plain version as the kernels
# are (random weights amplify any rounding in depth), so the logits are held
# to SERVE_LOGIT_REL at full width cut to this many repetitions of the first
# segment's pattern: the deepest cut read at which that plain pair stays
# within half the limit. tools/recurrent_depth.py reads the plain pair's
# largest distance on an H100 at 1, 2, 4, 8 mamba2 layers as 1.1e-3,
# 5.5e-3, 1.7e-2, 3.8e-2, and at 1 and 2 repetitions of recurrentgemma's
# (rglru, rglru, local) as 0 and 8.8e-2
RECURRENT_E2E_REPS = {"mamba2-2.7b": 4, "recurrentgemma-9b": 1}


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
PAR_PLAIN_EVENTS = 4096  # each c is held against its plain version on these
PLAIN_GRAPH_EVENTS = 128  # events per CUDA-graph replay of a full-width plain run
F32_PLAIN_EVENTS = 4096  # phase 5's Table-1 sweep is held to plain on these
TEMPORAL_SIM = 3600.0
TEMPORAL_GRID = np.linspace(0.0, TEMPORAL_SIM, 61)

# the repo's fleet benchmark at its full grid (benchmarks/run.py:914-925)
# at FleetScenario's default sim_time of 1e5 s; only replicas are chosen
FLEET_THRESHOLDS = [float(x) for x in np.linspace(60.0, 1200.0, 6)]
FLEET_REPLICAS = 512
FLEET_CLUSTER = 24
FLEET_QUEUED = dict(n_cluster=16, queue_depth=4)
FLEET_PLAIN_EVENTS = 4096  # the full-width launches are held to plain on these
# the JAX reference at the 60 s cell (tools/fleet_reference.py --replicas
# 32: JAX fleet_sweep(backend="ref") on the CPU, seed 0): per-function
# cold-start probability and the standard error of its per-replica values,
# and the cluster's average occupancy with its standard error.  The card's
# values (other draws: torch generators) must agree within REF_FLEET_SIGMAS
# standard errors of the difference of the two replica means.
REF_FLEET = dict(
    cold_start_prob=[0.00763286929577589, 0.003122523194178939, 0.039322253316640854,
                     0.012920089066028595, 0.2800758481025696, 0.13221755623817444,
                     0.01889190822839737, 0.061710502952337265],
    cold_start_prob_se=[4.007522183514945e-05, 2.041152014149779e-05,
                        0.00017685719017966435, 6.0654681115940774e-05,
                        0.0011211333353507355, 0.0004569574898031608,
                        8.953830432433068e-05, 0.00026071172033269145],
    avg_cluster_occupancy=21.65937266498804,
    avg_cluster_occupancy_se=0.007633272826279069,
)
REF_FLEET_SIGMAS = 4.0
# the same cell on the JAX f64 fleet scan (tools/fleet_reference.py
# --replicas 32 --backend scan, on the CPU, seed 0), which phase 14's f64
# fleet scan is held to: the f32 block engine's clocks (a step of ~8 ms at
# 1e5 s) move dynamic-html's 80 ms warm services, so its cold starts sit 3%
# (4 standard errors) below the f64 scan's in REF_FLEET
REF_FLEET_SCAN = dict(
    cold_start_prob=[0.0076604890695188945, 0.0032182859799589165, 0.03925099163848414,
                     0.012911388705040328, 0.27973171928676593, 0.13212638974829838,
                     0.018854962883734096, 0.061628019669727245],
    cold_start_prob_se=[4.028368678660978e-05, 1.8858421673705876e-05, 0.00017572701095463705,
                        6.194587967809452e-05, 0.001124667583050419, 0.0004471876548453889,
                        8.96428045650718e-05, 0.00025718496802789356],
    avg_cluster_occupancy=21.678376885262495,
    avg_cluster_occupancy_se=0.007634308891222423,
)

# the reliability and metric-window phase: the retry what-if of
# benchmarks/run.py:746-770 (bench_retry_sweep) at paper_cfg's horizon
# (benchmarks/run.py:62-73): Table 1's workload, 2e5 s, 50 s warm-up,
# 5% failures, an 8 s timeout and 2 retries with jittered backoff, over 4
# timeouts x 3 thresholds x 128 replicas (1,536 rows of ~547,700 attempts)
RETRY_SIM, RETRY_SKIP = 2e5, 50.0
RETRY_OVER = {"t_timeout": [2.0, 4.0, 8.0, 16.0], "expiration_threshold": [30.0, 120.0, 480.0]}
RETRY_REPLICAS = 128
# Table 1's sweep with the irregular windows benchmarks/run.py:636-638
# builds (linspace(0, T/2, 5), then 0.8 T and T; 6 windows)
TABLE1_WINDOWS = tuple(float(x) for x in np.concatenate(
    [np.linspace(0.0, 5e4, 5), [8e4, 1e5]]))
FAIL_REPLICAS = 4096  # rows of the fail-only run()
# the small cases: rows, base events and pool sizes
RELY_SMALL_ROWS, RELY_SMALL_EVENTS, RELY_SMALL_SLOTS = 256, 512, (8, 37, 64, 300)
# a window of the (0.9/s, 600 s) cell holds 32 replicas x >= 12,500 s of
# arrivals (>= 360,000, a standard error under 0.2%): its rate within 2%
WINDOW_RATE_RTOL = 0.02
RELY_PLAIN_EVENTS = 4096  # each full-width launch is held to plain on these
# the JAX reference per cell, t_timeout-major (tools/retry_reference.py
# --replicas 16: JAX sweep() on its f64 scan backend, on the CPU, seed 0):
# goodput (completions/s, replica mean) and cold-start probability (pooled),
# each with the standard error of its per-replica values.  The card's values
# (other draws: torch generators) must agree within REF_RETRY_SIGMAS
# standard errors of the difference.
REF_RETRY = dict(
    goodput=[0.8424412353088272, 0.8436831082770693, 0.8439197299324831, 0.8943704676169042,
             0.8954991872968242, 0.895557951987997, 0.8992119904976245, 0.9003078894723681,
             0.9002625656414104, 0.8993648412103026, 0.9004579269817454, 0.9004160415103776],
    goodput_se=[0.0005480422781949536, 0.00042061351852383354, 0.0006592330425884753,
                0.0005939743440042894, 0.0004857023639073898, 0.0007547012413021584,
                0.0005882586202488277, 0.000492636477202763, 0.0007462667399907878,
                0.0005892743210169087, 0.0004928336052433588, 0.0007450923380168021],
    cold_start_prob=[0.023514728375803862, 0.005231734911162395, 0.0011613808633339994,
                     0.03317980894551506, 0.007506451058220424, 0.0017081018244641075,
                     0.03384669628193179, 0.007631352740025509, 0.0017470224667607438,
                     0.03329810370445652, 0.0074733526692499904, 0.001715520881785645],
    cold_start_prob_se=[7.904913224803728e-05, 2.633463963614601e-05, 1.168738328759959e-05,
                        0.00010721111853022796, 3.641903397969988e-05, 1.927950149789971e-05,
                        0.00011201997470597468, 3.251098474367226e-05, 1.5061139823996076e-05,
                        0.00011186899623955885, 3.6950426330301645e-05, 1.3912355105947077e-05],
)
REF_RETRY_SIGMAS = 4.0
# f32 operations the optional paths add, counted as the kernel body does
# them: windows 9 on the row's scalars per event (the clipped interval 2,
# the cursor 2, membership 2, the counts 3) and, per window an event's
# interval overlaps, 12 on each slot (expiry time 1, run term 3, idle term
# 4, the two products and sums 4) and 5 on the row (bounds 2, the test 1,
# the two sums 2); reliability 8 per event (occupancy 1, timeout and
# failure tests 3, trigger 2, response caps 2); retries 11 more per event
# (activation 3, retry and abandon counts 4, successor checks 4)
WIN_OPS_PER_EVENT = 9
WIN_OPS_PER_SLOT_WINDOW = 12
WIN_OPS_PER_WINDOW = 5
RELY_OPS_PER_EVENT = 8
RETRY_OPS_PER_EVENT = 11


def bound_ms(C, M, K, n_active, G=0, grid_hits=0, W=0, window_passes=0,
             rely=False, retry=False, fault=None):
    """Least time for one faas_sweep call over ``n_active`` events inside
    their rows' horizons (of C * K staged), with ``grid_hits`` of the C * G
    grid points inside a horizon, W windows overlapped ``window_passes``
    times by those events' intervals, the reliability (and retry) path and
    the fault path (``fault``: the profiles' edge count E, -1 without
    capacity, whether crashes run, the cold starts and the evictions): its
    bytes (every input read once, every output written once) at HBM rate,
    or the f32 operations this data needs at the f32 peak, whichever is
    larger."""
    cols = 8 + 5 * W + 3 * G + (4 if rely else 0)
    nbytes = (4 * (3 * C * M + 4 * C + 3 * C * K + C * G + C * (W + 1 if W else 0))
              + 4 * (3 * C * M + C + cols * C))
    ops = (n_active * (M * OPS_PER_SLOT_EVENT + OPS_PER_ROW_EVENT)
           + (C * K - n_active) * OPS_PER_INERT_EVENT + C * M * OPS_PER_SLOT_FINAL)
    if G:
        ops += n_active * GRID_OPS_PER_EVENT + grid_hits * M * GRID_OPS_PER_SLOT_POINT
    if W:
        ops += (n_active * WIN_OPS_PER_EVENT
                + window_passes * (M * WIN_OPS_PER_SLOT_WINDOW + WIN_OPS_PER_WINDOW))
    if rely:
        nbytes += 4 * (2 * C + C * K)  # t_timeout, p_fail; fail_u
        ops += n_active * RELY_OPS_PER_EVENT
    if retry:
        nbytes += 4 * 3 * C * K  # is_first, child_pos in; the activation plane out
        ops += n_active * RETRY_OPS_PER_EVENT
    if fault is not None:
        fb, fo = fault_extra(C, M, K, n_active, *fault)
        nbytes, ops = nbytes + fb, ops + fo
    return _bound(nbytes, ops)


def par_bound_ms(C, M, c, K, n_active, live_slot_events):
    """Least time for one par_sweep call: ``n_active`` arrivals inside
    their horizons, ``live_slot_events`` live instances summed over them."""
    nbytes = 4 * (3 * C + 3 * C * K) + 4 * (2 * C * M + C * c * M + C + 9 * C)
    ops = (n_active * (M * PAR_OPS_PER_SLOT_EVENT + PAR_OPS_PER_ROW_EVENT)
           + live_slot_events * (PAR_OPS_PER_LIVE_SLOT + c * PAR_OPS_PER_SUB_SLOT)
           + (C * K - n_active) * OPS_PER_INERT_EVENT)
    return _bound(nbytes, ops)


def fleet_bound_ms(N, F, S, K, n_active, live_events, acting_live_events, fault=None, M=64):
    """Least time for one fleet_sweep call: N fleets of F functions reading
    a [S, K] stream (held once), ``n_active`` fleet-events inside their
    horizons (of N * K), ``live_events`` live instances of the fleet and
    ``acting_live_events`` live instances of the acting function, each
    summed over those events; with ``fault`` (the profile's edge count E,
    -1 without capacity, whether crashes run, the cold starts, the
    evictions) the fault path's bytes (rates, profiles, the [S, K] crash
    stream in, the [N, F, M] crash clocks out) and work (on each live
    instance per event, on the fleet per event, per cold start, and a pass
    over the F * M slots per eviction)."""
    nbytes = (FLEET_STREAM_BYTES * S * K + 4 * N * (2 * F + 3) + 8 * N
              + 4 * N * F * 14)
    ops = (n_active * (F * FLEET_OPS_PER_FUNCTION_EVENT + FLEET_OPS_PER_FLEET_EVENT)
           + live_events * FLEET_OPS_PER_LIVE_SLOT
           + acting_live_events * FLEET_OPS_PER_ACTING_LIVE
           + (N * K - n_active) * OPS_PER_INERT_EVENT)
    if fault is not None:
        E, crashes, cold_starts, evictions = fault
        nbytes += 4 * N * F * 3 + (4 * N * (2 * E + 1) if E >= 0 else 0)
        if crashes:
            nbytes += 4 * (N + S * K + N * F * M)
        ops += (live_events * FAULT_OPS_PER_SLOT_EVENT + n_active * FAULT_OPS_PER_ROW_EVENT
                + cold_starts * FAULT_OPS_PER_COLD
                + evictions * F * M * FAULT_OPS_PER_EVICT_SLOT)
    return _bound(nbytes, ops)


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_OPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def arrivals_per_row(dts, t_end, chunk=256):
    """Arrivals at or before each row's t_end, as an f64 [C] tensor (the
    clock summed in f64, so it may differ from the kernel's f32 clock by an
    event per row)."""
    import torch

    return torch.cat([
        (dts[i:i + chunk].double().cumsum(1) <= t_end[i:i + chunk, None].double()).sum(1)
        for i in range(0, dts.shape[0], chunk)
    ]).double()


def arrivals_in_horizon(dts, t_end, chunk=256):
    """Arrivals at or before each row's t_end, summed over the rows."""
    return int(arrivals_per_row(dts, t_end, chunk).sum())


def fresh_pools(torch, C, M, dev):
    alive = torch.zeros((C, M), dtype=torch.float32, device=dev)
    frozen = torch.full((C, M), -1e30, dtype=torch.float32, device=dev)
    return alive, frozen, frozen, torch.zeros((C,), dtype=torch.float32, device=dev)


def held_against_plain(torch, out_k, out_p, what, integral_cols=(3, 4)):
    """Kernel result vs plain result: the final state (and the activation
    plane of a retry launch, the crash clocks of a crash launch) equal, or
    None in both, every acc column but the integrals
    equal (the base counters, grid and window counts, the reliability
    columns), the integrals within INTEGRAL_RTOL of their size; returns
    the largest |acc difference|."""
    if len(out_k) != len(out_p):
        raise AssertionError(f"{what}: {len(out_k)} outputs vs {len(out_p)}")
    for i, (a, b) in enumerate(zip(out_k, out_p)):
        if i != 4 and ((a is None) != (b is None) or (a is not None and not torch.equal(a, b))):
            raise AssertionError(f"{what}: output {i} differs from the plain version")
    acc_k, acc_p = out_k[4], out_p[4]
    if acc_k.shape != acc_p.shape:
        raise AssertionError(f"{what}: acc shapes {acc_k.shape} vs {acc_p.shape}")
    for c in range(acc_k.shape[1]):
        if c not in integral_cols and not torch.equal(acc_k[:, c], acc_p[:, c]):
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


def card_state() -> str:
    """The SM clock, temperature and power draw that nvidia-smi reads now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


def against_base(torch, base_fn, fault_fn, reps, rounds):
    """A fault launch against the launch without faults on the same events:
    (base, faults, faults, base) ``rounds`` times, each reading the mean ms
    of ``reps`` calls by CUDA events after a warm-up call, with the card's
    SM clock, temperature and power read while those calls run.  Returns
    the base readings, the fault readings, all of them in order as text,
    and the last fault output."""
    base, fault, text, last = [], [], [], None
    for _ in range(rounds):
        for name, fn in (("base", base_fn), ("faults", fault_fn), ("faults", fault_fn),
                         ("base", base_fn)):
            out = fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                out = fn()
            end.record()
            state = card_state()  # the calls are still running on the card
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / reps
            (base if name == "base" else fault).append(ms)
            if name == "faults":
                last = out
            text.append(f"{name} {ms:.3f} ms [{state}]")
    return base, fault, "; ".join(text), last


def plain_timed(torch, fn):
    """Host ms of one call of a plain version, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def plain_in_graph(torch, run, seq, chunk=PLAIN_GRAPH_EVENTS):
    """A plain version's whole event loop over the ``[R, K]`` tensors ``seq``,
    fast: a plain loop on the card waits on the host to issue each small op
    of each event, so the events after the first chunk run in chunks of
    ``chunk`` replayed from one CUDA graph (the host issues a copy of the
    chunk's inputs and one replay).  ``run(state, part)`` runs the events of
    ``part`` from ``state`` (None: the plain version's own start) and
    returns the next state, a tuple of tensors; chunks so chained continue
    one run bit for bit (``acc0``/``state0`` of the plain versions), and a
    replay issues the kernels an eager call would."""
    K = seq[0].shape[1]
    first = min(chunk, K)
    # the first chunk eagerly: it warms up every op before the capture
    state = run(None, [x[:, :first] for x in seq])
    n = (K - first) // chunk
    if n:
        st = tuple(x.clone() for x in state)
        part = [x[:, first:first + chunk].clone() for x in seq]
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for a, b in zip(st, run(st, part)):
                a.copy_(b)
        for j in range(n):
            lo = first + j * chunk
            for p, x in zip(part, seq):
                p.copy_(x[:, lo:lo + chunk])
            graph.replay()
        state = st
        del graph
    if first + n * chunk < K:
        state = run(state, [x[:, first + n * chunk:] for x in seq])
    return state


def faas_ref_in_graph(torch, args, kw):
    """``faas_sweep_ref(*args, **kw)`` fast, bit for bit the one call: the
    event inputs (the three sample buffers, ``fail_u``, ``crash_u``) in
    chunks replayed from a CUDA graph (:func:`plain_in_graph`), the pool,
    clock, accumulator and crash clocks chained through ``acc0``/``doom0``.
    A retry launch, whose activation plane spans every event, runs as one
    eager call."""
    from repro_torch.kernels.ref import SweepOut, faas_sweep_ref

    if kw.get("is_first") is not None:
        return faas_sweep_ref(*args, **kw)
    ev = [k for k in ("fail_u", "crash_u") if kw.get(k) is not None]
    fixed = {k: v for k, v in kw.items() if k not in ev}
    crash = "crash_u" in ev

    def run(st, part):
        out = faas_sweep_ref(*(args[:4] if st is None else st[:4]), args[4], *part[:3],
                             acc0=None if st is None else st[4],
                             doom0=st[5] if crash and st is not None else None,
                             **fixed, **dict(zip(ev, part[3:])))
        return tuple(out[:5]) + ((out.doom,) if crash else ())

    st = plain_in_graph(torch, run, [*args[5:8], *(kw[k] for k in ev)])
    return SweepOut(*st[:5], None, st[5] if crash else None)


def graph_timed(torch, fn, reps):
    """Device ms of one call: ``reps`` calls captured in a CUDA graph,
    replayed once to warm up, then one replay timed by CUDA events, so no
    host launch time sits between the calls (a call shorter than its host
    side reads at the host's rate under ``timed``)."""
    out = fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            out = fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def device_ms_by_kernel(torch, fn, names, reps=20):
    """Device ms a call of each kernel whose name holds one of ``names``,
    from torch.profiler over ``reps`` calls: the decode split and combine
    kernels launch from one C call, so no CUDA event can sit between them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_time = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    out = {}
    for e in prof.key_averages():
        for name in names:
            if name in e.key and e.device_type == torch.autograd.DeviceType.CUDA:
                out[name] = out.get(name, 0.0) + dev_time(e) / 1e3 / reps
    return out


def decode_timing_line(torch, card, what, kernel, library, B, Hkv, G, D, T, kv_bytes, b_ms,
                       b_by):
    """Times decode_attention at one shape: eager calls by CUDA events (the
    host's launch rate), the device time under a CUDA graph, the split and
    combine kernels apart (profiler), the block count and K/V GB/s; and the
    library call the same two ways. Returns (device ms, library device ms)."""
    from repro_torch.kernels.decode_attention import n_splits

    eager_ms, _ = timed(torch, kernel, reps=20)
    ms, _ = graph_timed(torch, kernel, reps=20)
    parts = device_ms_by_kernel(torch, kernel, ("decode_split", "decode_combine"))
    lib_eager, _ = timed(torch, library, reps=20)
    lib_ms, _ = graph_timed(torch, library, reps=20)
    nsplit, pairs = n_splits(B, Hkv, T, G), B * Hkv * -(-G // 16)
    part = ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()) or "not measured"
    print(f"timing [{card}]: decode_attention {what}: {ms:.4f} ms device (CUDA graph of 20 "
          f"calls), {eager_ms:.4f} ms eager (mean of 20); split/combine by kernel: {part}; "
          f"{pairs * nsplit} split blocks ({nsplit} splits x {pairs} (b, kv head, 16-row "
          f"group)) and {-(-D // 64) * Hkv * G * B} combine blocks (64-column slice x query "
          f"head x b); {kv_bytes / ms / 1e6:.1f} GB/s of K/V ({kv_bytes / 1e6:.2f} MB); bound "
          f"{b_ms:.4f} ms ({b_by}), kernel {ms / b_ms:.1f}x its bound; "
          f"scaled_dot_product_attention {lib_ms:.4f} ms device, {lib_eager:.4f} ms eager",
          flush=True)
    return ms, lib_ms


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
    (S slots per lane and, for faas_sweep and scan_sweep, the optional paths
    the instance runs; L live-table entries per lane for fleet_sweep and
    fleet_scan, with kernel 10's columns in shared memory or registers and
    its L = 1 instances pinned or not)."""
    inst = None  # the template instance the next ptxas lines are about
    for line in log.splitlines():
        m = re.search(kernel + r"ILi(\d+)E((?:Lb[01]E)*)", line)
        if m and kernel in ("fleet_sweep_kernel", "fleet_scan_kernel"):
            per_lane = int(m.group(1))
            flags = re.findall(r"Lb([01])E", m.group(2))
            paths = [n for n, f in zip(("faults", "queues", "shared-memory columns",
                                        "pinned at 6 blocks an SM"), flags) if f == "1"]
            inst = (f"L={per_lane} (a table of {32 * per_lane} live instances)"
                    + "".join(f" {n}" for n in paths))
        elif m:
            per_lane = int(m.group(1))
            flags = re.findall(r"Lb([01])E", m.group(2))
            names = (("faults", "layers (windows, histogram, grid)", "fused")
                     if kernel == "scan_sweep_kernel" else
                     ("grid", "windows", "reliability", "retries", "fused", "faults"))
            paths = [n for n, f in zip(names, flags) if f == "1"]
            inst = f"S={per_lane} (M <= {32 * per_lane})" + "".join(f" {n}" for n in paths)
        elif inst and ("registers" in line or "spill" in line):
            print(f"  ptxas {kernel} {inst}: {line.split(':', 1)[-1].strip()}")


def held_fleet(torch, out_k, out_p, what):
    """Fleet kernel vs plain: every acc column but the integrals (3-4), the
    queue lengths and (with crashes) the crash clocks equal, the integrals
    within INTEGRAL_RTOL; returns the largest |acc difference|."""
    (acc_k, q_k, *doom_k), (acc_p, q_p, *doom_p) = out_k, out_p
    if acc_k.shape != acc_p.shape or not torch.equal(q_k, q_p):
        raise AssertionError(f"{what}: shapes or queue lengths differ from the plain version")
    if len(doom_k) != len(doom_p) or not all(torch.equal(a, b) for a, b in zip(doom_k, doom_p)):
        raise AssertionError(f"{what}: the crash clocks differ from the plain version")
    for c in [c for c in range(acc_k.shape[-1]) if c not in (3, 4)]:
        if not torch.equal(acc_k[..., c], acc_p[..., c]):
            n = int((acc_k[..., c] != acc_p[..., c]).sum())
            raise AssertionError(f"{what}: acc column {c} differs in {n} (fleet, function) rows")
    for c in (3, 4):
        err = (acc_k[..., c] - acc_p[..., c]).abs()
        if bool((err > INTEGRAL_RTOL * acc_p[..., c].abs().clamp_min(1.0)).any()):
            raise AssertionError(f"{what}: acc column {c} off by {err.max().item():.3e}")
    return float((acc_k.double() - acc_p.double()).abs().max())


def fleet_small_inputs(torch, dev, rng, F, ncl, limits, prestamped, M, streams, cells, K):
    gaps = rng.exponential(1 / 1.2, (streams, K))
    N, horizon = streams * cells, K / 1.2
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    return (
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


def fleet_prefix(inp, n):
    """The fleet launch's arguments on the first n events of its stream
    (all of it, uncopied, for n = K)."""
    st = inp.staged
    return (inp.t_exp, inp.limit, inp.ncl, inp.t_end, inp.skip, inp.stream,
            *(st[k][:, :n].contiguous() for k in ("times", "fids", "warms", "colds")))


def fleet_phase(torch, rt, dev, card):
    """The fleet phase (module docstring, item 6); returns the kernels-line
    numbers of fleet_sweep."""
    from repro_torch.core.fleet import fleet_inputs
    from repro_torch.data.catalog import catalog_names, fleet_of
    from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS
    from repro_torch.kernels.fleet_event_step import fleet_sweep, table_entries
    from repro_torch.kernels.ref import fleet_sweep_ref

    err = 0.0
    # 6.1 small cases, kernel against plain: (F, Q, prestamped, ncl, limits, M)
    cases = [(1, 0, False, None, 1000, 64), (1, 2, False, 3.0, 1000, 16),
             (3, 2, True, 4.0, (3, 2, 5), 64), (3, 0, False, 5.0, 1000, 40),
             (8, 0, True, None, 2, 16), (8, 2, True, 6.0, 1000, 64)]
    for case, (F, Q, pre, ncl, limits, M) in enumerate(cases):
        rng = np.random.default_rng(400 + case)
        args = fleet_small_inputs(torch, dev, rng, F, ncl, limits, pre, M, 32, 4, 1024)
        kw = dict(slots=M, queue_depth=Q, prestamped=pre)
        out_k = fleet_sweep(*args, **kw)
        ms_p, out_p = plain_timed(torch, lambda: fleet_sweep_ref(*args, **kw))
        e = held_fleet(torch, out_k, out_p, f"fleet case {case}")
        err = max(err, e)
        tot = out_k[0].sum((0, 1)).tolist()
        print(f"kernel==plain fleet case {case}: F={F} Q={Q} prestamped={pre} "
              f"ncl={ncl or 'inf'} limits={limits} M={M}: cold={tot[0]:.0f} "
              f"warm={tot[1]:.0f} reject={tot[2]:.0f} enqueued={tot[9]:.0f} "
              f"queue-served={tot[10]:.0f} peak<={out_k[0][..., 12].max().item():.0f} "
              f"max|acc diff|={e:.3e} (plain {ms_p:.0f} ms)", flush=True)
        if (ncl is not None or limits != 1000) and tot[2] + tot[9] <= 0:
            raise AssertionError(f"fleet case {case}: the cluster or limit never bound")
        if Q and tot[10] <= 0:
            raise AssertionError(f"fleet case {case}: no queued arrival was served")

    # 6.2 the full-width catalog sweep through fleet_sweep()
    names = list(catalog_names())
    fleet = fleet_of(names, n_cluster=FLEET_CLUSTER, skip_time=20.0, slots=64)
    over = {"expiration_threshold": FLEET_THRESHOLDS}
    LAUNCH_COUNTS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = rt.fleet_sweep(fleet, over, 5, replicas=FLEET_REPLICAS, backend="cuda")
    sweep_s = time.perf_counter() - t0
    launches = {"sweep": LAUNCH_COUNTS["fleet_sweep"]}
    if launches["sweep"] != 1 or LAUNCH_COUNTS["faas_sweep"]:
        raise AssertionError(f"fleet_sweep() launches: {dict(LAUNCH_COUNTS)}")
    if not grid.ok.all():
        raise AssertionError("fleet_sweep() cells are not finite")
    arrivals = sum(float(s.n_requests.sum()) for s in grid.summaries.reshape(-1))
    inp = fleet_inputs(fleet, over, 5, replicas=FLEET_REPLICAS, device=dev)
    N, (S, K) = inp.t_exp.shape[0], inp.staged["times"].shape
    events = N * K
    print(f"fleet sweep [{card}]: {len(names)} functions x {len(FLEET_THRESHOLDS)} "
          f"thresholds x {FLEET_REPLICAS} replicas = {N} fleets x K={K} merged events "
          f"(stream [{S}, {K}] held once, "
          f"{FLEET_STREAM_BYTES * S * K / 1e9:.2f} GB), {launches['sweep']} launch: "
          f"fleet_sweep() {sweep_s:.3f} s wall = {arrivals / sweep_s:.4e} simulated "
          f"arrivals/s, {events / sweep_s:.4e} events stepped/s", flush=True)
    for i, thr in enumerate(FLEET_THRESHOLDS):
        cold = ", ".join(f"{n} {100 * p:.3f}%" for n, p in zip(names, grid.cold_start_prob[i]))
        print(f"fleet sweep: threshold {thr:.0f} s: cold start {cold}; occupancy "
              f"{grid.cluster_utilization[i, 0] * FLEET_CLUSTER:.4f} of "
              f"{FLEET_CLUSTER}, peak {grid.peak_cluster[i, 0]:.0f}", flush=True)
    peak = float(grid.peak_cluster.max())
    print(f"fleet sweep: max_peak_cluster {peak:.0f} (cap {FLEET_CLUSTER})", flush=True)
    if peak > FLEET_CLUSTER:
        raise AssertionError("the fleet's peak exceeded n_cluster")
    # the 60 s cell against the JAX reference constants
    cell = grid.summaries[0]
    occ_r = sum((s.time_running + s.time_idle) / s.measured_time for s in cell)
    checks = [(f"{n} cold start", cell[f].cold_start_prob,
               float((cell[f].n_cold / np.maximum(cell[f].n_cold + cell[f].n_warm, 1)).std(ddof=1)),
               REF_FLEET["cold_start_prob"][f], REF_FLEET["cold_start_prob_se"][f])
              for f, n in enumerate(names)]
    checks.append(("avg cluster occupancy", float(occ_r.mean()), float(occ_r.std(ddof=1)),
                   REF_FLEET["avg_cluster_occupancy"], REF_FLEET["avg_cluster_occupancy_se"]))
    for what, got, sd, ref, ref_se in checks:
        tol = REF_FLEET_SIGMAS * float(np.hypot(sd / np.sqrt(FLEET_REPLICAS), ref_se))
        print(f"fleet vs JAX reference at 60 s: {what} {got:.6f} (reference {ref:.6f}, "
              f"|diff| {abs(got - ref):.2e} <= {tol:.2e})", flush=True)
        if abs(got - ref) > tol:
            raise AssertionError(f"fleet 60 s cell: {what} is off the JAX reference")

    # 6.3 queued: the same fleet behind a smaller cluster, through fleet_run()
    fleet_q = fleet_of(names, skip_time=20.0, slots=64, **FLEET_QUEUED)
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    res_q = rt.fleet_run(fleet_q, 6, replicas=FLEET_REPLICAS, backend="cuda")
    queued_s = time.perf_counter() - t0
    launches["queued"] = LAUNCH_COUNTS["fleet_sweep"]
    if launches["queued"] != 1:
        raise AssertionError(f"fleet_run() launches: {dict(LAUNCH_COUNTS)}")
    sq = res_q.summary
    wait = float(sq.queue_wait_sum.sum() / max(sq.queue_served.sum(), 1))
    print(f"fleet queued [{card}]: n_cluster={FLEET_QUEUED['n_cluster']} queue_depth="
          f"{FLEET_QUEUED['queue_depth']}, {FLEET_REPLICAS} replicas, 1 launch, "
          f"{queued_s:.3f} s wall: enqueued {100 * sq.enqueued.sum() / sq.arrivals.sum():.3f}% "
          f"of arrivals, mean queue wait {wait:.4f} s, rejected "
          f"{100 * sum(s.n_reject.sum() for s in sq.summaries) / sq.arrivals.sum():.3f}%, "
          f"peak {sq.max_peak_cluster:.0f}", flush=True)
    if sq.enqueued.sum() <= 0 or sq.max_peak_cluster > FLEET_QUEUED["n_cluster"]:
        raise AssertionError("the queued fleet queued nothing or passed its cap")
    inp_q = fleet_inputs(fleet_q, {}, 6, replicas=FLEET_REPLICAS, device=dev)
    qkw = dict(slots=64, queue_depth=FLEET_QUEUED["queue_depth"], prestamped=True)
    part = fleet_prefix(inp_q, FLEET_PLAIN_EVENTS)
    out_k = fleet_sweep(*part, **qkw, live_bound=inp_q.live_bound)
    ms_pq, out_p = plain_timed(torch, lambda: fleet_sweep_ref(*part, **qkw))
    e = held_fleet(torch, out_k, out_p, "queued fleet prefix")
    err = max(err, e)
    print(f"kernel==plain fleet queued, first {FLEET_PLAIN_EVENTS} events of "
          f"{inp_q.staged['times'].shape[1]}: max|acc diff|={e:.3e}, queue-served "
          f"{out_k[0][..., 10].sum().item():.0f} (plain {ms_pq:.0f} ms)", flush=True)
    del inp_q, part, out_k, out_p

    # 6.4 Table 1 as a one-function fleet against run() on the same draws
    scn1 = table1(rt)
    solo = rt.FleetFunction(
        name="table1", arrival_process=scn1.arrival_process,
        warm_service_process=scn1.warm_service_process,
        cold_service_process=scn1.cold_service_process,
        expiration_threshold=scn1.expiration_threshold,
        max_concurrency=scn1.max_concurrency,
    )
    fleet1 = rt.FleetScenario(functions=(solo,), sim_time=scn1.sim_time,
                              skip_time=scn1.skip_time, slots=scn1.slots)
    LAUNCH_COUNTS.clear()
    one = rt.fleet_run(fleet1, 7, replicas=FULL_REPLICAS, backend="cuda").summary
    launches["one"] = LAUNCH_COUNTS["fleet_sweep"]
    base = rt.run(scn1, 7, replicas=FULL_REPLICAS, backend="cuda").summary
    if launches["one"] != 1 or LAUNCH_COUNTS["faas_sweep"] != 1:
        raise AssertionError(f"one-function fleet launches: {dict(LAUNCH_COUNTS)}")
    for f in ("n_cold", "n_warm", "n_reject"):
        if not np.array_equal(getattr(one["table1"], f), getattr(base, f)):
            raise AssertionError(f"the one-function fleet differs from run() in {f}")
    print(f"fleet one-function: Table 1, n_cluster=inf, {FULL_REPLICAS} replicas: cold, "
          f"warm, reject equal to run()'s (faas_sweep) on the same draws; avg servers "
          f"{one['table1'].avg_server_count:.4f} vs {base.avg_server_count:.4f}", flush=True)

    # 6.5 timing at the full-width shape, and the plain version on its prefix
    args = fleet_prefix(inp, K)
    # the launch fleet_sweep() makes: the table sized by the host's bound
    kw = dict(slots=64, queue_depth=0, prestamped=True)
    table = dict(live_bound=inp.live_bound)
    ms, out_k = timed(torch, lambda: fleet_sweep(*args, **kw, **table), reps=3)
    cold_k = out_k[0][..., 0].double().cpu().numpy().reshape(len(FLEET_THRESHOLDS), -1, len(names))
    for i in range(len(FLEET_THRESHOLDS)):
        for f in range(len(names)):
            if not np.array_equal(cold_k[i, :, f], grid.summaries[i, f].n_cold):
                raise AssertionError("the timed fleet launch does not reproduce fleet_sweep()")
    part = fleet_prefix(inp, FLEET_PLAIN_EVENTS)
    out_k = fleet_sweep(*part, **kw, **table)
    plain_ms, out_p = plain_timed(torch, lambda: fleet_sweep_ref(*part, **kw))
    e = held_fleet(torch, out_k, out_p, "fleet sweep prefix")
    err = max(err, e)
    # events in the horizon (every cell's is sim_time) per replica, all and
    # by acting function; live instances at an arrival: by PASTA (the merged
    # stream is Poisson) each function's time-average instance count in
    # that cell and replica
    F = len(names)
    in_h = inp.staged["times"] <= inp.t_end[:1].item()
    per_row = in_h.sum(1).double().cpu().numpy()
    per_fn = np.stack([(in_h & (inp.staged["fids"] == f)).sum(1).double().cpu().numpy()
                       for f in range(F)])
    del in_h
    occ = np.array([[(s.time_running + s.time_idle) / s.measured_time for s in row]
                    for row in grid.summaries])  # [cells, F, replicas]
    active = int(per_row.sum()) * len(FLEET_THRESHOLDS)
    live = float((occ * per_row).sum())
    acting = float((occ * per_fn).sum())
    b_ms, b_by = fleet_bound_ms(N, F, S, K, active, live, acting)
    print(f"timing [{card}]: fleet_sweep N={N} F={F} M=64 K={K} (live bound "
          f"{inp.live_bound}: the launch's table {table_entries(F, 64, inp.live_bound)} entries "
          f"a lane): {ms:.3f} ms "
          f"(mean of 3); {active} fleet-events in horizon = {active / ms * 1e3:.4e}/s; "
          f"bound {b_ms:.3f} ms ({b_by}; {live:.4e} live and {acting:.4e} acting-function "
          f"live instance-events by PASTA), kernel {ms / b_ms:.1f}x its bound; plain "
          f"version {plain_ms:.1f} ms on the first {FLEET_PLAIN_EVENTS} events (held: "
          f"max|acc diff| {e:.3e}); fleet_sweep() {sweep_s:.3f} s wall", flush=True)
    del inp, args, part, out_k, out_p
    torch.cuda.empty_cache()
    return dict(launches=sum(launches.values()), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by), err


def print_attention_ptxas(log):
    """Registers and spills of each attention kernel instance (element type,
    and head_dim where the kernel is a template over it; flash_kernel_wgmma
    and decode_split_mma are bf16 only), the dynamic shared memory of the bf16
    instances, and ptxas' performance advisories (serialised wgmma)."""
    inst = None
    for line in log.splitlines():
        m = re.search(r"(flash_kernel_wgmma|flash_kernel|decode_split_mma|decode_split_kernel|"
                      r"decode_combine_kernel)I(f|13__nv_bfloat16)?(Li(\d+)E)?", line)
        if m:
            new = f"{m.group(1)} {'f32' if m.group(2) == 'f' else 'bf16'}" + (
                f" D={m.group(4)}" if m.group(4) else "")
            first, inst = new != inst, new
            if first and m.group(1) in ("flash_kernel_wgmma", "decode_split_mma") and m.group(4):
                print(f"  {inst}: {attention_smem(m.group(1), int(m.group(4)))} bytes of "
                      "dynamic shared memory")
        elif inst and ("registers" in line or "spill" in line):
            print(f"  ptxas {inst}: {line.split(':', 1)[-1].strip()}")
        elif "Performance Loss" in line or "C75" in line:
            print(f"  ptxas advisory: {line.strip()[:200]}")


def attention_smem(kernel, D):
    """Dynamic shared memory of a bf16 attention instance, as csrc computes it
    (flash_attention.cu Cfg<D>::SMEM, decode_attention.cu Cfg<D>::SMEM)."""
    if kernel == "flash_kernel_wgmma":
        bq = 192 if D <= 64 else 128
        bk = 128 if D <= 128 else 64
        q_bytes, kv_bytes = bq * D * 2, bk * D * 2
        st = min(3, (232448 - 1024 - 256 - q_bytes) // (2 * kv_bytes))
        return 1024 + q_bytes + 2 * st * kv_bytes + 256
    st = 3 if D <= 128 else 2
    return 2 * (16 * (D + 8) + 2 * st * 64 * (D + 8))


def print_scan_ptxas(log):
    """Registers and spills of each scan kernel instance (P and N for
    ssd_scan, the load path for rglru_scan)."""
    inst = None
    for line in log.splitlines():
        m = re.search(r"(ssd_scan_kernel|rglru_scan_kernel)(ILi(\d+)ELi(\d+)E|ILb([01])E)?",
                      line)
        if m:
            inst = m.group(1) + (f" P={m.group(3)} N={m.group(4)}" if m.group(3) else "")
            if m.group(5):
                inst += " TMA" if m.group(5) == "1" else " cp.async"
        elif inst and ("registers" in line or "spill" in line):
            print(f"  ptxas {inst}: {line.split(':', 1)[-1].strip()}")


def attention_cases():
    """(kind, shapes, options) of the small kernel-vs-plain cases."""
    flash = [  # B, S, T, Hq, Hkv, D, options
        (2, 200, 200, 4, 4, 64, dict(causal=True)),
        (1, 256, 256, 8, 2, 128, dict(causal=True, window=100)),
        (1, 130, 130, 8, 1, 256, dict(causal=True, softcap=30.0)),
        (2, 192, 192, 8, 2, 64, dict(causal=True, prefix_len=70)),
        (1, 100, 150, 4, 2, 64, dict(causal=False)),
        (1, 300, 300, 32, 8, 64, dict(causal=True, window=64, softcap=50.0)),
    ]
    decode = [  # B, T, Hq, Hkv, D, window, softcap, cache_len
        (3, 300, 4, 4, 64, 0, 0.0, [1, 150, 300]),
        (4, 4096, 32, 8, 64, 0, 0.0, [1, 2049, 4096, 777]),
        (2, 1000, 16, 2, 128, 200, 0.0, [1000, 517]),
        (2, 512, 8, 1, 256, 0, 30.0, [1, 512]),
        (2, 700, 8, 2, 128, 100, 20.0, [64, 700]),
    ]
    return flash, decode


def held_attention(torch, out, ref, dname, what, max_v=None):
    """Kernel output vs plain: each element within ATT_TOL[dname] x
    (1 + |plain|), or x (1 + max_v) where given, and the relative L2
    distance within ATT_REL_L2[dname]; returns (max |diff|, relative L2)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    tol, rel_tol = ATT_TOL[dname], ATT_REL_L2[dname]
    lim = tol * (1 + (ref.abs() if max_v is None else max_v))
    rel = ((out - ref).norm() / ref.norm()).item()
    if not bool((err <= lim).all()):
        bound = "|plain|" if max_v is None else f"max|v| = {max_v:.1f}"
        raise AssertionError(f"{what}: |diff| {err.max().item():.3e} over {tol} x (1 + {bound})")
    if not rel <= rel_tol:
        raise AssertionError(f"{what}: relative L2 {rel:.3e} over {rel_tol}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: non-finite output")
    return float(err.max()), rel


class held_calls:
    """Context in which the dispatch layer's kernels (``ops.flash_attention``,
    ``decode_attention``, ``ssd_scan``, ``rglru_scan``) run the kernel and
    then the plain version on the same inputs: the plain flash version in the
    kernel's tiles (``kernel_tiles``), the plain SSD scan at the call's chunk. Each call
    appends ``(max |diff|, relative L2, scale)`` to ``calls[name]`` and raises
    past its limit: attention ATT_TOL x (1 + max|v|) and ATT_REL_L2 (scale
    max|v|), ssd_scan SSD_TOL x (1 + |plain|) and SSD_REL_L2 on y and on the
    final state (scale max|y|), rglru_scan bit for bit (scale max|y|). The
    plain versions launch nothing, so the counts stay the kernels'."""

    def __init__(self, torch, ops, calls):
        self.torch, self.ops, self.calls = torch, ops, calls

    def __enter__(self):
        from repro_torch.kernels.flash_attention import kernel_tiles
        from repro_torch.models.attention import decode_attention_ref, flash_attention_ref
        from repro_torch.models.scans import rglru_scan_ref, ssd_chunked_ref

        torch, ops = self.torch, self.ops
        names = ("flash_attention", "decode_attention", "ssd_scan", "rglru_scan")
        self.orig = {name: getattr(ops, name) for name in names}
        orig = self.orig

        def record(name, out, ref, v):
            max_v = v.float().abs().max().item()
            e, rel = held_attention(torch, out, ref, "bfloat16", f"{name} on the path", max_v)
            self.calls[name].append((e, rel, max_v))

        def flash(q, k, v, **kw):
            out = orig["flash_attention"](q, k, v, **kw)
            q_chunk, kv_chunk = kernel_tiles(q.shape[-1], q.dtype)
            record("flash_attention", out, flash_attention_ref(
                q, k, v, **dict(kw, q_chunk=q_chunk, kv_chunk=kv_chunk)), v)
            return out

        def decode(q, kc, vc, cl, **kw):
            out = orig["decode_attention"](q, kc, vc, cl, **kw)
            record("decode_attention", out, decode_attention_ref(q, kc, vc, cl, **kw), vc)
            return out

        def ssd(x, dt, A, Bm, Cm, **kw):
            out = orig["ssd_scan"](x, dt, A, Bm, Cm, **kw)
            ref = ssd_chunked_ref(x, dt, A, Bm, Cm, **kw)
            e, rel = zip(*(held_ssd(torch, o, r, "ssd_scan on the path")
                           for o, r in zip(out, ref)))
            self.calls["ssd_scan"].append((max(e), max(rel), ref[0].abs().max().item()))
            return out

        def rglru(a, b, h0=None):
            out = orig["rglru_scan"](a, b, h0)
            ref = rglru_scan_ref(a, b, h0)
            if not (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])):
                raise AssertionError("rglru_scan on the path differs from its plain version: "
                                     f"{(out[0] - ref[0]).abs().max().item():.3e}")
            self.calls["rglru_scan"].append((0.0, 0.0, ref[0].abs().max().item()))
            return out

        for name, fn in zip(names, (flash, decode, ssd, rglru)):
            setattr(ops, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)
        return False


def held_ssd(torch, out, ref, what):
    """ssd_scan vs plain: each element within SSD_TOL x (1 + |plain|), the
    relative L2 within SSD_REL_L2, finite; returns (max |diff|, relative L2)."""
    err = (out - ref).abs()
    rel = ((out - ref).norm() / ref.norm()).item()
    if not bool((err <= SSD_TOL * (1 + ref.abs())).all()):
        raise AssertionError(f"{what}: |diff| {err.max().item():.3e} over {SSD_TOL} x "
                             "(1 + |plain|)")
    if not rel <= SSD_REL_L2 or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: relative L2 {rel:.3e} over {SSD_REL_L2}, or not finite")
    return float(err.max()), rel


def teacher_forced(torch, ops, model, tokens, feed, backend, per_prefill, per_step):
    """Prefill ``tokens``, then decode ``feed`` one token per step, under
    ``kernel_backend(backend)``; returns (logits [B, 1 + steps, V] f32,
    prefill ms, decode ms per token). With the kernels, checks the launches
    of each kernel per prefill (``per_prefill``) and per step (``per_step``)."""
    from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS

    def check(want, what, scale=1):
        for name, n in want.items():
            if backend is None and LAUNCH_COUNTS[name] != n * scale:
                raise AssertionError(f"{what} launched {name} {LAUNCH_COUNTS[name]} times "
                                     f"in all, expected {n * scale}")

    out = []
    with torch.inference_mode(), ops.kernel_backend(backend):
        LAUNCH_COUNTS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches, cl = model.prefill({"tokens": tokens}, SERVE_MAX_LEN)
        torch.cuda.synchronize()
        pre_ms = 1e3 * (time.perf_counter() - t0)
        check(per_prefill, "a prefill")
        LAUNCH_COUNTS.clear()
        out.append(lg.float())
        t0 = time.perf_counter()
        for i in range(feed.shape[1]):
            lg, caches, cl = model.decode_step(feed[:, i:i + 1], caches, cl)
            out.append(lg.float())
            check(per_step, f"decode steps 0-{i}", i + 1)
        torch.cuda.synchronize()
        dec_ms = 1e3 * (time.perf_counter() - t0) / feed.shape[1]
    return torch.cat(out, dim=1), pre_ms, dec_ms


def plain_retiled(torch, model, tokens, feed):
    """Teacher-forced logits of the plain versions in the kernels' tilings
    (the SSD scan in 64-token chunks, prefill attention in 64-tiles): a
    second correct rounding of the same model, beside which a distance
    between kernels and plain versions is read."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk_size=64))
    orig_tiles, tf._ref_tiles = tf._ref_tiles, lambda S: 64
    try:
        return teacher_forced(torch, ops, model, tokens, feed, "ref", {}, {})[0]
    finally:
        model.cfg, tf._ref_tiles = cfg, orig_tiles


def logit_distance(torch, a, b):
    """Relative L2 distance of two [B, P, V] logit stacks at each position
    (over batch and vocab), and the share of equal argmaxes."""
    rel = ((a - b).norm(dim=-1).square().sum(0).sqrt()
           / b.norm(dim=-1).square().sum(0).sqrt()).cpu().numpy()
    return rel, float((a.argmax(-1) == b.argmax(-1)).float().mean())


def serve_profile(torch, model, tokens, feed, card, steps=8, name=SERVE_ARCH):
    """Device time by kernel over one prefill and ``steps`` decode steps
    (torch.profiler); prints the top kernels and the device's busy share of
    the window (the kernels' summed time over the wall time)."""
    from torch.profiler import ProfilerActivity, profile

    steps = min(steps, feed.shape[1])
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            lg, caches, cl = model.prefill({"tokens": tokens}, SERVE_MAX_LEN)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for i in range(steps):
                lg, caches, cl = model.decode_step(feed[:, i:i + 1], caches, cl)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
    avgs = prof.key_averages()
    dev_time = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    # the kernels themselves (the CPU ops that launch them carry the same
    # device time, so they are left out of the sum)
    kernels = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(dev_time(e) for e in kernels)
    wall_us = 1e6 * (t2 - t0)
    print(f"serve profile {name} [{card}]: one prefill ({1e3 * (t1 - t0):.3f} ms under the "
          f"profiler) and {steps} decode steps ({1e3 * (t2 - t1) / steps:.3f} ms each): "
          f"device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
          f"({100 * busy_us / max(wall_us, 1):.1f}%)", flush=True)
    for e in sorted(kernels, key=dev_time, reverse=True)[:12]:
        print(f"  {dev_time(e) / 1e3:9.3f} ms device  {e.count:6d} calls  {e.key[:90]}")
    sys.stdout.flush()


def serving_phase(torch, dev, card):
    """The serving phase (module docstring, item 7); returns the kernels-line
    numbers and largest errors of flash_attention and decode_attention."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS
    from repro_torch.kernels.flash_attention import flash_attention, kernel_tiles
    from repro_torch.launch import serve
    from repro_torch.models.attention import decode_attention_ref, flash_attention_ref
    from repro_torch.serving.engine import Replica

    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    gen = torch.Generator(device="cpu").manual_seed(500)
    randn = lambda dtype, *shapes: [torch.randn(s, generator=gen).to(dev, dtype) for s in shapes]
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # 7.1 each kernel against its plain version at small shapes
    flash_cases, decode_cases = attention_cases()
    for dname, dtype in dtypes.items():
        for case, (B, S, T, Hq, Hkv, D, kw) in enumerate(flash_cases):
            q, k, v = randn(dtype, (B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D))
            out = flash_attention(q, k, v, **kw)
            # the plain version in the kernel's tiles
            q_chunk, kv_chunk = kernel_tiles(D, dtype)
            ref = flash_attention_ref(q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk, **kw)
            e, rel = held_attention(torch, out, ref, dname, f"flash case {case} {dname}")
            errs["flash_attention"] = max(errs["flash_attention"], e)
            print(f"kernel==plain flash case {case} {dname}: B={B} S={S} T={T} Hq={Hq} "
                  f"Hkv={Hkv} D={D} {kw}: max|diff|={e:.3e} (tol {ATT_TOL[dname]} x "
                  f"(1 + |plain|)), relative L2 {rel:.3e} (tol {ATT_REL_L2[dname]})", flush=True)
        for case, (B, T, Hq, Hkv, D, window, softcap, lens) in enumerate(decode_cases):
            q, k, v = randn(dtype, (B, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D))
            cl = torch.tensor(lens, dtype=torch.int32, device=dev)
            out = decode_attention(q, k, v, cl, window=window, softcap=softcap)
            ref = decode_attention_ref(q, k, v, cl, window=window, softcap=softcap)
            e, rel = held_attention(torch, out, ref, dname, f"decode case {case} {dname}")
            errs["decode_attention"] = max(errs["decode_attention"], e)
            print(f"kernel==plain decode case {case} {dname}: B={B} T={T} Hq={Hq} Hkv={Hkv} "
                  f"D={D} window={window} softcap={softcap} cache_len={lens}: "
                  f"max|diff|={e:.3e} (tol {ATT_TOL[dname]} x (1 + |plain|)), relative L2 "
                  f"{rel:.3e} (tol {ATT_REL_L2[dname]})", flush=True)

    # 7.2 the main path: a full-width replica measured, planned and replayed
    cfg = get_config(SERVE_ARCH)
    LAUNCH_COUNTS.clear()
    rep = Replica(cfg, max_len=SERVE_MAX_LEN, seed=0, device=dev)
    cold_s, warm_s = serve.measure(rep, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW)
    gen_counts = dict(LAUNCH_COUNTS)
    plan, obs = serve.plan_and_replay(cold_s, warm_s, SERVE_RATE, SERVE_HORIZON, SERVE_SLO)
    launches = dict(LAUNCH_COUNTS)
    L = cfg.n_layers
    # warmup: one prefill and one decode step; generate: one prefill, 128 steps
    want = {"flash_attention": 2 * L, "decode_attention": L * (1 + SERVE_NEW)}
    for name, n in want.items():
        if gen_counts.get(name, 0) != n:
            raise AssertionError(f"the replica launched {name} {gen_counts.get(name, 0)} "
                                 f"times, expected {n}")
    if launches.get("faas_sweep", 0) < 1:
        raise AssertionError("the keep-alive plan did not launch faas_sweep")
    print(f"serve [{card}]: {cfg.name} full width ({L} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab_size}, bf16), batch "
          f"{SERVE_BATCH} x {SERVE_PROMPT}-token prompts, max_len {SERVE_MAX_LEN}, "
          f"{SERVE_NEW} new tokens: init {rep.init_seconds:.3f} s, cold {cold_s:.3f} s, "
          f"warm {warm_s:.3f} s; launches {launches}", flush=True)
    print(f"serve plan: rate {SERVE_RATE}/s, SLO {SERVE_SLO:.0%}: threshold "
          f"{plan.expiration_threshold:.0f} s, predicted cold {plan.predicted_cold_prob:.4%}, "
          f"replicas {plan.predicted_avg_replicas:.4f}, wasted "
          f"{plan.predicted_wasted_ratio:.4%}", flush=True)
    print(f"serve replay: observed cold {obs.cold_start_prob:.4%}, replicas "
          f"{obs.avg_total_replicas:.4f}, wasted {obs.wasted_ratio:.4%}, resp "
          f"{obs.avg_response_time:.3f} s over {len(obs.records)} requests", flush=True)
    vals = [cold_s, warm_s, plan.predicted_cold_prob, obs.cold_start_prob,
            obs.avg_total_replicas, obs.wasted_ratio]
    if not np.isfinite(vals).all() or not obs.records:
        raise AssertionError(f"serve loop values not finite: {vals}")

    rng = np.random.default_rng(501)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))).to(dev)
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_NEW))).to(dev)
    # the path's device time by operation (torch.profiler), kernels on
    serve_profile(torch, rep.model, tokens, feed, card)

    # 7.3 the 16-layer path with every attention call held to its plain
    # version on the same inputs, then end-to-end logits (module docstring)
    counts = ({"flash_attention": L}, {"decode_attention": L})
    lk, pre_k, dec_k = teacher_forced(torch, ops, rep.model, tokens, feed, None, *counts)
    calls = {"flash_attention": [], "decode_attention": []}
    with held_calls(torch, ops, calls):
        teacher_forced(torch, ops, rep.model, tokens, feed, None, *counts)
    for name, rows in calls.items():
        e = max(r[0] for r in rows)
        errs[name] = max(errs[name], e)
        print(f"serve [{card}]: {len(rows)} {name} calls of the 16-layer path, each held "
              f"to its plain version on the same inputs: max|diff| {e:.3e} (tol "
              f"{ATT_TOL['bfloat16']} x (1 + max|v|), max|v| up to "
              f"{max(r[2] for r in rows):.1f}), relative L2 max "
              f"{max(r[1] for r in rows):.3e} (tol {ATT_REL_L2['bfloat16']})", flush=True)
    lr, pre_r, dec_r = teacher_forced(torch, ops, rep.model, tokens, feed, "ref", *counts)
    # the host-bound decode step read again after the plain run: kernels,
    # plain, kernels, so that the spread between readings shows beside the
    # difference
    _, pre_k2, dec_k2 = teacher_forced(torch, ops, rep.model, tokens, feed, None, *counts)
    print(f"serve [{card}]: prefill {pre_k:.3f} and {pre_k2:.3f} ms per request batch (plain "
          f"attention {pre_r:.3f}), decode {dec_k:.3f} and {dec_k2:.3f} ms per token (plain "
          f"attention {dec_r:.3f}; kernels, plain, kernels in turn)", flush=True)
    if not bool(torch.isfinite(lk).all()):
        raise AssertionError("full-width logits are not finite")
    # end-to-end logits at 16 layers and at full width cut in depth; beside
    # each, the plain version against itself in 64-tiles (a second correct
    # version): the random-weight model's distance between any two
    # roundings. Only the cut to SERVE_E2E_LAYERS is held to the limit.
    full = lk, lr
    for depth in dict.fromkeys((L, 2, SERVE_E2E_LAYERS)):
        if depth == L:
            model, (lk, lr) = rep.model, full
        else:
            cut = dataclasses.replace(cfg, n_layers=depth, segments=((("attn",), depth),))
            model = Replica(cut, max_len=SERVE_MAX_LEN, seed=0, device=dev).model
            cut_counts = ({"flash_attention": depth}, {"decode_attention": depth})
            lk, _, _ = teacher_forced(torch, ops, model, tokens, feed, None, *cut_counts)
            lr, _, _ = teacher_forced(torch, ops, model, tokens, feed, "ref", *cut_counts)
        lt = plain_retiled(torch, model, tokens, feed)
        rel, agree = logit_distance(torch, lk, lr)
        base, base_agree = logit_distance(torch, lt, lr)
        held = depth == SERVE_E2E_LAYERS
        print(f"serve logits, full width, {depth} layer(s) [{card}]: kernels vs plain relative "
              f"L2 prefill {rel[0]:.3e}, decode steps max {rel[1:].max():.3e} mean "
              f"{rel[1:].mean():.3e}, argmax agreement {agree:.4f}"
              + (f" (limit {SERVE_LOGIT_REL})" if held else "")
              + f"; plain in 64-tiles vs plain: {base[0]:.3e}, max {base[1:].max():.3e} mean "
              f"{base[1:].mean():.3e}, argmax agreement {base_agree:.4f}; max |logit| "
              f"{lr.abs().max().item():.3f}", flush=True)
        if not bool(torch.isfinite(lk).all()) or (held and rel.max() > SERVE_LOGIT_REL):
            raise AssertionError(f"full-width logits at {depth} layers off the plain "
                                 "versions' or not finite")
        del lk, lr, lt, model
    del full

    # 7.4 each kernel timed at the path's shapes
    B, S, D = SERVE_BATCH, SERVE_PROMPT, cfg.head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    bf = torch.bfloat16
    q, k, v = randn(bf, (B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))
    ms, out = timed(torch, lambda: flash_attention(q, k, v, causal=True), reps=10)
    tile = max(min(S // 8, 1024), 128)  # the model's tiles for the plain version
    plain_ms, ref = plain_timed(torch, lambda: flash_attention_ref(
        q, k, v, causal=True, q_chunk=tile, kv_chunk=tile))
    e, _ = held_attention(torch, out, ref, "bfloat16", "flash at the path's shape")
    errs["flash_attention"] = max(errs["flash_attention"], e)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms, lib = timed(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=3)
    pairs = B * Hq * S * (S + 1) // 2  # causal (query, key) pairs
    b_ms, b_by = _attention_bound(4 * D * pairs, 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D))
    print(f"timing [{card}]: flash_attention B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal: "
          f"{ms:.4f} ms (mean of 10); bound {b_ms:.4f} ms ({b_by}; {4 * D * pairs:.4e} FLOP); "
          f"kernel {ms / b_ms:.1f}x its bound, {4 * D * pairs / ms / 1e9:.2f} TFLOP/s; plain "
          f"{plain_ms:.3f} ms (max|diff| {e:.3e}); scaled_dot_product_attention {lib_ms:.4f} ms "
          f"(max|diff| {(lib.transpose(1, 2).float() - ref.float()).abs().max().item():.3e})",
          flush=True)
    results = {"flash_attention": dict(launches=gen_counts["flash_attention"], ms=ms,
                                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                       library_ms=lib_ms)}
    del q, k, v, qt, kt, vt, out, ref, lib

    T = SERVE_MAX_LEN
    q, kc, vc = randn(bf, (B, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D))
    cl = torch.full((B,), DECODE_TIMED_LEN, dtype=torch.int32, device=dev)
    out = decode_attention(q, kc, vc, cl)
    plain_ms, ref = plain_timed(torch, lambda: decode_attention_ref(q, kc, vc, cl))
    e, _ = held_attention(torch, out, ref, "bfloat16", "decode at the path's shape")
    errs["decode_attention"] = max(errs["decode_attention"], e)
    mask = (torch.arange(T, device=dev) < cl[:, None])[:, None, None, :]  # [B, 1, 1, T]
    library = lambda: F.scaled_dot_product_attention(
        q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2), attn_mask=mask, enable_gqa=True)
    lib = library()
    valid = B * DECODE_TIMED_LEN
    b_ms, b_by = _attention_bound(4 * D * valid * Hq,
                                  2 * (2 * valid * Hkv * D + 2 * B * Hq * D) + 4 * B)
    ms, lib_ms = decode_timing_line(
        torch, card, f"B={B} T={T} cache_len={DECODE_TIMED_LEN} Hq={Hq} Hkv={Hkv} D={D} bf16",
        lambda: decode_attention(q, kc, vc, cl), library, B, Hkv, Hq // Hkv, D, T,
        2 * 2 * valid * Hkv * D, b_ms, b_by)
    print(f"  decode plain {plain_ms:.3f} ms (max|diff| {e:.3e}); library max|diff| "
          f"{(lib[:, :, 0].float() - ref.float()).abs().max().item():.3e}", flush=True)
    results["decode_attention"] = dict(launches=gen_counts["decode_attention"], ms=ms,
                                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                       library_ms=lib_ms)
    del q, kc, vc, out, ref, lib, rep
    torch.cuda.empty_cache()
    return results, errs


def recurrent_cases():
    """(ssd_scan, rglru_scan, flash, decode) small kernel-vs-plain cases of
    the recurrent phase."""
    ssd = [  # B, L, H, P, N, G, chunk: tests/test_kernels.py's shapes, a
        # ragged L, the smoke widths
        *[(2, 256, 4, 64, 128, G, c) for G in (1, 2) for c in (64, 128, 256)],
        (2, 200, 4, 64, 128, 2, 64),
        (2, 50, 4, 32, 16, 1, 16),
    ]
    rglru = [  # B, L, W, with h0, a and b as views 4 bytes off 16-byte alignment
        (2, 256, 64, False, False), (2, 256, 512, True, False), (2, 300, 1024, False, False),
        (3, 77, 4096, True, False), (4, 2048, 4096, True, False),
        (2, 129, 101, True, False),  # W % 4 != 0: the cp.async path
        (2, 64, 200, False, False),  # W not a multiple of 32 on the TMA path
        (1, 1, 101, False, False), (1, 1, 4096, True, False),  # L = 1 on both paths
        (8, 64, 4096, False, False),  # more warps than one wave
        (1, 2048, 4096, True, False),  # batch 1 at recurrentgemma-9b's width
        (2, 100, 256, True, True), (4, 2048, 4096, False, True),
    ]
    flash = [  # B, S, T, Hq, Hkv, D, options: recurrentgemma's heads, its window
        (1, 300, 300, 16, 1, 256, dict(causal=True, window=128)),
        (1, 2100, 2100, 16, 1, 256, dict(causal=True, window=2048)),
    ]
    decode = [  # B, T, Hq, Hkv, D, window, softcap, cache_len: rings full or filling
        (2, 2048, 16, 1, 256, 0, 0.0, [2048, 2048]),
        (3, 300, 16, 1, 256, 0, 0.0, [300, 17, 1]),
    ]
    return ssd, rglru, flash, decode


def ssd_bound_ms(B, L, H, P, N, G, Q=64):
    """Least time for the SSD scan of these shapes at the kernel's chunk Q:
    operations (2 per multiply-add) C Bᵀ once per group and chunk over the
    causal half, the causal half of M xd, C stateᵀ and the state update per
    head; bytes x, y f32, dt, B, C read once, the final state written."""
    nc = -(-L // Q)
    tri = Q * (Q + 1) // 2
    ops = B * nc * (G * 2 * N * tri + H * (2 * P * tri + 4 * Q * P * N))
    nbytes = 4 * (2 * B * L * H * P + B * L * H + H + 2 * B * L * G * N + B * H * P * N)
    return _bound(nbytes, ops)


def recurrent_phase(torch, dev, card):
    """The recurrent serving phase (module docstring, item 8); returns the
    kernels-line numbers of ssd_scan and rglru_scan and the largest errors of
    the four kernels the phase runs."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS
    from repro_torch.kernels.flash_attention import flash_attention, kernel_tiles
    from repro_torch.kernels.rglru_scan import launch_plan, rglru_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import serve
    from repro_torch.models.attention import decode_attention_ref, flash_attention_ref
    from repro_torch.models.scans import rglru_scan_ref, ssd_chunked_ref
    from repro_torch.serving.engine import Replica

    names = ("ssd_scan", "rglru_scan", "flash_attention", "decode_attention")
    errs = dict.fromkeys(names, 0.0)
    gen = torch.Generator(device="cpu").manual_seed(800)
    randn = lambda *s: torch.randn(s, generator=gen)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def ssd_inputs(B, L, H, P, N, G):
        """The model's distributions: dt = softplus(N(0, 1) + 0.5), A = -exp(U(0, 1))."""
        dt = F.softplus(randn(B, L, H) + 0.5)
        A = -torch.exp(torch.rand(H, generator=gen))
        return [x.to(dev) for x in (randn(B, L, H, P), dt, A, randn(B, L, G, N),
                                    randn(B, L, G, N))]

    # 8.1 each kernel against its plain version at small shapes
    ssd_cases, rglru_cases, flash_cases, decode_cases = recurrent_cases()
    for B, L, H, P, N, G, chunk in ssd_cases:
        x, dt, A, Bm, Cm = ssd_inputs(B, L, H, P, N, G)
        out = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
        ref = ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk)
        what = f"ssd B={B} L={L} H={H} P={P} N={N} G={G} chunk={chunk}"
        (ey, ly), (es, ls) = (held_ssd(torch, o, r, what) for o, r in zip(out, ref))
        errs["ssd_scan"] = max(errs["ssd_scan"], ey, es)
        print(f"kernel==plain {what}: y max|diff| {ey:.3e} relative L2 {ly:.3e}, state "
              f"{es:.3e} / {ls:.3e} (tol {SSD_TOL} x (1 + |plain|), L2 {SSD_REL_L2})", flush=True)
    paths = set()
    for B, L, W, with_h0, shifted in rglru_cases:
        a = torch.sigmoid(randn(B, L, W)).to(dev)
        b = (0.1 * randn(B, L, W)).to(dev)
        h0 = randn(B, W).to(dev) if with_h0 else None
        if shifted:  # contiguous views that start 4 bytes into their buffers
            a, b = (torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape).copy_(t)
                    for t in (a, b))
        path = launch_plan(B, W, a.dtype, a.data_ptr(), b.data_ptr()).path
        paths.add(path)
        y, h_last = rglru_scan(a, b, h0)
        yr, hr = rglru_scan_ref(a, b, h0)
        if not (torch.equal(y, yr) and torch.equal(h_last, hr)):
            raise AssertionError(f"rglru B={B} L={L} W={W} ({path}): kernel != plain, max|diff| "
                                 f"{(y - yr).abs().max().item():.3e}")
        print(f"kernel==plain rglru B={B} L={L} W={W} h0={with_h0} view off 16 bytes="
              f"{shifted}, {path} path: bit-equal", flush=True)
    if paths != {"tma", "cp.async"}:
        raise AssertionError(f"the rglru cases took only the {paths} load path(s)")
    for dname, dtype in dtypes.items():
        for B, S, T, Hq, Hkv, D, kw in flash_cases:
            q, k, v = (randn(*s).to(dev, dtype) for s in ((B, S, Hq, D), (B, T, Hkv, D),
                                                         (B, T, Hkv, D)))
            out = flash_attention(q, k, v, **kw)
            q_chunk, kv_chunk = kernel_tiles(D, dtype)
            ref = flash_attention_ref(q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk, **kw)
            e, rel = held_attention(torch, out, ref, dname, f"flash D=256 {dname}")
            errs["flash_attention"] = max(errs["flash_attention"], e)
            print(f"kernel==plain flash {dname}: B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} {kw}: "
                  f"max|diff|={e:.3e}, relative L2 {rel:.3e}", flush=True)
        for B, T, Hq, Hkv, D, window, softcap, lens in decode_cases:
            q, k, v = (randn(*s).to(dev, dtype) for s in ((B, Hq, D), (B, T, Hkv, D),
                                                         (B, T, Hkv, D)))
            cl = torch.tensor(lens, dtype=torch.int32, device=dev)
            out = decode_attention(q, k, v, cl, window=window, softcap=softcap)
            ref = decode_attention_ref(q, k, v, cl, window=window, softcap=softcap)
            e, rel = held_attention(torch, out, ref, dname, f"decode D=256 {dname}")
            errs["decode_attention"] = max(errs["decode_attention"], e)
            print(f"kernel==plain decode {dname}: B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} "
                  f"cache_len={lens}: max|diff|={e:.3e}, relative L2 {rel:.3e}", flush=True)

    results = {}
    for arch in RECURRENT_ARCHS:
        # 8.2 the main path: a full-width replica measured, planned and replayed
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        kinds = [k for pattern, count in cfg.segments for _ in range(count) for k in pattern]
        per_prefill = {name: kinds.count(kind) for name, kind in (
            ("ssd_scan", "ssm"), ("rglru_scan", "rglru"), ("flash_attention", "local"))
            if kind in kinds}
        per_step = {"decode_attention": kinds.count("local")} if "local" in kinds else {}
        LAUNCH_COUNTS.clear()
        torch.cuda.reset_peak_memory_stats()
        rep = Replica(cfg, max_len=SERVE_MAX_LEN, seed=0, device=dev)
        cold_s, warm_s = serve.measure(rep, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW)
        gen_counts = dict(LAUNCH_COUNTS)
        plan, obs = serve.plan_and_replay(cold_s, warm_s, SERVE_RATE, SERVE_HORIZON, SERVE_SLO)
        launches = dict(LAUNCH_COUNTS)
        # warmup: one prefill and one decode step; generate: one prefill, 128 steps
        want = {name: 2 * n for name, n in per_prefill.items()}
        want.update({name: n * (1 + SERVE_NEW) for name, n in per_step.items()})
        for name in names:
            if gen_counts.get(name, 0) != want.get(name, 0):
                raise AssertionError(f"the {arch} replica launched {name} "
                                     f"{gen_counts.get(name, 0)} times, expected "
                                     f"{want.get(name, 0)}")
        if launches.get("faas_sweep", 0) < 1:
            raise AssertionError("the keep-alive plan did not launch faas_sweep")
        print(f"serve [{card}]: {cfg.name} full width ({cfg.n_layers} layers {kinds.count('ssm')} "
              f"ssm / {kinds.count('rglru')} rglru / {kinds.count('local')} local, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab_size}, bf16 with f32 leaves), batch "
              f"{SERVE_BATCH} x {SERVE_PROMPT}-token prompts, max_len {SERVE_MAX_LEN}, "
              f"{SERVE_NEW} new tokens: init {rep.init_seconds:.3f} s, cold {cold_s:.3f} s, "
              f"warm {warm_s:.3f} s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}",
              flush=True)
        print(f"serve plan {cfg.name}: rate {SERVE_RATE}/s, SLO {SERVE_SLO:.0%}: threshold "
              f"{plan.expiration_threshold:.0f} s, predicted cold "
              f"{plan.predicted_cold_prob:.4%}, replicas {plan.predicted_avg_replicas:.4f}, "
              f"wasted {plan.predicted_wasted_ratio:.4%}; replay: observed cold "
              f"{obs.cold_start_prob:.4%}, replicas {obs.avg_total_replicas:.4f}, wasted "
              f"{obs.wasted_ratio:.4%}, resp {obs.avg_response_time:.3f} s over "
              f"{len(obs.records)} requests", flush=True)
        vals = [cold_s, warm_s, plan.predicted_cold_prob, obs.cold_start_prob,
                obs.avg_total_replicas, obs.wasted_ratio]
        if not np.isfinite(vals).all() or not obs.records:
            raise AssertionError(f"serve loop values not finite: {vals}")

        rng = np.random.default_rng(801)
        draw = lambda n: torch.from_numpy(rng.integers(0, cfg.vocab_size, (SERVE_BATCH, n)))
        tokens, feed = draw(SERVE_PROMPT).to(dev), draw(SERVE_NEW).to(dev)
        serve_profile(torch, rep.model, tokens, feed, card, name=cfg.name)

        # 8.3 every kernel call of the full-depth path held to its plain
        # version on the same inputs; end-to-end logits
        lk, pre_k, dec_k = teacher_forced(torch, ops, rep.model, tokens, feed, None,
                                          per_prefill, per_step)
        calls = {name: [] for name in names}
        with held_calls(torch, ops, calls):
            teacher_forced(torch, ops, rep.model, tokens, feed, None, per_prefill, per_step)
        for name, rows in calls.items():
            n_want = per_prefill.get(name, 0) + per_step.get(name, 0) * SERVE_NEW
            if len(rows) != n_want:
                raise AssertionError(f"{len(rows)} {name} calls held on the {arch} path, "
                                     f"expected {n_want}")
            if not rows:
                continue
            e = max(r[0] for r in rows)
            errs[name] = max(errs[name], e)
            print(f"serve [{card}]: {len(rows)} {name} calls of the {cfg.n_layers}-layer "
                  f"{cfg.name} path, each held to its plain version on the same inputs: "
                  f"max|diff| {e:.3e}, relative L2 max {max(r[1] for r in rows):.3e}, scale "
                  f"up to {max(r[2] for r in rows):.1f}", flush=True)
        lr, pre_r, dec_r = teacher_forced(torch, ops, rep.model, tokens, feed, "ref",
                                          per_prefill, per_step)
        if not bool(torch.isfinite(lk).all()):
            raise AssertionError(f"{arch} full-width logits are not finite")
        lt = plain_retiled(torch, rep.model, tokens, feed)
        rel, agree = logit_distance(torch, lk, lr)
        base, base_agree = logit_distance(torch, lt, lr)
        print(f"serve [{card}]: {cfg.name} prefill {pre_k:.3f} ms per request batch (plain "
              f"kernels {pre_r:.3f}), decode {dec_k:.3f} ms per token (plain kernels "
              f"{dec_r:.3f}); logits at full depth, kernels vs plain: relative L2 prefill "
              f"{rel[0]:.3e}, decode steps max {rel[1:].max():.3e} mean {rel[1:].mean():.3e}, "
              f"argmax agreement {agree:.4f}; plain in 64-chunks/tiles vs plain: "
              f"{base[0]:.3e}, max {base[1:].max():.3e} mean {base[1:].mean():.3e}, argmax "
              f"agreement {base_agree:.4f}; max |logit| {lr.abs().max().item():.3f}",
              flush=True)
        del rep, lk, lr, lt
        torch.cuda.empty_cache()
        # the logits held at full width cut to RECURRENT_E2E_REPS[arch]
        # repetitions of the first segment's pattern, beside the plain pair
        reps, pattern = RECURRENT_E2E_REPS[arch], cfg.segments[0][0]
        cut = dataclasses.replace(cfg, n_layers=reps * len(pattern), segments=((pattern, reps),))
        cut_pre = {name: reps * pattern.count(kind) for name, kind in (
            ("ssd_scan", "ssm"), ("rglru_scan", "rglru"), ("flash_attention", "local"))
            if kind in pattern}
        cut_step = ({"decode_attention": reps * pattern.count("local")}
                    if "local" in pattern else {})
        model = Replica(cut, max_len=SERVE_MAX_LEN, seed=0, device=dev).model
        lk, _, _ = teacher_forced(torch, ops, model, tokens, feed, None, cut_pre, cut_step)
        lr, _, _ = teacher_forced(torch, ops, model, tokens, feed, "ref", cut_pre, cut_step)
        lt = plain_retiled(torch, model, tokens, feed)
        rel, agree = logit_distance(torch, lk, lr)
        base, _ = logit_distance(torch, lt, lr)
        print(f"serve logits {cfg.name}, full width cut to {cut.n_layers} layer(s), {reps} x "
              f"{pattern} [{card}]: kernels vs plain relative L2 prefill {rel[0]:.3e}, decode "
              f"steps max {rel[1:].max():.3e} mean {rel[1:].mean():.3e} (limit "
              f"{SERVE_LOGIT_REL}), argmax agreement {agree:.4f}; plain in 64-chunks/tiles vs "
              f"plain: {base[0]:.3e}, max {base[1:].max():.3e}", flush=True)
        if not bool(torch.isfinite(lk).all()) or rel.max() > SERVE_LOGIT_REL:
            raise AssertionError(f"{arch} logits at {cut.n_layers} layers off the plain "
                                 "versions' or not finite")
        del model, lk, lr, lt
        torch.cuda.empty_cache()
        results[arch] = dict(launches=gen_counts)
        print(f"{cfg.name}: {time.perf_counter() - t_arch:.1f} s", flush=True)

    # 8.4 each kernel timed at the paths' shapes
    B, L = SERVE_BATCH, SERVE_PROMPT
    m = get_config("mamba2-2.7b")
    H, P, N, G = (m.ssm.expand * m.d_model // m.ssm.head_dim, m.ssm.head_dim, m.ssm.d_state,
                  m.ssm.n_groups)
    x, dt, A, Bm, Cm = ssd_inputs(B, L, H, P, N, G)
    ms, out = timed(torch, lambda: ssd_scan(x, dt, A, Bm, Cm), reps=10)
    plain_ms, ref = plain_timed(torch, lambda: ssd_chunked_ref(x, dt, A, Bm, Cm,
                                                                chunk=m.ssm.chunk_size))
    e = max(held_ssd(torch, o, r, "ssd at the path's shape")[0] for o, r in zip(out, ref))
    errs["ssd_scan"] = max(errs["ssd_scan"], e)
    b_ms, b_by = ssd_bound_ms(B, L, H, P, N, G)
    print(f"timing [{card}]: ssd_scan B={B} L={L} H={H} P={P} N={N} G={G} f32: {ms:.4f} ms "
          f"(mean of 10); bound {b_ms:.4f} ms ({b_by}); kernel {ms / b_ms:.1f}x its bound; "
          f"plain (chunk {m.ssm.chunk_size}) {plain_ms:.3f} ms (max|diff| {e:.3e}); no single "
          "PyTorch call computes this", flush=True)
    results["ssd_scan"] = dict(launches=results["mamba2-2.7b"]["launches"]["ssd_scan"], ms=ms,
                               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    del x, dt, A, Bm, Cm, out, ref

    r = get_config("recurrentgemma-9b")
    W = r.rglru.lru_width
    for Bs in (B, 1):  # the path's batch, and one request
        a = torch.rand((Bs, L, W), generator=gen).to(dev)
        b = randn(Bs, L, W).to(dev)
        ms, out = timed(torch, lambda: rglru_scan(a, b), reps=10)
        plain_ms, ref = plain_timed(torch, lambda: rglru_scan_ref(a, b))
        if not torch.equal(out[0], ref[0]):
            raise AssertionError(f"rglru_scan at B={Bs} L={L} W={W} differs from its plain "
                                 "version")
        # the streaming yardstick: the same two reads and one write
        y = torch.empty_like(a)
        add_ms, _ = timed(torch, lambda: torch.add(a, b, out=y), reps=10)
        nbytes = 3 * 4 * Bs * L * W
        b_ms, b_by = _bound(nbytes, 2 * Bs * L * W)
        path = launch_plan(Bs, W, a.dtype, a.data_ptr(), b.data_ptr()).path
        print(f"timing [{card}]: rglru_scan B={Bs} L={L} W={W} f32 ({path} path): {ms:.4f} ms "
              f"(mean of 10); bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB); kernel "
              f"{ms / b_ms:.2f}x its bound ({b_ms / ms:.1%} of it), {nbytes / ms / 1e6:.1f} GB/s; "
              f"torch.add(a, b, out=y) on the same bytes {add_ms:.4f} ms ({nbytes / add_ms / 1e6:.1f}"
              f" GB/s), kernel {ms / add_ms:.2f}x it; plain {plain_ms:.3f} ms (bit-equal); no "
              "single PyTorch call computes this", flush=True)
        if Bs == B:
            results["rglru_scan"] = dict(
                launches=results["recurrentgemma-9b"]["launches"]["rglru_scan"], ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        del a, b, y, out, ref

    Hq, Hkv, D, bf = r.n_heads, r.n_kv_heads, r.head_dim, torch.bfloat16
    q, k, v = (randn(*s).to(dev, bf) for s in ((B, L, Hq, D), (B, L, Hkv, D), (B, L, Hkv, D)))
    kw = dict(causal=True, window=r.window)
    ms, out = timed(torch, lambda: flash_attention(q, k, v, **kw), reps=10)
    tile = max(min(L // 8, 1024), 128)  # the model's tiles for the plain version
    plain_ms, ref = plain_timed(torch, lambda: flash_attention_ref(q, k, v, q_chunk=tile,
                                                                   kv_chunk=tile, **kw))
    e, _ = held_attention(torch, out, ref, "bfloat16", "flash at recurrentgemma's shape")
    errs["flash_attention"] = max(errs["flash_attention"], e)
    qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
    pos = torch.arange(L, device=dev)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - r.window)
    lib_kw = dict(is_causal=True) if r.window >= L else dict(attn_mask=band)
    lib_ms, lib = timed(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True, **lib_kw), reps=3)
    pairs = B * Hq * L * (L + 1) // 2
    b_ms, b_by = _attention_bound(4 * D * pairs, 2 * (2 * B * L * Hq * D + 2 * B * L * Hkv * D))
    print(f"timing [{card}]: flash_attention recurrentgemma B={B} S={L} Hq={Hq} Hkv={Hkv} D={D} "
          f"bf16 causal window {r.window}: {ms:.4f} ms (mean of 10); bound {b_ms:.4f} ms "
          f"({b_by}); kernel {ms / b_ms:.1f}x its bound, {4 * D * pairs / ms / 1e9:.2f} TFLOP/s; "
          f"plain {plain_ms:.3f} ms (max|diff| {e:.3e}); scaled_dot_product_attention "
          f"{lib_ms:.4f} ms (max|diff| "
          f"{(lib.transpose(1, 2).float() - ref.float()).abs().max().item():.3e})", flush=True)
    del q, k, v, qt, kt, vt, out, ref, lib

    T = min(SERVE_MAX_LEN, r.window)  # the ring, full from the first step
    q, kc, vc = (randn(*s).to(dev, bf) for s in ((B, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    cl = torch.full((B,), T, dtype=torch.int32, device=dev)
    out = decode_attention(q, kc, vc, cl)
    plain_ms, ref = plain_timed(torch, lambda: decode_attention_ref(q, kc, vc, cl))
    e, _ = held_attention(torch, out, ref, "bfloat16", "decode at recurrentgemma's shape")
    errs["decode_attention"] = max(errs["decode_attention"], e)
    library = lambda: F.scaled_dot_product_attention(
        q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2), enable_gqa=True)
    lib = library()
    nbytes = 2 * (2 * B * T * Hkv * D + 2 * B * Hq * D) + 4 * B
    b_ms, b_by = _attention_bound(4 * D * B * T * Hq, nbytes)
    decode_timing_line(torch, card, f"recurrentgemma B={B} T={T} (full ring) Hq={Hq} "
                       f"Hkv={Hkv} D={D} bf16", lambda: decode_attention(q, kc, vc, cl),
                       library, B, Hkv, Hq // Hkv, D, T, 2 * 2 * B * T * Hkv * D, b_ms, b_by)
    print(f"  decode plain {plain_ms:.3f} ms (max|diff| {e:.3e}); library max|diff| "
          f"{(lib[:, :, 0].float() - ref.float()).abs().max().item():.3e}", flush=True)
    del q, kc, vc, out, ref, lib
    torch.cuda.empty_cache()
    return {k: results[k] for k in ("ssd_scan", "rglru_scan")}, errs


def _attention_bound(flops, nbytes):
    """Least time for the work: FLOP at the bf16 tensor-core peak or bytes
    at HBM rate, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_BF16_OPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes > t_ops else "operations")


def retry_policy(rt):
    """bench_retry_sweep's policy: 5% failures, an 8 s timeout, 2 retries
    after 2 s, 4 s of backoff with 30% jitter."""
    return rt.Reliability(
        rt.FailurePolicy(p_fail=0.05, t_timeout=8.0),
        rt.RetryPolicy(max_retries=2, backoff_base=2.0, backoff_mult=2.0, backoff_jitter=0.3),
    )


def rely_small_inputs(torch, dev, rng, C, M, N, J, backoff, windows):
    """One small launch's inputs from numpy draws: an attempt table of N
    base arrivals with J retries each (the port's build_attempt_table,
    backoff ``backoff`` s), its base gap stream with failure uniforms, per
    -row thresholds, horizons, warm-ups, timeouts and failure rates, and
    window bounds ("irregular": 4 windows inside the horizon; "narrow": 240,
    several to an inter-arrival gap)."""
    from repro_torch.core.reliability import RetryPolicy, build_attempt_table

    gaps = rng.exponential(1 / 0.8, (C, N)).astype(np.float32)
    t0 = np.cumsum(gaps.astype(np.float64), axis=1)
    w, c, f = (rng.exponential(2.0, (C, N, J + 1)), rng.exponential(2.5, (C, N, J + 1)),
               rng.random((C, N, J + 1)))
    to = lambda x, dt=torch.float32: torch.tensor(np.asarray(x), dtype=dt, device=dev)
    table = build_attempt_table(
        to(t0, torch.float64), to(w), to(c), to(f), to(rng.random((C, N, J)), torch.float64),
        RetryPolicy(max_retries=J, backoff_base=backoff, backoff_jitter=0.3),
    )
    horizon = float(t0[:, -1].min())
    wb = (np.tile(np.linspace(0.0, horizon, 241), (C, 1)) if windows == "narrow"
          else np.sort(rng.uniform(0, horizon, (C, 5)), axis=1))
    return dict(
        pool=fresh_pools(torch, C, M, dev),
        t_exp=to(10 * rng.uniform(0.5, 1.5, C)),
        table=tuple(x.float().contiguous() for x in table),
        gaps=(to(gaps), to(w[:, :, 0]), to(c[:, :, 0])),
        fail_gaps=to(f[:, :, 0]),
        t_end=to(horizon * rng.uniform(0.5, 0.9, C)),
        skip=to(horizon * rng.uniform(0.0, 0.1, C)),
        window_bounds=to(wb),
        t_timeout=to(rng.uniform(1.0, 5.0, C)),
        p_fail=to(rng.uniform(0.0, 0.3, C)),
    )


def rely_call(inp, windows, rely, retry, max_c):
    """(args, kw) of a faas_sweep call on ``rely_small_inputs``: retries
    run the attempt table prestamped, the other paths the gap stream."""
    kw = dict(t_end=inp["t_end"], skip=inp["skip"], max_concurrency=max_c, prestamped=retry)
    if windows:
        kw["window_bounds"] = inp["window_bounds"]
    if rely:
        kw.update(t_timeout=inp["t_timeout"], p_fail=inp["p_fail"],
                  fail_u=inp["table"][3] if retry else inp["fail_gaps"])
    if retry:
        kw.update(is_first=inp["table"][4], child_pos=inp["table"][5])
    samples = inp["table"][:3] if retry else inp["gaps"]
    return (*inp["pool"], inp["t_exp"], *samples), kw


def window_integral_cols(W):
    """The acc columns that sum the pool's times over its slots: 3-4 and
    each window's running and idle columns."""
    return (3, 4) + tuple(range(8 + 3 * W, 8 + 5 * W))


def prefix(x, n):
    return x[:, :n].contiguous()


# name, windows ("irregular", "narrow" or None), reliability, retries, J, backoff (s)
RELY_CASES = (
    ("windows", "irregular", False, False, 1, 1.0),
    ("240 narrow windows", "narrow", False, False, 1, 1.0),
    ("fail-only", None, True, False, 1, 1.0),
    ("retries J=1, children in the batch", None, True, True, 1, 0.05),
    ("retries J=2, children past the batch", None, True, True, 2, 60.0),
    ("windows + retries J=2", "irregular", True, True, 2, 2.0),
)


def reliability_phase(torch, rt, dev, card, table1_grid):
    """The reliability and metric-window phase (module docstring, item 9);
    returns the kernels-line entries and the largest differences."""
    from repro_torch.core.reliability import NO_TIMEOUT
    from repro_torch.core.scenario import sweep_inputs
    from repro_torch.core.simulator import run_samples
    from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS, faas_sweep, launch_key
    from repro_torch.kernels.ref import faas_sweep_ref
    from repro_torch.serving.autoscale import plan_expiration_threshold

    keys = ("faas_sweep_retry", "faas_sweep_win", "faas_sweep_rely")
    errs = {k: 0.0 for k in keys}
    results = {}

    # ---- small cases: the kernel against its plain version at M = 8, 37, 64, 300
    C, N = RELY_SMALL_ROWS, RELY_SMALL_EVENTS
    t0 = time.perf_counter()
    for M in RELY_SMALL_SLOTS:
        max_c = 3 if M in (8, 64) else 1000  # rejections trigger retries
        for case, (name, windows, rely, retry, J, backoff) in enumerate(RELY_CASES):
            rng = np.random.default_rng(400 + 10 * M + case)
            inp = rely_small_inputs(torch, dev, rng, C, M, N, J, backoff, windows)
            args, kw = rely_call(inp, windows, rely, retry, max_c)
            W = inp["window_bounds"].shape[1] - 1 if windows else 0
            key = launch_key(False, bool(W), rely, retry)
            before = LAUNCH_COUNTS[key]
            out_k = faas_sweep(*args, **kw)
            if LAUNCH_COUNTS[key] != before + 1:
                raise AssertionError(f"{name}: no {key} launch counted")
            out_p = faas_sweep_ref(*args, **kw)
            err = held_against_plain(torch, out_k, out_p, f"{name} M={M}",
                                     integral_cols=window_integral_cols(W))
            if key in errs:
                errs[key] = max(errs[key], err)
            tot = out_k[4].sum(0).tolist()
            line = (f"kernel==plain rely M={M} {name}: cold={tot[0]:.0f} warm={tot[1]:.0f} "
                    f"reject={tot[2]:.0f}")
            if W:
                line += f", window arrivals {sum(tot[8 + 2 * W:8 + 3 * W]):.0f}"
            if rely:
                line += (f", timeouts {tot[-4]:.0f} failures {tot[-3]:.0f} retries "
                         f"{tot[-2]:.0f} abandons {tot[-1]:.0f}")
                if tot[-4] <= 0 or tot[-3] <= 0:
                    raise AssertionError(f"{name}: no timeout or no failure happened")
            if retry:
                child = inp["table"][5].long()
                pos = torch.arange(child.shape[1], device=dev).expand_as(child)
                has = child < (1 << 30)
                same = float((child[has] // 32 == pos[has] // 32).float().mean())
                line += f", act plane equal ({100 * same:.1f}% of children in their batch)"
                if tot[-2] <= 0:
                    raise AssertionError(f"{name}: no retry was processed")
            print(line + f", max|acc diff| {err:.3e}", flush=True)
        # a trivial policy leaves the pool and every other column bit-equal
        args, kw = rely_call(inp, "irregular", False, False, max_c)
        plain = faas_sweep(*args, **kw)
        triv = faas_sweep(*args, **kw, t_timeout=NO_TIMEOUT, p_fail=0.0, fail_u=inp["fail_gaps"])
        W = inp["window_bounds"].shape[1] - 1
        if not all(torch.equal(a, b) for a, b in zip(plain[:4], triv[:4])) or not torch.equal(
                plain[4], triv[4][:, :8 + 5 * W]) or float(triv[4][:, -4:-1].sum()) != 0.0:
            raise AssertionError(f"M={M}: the trivial policy changed the launch")
    print(f"rely small cases: {len(RELY_CASES)} cases and a trivial policy at M = "
          f"{', '.join(map(str, RELY_SMALL_SLOTS))}, {C} rows x {N} base events, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 1. the retry what-if sweep at full width
    scn_r = table1(rt, sim_time=RETRY_SIM, skip_time=RETRY_SKIP, expiration_threshold=120.0,
                   reliability=retry_policy(rt))
    cells = len(RETRY_OVER["t_timeout"]) * len(RETRY_OVER["expiration_threshold"])
    Cr, Kr = cells * RETRY_REPLICAS, 3 * scn_r.steps_needed()
    draw_rows = len(RETRY_OVER["expiration_threshold"]) * RETRY_REPLICAS
    print(f"retry sweep: {Cr} rows x {Kr} attempts; the six f32 [C, K] launch buffers take "
          f"{6 * 4 * Cr * Kr / 2**30:.2f} GiB, the draw cells' {6 * 4 * draw_rows * Kr / 2**30:.2f}"
          f" GiB before the timeout cells copy them", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    grid_r = rt.sweep(scn_r, RETRY_OVER, seed=4, replicas=RETRY_REPLICAS, backend="cuda")
    retry_wall = time.perf_counter() - t0
    retry_launches = LAUNCH_COUNTS["faas_sweep_retry"]
    if dict(LAUNCH_COUNTS) != {"faas_sweep_retry": 1}:
        raise AssertionError(f"the retry sweep's launches: {dict(LAUNCH_COUNTS)}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not grid_r.ok.all():
        raise AssertionError("retry sweep cells are not finite")
    gp, gp_se, cp, cp_se = [], [], [], []
    for s in grid_r.summaries.ravel():
        if not (s.n_attempts == s.n_completions + s.n_timeout + s.n_fail + s.n_reject).all():
            raise AssertionError("an attempt is neither served nor rejected")
        n = len(s.n_cold)
        gp.append(s.goodput)
        gp_se.append(float(np.std(s.n_completions / s.measured_time, ddof=1) / np.sqrt(n)))
        cp.append(s.cold_start_prob)
        cp_se.append(float(np.std(s.n_cold / np.maximum(s.n_cold + s.n_warm, 1), ddof=1)
                           / np.sqrt(n)))
    worst = 0.0
    for name, card_v, card_se in (("goodput", gp, gp_se), ("cold_start_prob", cp, cp_se)):
        ref_v, ref_se = np.asarray(REF_RETRY[name]), np.asarray(REF_RETRY[name + "_se"])
        z = np.abs(np.asarray(card_v) - ref_v) / np.sqrt(np.asarray(card_se) ** 2 + ref_se ** 2)
        worst = max(worst, float(z.max()))
        print(f"retry sweep {name} per cell (t_timeout-major) "
              + " ".join(f"{v:.5f}" for v in card_v) + "; JAX reference "
              + " ".join(f"{v:.5f}" for v in ref_v) + f"; max {z.max():.2f} standard errors",
              flush=True)
        if z.max() > REF_RETRY_SIGMAS:
            raise AssertionError(f"the retry sweep's {name} is more than "
                                 f"{REF_RETRY_SIGMAS} standard errors from the reference")
    amp = [s.retry_amplification for s in grid_r.summaries.ravel()]
    print(f"retry sweep: {grid_r.shape} cells x {RETRY_REPLICAS} replicas, 1 launch, "
          f"{retry_wall:.2f} s wall, peak {peak:.2f} GiB on the card; retry amplification "
          f"{min(amp):.4f}-{max(amp):.4f}, goodput {min(gp):.4f}-{max(gp):.4f}/s", flush=True)

    # timing at the sweep's width, on its own inputs
    inp = sweep_inputs(scn_r, RETRY_OVER, 4, replicas=RETRY_REPLICAS, device=dev)
    row = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    args = (*fresh_pools(torch, Cr, scn_r.slots, dev), row(inp.thr_rows), *inp.samples[:3])
    kw = dict(t_end=row(inp.sim_rows), skip=row(inp.skip_rows), max_concurrency=1000,
              prestamped=True, t_timeout=row(inp.t_timeout_rows), p_fail=row(inp.p_fail_rows),
              fail_u=inp.samples[3], is_first=inp.samples[4], child_pos=inp.samples[5])
    ms, out_full = timed(torch, lambda: faas_sweep(*args, **kw), reps=3)
    acc = out_full[4]
    cell_cold = acc[:, 0].double().reshape(len(RETRY_OVER["expiration_threshold"]),
                                           len(RETRY_OVER["t_timeout"]), RETRY_REPLICAS)
    want = np.stack([[grid_r.summaries[i, j].n_cold for i in range(4)] for j in range(3)])
    if not np.array_equal(cell_cold.cpu().numpy(), want):
        raise AssertionError("the timed retry launch does not reproduce sweep()")
    times, first = inp.samples[0], inp.samples[4]
    in_h = times <= kw["t_end"][:, None]
    counted_first = ((first > 0) & in_h & (times > kw["skip"][:, None])).sum(1)
    attempts = acc[:, :3].sum(1)
    if not torch.equal(counted_first.float() + acc[:, 10], attempts):
        raise AssertionError("first attempts plus retries differ from the attempts")
    active = int(in_h.sum())
    # the work the result needs: only switched-on attempts (first attempts
    # and the children a trigger activated) change a count; the kernel walks
    # the pool for every attempt in the horizon, as the reference does
    switched = int((in_h & ((first > 0) | (out_full.act > 0))).sum())
    b_ms, b_by = bound_ms(Cr, scn_r.slots, Kr, switched, rely=True, retry=True)
    b_all_ms, _ = bound_ms(Cr, scn_r.slots, Kr, active, rely=True, retry=True)
    part = [prefix(x, RELY_PLAIN_EVENTS) for x in (times, inp.samples[1], inp.samples[2])]
    pkw = dict(kw, fail_u=prefix(kw["fail_u"], RELY_PLAIN_EVENTS),
               is_first=prefix(kw["is_first"], RELY_PLAIN_EVENTS),
               child_pos=prefix(kw["child_pos"], RELY_PLAIN_EVENTS))
    pargs = (*args[:5], *part)
    out_k = faas_sweep(*pargs, **pkw)
    plain_ms, out_p = plain_timed(torch, lambda: faas_sweep_ref(*pargs, **pkw))
    errs["faas_sweep_retry"] = max(errs["faas_sweep_retry"], held_against_plain(
        torch, out_k, out_p, f"retry sweep, first {RELY_PLAIN_EVENTS} attempts"))
    print(f"timing [{card}]: faas_sweep with retries C={Cr} M={scn_r.slots} K={Kr}: "
          f"{ms:.3f} ms; {active} attempts in horizon = {active / ms * 1e3:.4e} attempts/s, "
          f"{switched} of them switched on ({100 * switched / active:.1f}%); bound "
          f"{b_ms:.3f} ms ({b_by}) for the switched-on attempts, {b_all_ms:.3f} ms if every "
          f"attempt in the horizon walked the pool; plain version {plain_ms:.1f} ms on the first "
          f"{RELY_PLAIN_EVENTS} attempts (act plane and counts equal, max|acc diff| "
          f"{errs['faas_sweep_retry']:.3e}); first attempts + retries = attempts in every "
          f"row; sweep() {retry_wall:.2f} s wall = {active / retry_wall:.4e} attempts/s",
          flush=True)
    results["faas_sweep_retry"] = dict(launches=retry_launches, ms=ms, plain_ms=plain_ms,
                                       bound_ms=b_ms, bound_by=b_by)
    del inp, args, kw, pkw, pargs, part, out_full, out_k, out_p, acc, times, first, in_h
    torch.cuda.empty_cache()

    # ---- 2. the windowed Table-1 sweep
    scn_w = table1(rt, window_bounds=TABLE1_WINDOWS)
    W = len(TABLE1_WINDOWS) - 1
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    grid_w = rt.sweep(scn_w, SWEEP_OVER, seed=0, replicas=SWEEP_REPLICAS, backend="cuda")
    win_wall = time.perf_counter() - t0
    win_launches = LAUNCH_COUNTS["faas_sweep_win"]
    if dict(LAUNCH_COUNTS) != {"faas_sweep_win": 1}:
        raise AssertionError(f"the windowed sweep's launches: {dict(LAUNCH_COUNTS)}")
    if grid_w.windowed_arrivals.shape != grid_w.shape + (W,) or not all(
            np.isfinite(getattr(grid_w, f)).all() for f in grid_w._WINDOWED_FIELDS):
        raise AssertionError("the windowed grids are not finite or not [cells, W]")
    # the windows change no decision: the base metrics are the plain sweep's
    if not np.array_equal(grid_w.cold_start_prob, table1_grid.cold_start_prob):
        raise AssertionError("the windowed sweep's cold starts differ from the plain sweep's")
    rate = grid_w.sel(arrival_rate=0.9, expiration_threshold=600.0)
    widths = np.diff(TABLE1_WINDOWS)
    per_s = rate.windowed_arrivals / widths
    print(f"windowed sweep: {grid_w.shape} cells x {SWEEP_REPLICAS} replicas x {W} windows, "
          f"1 launch, {win_wall:.2f} s wall; (0.9/s, 600 s) arrivals/s per window "
          + " ".join(f"{v:.4f}" for v in per_s) + ", cold-start % "
          + " ".join(f"{100 * v:.3f}" for v in rate.windowed_cold_prob) + ", instances "
          + " ".join(f"{v:.3f}" for v in rate.windowed_instance_count), flush=True)
    if np.abs(per_s / 0.9 - 1).max() > WINDOW_RATE_RTOL:
        raise AssertionError(f"a window's arrival rate is more than {WINDOW_RATE_RTOL} from 0.9/s")
    inp = sweep_inputs(scn_w, SWEEP_OVER, 0, replicas=SWEEP_REPLICAS, device=dev)
    dts, warms, colds = inp.samples
    Cw, Kw = dts.shape
    wb = row(np.tile(TABLE1_WINDOWS, (Cw, 1)))
    args = (*fresh_pools(torch, Cw, scn_w.slots, dev), row(inp.thr_rows), dts, warms, colds)
    kw = dict(t_end=row(inp.sim_rows), skip=row(inp.skip_rows),
              max_concurrency=scn_w.max_concurrency, window_bounds=wb)
    ms, out_full = timed(torch, lambda: faas_sweep(*args, **kw), reps=3)
    acc = out_full[4].double()
    # the windows tile [0, T): they hold every arrival in the horizon, the
    # ones before skip included (the f64 clock may move one across skip or
    # onto T, where the half-open last window ends)
    before_skip = arrivals_per_row(dts, kw["skip"])
    diff = acc[:, 8 + 2 * W:8 + 3 * W].sum(1) - acc[:, :3].sum(1) - before_skip
    if float(diff.abs().max()) > 1:
        raise AssertionError("the windows' arrivals do not add up to the horizon's")
    active = arrivals_in_horizon(dts, kw["t_end"])
    passes = active + Cw * W
    b_ms, b_by = bound_ms(Cw, scn_w.slots, Kw, active, W=W, window_passes=passes)
    part = [prefix(x, RELY_PLAIN_EVENTS) for x in (dts, warms, colds)]
    pargs = (*args[:5], *part)
    out_k = faas_sweep(*pargs, **kw)
    plain_ms, out_p = plain_timed(torch, lambda: faas_ref_in_graph(torch, pargs, kw))
    errs["faas_sweep_win"] = max(errs["faas_sweep_win"], held_against_plain(
        torch, out_k, out_p, f"windowed sweep, first {RELY_PLAIN_EVENTS} events",
        integral_cols=window_integral_cols(W)))
    # every prefix event lies in the first windows: all are counted there
    if not bool((out_k[4][:, 8 + 2 * W:8 + 3 * W].sum(1) == RELY_PLAIN_EVENTS).all()):
        raise AssertionError("the prefix's windows miss an arrival")
    print(f"timing [{card}]: faas_sweep with {W} windows C={Cw} M={scn_w.slots} K={Kw}: "
          f"{ms:.3f} ms; {active} arrivals in horizon = {active / ms * 1e3:.4e} arrivals/s; "
          f"bound {b_ms:.3f} ms ({b_by}); plain version {plain_ms:.1f} ms on the first "
          f"{RELY_PLAIN_EVENTS} events (window counts equal, max|acc diff| "
          f"{errs['faas_sweep_win']:.3e}); windows vs horizon: largest per-row difference "
          f"{float(diff.abs().max()):.0f}, {int((diff != 0).sum())} rows differ by one; "
          f"sweep() {win_wall:.2f} s wall = {active / win_wall:.4e} arrivals/s", flush=True)
    results["faas_sweep_win"] = dict(launches=win_launches, ms=ms, plain_ms=plain_ms,
                                     bound_ms=b_ms, bound_by=b_by)
    del inp, args, kw, pargs, part, out_full, out_k, out_p, acc, dts, warms, colds, wb
    torch.cuda.empty_cache()

    # ---- 3. the fail-only run() of Table 1
    fail = rt.Reliability(rt.FailurePolicy(p_fail=0.05, t_timeout=8.0))
    scn_f = table1(rt, reliability=fail)
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    res_f = rt.run(scn_f, seed=5, replicas=FAIL_REPLICAS, backend="cuda")
    fail_wall = time.perf_counter() - t0
    rely_launches = LAUNCH_COUNTS["faas_sweep_rely"]
    if dict(LAUNCH_COUNTS) != {"faas_sweep_rely": 1}:
        raise AssertionError(f"the fail-only run's launches: {dict(LAUNCH_COUNTS)}")
    s = res_f.summary
    served = float((s.n_cold + s.n_warm).sum())
    want_to = float((s.n_warm.sum() * np.exp(-8 / 1.991) + s.n_cold.sum() * np.exp(-8 / 2.244))
                    / served)
    # the same draws each call; tools/fail_only_seeds.py holds the shares
    # at other seeds and probes the exponential sampler's tail
    checks = (("failure", s.failure_prob, 0.05 * (1 - want_to)),
              ("timeout", s.timeout_prob, want_to))
    for what, got, want in checks:
        z = abs(got - want) / np.sqrt(want * (1 - want) / served)
        print(f"fail-only run: {what} probability {got:.6f}, expected {want:.6f} "
              f"({z:.2f} standard errors)", flush=True)
        if z > REF_RETRY_SIGMAS:
            raise AssertionError(f"the fail-only run's {what} probability is off")
    if not (s.n_completions == s.n_cold + s.n_warm - s.n_timeout - s.n_fail).all() or not (
            s.n_abandon == s.n_timeout + s.n_fail + s.n_reject).all():
        raise AssertionError("the fail-only run's counts do not add up")
    print(f"fail-only run: Table 1, {FAIL_REPLICAS} replicas, 1 launch, {fail_wall:.2f} s "
          f"wall; goodput {s.goodput:.5f}/s, avg servers {res_f.avg_server_count:.4f}", flush=True)
    samples = run_samples(scn_f, 5, FAIL_REPLICAS, None, None, dev)
    Cf, Kf = samples[0].shape
    full = lambda v: torch.full((Cf,), v, dtype=torch.float32, device=dev)
    args = (*fresh_pools(torch, Cf, scn_f.slots, dev), full(scn_f.expiration_threshold),
            *samples[:3])
    kw = dict(t_end=full(scn_f.sim_time), skip=full(scn_f.skip_time),
              max_concurrency=scn_f.max_concurrency, t_timeout=full(8.0), p_fail=full(0.05),
              fail_u=samples[3])
    ms, out_full = timed(torch, lambda: faas_sweep(*args, **kw), reps=3)
    if not np.array_equal(out_full[4][:, 9].double().cpu().numpy(), s.n_fail):
        raise AssertionError("the timed fail-only launch does not reproduce run()")
    active = arrivals_in_horizon(samples[0], kw["t_end"])
    b_ms, b_by = bound_ms(Cf, scn_f.slots, Kf, active, rely=True)
    part = [prefix(x, RELY_PLAIN_EVENTS) for x in samples]
    pargs = (*args[:5], *part[:3])
    pkw = dict(kw, fail_u=part[3])
    out_k = faas_sweep(*pargs, **pkw)
    plain_ms, out_p = plain_timed(torch, lambda: faas_ref_in_graph(torch, pargs, pkw))
    errs["faas_sweep_rely"] = max(errs["faas_sweep_rely"], held_against_plain(
        torch, out_k, out_p, f"fail-only run, first {RELY_PLAIN_EVENTS} events"))
    print(f"timing [{card}]: faas_sweep with reliability C={Cf} M={scn_f.slots} K={Kf}: "
          f"{ms:.3f} ms; {active} arrivals in horizon = {active / ms * 1e3:.4e} arrivals/s; "
          f"bound {b_ms:.3f} ms ({b_by}); plain version {plain_ms:.1f} ms on the first "
          f"{RELY_PLAIN_EVENTS} events (max|acc diff| {errs['faas_sweep_rely']:.3e}); run() "
          f"{fail_wall:.2f} s wall = {active / fail_wall:.4e} arrivals/s", flush=True)
    results["faas_sweep_rely"] = dict(launches=rely_launches, ms=ms, plain_ms=plain_ms,
                                      bound_ms=b_ms, bound_by=b_by)
    del samples, args, kw, pkw, pargs, part, out_full, out_k, out_p
    torch.cuda.empty_cache()

    # ---- 4. the planner under the retry policy
    LAUNCH_COUNTS.clear()
    plan = plan_expiration_threshold(0.9, 1.991, 2.244, 0.01, reliability=retry_policy(rt),
                                     replicas=32, execution=rt.Execution(backend="cuda"))
    plan_launches = LAUNCH_COUNTS["faas_sweep_retry"]
    if dict(LAUNCH_COUNTS) != {"faas_sweep_retry": 1} or not np.isfinite(plan.predicted_goodput):
        raise AssertionError(f"the planner: {dict(LAUNCH_COUNTS)}, goodput "
                             f"{plan.predicted_goodput}")
    print(f"planner under the retry policy: threshold {plan.expiration_threshold:.0f} s, "
          f"cold starts {100 * plan.predicted_cold_prob:.3f}%, goodput "
          f"{plan.predicted_goodput:.4f}/s, replicas {plan.predicted_avg_replicas:.3f}, "
          f"{plan_launches} launch", flush=True)
    results["faas_sweep_retry"]["launches"] += plan_launches
    return results, errs


# ---- the fused draw phase (module docstring, item 10)
# per stream, per event: threefry-2x32 (4 key-schedule and counter ops, 20
# rounds of add, rotate and xor, 5 key injections of 3 adds) and the two
# mantissa fills (shift and or each): int32 operations
INT_OPS_PER_DRAW = 83
# f32 operations and libm calls of each transform (drawplan.sample_dist):
# divisions, products and sums count as f32 operations (the two mantissa
# subtractions and the clamp included); log, sqrt, cos, exp and pow each
# count as one call of the special-function unit
FUSED_F32_OPS = {"exp": 4, "det": 3, "gauss": 7, "weibull": 5, "lognorm": 7, "pareto": 5}
FUSED_SFU_CALLS = {"exp": 1, "det": 0, "gauss": 3, "weibull": 2, "lognorm": 4, "pareto": 1}
# H100 SXM per SM (NVIDIA H100 architecture whitepaper): 128 FP32 lanes (the
# 67 TFLOP/s above counts an FMA as 2), 64 INT32 lanes and 16 special-
# function units, 132 SMs at the 1,980 MHz boost clock
PEAK_INT32_OPS = 132 * 64 * 1.98e9
PEAK_SFU_OPS = 132 * 16 * 1.98e9
# the small cases: (arrival, warm, cold) families with their (p0, p1); across
# the six cases every family is drawn on every stream
FUSED_CASES = (
    (("exp", 0.8, 0.0), ("weibull", 1.5, 2.2), ("pareto", 3.0, 1.6)),
    (("det", 1.3, 0.0), ("gauss", 2.0, 0.5), ("lognorm", 0.5, 0.6)),
    (("gauss", 1.25, 0.3), ("exp", 0.5, 0.0), ("weibull", 0.8, 2.0)),
    (("weibull", 1.2, 1.3), ("det", 2.0, 0.0), ("gauss", 2.5, 0.8)),
    (("lognorm", 0.0, 0.5), ("pareto", 2.5, 1.2), ("exp", 0.4, 0.0)),
    (("pareto", 3.0, 0.8), ("lognorm", 0.4, 0.7), ("det", 2.4, 0.0)),
)
# rows (not a multiple of the kernel's 4 rows a block), events (not a
# multiple of its 32-event batches) and pool sizes of the small cases
FUSED_SMALL_ROWS, FUSED_SMALL_EVENTS, FUSED_SMALL_SLOTS = 258, 509, (8, 37, 64, 300)
# the paths: windows ("narrow": 240, several to a gap), reliability
FUSED_PATHS = (("base", False, False), ("240 narrow windows", True, False),
               ("reliability", False, True), ("windows + reliability", True, True))
# the sampler check: 2^26 draws of each family under Table 1's mean service
# time (1.991 s) and under a heavier tail; Pareto keeps alpha > 4, where the
# standard error of the sample variance is finite
SAMPLER_ROWS, SAMPLER_EVENTS = 1 << 16, 1 << 10
SAMPLER_SETS = {
    "Table 1": {"exp": (1 / 1.991, 0.0), "det": (1.991, 0.0), "gauss": (1.991, 0.5),
                "weibull": (1.5, 1.991 / 0.9027452929509336),
                "lognorm": (float(np.log(1.991) - 0.125), 0.5),
                "pareto": (5.0, 1.991 * 4 / 5)},
    "heavy tail": {"exp": (0.1, 0.0), "det": (0.25, 0.0), "gauss": (1.991, 1.5),
                   "weibull": (0.6, 1.0), "lognorm": (0.0, 1.0), "pareto": (4.5, 1.0)},
}
SAMPLER_SIGMAS = 4.0
FUSED_PLAIN_EVENTS = 4096  # each full-width launch is held to plain on these
FUSED_WIDE_REPLICAS = 256  # 32,768 rows: the staged buffers would fill the card
# the arrivals before skip of a windowed row are counted on a materialized
# prefix of its stream this long (at 2/s, 100 s holds ~200 arrivals)
SKIP_PREFIX_EVENTS = 512


def fused_bound_ms(C, M, K, n_active, dists, W=0, window_passes=0, rely=False):
    """Least time for one fused faas_sweep call: ``bound_ms``'s pool walk
    without the sample bytes, plus the keys and parameters (8 bytes a row
    each) and the draws of every event in a horizon, one more per row (the
    event that steps past it), each stream's int32 operations, f32
    operations and special-function calls at their own rates."""
    streams = 3 + (1 if rely else 0)
    cols = 8 + 5 * W + (4 if rely else 0)
    nbytes = (4 * (3 * C * M + 4 * C + C * (W + 1 if W else 0)) + 8 * C * (2 * 3 + rely)
              + 4 * (3 * C * M + C + cols * C) + (8 * C if rely else 0))
    f32 = (n_active * (M * OPS_PER_SLOT_EVENT + OPS_PER_ROW_EVENT)
           + (C * K - n_active) * OPS_PER_INERT_EVENT + C * M * OPS_PER_SLOT_FINAL)
    if W:
        f32 += (n_active * WIN_OPS_PER_EVENT
                + window_passes * (M * WIN_OPS_PER_SLOT_WINDOW + WIN_OPS_PER_WINDOW))
    if rely:
        f32 += n_active * RELY_OPS_PER_EVENT
    drawn = n_active + C
    f32 += drawn * (sum(FUSED_F32_OPS[d] for d in dists) + (1 if rely else 0))
    ints = drawn * streams * INT_OPS_PER_DRAW
    sfu = drawn * sum(FUSED_SFU_CALLS[d] for d in dists)
    times = {"bytes": nbytes / PEAK_BYTES, "operations": max(
        f32 / PEAK_F32_OPS, ints / PEAK_INT32_OPS, sfu / PEAK_SFU_OPS)}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def fused_small_inputs(torch, dev, rng, C, M, K, case):
    """One small launch's inputs: numpy-seeded uint32 keys for the four
    streams, the case's families and per-row parameters (each row's p0
    jittered by 10%), per-row thresholds, horizons, warm-ups, timeouts and
    failure rates, and 240 narrow windows over the shortest horizon."""
    from repro_torch.core.drawplan import materialize_stream

    to = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    keys = [torch.from_numpy(rng.integers(0, 1 << 32, (C, 2), dtype=np.uint64)
                             .astype(np.uint32)).to(dev) for _ in range(4)]
    params = [to(np.stack([p0 * rng.uniform(0.9, 1.1, C), np.full(C, p1)], 1))
              for _, p0, p1 in case]
    dists = tuple(d for d, _, _ in case)
    # the mean gap, read off a prefix of the arrival stream itself
    gap = float(materialize_stream(dists[0], keys[0], (params[0][:, 0], params[0][:, 1]),
                                   64, dev).double().mean())
    horizon = K * gap
    t_end = horizon * rng.uniform(0.5, 0.9, C)
    return dict(
        pool=fresh_pools(torch, C, M, dev), t_exp=to(10 * rng.uniform(0.5, 1.5, C)),
        keys=keys, params=params, dists=dists, t_end=to(t_end),
        skip=to(horizon * rng.uniform(0.0, 0.1, C)),
        window_bounds=to(np.tile(np.linspace(0.0, 0.5 * horizon, 241), (C, 1))),
        t_timeout=to(rng.uniform(1.0, 5.0, C)), p_fail=to(np.full(C, 0.1)),
    )


def fused_call(inp, K, windows, rely, max_c):
    """(args, kw) of a fused faas_sweep call on ``fused_small_inputs``."""
    kw = dict(t_end=inp["t_end"], skip=inp["skip"], max_concurrency=max_c,
              fused_keys=tuple(inp["keys"][:3]), fused_params=tuple(inp["params"]),
              fused_dists=inp["dists"], fused_k=K)
    if windows:
        kw["window_bounds"] = inp["window_bounds"]
    if rely:
        kw.update(t_timeout=inp["t_timeout"], p_fail=inp["p_fail"],
                  fused_fail_keys=inp["keys"][3])
    return (*inp["pool"], inp["t_exp"], None, None, None), kw


def staged_twin(inp, K, kw):
    """The staged call on the fused call's draws: the port's
    materialize_stream on the card from the same keys (and the failure
    stream's word-0 uniforms as fail_u)."""
    from repro_torch.core.drawplan import materialize_stream

    dev = inp["t_end"].device
    bufs = [materialize_stream(d, k, (p[:, 0], p[:, 1]), K, dev)
            for d, k, p in zip(inp["dists"], inp["keys"][:3], inp["params"])]
    skw = {k: v for k, v in kw.items() if not k.startswith("fused")}
    if "fused_fail_keys" in kw:
        skw["fail_u"] = materialize_stream("uniform", kw["fused_fail_keys"], None, K, dev)
    return (*inp["pool"], inp["t_exp"], *bufs), skw


def fused_small_cases(torch, dev):
    """The fused kernel against its plain version on every family of every
    stream, every path and M = 8, 37, 64, 300, and against the staged kernel
    on the same draws materialized; returns the largest |acc difference|
    per launch key."""
    from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS, faas_sweep, launch_key
    from repro_torch.kernels.ref import faas_sweep_ref

    C, K = FUSED_SMALL_ROWS, FUSED_SMALL_EVENTS
    errs = {}
    t0 = time.perf_counter()
    for m_i, M in enumerate(FUSED_SMALL_SLOTS):
        max_c = 3 if M in (8, 64) else 1000
        for c_i, case in enumerate(FUSED_CASES):
            name, windows, rely = FUSED_PATHS[(c_i + m_i) % len(FUSED_PATHS)]
            rng = np.random.default_rng(1000 + 10 * M + c_i)
            inp = fused_small_inputs(torch, dev, rng, C, M, K, case)
            args, kw = fused_call(inp, K, windows, rely, max_c)
            key = launch_key(False, windows, rely, False, True)
            before = LAUNCH_COUNTS[key]
            out_k = faas_sweep(*args, **kw)
            if LAUNCH_COUNTS[key] != before + 1:
                raise AssertionError(f"fused {name}: no {key} launch counted")
            out_p = faas_sweep_ref(*args, **kw)
            W = 240 if windows else 0
            what = f"fused M={M} {name} {inp['dists']}"
            err = held_against_plain(torch, out_k, out_p, what,
                                     integral_cols=window_integral_cols(W))
            errs[key] = max(errs.get(key, 0.0), err)
            # the same draws materialized and staged: the staged kernel
            # makes the same launch bit for bit
            sargs, skw = staged_twin(inp, K, kw)
            out_s = faas_sweep(*sargs, **skw)
            same = all((a is None) == (b is None) and (a is None or torch.equal(a, b))
                       for a, b in zip(out_k, out_s))
            if not same:
                raise AssertionError(f"{what}: the fused launch differs from the staged "
                                     "launch on its materialized draws")
            tot = out_k[4].sum(0).tolist()
            line = (f"kernel==plain==staged fused M={M} {name} {'/'.join(inp['dists'])}: "
                    f"cold={tot[0]:.0f} warm={tot[1]:.0f} reject={tot[2]:.0f}")
            if W:
                line += f", window arrivals {sum(tot[8 + 2 * W:8 + 3 * W]):.0f}"
            if rely:
                line += f", timeouts {tot[-4]:.0f} failures {tot[-3]:.0f}"
                if tot[-3] <= 0:
                    raise AssertionError(f"{what}: no failure happened")
            if tot[0] + tot[1] <= 0:
                raise AssertionError(f"{what}: nothing was served")
            print(line + f", max|acc diff| {err:.3e}", flush=True)
    print(f"fused small cases: {len(FUSED_CASES)} family cases x {len(FUSED_SMALL_SLOTS)} "
          f"pool sizes over {len(FUSED_PATHS)} paths, {C} rows x {K} events, each equal to "
          f"its plain version and to the staged kernel on its materialized draws, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return errs


def sampler_check(torch, dev):
    """2^26 draws of each family and parameter set materialized on the card:
    mean and variance within SAMPLER_SIGMAS standard errors of the closed
    form (the Gaussian's clamped at 1e-9); the deterministic family exact."""
    from math import erf, exp, gamma, pi, sqrt

    from repro_torch.core.drawplan import materialize_stream

    Phi = lambda x: 0.5 * (1 + erf(x / sqrt(2)))
    phi = lambda x: exp(-x * x / 2) / sqrt(2 * pi)

    def moments(kind, p0, p1):
        """The first two raw moments of the clamped family."""
        if kind == "exp":
            return 1 / p0, 2 / p0 ** 2
        if kind == "det":
            return p0, p0 ** 2
        if kind == "gauss":
            a = p0 / p1
            return (p0 * Phi(a) + p1 * phi(a),
                    (p0 ** 2 + p1 ** 2) * Phi(a) + p0 * p1 * phi(a))
        if kind == "weibull":
            return p1 * gamma(1 + 1 / p0), p1 ** 2 * gamma(1 + 2 / p0)
        if kind == "lognorm":
            return exp(p0 + p1 ** 2 / 2), exp(2 * p0 + 2 * p1 ** 2)
        return p0 * p1 / (p0 - 1), p0 * p1 ** 2 / (p0 - 2)

    rng = np.random.default_rng(7)
    N = SAMPLER_ROWS * SAMPLER_EVENTS
    worst = 0.0
    t0 = time.perf_counter()
    for set_name, fams in SAMPLER_SETS.items():
        for kind, (p0, p1) in fams.items():
            keys = torch.from_numpy(rng.integers(0, 1 << 32, (SAMPLER_ROWS, 2), dtype=np.uint64)
                                    .astype(np.uint32)).to(dev)
            x = materialize_stream(kind, keys, (p0, p1), SAMPLER_EVENTS, dev).double()
            m = float(x.mean())
            var = float(x.var(unbiased=False))
            m1, m2 = moments(kind, p0, p1)
            if kind == "det":
                if not bool((x == float(np.float32(p0))).all()):
                    raise AssertionError(f"sampler {set_name} det: a draw is not p0")
                print(f"sampler {set_name} {kind}({p0:.5g}): every one of {N} draws equals p0",
                      flush=True)
                continue
            mu4 = float(((x - m) ** 4).mean())
            z_m = abs(m - m1) / sqrt(var / N)
            z_v = abs(var - (m2 - m1 ** 2)) / sqrt(max(mu4 - var ** 2, 1e-300) / N)
            worst = max(worst, z_m, z_v)
            print(f"sampler {set_name} {kind}({p0:.5g}, {p1:.5g}): mean {m:.6f} (closed form "
                  f"{m1:.6f}, {z_m:.2f} standard errors), variance {var:.6f} ({m2 - m1 ** 2:.6f}, "
                  f"{z_v:.2f}) over {N} draws", flush=True)
            if max(z_m, z_v) > SAMPLER_SIGMAS:
                raise AssertionError(f"sampler {set_name} {kind}: more than {SAMPLER_SIGMAS} "
                                     "standard errors from the closed form")
            del x
    print(f"sampler check: {sum(len(f) for f in SAMPLER_SETS.values())} family sets, largest "
          f"{worst:.2f} standard "
          f"errors, in {time.perf_counter() - t0:.1f} s", flush=True)
    staged_sampler_check(torch, dev)


def staged_sampler_check(torch, dev):
    """The staged samplers with no fused transform, 2^26 draws each on the
    card from a card generator: Gamma at k = 0.5 and 2 (Marsaglia–Tsang
    rejection, the u^(1/k) boost below 1), empirical resampling, and batch
    arrivals (exact zeros inside a batch, the heads exponential): mean and
    variance within SAMPLER_SIGMAS standard errors of the closed form."""
    from math import sqrt

    from repro_torch.core import processes as rproc

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(11)
    shape = (SAMPLER_ROWS, SAMPLER_EVENTS)
    durations = (0.5, 1.5, 2.0, 8.0)
    d = np.asarray(durations)
    cases = [(f"gamma(k={k}, scale=1.5)", rproc.GammaSimProcess(shape_k=k, scale=1.5),
              k * 1.5, k * 1.5 ** 2) for k in (0.5, 2.0)]
    cases.append((f"empirical{durations}", rproc.EmpiricalSimProcess(durations=durations),
                  d.mean(), d.var()))
    batch = rproc.BatchArrivalProcess(base=rproc.ExpSimProcess(rate=0.6), batch_size=3)
    cases.append(("batch(exp(0.6), 3) heads", batch, 1 / 0.6, 1 / 0.36))
    worst = 0.0
    for what, proc, m1, v1 in cases:
        x = proc.sample(g, shape, dev)
        if proc is batch:
            heads = (torch.arange(x.numel(), device=dev) % 3 == 0).view(shape)
            if not bool((x[~heads] == 0).all()) or not bool((x[heads] > 0).all()):
                raise AssertionError("batch draws: a gap inside a batch is not 0")
            x = x[heads]
        x = x.double()
        n = x.numel()
        m = float(x.mean())
        var = float(x.var(unbiased=False))
        mu4 = float(((x - m) ** 4).mean())
        z_m = abs(m - m1) / sqrt(var / n)
        z_v = abs(var - v1) / sqrt(max(mu4 - var ** 2, 1e-300) / n)
        worst = max(worst, z_m, z_v)
        print(f"sampler {what}: mean {m:.6f} (closed form {m1:.6f}, {z_m:.2f} standard "
              f"errors), variance {var:.6f} ({v1:.6f}, {z_v:.2f}) over {n} draws", flush=True)
        if max(z_m, z_v) > SAMPLER_SIGMAS:
            raise AssertionError(f"sampler {what}: more than {SAMPLER_SIGMAS} standard errors "
                                 "from the closed form")
        del x
    print(f"staged sampler check: {len(cases)} families, largest {worst:.2f} standard errors, "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)


def cell_server_stats(grid):
    """Per cell: the replica mean of the average instance count and its
    standard error."""
    mean, se = [], []
    for s in grid.summaries.ravel():
        v = (s.time_running + s.time_idle) / s.measured_time
        mean.append(v.mean())
        se.append(v.std(ddof=1) / np.sqrt(len(v)))
    return np.asarray(mean), np.asarray(se)


def fused_timed(torch, rt, dev, card, scn, over, seed, replicas, what, window_bounds=None):
    """One fused launch at an entry point's width on its own inputs (from
    sweep_inputs, or run()'s single cell), timed by CUDA events and held to
    the plain version on the first FUSED_PLAIN_EVENTS events; returns
    (ms, plain_ms, bound_ms, bound_by, err, acc, arrivals before skip per
    row, arrivals in the horizons)."""
    from repro_torch.core.scenario import fused_state, sweep_inputs
    from repro_torch.kernels.faas_event_step import faas_sweep
    from repro_torch.kernels.ref import faas_sweep_ref

    row = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    rel = scn.reliability
    if over is None:
        st = fused_state([scn], seed, replicas, scn.steps_needed(), dev)
        C = replicas
        thr, sim, skip = (np.full(C, v) for v in (scn.expiration_threshold, scn.sim_time,
                                                  scn.skip_time))
    else:
        inp = sweep_inputs(scn, over, seed, replicas=replicas, device=dev, draws="fused")
        st, thr, sim, skip = inp.fused, inp.thr_rows, inp.sim_rows, inp.skip_rows
        C = len(thr)
    K = st["n_steps"]
    args = (*fresh_pools(torch, C, scn.slots, dev), row(thr), None, None, None)
    kw = dict(t_end=row(sim), skip=row(skip), max_concurrency=scn.max_concurrency,
              fused_keys=st["keys"], fused_params=st["params"], fused_dists=st["dists"],
              fused_k=K)
    W = 0
    if window_bounds is not None:
        W = len(window_bounds) - 1
        kw["window_bounds"] = row(np.tile(window_bounds, (C, 1)))
    if rel is not None:
        kw.update(t_timeout=row(np.full(C, rel.failure.timeout_or_inf)),
                  p_fail=row(np.full(C, rel.failure.p_fail)), fused_fail_keys=st["fail_keys"])
    ms, out_full = timed(torch, lambda: faas_sweep(*args, **kw), reps=3)
    acc = out_full[4]
    # arrivals in the horizons: every counted event, the ones before skip
    # read off a materialized prefix of each row's arrival stream
    before_skip = skip_arrivals(torch, st, skip, dev)
    active = int(acc[:, :3].double().sum()) + int(before_skip.sum())
    passes = active + C * W
    b_ms, b_by = fused_bound_ms(C, scn.slots, K, active, st["dists"], W=W,
                                window_passes=passes, rely=rel is not None)
    pkw = dict(kw, fused_k=FUSED_PLAIN_EVENTS)
    out_k = faas_sweep(*args, **pkw)
    plain_ms, out_p = plain_timed(torch, lambda: faas_sweep_ref(*args, **pkw))
    err = held_against_plain(torch, out_k, out_p, f"{what}, first {FUSED_PLAIN_EVENTS} events",
                             integral_cols=window_integral_cols(W))
    print(f"timing [{card}]: faas_sweep fused {what} C={C} M={scn.slots} K={K} "
          f"{'/'.join(st['dists'])}: {ms:.3f} ms; {active} arrivals in horizon = "
          f"{active / ms * 1e3:.4e} arrivals/s; bound {b_ms:.3f} ms ({b_by}; the draws' "
          f"int32, f32 and special-function work included); plain version {plain_ms:.1f} ms "
          f"on the first {FUSED_PLAIN_EVENTS} events (max|acc diff| {err:.3e})", flush=True)
    return ms, plain_ms, b_ms, b_by, err, acc, before_skip, active


def skip_arrivals(torch, st, skip, dev):
    """Arrivals at or before each row's skip, on the f64 sum of a
    materialized prefix of its fused arrival stream."""
    from repro_torch.core.drawplan import materialize_stream

    p = st["params"][0]
    gaps = materialize_stream(st["dists"][0], st["keys"][0], (p[:, 0], p[:, 1]),
                              SKIP_PREFIX_EVENTS, dev).double().cumsum(1)
    skip = torch.as_tensor(np.asarray(skip, np.float64), device=dev)
    if bool((gaps[:, -1] <= skip).any()):
        raise AssertionError("the materialized prefix does not reach skip_time")
    return (gaps <= skip[:, None]).sum(1).double()


def fused_phase(torch, rt, dev, card, staged_grid, staged_peak):
    """The fused draw phase (module docstring, item 10); returns the
    kernels-line entries and the largest differences."""
    from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS

    results = {}
    errs = fused_small_cases(torch, dev)
    sampler_check(torch, dev)
    fused = rt.Execution(backend="cuda", draws="fused")

    # ---- 1. the Table-1 sweep with fused draws
    scn = table1(rt)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    grid = rt.sweep(scn, SWEEP_OVER, seed=10, replicas=SWEEP_REPLICAS, execution=fused)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = LAUNCH_COUNTS["faas_sweep_fused"]
    if dict(LAUNCH_COUNTS) != {"faas_sweep_fused": 1}:
        raise AssertionError(f"the fused sweep's launches: {dict(LAUNCH_COUNTS)}")
    if not grid.ok.all() or grid.to_dict()["draws"] != "fused":
        raise AssertionError("the fused sweep's cells are not finite, or it ran staged")
    servers = float(grid.sel(arrival_rate=0.9, expiration_threshold=600.0).avg_server_count)
    if abs(servers / PAPER_SERVERS - 1) > 0.05:
        raise AssertionError("the fused Table-1 cell is more than 5% from the paper")
    m_f, se_f = cell_server_stats(grid)
    m_s, se_s = cell_server_stats(staged_grid)
    z = np.abs(m_f - m_s) / np.sqrt(se_f ** 2 + se_s ** 2)
    print(f"fused sweep: {grid.shape} cells x {SWEEP_REPLICAS} replicas, 1 launch, {wall:.3f} s "
          f"wall, peak {peak / 2**30:.3f} GiB on the card (the staged sweep: "
          f"{staged_peak / 2**30:.3f} GiB); (0.9/s, 600 s) avg servers {servers:.4f} (paper "
          f"{PAPER_SERVERS}); per-cell avg instances against the staged sweep: largest "
          f"{z.max():.2f} combined standard errors over {z.size} cells", flush=True)
    if z.max() > REF_RETRY_SIGMAS:
        raise AssertionError("a fused cell is more than 4 standard errors from the staged one")
    ms, plain_ms, b_ms, b_by, err, acc, _, active = fused_timed(
        torch, rt, dev, card, scn, SWEEP_OVER, 10, SWEEP_REPLICAS, "Table-1 sweep")
    cold = acc[:, 0].double().cpu().numpy().reshape(grid.shape + (SWEEP_REPLICAS,))
    want = np.stack([[s.n_cold for s in r] for r in grid.summaries])
    if not np.array_equal(cold, want):
        raise AssertionError("the timed fused launch does not reproduce sweep()")
    print(f"end to end [{card}]: fused sweep() {active / wall:.4e} simulated arrivals/s "
          f"({wall:.3f} s incl. keys and assembly), kernel {ms:.3f} ms", flush=True)
    errs["faas_sweep_fused"] = max(errs.get("faas_sweep_fused", 0.0), err)
    results["faas_sweep_fused"] = dict(launches=launches, ms=ms, plain_ms=plain_ms,
                                       bound_ms=b_ms, bound_by=b_by)
    del acc
    torch.cuda.empty_cache()

    # ---- 2. the same sweep over 32,768 rows, whose staged buffers would fill the card
    rows = len(SWEEP_OVER["expiration_threshold"]) * len(SWEEP_OVER["arrival_rate"]) \
        * FUSED_WIDE_REPLICAS
    K = max(rt.Scenario.of(scn, arrival_rate=r).steps_needed() for r in SWEEP_OVER["arrival_rate"])
    staged_gb = 3 * 4 * rows * K / 1e9
    torch.cuda.reset_peak_memory_stats()
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    wide = rt.sweep(scn, SWEEP_OVER, seed=11, replicas=FUSED_WIDE_REPLICAS, execution=fused)
    wide_wall = time.perf_counter() - t0
    wide_peak = torch.cuda.max_memory_allocated()
    if dict(LAUNCH_COUNTS) != {"faas_sweep_fused": 1} or not wide.ok.all():
        raise AssertionError(f"the 32,768-row sweep: {dict(LAUNCH_COUNTS)}")
    results["faas_sweep_fused"]["launches"] += 1
    w_servers = float(wide.sel(arrival_rate=0.9, expiration_threshold=600.0).avg_server_count)
    print(f"fused sweep at {FUSED_WIDE_REPLICAS} replicas: {rows} rows x "
          f"{K} events, 1 launch, {wide_wall:.3f} s wall, peak "
          f"{wide_peak / 2**30:.3f} GiB on the card (staged, its three [C, K] buffers alone: "
          f"{staged_gb:.1f} GB); (0.9/s, 600 s) avg servers {w_servers:.4f}", flush=True)
    if abs(w_servers / PAPER_SERVERS - 1) > 0.05:
        raise AssertionError("the 32,768-row Table-1 cell is more than 5% from the paper")
    del wide
    torch.cuda.empty_cache()

    # ---- 3. a fused fail-only run() of Table 1
    scn_f = table1(rt, reliability=rt.Reliability(rt.FailurePolicy(p_fail=0.05, t_timeout=8.0)))
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    res = rt.run(scn_f, seed=12, replicas=FAIL_REPLICAS, execution=fused)
    fail_wall = time.perf_counter() - t0
    if dict(LAUNCH_COUNTS) != {"faas_sweep_rely_fused": 1}:
        raise AssertionError(f"the fused fail-only run's launches: {dict(LAUNCH_COUNTS)}")
    s = res.summary
    served = float((s.n_cold + s.n_warm).sum())
    want_to = float((s.n_warm.sum() * np.exp(-8 / 1.991) + s.n_cold.sum() * np.exp(-8 / 2.244))
                    / served)
    for name, got, want in (("failure", s.failure_prob, 0.05 * (1 - want_to)),
                            ("timeout", s.timeout_prob, want_to)):
        zz = abs(got - want) / np.sqrt(want * (1 - want) / served)
        print(f"fused fail-only run: {name} probability {got:.6f}, expected {want:.6f} "
              f"({zz:.2f} standard errors)", flush=True)
        if zz > REF_RETRY_SIGMAS:
            raise AssertionError(f"the fused fail-only run's {name} probability is off")
    print(f"fused fail-only run: Table 1, {FAIL_REPLICAS} replicas, 1 launch, {fail_wall:.3f} s "
          f"wall; goodput {s.goodput:.5f}/s, avg servers {res.avg_server_count:.4f}", flush=True)
    ms, plain_ms, b_ms, b_by, err, acc, _, _ = fused_timed(
        torch, rt, dev, card, scn_f, None, 12, FAIL_REPLICAS, "fail-only run")
    if not np.array_equal(acc[:, 9].double().cpu().numpy(), s.n_fail):
        raise AssertionError("the timed fused fail-only launch does not reproduce run()")
    errs["faas_sweep_rely_fused"] = max(errs.get("faas_sweep_rely_fused", 0.0), err)
    results["faas_sweep_rely_fused"] = dict(launches=1, ms=ms, plain_ms=plain_ms,
                                            bound_ms=b_ms, bound_by=b_by)
    del acc
    torch.cuda.empty_cache()

    # ---- 4. a fused windowed sweep: the windows hold the horizon's arrivals
    scn_w = table1(rt, window_bounds=TABLE1_WINDOWS)
    W = len(TABLE1_WINDOWS) - 1
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    grid_w = rt.sweep(scn_w, SWEEP_OVER, seed=10, replicas=SWEEP_REPLICAS, execution=fused)
    win_wall = time.perf_counter() - t0
    if dict(LAUNCH_COUNTS) != {"faas_sweep_win_fused": 1}:
        raise AssertionError(f"the fused windowed sweep's launches: {dict(LAUNCH_COUNTS)}")
    if not np.array_equal(grid_w.cold_start_prob, grid.cold_start_prob):
        raise AssertionError("the fused windows changed a decision of the fused sweep")
    ms, plain_ms, b_ms, b_by, err, acc, before_skip, _ = fused_timed(
        torch, rt, dev, card, scn_w, SWEEP_OVER, 10, SWEEP_REPLICAS, "windowed sweep",
        window_bounds=TABLE1_WINDOWS)
    win_arr = np.concatenate([s.windows.n_arrivals.sum(1) for s in grid_w.summaries.ravel()])
    counted = np.concatenate([s.n_requests for s in grid_w.summaries.ravel()])
    diff = win_arr - counted - before_skip.cpu().numpy()
    print(f"fused windowed sweep: {grid_w.shape} cells x {SWEEP_REPLICAS} replicas x {W} "
          f"windows, 1 launch, {win_wall:.3f} s wall; windows vs horizon: largest per-row "
          f"difference {np.abs(diff).max():.0f}, {int((diff != 0).sum())} rows differ by one",
          flush=True)
    if np.abs(diff).max() > 1:
        raise AssertionError("the fused windows' arrivals do not add up to the horizon's")
    errs["faas_sweep_win_fused"] = max(errs.get("faas_sweep_win_fused", 0.0), err)
    results["faas_sweep_win_fused"] = dict(launches=1, ms=ms, plain_ms=plain_ms,
                                           bound_ms=b_ms, bound_by=b_by)
    return results, errs


# ---------------------------------------------------------------------------
# platform faults
# ---------------------------------------------------------------------------

# benchmarks/run.py::bench_fault_sweep's full grid (:996-1016): paper_cfg at
# 4000 s, a 50 s warm-up, max_concurrency 30, the capacity dip 40 -> 2 -> 40
# at 0.4 T and 0.7 T, crash_rate x threshold, 5,400 steps; only the
# replicas are raised (2 -> 512: 6,144 rows in one launch)
FAULT_SIM, FAULT_SKIP, FAULT_STEPS = 4000.0, 50.0, 5400
FAULT_OVER = {"crash_rate": [1e-4, 1e-3, 5e-3, 2e-2], "expiration_threshold": [30.0, 120.0, 600.0]}
FAULT_DIP = ((0.4 * FAULT_SIM, 0.7 * FAULT_SIM), (40.0, 2.0, 40.0))
FAULT_REPLICAS = 512
FAULT_RUN_REPLICAS = 4096  # rows of the fault runs with reliability and retries
# Table 1's sweep (phase 4) with crashes at the chaos frontier's base rate
# (examples/chaos.py:40-76)
TABLE1_CRASH_RATE = 1e-3
# rounds of (base, faults, faults, base) readings of that launch against the
# launch without faults; two, so that a spread between readings shows
TABLE1_FAULT_ROUNDS = 2
# examples/chaos.py:79-109's capacity dip: api and batch under n_cluster 40,
# crash_rate 2e-3, the ceiling 40 -> 10 -> 40 at 0.4 T and 0.7 T, T = 1000 s
DIP_T, DIP_FLEETS, DIP_CRASH_RATE = 1000.0, 4096, 2e-3
# the catalog sweep of phase 6 with chaos.py's crash rate and dip ratio
CATALOG_CRASH_RATE, CATALOG_DIP = 2e-3, (24.0, 6.0, 24.0)
FAULT_PLAIN_EVENTS = 4096  # the Table-1 and catalog launches are held to plain on these
# the JAX reference per cell, crash_rate-major (tools/fault_reference.py
# --replicas 256: JAX sweep()/fleet_run() on the f64 scan backend, on the
# CPU, seeds 0 and 1): availability and cold-start probability pooled over
# replicas, the average instance count as the replica mean, each with the
# standard error of its per-replica values; and the dip fleet's
# per-function availability.  The card's values (other draws: torch
# generators) must agree within REF_FAULT_SIGMAS standard errors of the
# difference.
REF_FAULT = dict(
    availability=[0.9998083443174708, 0.999793621036319, 0.9997938579545524,
                  0.9979564411663986, 0.9979537846951497, 0.9979524332596917,
                  0.9900568146714808, 0.9901805237794797, 0.9901933815810736,
                  0.9613659185697652, 0.9613199112308711, 0.9611658847428264],
    availability_se=[1.4925765740638021e-05, 1.4918990964887121e-05, 1.6285024918772196e-05,
                     4.769611856798651e-05, 5.274321157188688e-05, 4.8156384717459866e-05,
                     0.00010449796932189488, 0.00010917199689763725, 0.00011119471881411338,
                     0.00021891062251167367, 0.0002037485074717568, 0.00019843954257443535],
    cold_start_prob=[0.027351120629323072, 0.007414813066383585, 0.0035105866901364116,
                     0.03015763713664399, 0.010995935989047311, 0.008259383138121273,
                     0.042748159516025, 0.028559575563542616, 0.02828870191210556,
                     0.09156065375824744, 0.08847602322184647, 0.08854380065433061],
    cold_start_prob_se=[0.000152647214495357, 7.135443187270021e-05, 4.261209608448006e-05,
                        0.0001531846668797617, 9.098540265896853e-05, 8.794445312941459e-05,
                        0.00019066642854822648, 0.00016026012230817998, 0.00016490566921650805,
                        0.00028487964374893646, 0.0002783280070373732, 0.00028985102302212683],
    avg_server_count=[4.27448429249014, 5.066962880297887, 5.657340489109119,
                      4.225264725862197, 4.883914330953774, 5.09869631382633,
                      4.026592410265435, 4.3271551178939305, 4.327089091077085,
                      3.500677574783542, 3.524692572135615, 3.511177623724322],
    avg_server_count_se=[0.005522610169664349, 0.00912248968031673, 0.01670245787488804,
                         0.0055879223622780135, 0.009314110137034102, 0.013487465073170555,
                         0.005484826319960063, 0.007382045637434626, 0.007679408322068043,
                         0.004787834185006855, 0.0048779236398310164, 0.004965482867111069],
)
REF_FLEET_FAULT = dict(
    functions=["api", "batch"],
    availability=[0.9958985153018821, 0.9901985390275154],
    availability_se=[0.0001372768055611804, 0.00033779258765725295],
)
REF_FAULT_SIGMAS = 4.0
# f32 operations the fault path adds, counted as the kernel bodies do them:
# 5 on each slot per event (the crash-clipped stop, the exit clock, the
# crash test's 3 compares), 8 on the row (the crash count 1, the segment
# test 2, live count minus ceiling 1, the admission gate 1, the
# interruption test 2, its count 1), 4 per cold start (1 - u, the log, the
# division, the clock) and 5 on each slot per eviction pass (idle and
# newest tests, the arg-max butterfly's share)
FAULT_OPS_PER_SLOT_EVENT = 5
FAULT_OPS_PER_ROW_EVENT = 8
FAULT_OPS_PER_COLD = 4
FAULT_OPS_PER_EVICT_SLOT = 5
# (crashes, capacity, reliability, retries): every fault path set
FAULT_PATHS = [(c, k, rel, ret)
               for c, k in ((True, False), (False, True), (True, True))
               for rel, ret in ((False, False), (True, False), (True, True))]


def fault_extra(C, M, K, n_active, E, crashes, cold_starts, evictions):
    """The bytes and f32 operations the fault path adds to a faas_sweep
    call's bound: the crash rates and uniforms in and the crash clocks
    out, the capacity profiles in, the 3 fault columns out; per event in a
    horizon the slot and row work, per cold start its lifetime and per
    eviction one pass over the pool."""
    nbytes = 4 * 3 * C + (4 * C * (2 * E + 1) if E >= 0 else 0)
    if crashes:
        nbytes += 4 * (C + C * K + C * M)
    ops = (n_active * (M * FAULT_OPS_PER_SLOT_EVENT + FAULT_OPS_PER_ROW_EVENT)
           + cold_starts * FAULT_OPS_PER_COLD + evictions * M * FAULT_OPS_PER_EVICT_SLOT)
    return nbytes, ops


def fault_kwargs(torch, dev, rng, C, K, horizon, crashes, capacity, values=(6.0, 1.5, 8.0)):
    """Per-row crash rates and a crash uniform per event; a per-row ceiling
    stepping through ``values`` (a non-integer one among them) inside the
    horizon."""
    to = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    kw = {}
    if crashes:
        kw.update(crash_rate=to(rng.uniform(0.005, 0.05, C)), crash_u=to(rng.random((C, K))))
    if capacity:
        kw.update(cap_edges=to(np.sort(rng.uniform(0.2, 0.8, (C, len(values) - 1)), 1) * horizon),
                  cap_values=to(np.tile(values, (C, 1))))
    return kw


def fault_small_cases(torch, dev):
    """The fault kernels against their plain versions on small cases
    (module docstring, item 11); returns the largest |acc difference| per
    LAUNCH_COUNTS key."""
    from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS, faas_sweep, launch_key
    from repro_torch.kernels.fleet_event_step import fleet_sweep
    from repro_torch.kernels.ref import faas_sweep_ref, fleet_sweep_ref

    errs = {}
    C, N = RELY_SMALL_ROWS, RELY_SMALL_EVENTS
    t0 = time.perf_counter()
    cases = [(M, *p) for M in (8, 64) for p in FAULT_PATHS]
    cases += [(300, True, True, False, False), (300, True, True, True, True)]
    for case, (M, crashes, capacity, rely, retry) in enumerate(cases):
        rng = np.random.default_rng(500 + case)
        inp = rely_small_inputs(torch, dev, rng, C, M, N, 2, 0.5, None)
        args, kw = rely_call(inp, False, rely, retry, 3 if M == 8 else 100)
        horizon = float(inp["t_end"].max())
        kw.update(fault_kwargs(torch, dev, rng, C, args[5].shape[1], horizon, crashes, capacity))
        key = launch_key(False, False, rely, retry, faults=True)
        before = LAUNCH_COUNTS[key]
        out_k = faas_sweep(*args, **kw)
        if LAUNCH_COUNTS[key] != before + 1:
            raise AssertionError(f"fault case {case}: no {key} launch counted")
        # pools, the activation plane and the crash clocks equal bit for bit
        err = held_against_plain(torch, out_k, faas_sweep_ref(*args, **kw),
                                 f"fault case {case}")
        errs[key] = max(errs.get(key, 0.0), err)
        tot = out_k[4].sum(0).tolist()
        crash_n, evict_n, cut_n = tot[-3:]
        print(f"kernel==plain fault case {case} M={M}: crashes={crashes} capacity={capacity} "
              f"reliability={rely} retries={retry}: cold={tot[0]:.0f} warm={tot[1]:.0f} "
              f"reject={tot[2]:.0f} crashed={crash_n:.0f} evicted={evict_n:.0f} "
              f"interrupted={cut_n:.0f}" + (f" retries={tot[-5]:.0f}" if retry else "")
              + f", doom plane equal, max|acc diff| {err:.3e}", flush=True)
        if (crash_n > 0) != crashes or (evict_n > 0) != capacity or (cut_n > 0) != crashes:
            raise AssertionError(f"fault case {case}: a fault path did not act")

    # creation-time ties under eviction: arrival times on whole seconds,
    # ceilings 5 -> 2.5 -> 3.5, crashes on
    R, K, M = 256, 512, 32
    rng = np.random.default_rng(560)
    times = np.floor(np.cumsum(rng.exponential(1 / 3.0, (R, K)), axis=1))
    to = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    horizon = float(times[:, -1].min())
    args = (*fresh_pools(torch, R, M, dev), to(rng.uniform(5.0, 20.0, R)), to(times),
            to(rng.exponential(0.6, (R, K))), to(rng.exponential(0.8, (R, K))))
    kw = dict(t_end=to(np.full(R, horizon)), skip=0.0, max_concurrency=100, prestamped=True,
              **fault_kwargs(torch, dev, rng, R, K, horizon, True, True, (5.0, 2.5, 3.5)))
    out_k = faas_sweep(*args, **kw)
    err = held_against_plain(torch, out_k, faas_sweep_ref(*args, **kw), "fault tie case")
    errs["faas_sweep_fault"] = max(errs["faas_sweep_fault"], err)
    # slots whose last cold start shares its instant with another slot's
    cre = out_k[1].cpu().numpy()
    tied = sum(int((c > -1e29).sum() - len(set(c[c > -1e29]))) for c in cre)
    print(f"kernel==plain fault tie case: {R} rows of whole-second arrival times, ceilings "
          f"5 -> 2.5 -> 3.5: evicted {out_k[4][:, -2].sum().item():.0f}, {tied} slots' last "
          f"cold starts share an instant with another's, pools equal", flush=True)
    if out_k[4][:, -2].sum() <= 0 or tied <= 0:
        raise AssertionError("the tie case evicted nothing or holds no tie")

    # a crash past t_end: one instance cold at t = 1 lives 50 s (dies at
    # 51), seen by the arrival at 60; t_end runs from 40 to 59 over the
    # rows, so the crash counts exactly where doom <= t_end
    rate = 0.02
    u = float(np.float32(-np.expm1(-50.0 * rate)))
    R = 256
    t_end = np.linspace(40.0, 59.0, R)
    full = lambda v, k: torch.full((R, k), v, dtype=torch.float32, device=dev)
    args = (*fresh_pools(torch, R, 8, dev), full(100.0, 1)[:, 0].contiguous(),
            to(np.tile([1.0, 45.0, 60.0], (R, 1))), full(2.0, 3), full(2.0, 3))
    kw = dict(t_end=to(t_end), skip=0.0, max_concurrency=10, prestamped=True,
              crash_rate=full(rate, 1)[:, 0].contiguous(),
              crash_u=to(np.tile([u, 0.5, 0.5], (R, 1))))
    out_k = faas_sweep(*args, **kw)
    err = held_against_plain(torch, out_k, faas_sweep_ref(*args, **kw), "crash past t_end")
    errs["faas_sweep_fault"] = max(errs["faas_sweep_fault"], err)
    doom = out_k.doom[:, 0]
    want = (doom <= to(t_end)).float()
    if (not torch.equal(out_k[4][:, -3], want) or not 0 < int(want.sum()) < R
            or abs(doom[0].item() - 51.0) > 1e-3 or not torch.equal(doom, doom[:1].expand(R))):
        raise AssertionError("a crash past t_end was counted, or one inside was not")
    print(f"kernel==plain crash past t_end: doom {doom[0].item():.4f}, counted in "
          f"{int(want.sum())} of {R} rows (those with t_end >= doom)", flush=True)

    # an interrupted attempt triggers its retry: attempt 0 (child 1) starts
    # cold at t = 1 for 3 s on an instance that dies at 3; attempt 1 at t = 5
    # runs, attempt 2 reuses its instance
    u2 = float(np.float32(-np.expm1(-2.0 * 0.5)))
    args = (*fresh_pools(torch, R, 8, dev), full(100.0, 1)[:, 0].contiguous(),
            to(np.tile([1.0, 5.0, 9.0], (R, 1))), full(3.0, 3), full(3.0, 3))
    kw = dict(t_end=full(20.0, 1)[:, 0].contiguous(), skip=0.0, max_concurrency=10,
              prestamped=True, t_timeout=full(100.0, 1)[:, 0].contiguous(),
              p_fail=full(0.0, 1)[:, 0].contiguous(), fail_u=full(1.0, 3),
              is_first=to(np.tile([1.0, 0.0, 1.0], (R, 1))),
              child_pos=to(np.tile([1.0, float(1 << 30), float(1 << 30)], (R, 1))),
              crash_rate=full(0.5, 1)[:, 0].contiguous(),
              crash_u=to(np.tile([u2, 0.9999, 0.9999], (R, 1))))
    out_k = faas_sweep(*args, **kw)
    err = held_against_plain(torch, out_k, faas_sweep_ref(*args, **kw), "interrupted retry")
    errs["faas_sweep_retry_fault"] = max(errs["faas_sweep_retry_fault"], err)
    acc = out_k[4]
    if not (torch.equal(out_k.act[:, 1], full(1.0, 1)[:, 0]) and bool((acc[:, 10] == 1).all())
            and bool((acc[:, -1] == 1).all())):
        raise AssertionError("the interrupted attempt did not trigger its retry")
    print(f"kernel==plain interrupted retry: every row's attempt 0 interrupted, its retry "
          f"switched on and processed ({R} rows)", flush=True)

    # fleets: F = 1, 3, 8, crashes and/or capacity, a non-integer ceiling
    for case, (F, M, crashes, capacity) in enumerate(
            [(1, 64, True, True), (3, 64, True, False), (3, 40, False, True),
             (3, 64, True, True), (8, 16, True, True), (8, 64, True, True)]):
        rng = np.random.default_rng(570 + case)
        args = fleet_small_inputs(torch, dev, rng, F, 4.0 * F, 1000, True, M, 32, 4, 1024)
        Nf, (S, Kf) = args[0].shape[0], args[6].shape
        horizon = float(args[3].max())
        fk = {}
        if crashes:
            fk.update(crash_rate=to(rng.uniform(0.01, 0.05, Nf)), crash_u=to(rng.random((S, Kf))))
        if capacity:
            fk.update(cap_edges=to(np.sort(rng.uniform(0.2, 0.8, (Nf, 2)), 1) * horizon),
                      cap_values=to(np.tile([3.0 * F, 1.5 * F + 0.5, 4.0 * F], (Nf, 1))))
        before = LAUNCH_COUNTS["fleet_sweep_fault"]
        out_k = fleet_sweep(*args, slots=M, prestamped=True, **fk)
        if LAUNCH_COUNTS["fleet_sweep_fault"] != before + 1:
            raise AssertionError(f"fleet fault case {case}: no fleet_sweep_fault launch counted")
        e = held_fleet(torch, out_k, fleet_sweep_ref(*args, slots=M, prestamped=True, **fk),
                       f"fleet fault case {case}")
        errs["fleet_sweep_fault"] = max(errs.get("fleet_sweep_fault", 0.0), e)
        tot = out_k[0].sum((0, 1)).tolist()
        print(f"kernel==plain fleet fault case {case}: F={F} M={M} crashes={crashes} "
              f"capacity={capacity}: cold={tot[0]:.0f} warm={tot[1]:.0f} reject={tot[2]:.0f} "
              f"crashed={tot[13]:.0f} evicted={tot[14]:.0f} interrupted={tot[15]:.0f} "
              f"peak<={out_k[0][..., 12].max().item():.0f}, max|acc diff| {e:.3e}", flush=True)
        if (tot[13] > 0) != crashes or (tot[14] > 0) != capacity:
            raise AssertionError(f"fleet fault case {case}: a fault path did not act")
    print(f"fault small cases in {time.perf_counter() - t0:.1f} s", flush=True)
    return errs


def fault_rows_on(torch, dev, inp):
    """A sweep_inputs' per-row fault inputs as f32 tensors on the card."""
    row = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    out = {}
    if "crash_rate" in inp.fault_rows:
        out.update(crash_rate=row(inp.fault_rows["crash_rate"]), crash_u=inp.samples[-1])
    if "cap_values" in inp.fault_rows:
        out.update(cap_edges=row(inp.fault_rows["cap_edges"]),
                   cap_values=row(inp.fault_rows["cap_values"]))
    return out


def fault_launch(torch, dev, card, what, scn, inp, plain_events, reps=3):
    """One fault launch at an entry point's width on its own sweep_inputs:
    timed by CUDA events, held to the plain version on its first
    ``plain_events`` events (None: all of them); returns (ms, plain_ms,
    bound_ms, bound_by, err, acc, out)."""
    from repro_torch.kernels.faas_event_step import faas_sweep

    row = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    C = len(inp.thr_rows)
    rel = scn.reliability
    retry = scn.max_retries > 0
    samples = inp.samples[:-1] if "crash_rate" in inp.fault_rows else inp.samples
    args = (*fresh_pools(torch, C, scn.slots, dev), row(inp.thr_rows), *samples[:3])
    kw = dict(t_end=row(inp.sim_rows), skip=row(inp.skip_rows),
              max_concurrency=scn.max_concurrency, prestamped=inp.prestamped,
              **fault_rows_on(torch, dev, inp))
    if rel is not None:
        kw.update(t_timeout=row(inp.t_timeout_rows), p_fail=row(inp.p_fail_rows),
                  fail_u=samples[3])
    if retry:
        kw.update(is_first=samples[4], child_pos=samples[5])
    ms, out = timed(torch, lambda: faas_sweep(*args, **kw), reps=reps)
    acc = out[4]
    K = samples[0].shape[1]
    if plain_events is None or plain_events >= K:
        pargs, pkw, held = args, kw, f"all {K} events"
    else:
        pargs = (*args[:5], *(prefix(x, plain_events) for x in args[5:]))
        pkw = {k: prefix(v, plain_events) if torch.is_tensor(v) and v.dim() == 2
               and v.shape[1] == K else v for k, v in kw.items()}
        held = f"the first {plain_events} of {K} events"
    out_k = faas_sweep(*pargs, **pkw)
    plain_ms, out_p = plain_timed(torch, lambda: faas_ref_in_graph(torch, pargs, pkw))
    err = held_against_plain(torch, out_k, out_p, f"{what}, {held}")
    # the work this data needs: the events in their rows' horizons (gaps
    # summed in f64; an attempt table's times compared), the cold starts and
    # evictions it counted
    if retry:
        active = int((samples[0] <= kw["t_end"][:, None]).sum())
    else:
        active = arrivals_in_horizon(samples[0], kw["t_end"])
    E = kw["cap_values"].shape[1] - 1 if "cap_values" in kw else -1
    b_ms, b_by = bound_ms(C, scn.slots, K, active, rely=rel is not None, retry=retry,
                          fault=(E, "crash_rate" in kw, float(acc[:, 0].sum()),
                                 float(acc[:, -2].sum())))
    print(f"timing [{card}]: faas_sweep {what} C={C} M={scn.slots} K={K}: {ms:.3f} ms; "
          f"{active} events in horizon = {active / ms * 1e3:.4e}/s; bound {b_ms:.3f} ms "
          f"({b_by}), kernel {ms / b_ms:.1f}x its bound; plain version {plain_ms:.1f} ms on "
          f"{held} (doom plane and counts equal, max|acc diff| {err:.3e})", flush=True)
    return ms, plain_ms, b_ms, b_by, err, acc, out


def fault_cell_stats(grid):
    """Per cell (in grid order): availability and cold-start probability
    pooled over replicas and the replica mean of the instance count, each
    with the standard error of its per-replica values."""
    out = {k: ([], []) for k in ("availability", "cold_start_prob", "avg_server_count")}
    for s in grid.summaries.ravel():
        served = np.maximum(s.n_cold + s.n_warm, 1)
        se = lambda v: float(np.std(v, ddof=1) / np.sqrt(len(v)))
        for k, v, per in (("availability", s.availability, 1 - s.n_interrupt / served),
                          ("cold_start_prob", s.cold_start_prob, s.n_cold / served),
                          ("avg_server_count", s.avg_server_count,
                           (s.time_running + s.time_idle) / s.measured_time)):
            out[k][0].append(v)
            out[k][1].append(se(per))
    return out


def faults_phase(torch, rt, dev, card):
    """The platform-fault phase (module docstring, item 11); returns the
    kernels-line entries and the largest differences."""
    import dataclasses

    from repro_torch.core.fleet import fleet_inputs
    from repro_torch.core.scenario import sweep_inputs
    from repro_torch.data.catalog import catalog_names, fleet_of
    from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS, faas_sweep
    from repro_torch.kernels.fleet_event_step import fleet_sweep
    from repro_torch.kernels.ref import fleet_sweep_ref

    errs = fault_small_cases(torch, dev)
    results = {}
    launches = {k: 0 for k in ("faas_sweep_fault", "faas_sweep_rely_fault",
                               "faas_sweep_retry_fault", "fleet_sweep_fault")}

    # ---- 1. bench_fault_sweep's grid at 512 replicas, through sweep()
    dip = rt.CapacityProfile(*FAULT_DIP)
    scn_f = table1(rt, sim_time=FAULT_SIM, skip_time=FAULT_SKIP, expiration_threshold=120.0,
                   max_concurrency=30,
                   faults=rt.FaultModel(crash_rate=FAULT_OVER["crash_rate"][0], capacity=dip))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    grid_f = rt.sweep(scn_f, FAULT_OVER, seed=11, replicas=FAULT_REPLICAS, steps=FAULT_STEPS,
                      backend="cuda")
    wall = time.perf_counter() - t0
    if dict(LAUNCH_COUNTS) != {"faas_sweep_fault": 1}:
        raise AssertionError(f"the fault sweep's launches: {dict(LAUNCH_COUNTS)}")
    launches["faas_sweep_fault"] += 1
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not grid_f.ok.all():
        raise AssertionError("fault sweep cells are not finite")
    stats = fault_cell_stats(grid_f)
    worst = 0.0
    for name, (card_v, card_se) in stats.items():
        ref_v, ref_se = np.asarray(REF_FAULT[name]), np.asarray(REF_FAULT[name + "_se"])
        z = np.abs(np.asarray(card_v) - ref_v) / np.hypot(np.asarray(card_se), ref_se)
        worst = max(worst, float(z.max()))
        print(f"fault sweep {name} per cell (crash_rate-major) "
              + " ".join(f"{v:.5f}" for v in card_v) + "; JAX reference "
              + " ".join(f"{v:.5f}" for v in ref_v) + f"; max {z.max():.2f} standard errors",
              flush=True)
        if z.max() > REF_FAULT_SIGMAS:
            raise AssertionError(f"the fault sweep's {name} is more than "
                                 f"{REF_FAULT_SIGMAS} standard errors from the reference")
    crashes = sum(float(s.n_crash.sum()) for s in grid_f.summaries.ravel())
    evictions = sum(float(s.n_evict.sum()) for s in grid_f.summaries.ravel())
    print(f"fault sweep: {grid_f.shape} cells x {FAULT_REPLICAS} replicas = "
          f"{grid_f.summaries.size * FAULT_REPLICAS} rows x K={FAULT_STEPS}, 1 launch, "
          f"{wall:.3f} s wall, peak {peak:.3f} GiB; crashes {crashes:.0f}, evictions "
          f"{evictions:.0f}, worst availability {grid_f.availability.min():.5f}", flush=True)
    inp = sweep_inputs(scn_f, FAULT_OVER, 11, replicas=FAULT_REPLICAS, device=dev,
                       steps=FAULT_STEPS)
    ms, plain_ms, b_ms, b_by, err, acc, _ = fault_launch(
        torch, dev, card, "fault sweep", scn_f, inp, None)
    errs["faas_sweep_fault"] = max(errs["faas_sweep_fault"], err)
    cold = acc[:, 0].double().reshape(len(FAULT_OVER["expiration_threshold"]),
                                      len(FAULT_OVER["crash_rate"]), FAULT_REPLICAS)
    want = np.stack([[grid_f.summaries[i, j].n_cold for i in range(len(FAULT_OVER["crash_rate"]))]
                     for j in range(len(FAULT_OVER["expiration_threshold"]))])
    if not np.array_equal(cold.cpu().numpy(), want):
        raise AssertionError("the timed fault launch does not reproduce sweep()")
    print(f"end to end [{card}]: fault sweep() {wall:.3f} s wall "
          f"({ms:.3f} ms of it the kernel)", flush=True)
    results["faas_sweep_fault"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    del inp, acc

    # ---- 2. the fault runs with reliability and with retries, through
    # run(), at the frontier's base crash rate
    flt_r = rt.FaultModel(crash_rate=TABLE1_CRASH_RATE, capacity=dip)
    for key, rel in (("faas_sweep_rely_fault", rt.Reliability(rt.FailurePolicy(0.05, 8.0))),
                     ("faas_sweep_retry_fault", retry_policy(rt))):
        scn_r = rt.Scenario.of(scn_f, reliability=rel, faults=flt_r)
        LAUNCH_COUNTS.clear()
        t0 = time.perf_counter()
        res = rt.run(scn_r, 13, replicas=FAULT_RUN_REPLICAS, steps=FAULT_STEPS, backend="cuda")
        wall = time.perf_counter() - t0
        if dict(LAUNCH_COUNTS) != {key: 1}:
            raise AssertionError(f"the fault run's launches: {dict(LAUNCH_COUNTS)}")
        launches[key] += 1
        s = res.summary
        total = s.n_completions + s.n_interrupt + s.n_timeout + s.n_fail + s.n_reject
        if not (s.n_requests == total).all() or s.n_interrupt.sum() <= 0:
            raise AssertionError(f"{key}: an attempt is in no bucket, or none was interrupted")
        print(f"fault run {key}: {FAULT_RUN_REPLICAS} replicas, 1 launch, {wall:.3f} s wall: "
              f"availability {s.availability:.5f}, goodput {s.goodput:.5f}/s, retries "
              f"{s.n_retry.sum():.0f}, interrupted {s.n_interrupt.sum():.0f}; every attempt "
              f"completed, interrupted, timed out, failed or rejected", flush=True)
        inp = sweep_inputs(scn_r, {"expiration_threshold": [scn_r.expiration_threshold]}, 13,
                           replicas=FAULT_RUN_REPLICAS, device=dev, steps=FAULT_STEPS)
        ms, plain_ms, b_ms, b_by, err, acc, _ = fault_launch(
            torch, dev, card, f"{key} run", scn_r, inp, FAULT_PLAIN_EVENTS)
        if not np.array_equal(acc[:, 0].double().cpu().numpy(), s.n_cold):
            raise AssertionError(f"the timed {key} launch does not reproduce run()")
        errs[key] = max(errs.get(key, 0.0), err)
        results[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        del inp, acc

    # ---- 3. the Table-1 sweep (phase 4) with crashes, against the same
    # launch without them on the same events (base, faults, faults, base)
    scn_c = table1(rt, faults=rt.FaultModel(crash_rate=TABLE1_CRASH_RATE))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    grid_c = rt.sweep(scn_c, SWEEP_OVER, seed=0, replicas=SWEEP_REPLICAS, backend="cuda")
    wall = time.perf_counter() - t0
    if dict(LAUNCH_COUNTS) != {"faas_sweep_fault": 1}:
        raise AssertionError(f"the Table-1 crash sweep's launches: {dict(LAUNCH_COUNTS)}")
    launches["faas_sweep_fault"] += 1
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not grid_c.ok.all():
        raise AssertionError("Table-1 crash sweep cells are not finite")
    cell = grid_c.sel(arrival_rate=0.9, expiration_threshold=600.0)
    print(f"Table-1 sweep with crashes (rate {TABLE1_CRASH_RATE}): 1 launch, {wall:.3f} s "
          f"wall, peak {peak:.3f} GiB; (0.9/s, 600 s) avg servers "
          f"{float(cell.avg_server_count):.4f}, cold start "
          f"{100 * float(cell.cold_start_prob):.4f}%, availability "
          f"{float(cell.availability):.5f}", flush=True)
    inp = sweep_inputs(scn_c, SWEEP_OVER, 0, replicas=SWEEP_REPLICAS, device=dev)
    row = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    Cc = len(inp.thr_rows)
    base_args = (*fresh_pools(torch, Cc, scn_c.slots, dev), row(inp.thr_rows), *inp.samples[:3])
    base_kw = dict(t_end=row(inp.sim_rows), skip=row(inp.skip_rows),
                   max_concurrency=scn_c.max_concurrency)
    crash_kw = dict(base_kw, **fault_rows_on(torch, dev, inp))
    base_ms, crash_ms, readings, out_c = against_base(
        torch, lambda: faas_sweep(*base_args, **base_kw),
        lambda: faas_sweep(*base_args, **crash_kw), reps=3, rounds=TABLE1_FAULT_ROUNDS)
    if not np.array_equal(out_c[4][:, 0].double().cpu().numpy(),
                          np.concatenate([s.n_cold for s in grid_c.summaries.ravel()])):
        raise AssertionError("the timed Table-1 crash launch does not reproduce sweep()")
    pargs = (*base_args[:5], *(prefix(x, FAULT_PLAIN_EVENTS) for x in base_args[5:]))
    pkw = dict(crash_kw, crash_u=prefix(crash_kw["crash_u"], FAULT_PLAIN_EVENTS))
    out_k = faas_sweep(*pargs, **pkw)
    plain_c, out_p = plain_timed(torch, lambda: faas_ref_in_graph(torch, pargs, pkw))
    e = held_against_plain(torch, out_k, out_p,
                           f"Table-1 crash sweep, first {FAULT_PLAIN_EVENTS} events")
    errs["faas_sweep_fault"] = max(errs["faas_sweep_fault"], e)
    K = inp.samples[0].shape[1]
    active = arrivals_in_horizon(inp.samples[0], base_kw["t_end"])
    acc = out_c[4]
    b_c, b_by_c = bound_ms(Cc, scn_c.slots, K, active,
                           fault=(-1, True, float(acc[:, 0].sum()), 0.0))
    crashed = float(acc[:, -3].sum())
    print(f"timing [{card}]: faas_sweep Table-1 with crashes C={Cc} M={scn_c.slots} K={K}: "
          f"{readings} (without faults on the same events; clock, temperature and power "
          f"read during each): {100 * (sum(crash_ms) / sum(base_ms) - 1):+.1f}%, fault "
          f"readings {min(crash_ms):.3f} to {max(crash_ms):.3f} ms, base {min(base_ms):.3f} "
          f"to {max(base_ms):.3f} ms; bound {b_c:.3f} ms ({b_by_c}); "
          f"{crashed:.0f} crashes, {float(acc[:, -1].sum()):.0f} interrupted; plain version "
          f"{plain_c:.1f} ms on the first {FAULT_PLAIN_EVENTS} events (held: max|acc diff| "
          f"{e:.3e}); sweep() {wall:.3f} s wall", flush=True)
    del inp, base_args, crash_kw, base_kw, out_c, out_k, out_p, pargs, pkw, acc
    torch.cuda.empty_cache()

    # ---- 4. examples/chaos.py's capacity dip at 4,096 fleets, through fleet_run()
    fn = lambda name, rate, warm, cold, thr, limit: rt.FleetFunction(
        name=name, arrival_process=rt.ExpSimProcess(rate=rate),
        warm_service_process=rt.ExpSimProcess(rate=warm),
        cold_service_process=rt.ExpSimProcess(rate=cold),
        expiration_threshold=thr, max_concurrency=limit)
    fleet_d = rt.FleetScenario(
        functions=(fn("api", 0.8, 0.5, 0.25, 60.0, 25), fn("batch", 0.3, 0.2, 0.1, 120.0, 20)),
        n_cluster=40, sim_time=DIP_T, skip_time=0.0,
        faults=rt.FaultModel(crash_rate=DIP_CRASH_RATE, capacity=rt.CapacityProfile(
            (0.4 * DIP_T, 0.7 * DIP_T), (40.0, 10.0, 40.0))))
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    res_d = rt.fleet_run(fleet_d, 12, replicas=DIP_FLEETS, backend="cuda")
    wall_d = time.perf_counter() - t0
    if dict(LAUNCH_COUNTS) != {"fleet_sweep_fault": 1}:
        raise AssertionError(f"the dip fleet's launches: {dict(LAUNCH_COUNTS)}")
    launches["fleet_sweep_fault"] += 1
    sd = res_d.summary
    for f, (name, s) in enumerate(zip(sd.functions, sd.summaries)):
        per = 1 - s.n_interrupt / np.maximum(s.n_cold + s.n_warm, 1)
        se = float(np.std(per, ddof=1) / np.sqrt(len(per)))
        ref, ref_se = REF_FLEET_FAULT["availability"][f], REF_FLEET_FAULT["availability_se"][f]
        tol = REF_FAULT_SIGMAS * float(np.hypot(se, ref_se))
        print(f"fleet dip {name}: availability {s.availability:.5f} (JAX reference "
              f"{ref:.5f}, |diff| {abs(s.availability - ref):.2e} <= {tol:.2e}); crashes "
              f"{s.n_crash.sum():.0f}, evictions {s.n_evict.sum():.0f}, interrupted "
              f"{s.n_interrupt.sum():.0f}", flush=True)
        if abs(s.availability - ref) > tol:
            raise AssertionError(f"the dip fleet's {name} availability is off the reference")
    if sd.max_peak_cluster > 40 or sum(s.n_evict.sum() for s in sd.summaries) <= 0:
        raise AssertionError("the dip fleet passed its ceiling or evicted nothing")
    inp = fleet_inputs(fleet_d, {}, 12, replicas=DIP_FLEETS, device=dev)
    Kd = inp.staged["times"].shape[1]
    args = fleet_prefix(inp, Kd)
    kw = dict(slots=fleet_d.slots, queue_depth=0, prestamped=True, **inp.faults)
    ms_d, out_k = timed(torch, lambda: fleet_sweep(*args, **kw, live_bound=inp.live_bound),
                        reps=3)
    plain_d, out_p = plain_timed(torch, lambda: fleet_sweep_ref(*args, **kw))
    e = held_fleet(torch, out_k, out_p, "dip fleet, all events")
    errs["fleet_sweep_fault"] = max(errs["fleet_sweep_fault"], e)
    for f, s in enumerate(sd.summaries):
        if not np.array_equal(out_k[0][:, f, 0].double().cpu().numpy(), s.n_cold):
            raise AssertionError("the timed dip launch does not reproduce fleet_run()")
    print(f"timing [{card}]: fleet_sweep dip N={DIP_FLEETS} F=2 K={Kd}: {ms_d:.3f} ms; plain "
          f"version {plain_d:.1f} ms on all events (doom plane and counts equal, max|acc diff| "
          f"{e:.3e}); peak {sd.max_peak_cluster:.0f} <= 40; fleet_run() {wall_d:.3f} s wall",
          flush=True)
    del inp, args, kw, out_k, out_p

    # ---- 5. the catalog sweep (phase 6) with crashes and a dip, timed
    # against the same launch without faults (base, faults, faults, base)
    names = list(catalog_names())
    fleet_c = dataclasses.replace(
        fleet_of(names, n_cluster=FLEET_CLUSTER, skip_time=20.0, slots=64),
        faults=rt.FaultModel(crash_rate=CATALOG_CRASH_RATE, capacity=rt.CapacityProfile(
            (0.4e5, 0.7e5), CATALOG_DIP)))
    over = {"expiration_threshold": FLEET_THRESHOLDS}
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    grid = rt.fleet_sweep(fleet_c, over, 5, replicas=FLEET_REPLICAS, backend="cuda")
    wall = time.perf_counter() - t0
    if dict(LAUNCH_COUNTS) != {"fleet_sweep_fault": 1}:
        raise AssertionError(f"the faulty catalog sweep's launches: {dict(LAUNCH_COUNTS)}")
    launches["fleet_sweep_fault"] += 1
    if not grid.ok.all() or float(grid.peak_cluster.max()) > FLEET_CLUSTER:
        raise AssertionError("the faulty catalog sweep is not finite or passed its cap")
    inp = fleet_inputs(fleet_c, over, 5, replicas=FLEET_REPLICAS, device=dev)
    N, (S, K) = inp.t_exp.shape[0], inp.staged["times"].shape
    args = fleet_prefix(inp, K)
    kw0 = dict(slots=64, queue_depth=0, prestamped=True)
    kw = dict(kw0, **inp.faults)
    table = dict(live_bound=inp.live_bound)
    base, fault_ms, readings, out_f = against_base(
        torch, lambda: fleet_sweep(*args, **kw0, **table),
        lambda: fleet_sweep(*args, **kw, **table),
        reps=1, rounds=1)
    ms_f = sum(fault_ms) / len(fault_ms)
    F = len(fleet_c.functions)
    cold_k = out_f[0][..., 0].double().cpu().numpy().reshape(len(FLEET_THRESHOLDS), -1, F)
    for i in range(len(FLEET_THRESHOLDS)):
        for f in range(F):
            if not np.array_equal(cold_k[i, :, f], grid.summaries[i, f].n_cold):
                raise AssertionError("the timed catalog launch does not reproduce fleet_sweep()")
    tot = out_f[0].sum((0, 1)).tolist()
    part = fleet_prefix(inp, FAULT_PLAIN_EVENTS)
    pkw = dict(kw, crash_u=prefix(kw["crash_u"], FAULT_PLAIN_EVENTS))
    out_k = fleet_sweep(*part, **pkw, **table)
    plain_ms, out_p = plain_timed(torch, lambda: fleet_sweep_ref(*part, **pkw))
    e = held_fleet(torch, out_k, out_p, "faulty catalog sweep prefix")
    errs["fleet_sweep_fault"] = max(errs["fleet_sweep_fault"], e)
    # the bound: phase 6's count (events in the horizon; live instances by
    # PASTA from this sweep's occupancies) plus the fault path's work
    in_h = inp.staged["times"] <= inp.t_end[:1].item()
    per_row = in_h.sum(1).double().cpu().numpy()
    per_fn = np.stack([(in_h & (inp.staged["fids"] == f)).sum(1).double().cpu().numpy()
                       for f in range(F)])
    del in_h
    occ = np.array([[(s.time_running + s.time_idle) / s.measured_time for s in row]
                    for row in grid.summaries])
    active = int(per_row.sum()) * len(FLEET_THRESHOLDS)
    live, acting = float((occ * per_row).sum()), float((occ * per_fn).sum())
    b_ms, b_by = fleet_bound_ms(N, F, S, K, active, live, acting,
                                fault=(2, True, tot[0], tot[14]))
    print(f"timing [{card}]: fleet_sweep with faults N={N} F={F} M=64 K={K}: {readings} "
          f"(without faults on the same stream; clock, temperature and power read during "
          f"each): {100 * (sum(fault_ms) / sum(base) - 1):+.1f}%; bound {b_ms:.3f} ms ({b_by}); "
          f"crashes {tot[13]:.0f}, evictions {tot[14]:.0f}, interrupted {tot[15]:.0f}; plain "
          f"version {plain_ms:.1f} ms on the first {FAULT_PLAIN_EVENTS} events (held: max|acc "
          f"diff| {e:.3e}); fleet_sweep() {wall:.3f} s wall", flush=True)
    results["fleet_sweep_fault"] = dict(ms=ms_f, plain_ms=plain_ms, bound_ms=b_ms,
                                        bound_by=b_by)
    # the two faults apart, each against the same base: what each costs
    alone = {"crashes": dict(crash_rate=kw["crash_rate"], crash_u=kw["crash_u"]),
             "the dip": dict(cap_edges=kw["cap_edges"], cap_values=kw["cap_values"])}
    for what, fk in alone.items():
        base, one_ms, readings, out_1 = against_base(
            torch, lambda: fleet_sweep(*args, **kw0, **table),
            lambda: fleet_sweep(*args, **kw0, **fk, **table), reps=1, rounds=1)
        if not bool(torch.isfinite(out_1[0]).all()):
            raise AssertionError(f"the catalog sweep with {what} alone is not finite")
        one = out_1[0].sum((0, 1)).tolist()
        print(f"timing [{card}]: fleet_sweep with {what} alone N={N} F={F} M=64 K={K}: "
              f"{readings}: {100 * (sum(one_ms) / sum(base) - 1):+.1f}%; crashes {one[13]:.0f}, "
              f"evictions {one[14]:.0f}, interrupted {one[15]:.0f}", flush=True)
    del inp, args, part, out_f, out_k, out_p, out_1
    torch.cuda.empty_cache()
    for k, n in launches.items():
        results[k]["launches"] = n
    return results, errs


# ---- the non-stationary phase (module docstring, item 12)
# examples/diurnal.py's scenario at the scale of a real day (the what-if of
# benchmarks/run.py:406-450, bench_nhpp_sweep, at full width): Table 1's
# services, 64 slots, sim_time one day, skip_time 0, 24 hourly windows;
# the profile axis SinusoidalRate(base=0.9, amplitude=a, period=P) for
# a in 0.1 .. 0.8 and P one day or half a day (16 profiles, amplitude-major)
# x 4 thresholds x 64 replicas = 4,096 rows of ~142,229 candidate events
# (the largest envelope, 1.62/s, sizes every draw cell's stream)
DAY = 86400.0
NHPP_AMPLITUDES = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8]
NHPP_PERIODS = [DAY, DAY / 2]
NHPP_THRESHOLDS = [60.0, 120.0, 300.0, 600.0]
NHPP_REPLICAS = 64
NHPP_WINDOWS = tuple(float(x) for x in np.linspace(0.0, DAY, 25))
NHPP_PLAIN_EVENTS = 4096  # each launch of the phase is held to plain on these
# an hour's arrivals, pooled over a profile's 4 x 64 replicas, against the
# profile's integral over that hour: a Poisson count, within this many of
# its standard errors (sqrt of the expected count)
HOURLY_SIGMAS = 4.0
# the JAX reference per cell, profile-major (tools/nhpp_reference.py
# --replicas 64: JAX sweep() on its f64 scan backend, on the CPU, seed 0):
# the whole-day cold-start probability (pooled) and average instance count
# (the replica mean), each with the standard error of its per-replica
# values.  The card's values (other draws: torch generators) must agree
# within REF_NHPP_SIGMAS standard errors of the difference.
REF_NHPP = dict(
    cold_start_prob=[
        0.01606386783790408, 0.007621076553908861, 0.0028814598753698277,
        0.0013983527521092807, 0.016108890882927905, 0.007674954809202555,
        0.0028827048751567507, 0.001420826089640113, 0.015964223687106677,
        0.007615617078157923, 0.002855034096885538, 0.0013902703975470164,
        0.01601868712792974, 0.007634429839939384, 0.002911666908200083,
        0.0014181605682281426, 0.016015248942156904, 0.007626198902889946,
        0.0028852894454198742, 0.0014259703800759513, 0.01600658473932392,
        0.007615871815265825, 0.0028724526903444554, 0.0014279766057803914,
        0.015925046982150897, 0.007618594682112276, 0.002881948624106161,
        0.0014152304103585626, 0.01605905291403641, 0.007571818320614065,
        0.002871973076458444, 0.0014019044831188425, 0.015887621951868804,
        0.007568433632970773, 0.0028480407734755324, 0.001410098628554025,
        0.015885322936418093, 0.007540100483773554, 0.0028944156495065098,
        0.0014019887865010404, 0.015781906962178262, 0.007458875289799946,
        0.002862411620455186, 0.0014185811414542699, 0.015734161054379876,
        0.0075660643579831145, 0.00283897543601782, 0.001415342123740651,
        0.015694559904450407, 0.0074587087818641104, 0.0028403118051728207,
        0.0013858701110865592, 0.015661536001889603, 0.007450044539619377,
        0.0028297197124749185, 0.0014196160263253048, 0.0155443176170475,
        0.007425105782452755, 0.002783582070058338, 0.0013650762928872678,
        0.015575569545267428, 0.00739307043513001, 0.0027758126174870774,
        0.0013928410421416282,
    ],
    cold_start_prob_se=[
        4.7323564256602685e-05, 2.987253290205531e-05, 1.9537067667776086e-05,
        1.3560956166138148e-05, 4.3412853069533636e-05, 3.358094862473171e-05,
        1.7636184256392545e-05, 1.2886925049279019e-05, 4.787655069283758e-05,
        3.385625547284527e-05, 1.9920939560856745e-05, 1.2428172214510583e-05,
        5.239400541066456e-05, 3.3551063789341496e-05, 1.9090461144059802e-05,
        1.2258790206299568e-05, 5.177286400308779e-05, 3.204665623754571e-05,
        1.6646697789358196e-05, 1.1616154426532165e-05, 4.4829058208738604e-05,
        2.617330842981741e-05, 1.8092275992513723e-05, 1.2553416474210006e-05,
        4.9389392390021155e-05, 3.246009557014786e-05, 1.7441419576290017e-05,
        1.1995123108690501e-05, 4.400965204226473e-05, 2.902135950134424e-05,
        1.6845143779577686e-05, 1.1363599584742193e-05, 4.299913865565879e-05,
        3.442897513400038e-05, 1.942611430818651e-05, 1.1689227686043763e-05,
        4.716167354386884e-05, 3.390328170895101e-05, 1.7063884555825755e-05,
        1.4665844303354406e-05, 4.5983467889112786e-05, 2.735841280117197e-05,
        1.747357944885776e-05, 1.330101659194685e-05, 4.582239742685868e-05,
        3.209794273862245e-05, 1.68930737963587e-05, 1.317582317090752e-05,
        4.116122434618426e-05, 3.183881928821613e-05, 2.027433148441996e-05,
        1.387810954553651e-05, 4.688105640285239e-05, 3.578603429713235e-05,
        1.588970114520108e-05, 1.2657677319199312e-05, 4.555026944557569e-05,
        2.599774751781473e-05, 1.8332150073468335e-05, 1.2216700200990408e-05,
        4.4783178922901e-05, 3.16229701936465e-05, 2.223530221929722e-05,
        1.2022709928586168e-05,
    ],
    avg_server_count=[
        5.885941001126371, 6.470274563144702, 7.183965404743115,
        7.675364044365998, 5.886584191857956, 6.472319687778389,
        7.19376766147871, 7.689424796622198, 5.880547965207571,
        6.458674023196302, 7.165716325348173, 7.663442506490416,
        5.875417731207277, 6.453234666081683, 7.179452970114065,
        7.680834635543592, 5.861087004504973, 6.445798046612033,
        7.16047942437873, 7.671151536498223, 5.866915319041189,
        6.445031468412347, 7.153171380105005, 7.676665834289678,
        5.849752493034998, 6.4208855388764565, 7.133210562291394,
        7.624428685263841, 5.853120079196639, 6.42100208010388,
        7.135987238144807, 7.644857820939398, 5.825864140250969,
        6.399754972826686, 7.101865163549248, 7.610354141603516,
        5.8204298783391195, 6.392470878056102, 7.101478626179309,
        7.609426446873554, 5.790654935203413, 6.355674794006112,
        7.073586272645982, 7.568703753169375, 5.786960537104454,
        6.3587040179629195, 7.062265577555883, 7.562726768730117,
        5.7450995343370375, 6.318730986878095, 7.01208667710098,
        7.492818388601037, 5.750870882996182, 6.322738647987792,
        7.020045434081887, 7.510070067983408, 5.692894049468657,
        6.264367922020519, 6.939038051057938, 7.426558975219127,
        5.7007692457914825, 6.261117958805417, 6.949349677779602,
        7.447495118574015,
    ],
    avg_server_count_se=[
        0.0034042505680908592, 0.0038289904942873845, 0.007453279571771071,
        0.009533942534407707, 0.0036785927143487126, 0.005105292104877793,
        0.00641948605704078, 0.009575675391251584, 0.003544433817967519,
        0.004900099664015299, 0.007315178797273172, 0.008112558239069277,
        0.003482289229339556, 0.00511975175780351, 0.007502281916615327,
        0.008484917616119986, 0.0037752313433876863, 0.00547687023082281,
        0.006620030130810287, 0.009125519159461427, 0.0036152602892305517,
        0.004996231780204766, 0.00711252404215354, 0.009769561764812848,
        0.0044035007268184625, 0.004794636742753612, 0.00706395029098814,
        0.011007458780767811, 0.003603064517049097, 0.004325295683311682,
        0.007550802615546535, 0.008889229773722432, 0.004074010947576717,
        0.005100228513199778, 0.006035710914113206, 0.008881181421269937,
        0.0037649195504562464, 0.004651494568133446, 0.006491343341999128,
        0.010229862081117697, 0.0033324367052157515, 0.004825333047898111,
        0.006002861827982861, 0.009160915311082726, 0.004117993527116468,
        0.004904173916183012, 0.006134588126686759, 0.00889963386602534,
        0.0035052759590786515, 0.0051679174188101785, 0.006820428202075925,
        0.010123620094828445, 0.0037324538814839333, 0.004834557362802144,
        0.00621067012698443, 0.008335201028377839, 0.0035681011432832726,
        0.004480250833982459, 0.0071344888735497426, 0.009189943403405535,
        0.0035665984967204988, 0.005125421333058568, 0.0066438496874564055,
        0.008485217729064612,
    ],
)
REF_NHPP_SIGMAS = 4.0
# one run() of each of the other timestamp workloads
MMPP_RATES = dict(rate_low=0.3, rate_high=3.0, switch_rate=1 / 600)
MMPP_REPLICAS = 1024  # ~261,000 candidates a row
TRACE_EVENTS, TRACE_RATE, TRACE_BATCH = 20_000, 2.0, 4  # batch_arrivals' recording
TRACE_SIM, TRACE_C = 9000.0, 3
TEMPORAL_NHPP = dict(base=0.9, amplitude=0.5, period=3600.0)
FLEET_NHPP_REPLICAS = 512
FLEET_NHPP_THRESHOLDS = [60.0, 600.0]


# phase 12's diurnal sweep() wall and its staging, which phase 14's fused
# diurnal what-if is read beside
DIURNAL_STAGED = {}


def nhpp_profiles(rt):
    return [rt.SinusoidalRate(base=0.9, amplitude=a, period=p)
            for a in NHPP_AMPLITUDES for p in NHPP_PERIODS]


def sinusoid_integral(prof, a, b):
    """The integral of prof.rate(t) over [a, b] (phase 0)."""
    w = 2 * np.pi / prof.period
    return prof.base * ((b - a) + prof.amplitude / w * (np.cos(w * a) - np.cos(w * b)))


def nhpp_cell_stats(grid):
    """Per cell (profile-major): the pooled cold-start probability and the
    replica mean of the average instance count, each with the standard
    error of its per-replica values."""
    out = {k: [] for k in ("cold", "cold_se", "servers", "servers_se")}
    for s in grid.summaries.ravel():
        cold = s.n_cold / np.maximum(s.n_cold + s.n_warm, 1)
        v = (s.time_running + s.time_idle) / s.measured_time
        out["cold"].append(s.cold_start_prob)
        out["cold_se"].append(cold.std(ddof=1) / np.sqrt(len(cold)))
        out["servers"].append(v.mean())
        out["servers_se"].append(v.std(ddof=1) / np.sqrt(len(v)))
    return {k: np.asarray(v) for k, v in out.items()}


def timestamp_run_held(torch, rt, dev, card, what, scn, seed, replicas, engine, launch_key,
                       kernel_kw, res):
    """A run() of a timestamp workload held to its plain version: its own
    staged buffers (run_samples, the draws run() made), the full launch
    timed by CUDA events and reproducing run()'s cold starts, then kernel
    and plain on the first NHPP_PLAIN_EVENTS events; returns the largest
    |acc difference|."""
    from repro_torch.core.simulator import run_samples
    from repro_torch.core.temporal import _snapshots_to_pool
    from repro_torch.kernels.faas_event_step import faas_sweep
    from repro_torch.kernels.par_event_step import par_sweep
    from repro_torch.kernels.ref import faas_par_sweep_ref, faas_sweep_ref

    cfg = rt.Scenario.of(scn, skip_time=0.0) if engine == "temporal" else scn
    dts, warms, colds = run_samples(cfg, seed, replicas, None, None, dev)
    C, K = dts.shape
    full = lambda v: torch.full((C,), v, dtype=torch.float32, device=dev)
    kw = dict(t_end=full(cfg.sim_time), skip=full(cfg.skip_time),
              max_concurrency=cfg.max_concurrency, prestamped=True, **kernel_kw)
    if engine == "par":
        head = (full(cfg.expiration_threshold),)
        kernel, plain, cols = par_sweep, faas_par_sweep_ref, (3, 4, 8)
    else:
        pool = (torch.from_numpy(np.asarray(x, np.float32)).to(dev).expand(C, cfg.slots)
                .contiguous() for x in _snapshots_to_pool([], cfg.slots))
        head = (*pool, full(0.0), full(cfg.expiration_threshold))
        kernel, plain, cols = faas_sweep, faas_sweep_ref, (3, 4)
    ms, out_full = timed(torch, lambda: kernel(*head, dts, warms, colds, **kw), reps=3)
    if not np.array_equal(out_full[4][:, 0].double().cpu().numpy(), res.summary.n_cold):
        raise AssertionError(f"{what}: the timed launch does not reproduce run()")
    pad = float((dts >= 1e29).double().mean())
    part = [prefix(x, NHPP_PLAIN_EVENTS) for x in (dts, warms, colds)]
    out_k = kernel(*head, *part, **kw)
    if engine == "par":
        plain_ms, out_p = plain_timed(torch, lambda: plain_in_graph(
            torch, lambda st, p: plain(*head, *p, state0=st, **kw), part))
    else:
        plain_ms, out_p = plain_timed(torch, lambda: faas_ref_in_graph(
            torch, (*head, *part), kw))
    err = held_against_plain(torch, out_k, out_p, f"{what}, first {NHPP_PLAIN_EVENTS} events",
                             integral_cols=cols)
    print(f"timing [{card}]: {launch_key} {what} C={C} M={cfg.slots} K={K} prestamped: "
          f"{ms:.3f} ms ({100 * pad:.1f}% of events PAD_TIME); plain version {plain_ms:.1f} ms "
          f"on the first {NHPP_PLAIN_EVENTS} events (counters equal, max|acc diff| "
          f"{err:.3e})", flush=True)
    return err


def nonstationary_phase(torch, rt, dev, card, seed):
    """The non-stationary phase (module docstring, item 12); returns the
    kernels-line entry of the diurnal sweep's launch and the largest
    differences."""
    from repro_torch.core import scenario as scenario_mod
    from repro_torch.core.fleet import fleet_inputs
    from repro_torch.data.workload import batch_arrivals
    from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS, faas_sweep
    from repro_torch.kernels.fleet_event_step import fleet_sweep
    from repro_torch.kernels.ref import fleet_sweep_ref

    errs = {}
    row = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
    t1 = lambda s: rt.ExpSimProcess(rate=1 / s)
    profiles = nhpp_profiles(rt)
    scn = rt.Scenario(rate_profile=profiles[0], warm_service_process=t1(1.991),
                      cold_service_process=t1(2.244), expiration_threshold=NHPP_THRESHOLDS[0],
                      sim_time=DAY, skip_time=0.0, slots=64, window_bounds=NHPP_WINDOWS)
    over = {"profile": profiles, "expiration_threshold": NHPP_THRESHOLDS}
    W = len(NHPP_WINDOWS) - 1

    # ---- 1. the diurnal what-if sweep through sweep()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    LAUNCH_COUNTS.clear()
    # sweep() stages through the module's sweep_inputs: wrapped for this
    # one call, it times the staging of the same call and keeps its inputs
    staged, stage_fn = {}, scenario_mod.sweep_inputs

    def timed_staging(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        staged["inp"] = stage_fn(*a, **k)
        torch.cuda.synchronize()
        staged["s"] = time.perf_counter() - t
        return staged["inp"]

    scenario_mod.sweep_inputs = timed_staging
    try:
        t0 = time.perf_counter()
        grid = rt.sweep(scn, over, seed=seed, replicas=NHPP_REPLICAS, backend="cuda")
        sweep_s = time.perf_counter() - t0
    finally:
        scenario_mod.sweep_inputs = stage_fn
    peak = torch.cuda.max_memory_allocated()
    launches = dict(LAUNCH_COUNTS)
    if launches != {"faas_sweep_win": 1}:
        raise AssertionError(f"the diurnal sweep's launches: {launches}")
    if not grid.ok.all() or not all(np.isfinite(getattr(grid, f)).all()
                                    for f in grid._WINDOWED_FIELDS):
        raise AssertionError("the diurnal sweep's cells are not finite")
    # the launch again, on the inputs sweep() staged, by CUDA events
    inp, staging_s = staged.pop("inp"), staged["s"]
    if not inp.prestamped:
        raise AssertionError("the diurnal sweep's inputs are not prestamped")
    dts, warms, colds = inp.samples
    C, K = dts.shape
    args = (*fresh_pools(torch, C, scn.slots, dev), row(inp.thr_rows), dts, warms, colds)
    kw = dict(t_end=row(inp.sim_rows), skip=row(inp.skip_rows),
              max_concurrency=scn.max_concurrency, prestamped=True,
              window_bounds=row(np.tile(NHPP_WINDOWS, (C, 1))))
    ms, out_full = timed(torch, lambda: faas_sweep(*args, **kw), reps=3)
    acc = out_full[4].double()
    cold_k = acc[:, 0].cpu().numpy().reshape(len(profiles), len(NHPP_THRESHOLDS), -1)
    for i in range(len(profiles)):
        for j in range(len(NHPP_THRESHOLDS)):
            if not np.array_equal(cold_k[i, j], grid.summaries[i, j].n_cold):
                raise AssertionError("the timed diurnal launch does not reproduce sweep()")
    pad = int((dts >= 1e29).sum())
    active = int((dts <= kw["t_end"][:, None]).sum())
    # the windows [b_w, b_w+1) tile [0, T): they hold every arrival of the
    # day but those cast onto T itself
    at_end = int((dts == kw["t_end"][:, None]).sum())
    if int(acc[:, 8 + 2 * W:8 + 3 * W].sum()) != active - at_end:
        raise AssertionError("the hourly windows do not hold every arrival of the day")
    b_ms, b_by = bound_ms(C, scn.slots, K, active, W=W, window_passes=active + C * W)
    part = [prefix(x, NHPP_PLAIN_EVENTS) for x in (dts, warms, colds)]
    pargs = (*args[:5], *part)
    out_k = faas_sweep(*pargs, **kw)
    plain_ms, out_p = plain_timed(torch, lambda: faas_ref_in_graph(torch, pargs, kw))
    errs["faas_sweep_win_prestamped"] = held_against_plain(
        torch, out_k, out_p, f"diurnal sweep, first {NHPP_PLAIN_EVENTS} events",
        integral_cols=window_integral_cols(W))
    DIURNAL_STAGED.update(sweep_s=sweep_s, staging_s=staging_s)
    print(f"diurnal sweep [{card}]: {len(profiles)} profiles x {len(NHPP_THRESHOLDS)} "
          f"thresholds x {NHPP_REPLICAS} replicas = {C} rows x K={K} candidates, {W} hourly "
          f"windows, 1 launch: sweep() {sweep_s:.3f} s wall, its staging {staging_s:.3f} s "
          f"({100 * staging_s / sweep_s:.1f}% of the wall), peak {peak / 2**30:.3f} GiB on the "
          f"card; {pad} of {C * K} events PAD_TIME ({100 * pad / (C * K):.1f}%)", flush=True)
    print(f"timing [{card}]: faas_sweep with {W} windows, prestamped, C={C} M={scn.slots} "
          f"K={K}: {ms:.3f} ms ({100 * ms / 1e3 / sweep_s:.1f}% of the sweep's wall); {active} "
          f"arrivals in horizon = {active / ms * 1e3:.4e} arrivals/s; bound {b_ms:.3f} ms "
          f"({b_by}); plain version {plain_ms:.1f} ms on the first {NHPP_PLAIN_EVENTS} events "
          f"(counters and window counts equal, max|acc diff| "
          f"{errs['faas_sweep_win_prestamped']:.3e})", flush=True)
    print(f"end to end [{card}]: diurnal sweep() {active / sweep_s:.4e} simulated arrivals/s, "
          f"{C * K / sweep_s:.4e} events stepped/s ({sweep_s:.3f} s incl. thinning, sort, "
          f"draws and assembly)", flush=True)
    result = dict(launches=launches["faas_sweep_win"], ms=ms, plain_ms=plain_ms,
                  bound_ms=b_ms, bound_by=b_by)
    del inp, args, kw, pargs, part, out_full, out_k, out_p, acc, dts, warms, colds
    torch.cuda.empty_cache()

    # each hour's arrivals, pooled over a profile's replicas, against the
    # profile's integral over the hour
    worst = 0.0
    for i, prof in enumerate(profiles):
        n = sum(grid.summaries[i, j].windows.n_arrivals.sum(0)
                for j in range(len(NHPP_THRESHOLDS)))
        reps = len(NHPP_THRESHOLDS) * NHPP_REPLICAS
        expected = reps * np.array([sinusoid_integral(prof, a, b) for a, b in
                                    zip(NHPP_WINDOWS[:-1], NHPP_WINDOWS[1:])])
        z = np.abs(n - expected) / np.sqrt(expected)
        worst = max(worst, float(z.max()))
        if z.max() > HOURLY_SIGMAS:
            raise AssertionError(f"profile {prof}: an hour's arrivals are {z.max():.2f} "
                                 "standard errors from the profile's integral")
    ex = grid.sel(profile=profiles[-2], expiration_threshold=60.0)
    print(f"diurnal sweep: every hour's arrivals of every profile within {worst:.2f} standard "
          f"errors of the profile's integral (limit {HOURLY_SIGMAS}); amplitude 0.8, one day, "
          f"60 s: arrivals/s by hour "
          + " ".join(f"{v:.3f}" for v in ex.windowed_arrivals / 3600.0)
          + "; cold-start % by hour " + " ".join(f"{100 * v:.2f}" for v in ex.windowed_cold_prob),
          flush=True)
    st = nhpp_cell_stats(grid)
    worst = 0.0
    for m, key in (("cold", "cold_start_prob"), ("servers", "avg_server_count")):
        ref, ref_se = np.asarray(REF_NHPP[key]), np.asarray(REF_NHPP[key + "_se"])
        z = np.abs(st[m] - ref) / np.hypot(st[m + "_se"], ref_se)
        worst = max(worst, float(z.max()))
        k = int(np.argmax(z))
        print(f"diurnal sweep vs JAX reference: {key} in all {len(z)} cells within "
              f"{z.max():.2f} standard errors (limit {REF_NHPP_SIGMAS}); worst cell {k}: "
              f"{st[m][k]:.6f} against {ref[k]:.6f}", flush=True)
        if z.max() > REF_NHPP_SIGMAS:
            raise AssertionError(f"the diurnal sweep's {key} is off the JAX reference")
    del grid

    # ---- 2. an MMPP run() on the scan engine
    scn_m = rt.Scenario.of(scn, rate_profile=None, window_bounds=None,
                           arrival_process=rt.MMPPArrivalProcess(**MMPP_RATES),
                           expiration_threshold=600.0)
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    res = rt.run(scn_m, seed + 1, replicas=MMPP_REPLICAS, backend="cuda")
    wall = time.perf_counter() - t0
    if dict(LAUNCH_COUNTS) != {"faas_sweep": 1}:
        raise AssertionError(f"the MMPP run()'s launches: {dict(LAUNCH_COUNTS)}")
    s = res.summary
    rate = s.n_requests.mean() / DAY
    print(f"mmpp run [{card}]: {MMPP_RATES}, {MMPP_REPLICAS} replicas x K="
          f"{scn_m.steps_needed()}, 1 launch, run() {wall:.3f} s wall: arrivals/s {rate:.4f} "
          f"(the phases' mean {(MMPP_RATES['rate_low'] + MMPP_RATES['rate_high']) / 2:.4f}), "
          f"avg servers {s.avg_server_count:.4f}, cold start {100 * s.cold_start_prob:.4f}%",
          flush=True)
    if not np.isfinite(s.avg_server_count) or abs(rate / 1.65 - 1) > 0.05:
        raise AssertionError("the MMPP run is not finite or its rate is off the phases' mean")
    errs["faas_sweep"] = timestamp_run_held(torch, rt, dev, card, "MMPP run()", scn_m,
                                            seed + 1, MMPP_REPLICAS, "scan", "faas_sweep",
                                            {}, res)
    torch.cuda.empty_cache()

    # ---- 3. a trace replay through engine="par"
    ts = tuple(r.arrival_time for r in batch_arrivals(
        TRACE_RATE, TRACE_BATCH, 1.2 * TRACE_EVENTS / TRACE_RATE, seed=seed))[:TRACE_EVENTS]
    if len(ts) != TRACE_EVENTS:
        raise AssertionError(f"the recording holds {len(ts)} timestamps")
    scn_p = rt.Scenario.of(scn, rate_profile=None, window_bounds=None,
                           arrival_process=rt.TraceArrivalProcess(ts),
                           expiration_threshold=60.0, sim_time=TRACE_SIM,
                           concurrency_value=TRACE_C)
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    res = rt.run(scn_p, seed + 2, replicas=FULL_REPLICAS, engine="par", backend="cuda")
    wall = time.perf_counter() - t0
    if dict(LAUNCH_COUNTS) != {"par_sweep": 1}:
        raise AssertionError(f"the trace par run()'s launches: {dict(LAUNCH_COUNTS)}")
    s = res.summary
    # arrivals inside the horizon on the f32 clock the kernel steps
    recorded = int(np.sum(np.asarray(ts, np.float32) <= np.float32(TRACE_SIM)))
    print(f"trace run [{card}]: {TRACE_EVENTS} timestamps (batch_arrivals rate {TRACE_RATE}, "
          f"batches of {TRACE_BATCH}, seed {seed}) over {TRACE_SIM:.0f} s at c={TRACE_C}, "
          f"{FULL_REPLICAS} replicas, 1 launch, run() {wall:.3f} s wall: {recorded} recorded "
          f"arrivals in every replica, avg instances {s.avg_server_count:.4f}, in flight "
          f"{s.avg_in_flight:.4f}, cold start {100 * s.cold_start_prob:.4f}%", flush=True)
    if not (s.n_requests == recorded).all() or not np.isfinite(s.avg_in_flight):
        raise AssertionError("a replica did not replay the recording exactly")
    errs["par_sweep"] = timestamp_run_held(
        torch, rt, dev, card, "trace par run()", scn_p, seed + 2, FULL_REPLICAS, "par",
        "par_sweep", dict(concurrency=TRACE_C, slots=scn_p.slots), res)

    # ---- 4. run(engine="temporal") under an NHPP profile
    prof_t = rt.SinusoidalRate(**TEMPORAL_NHPP)
    scn_t = rt.Scenario.of(scn, arrival_process=None, rate_profile=prof_t, window_bounds=None,
                           expiration_threshold=60.0, sim_time=TEMPORAL_NHPP["period"])
    tgrid = np.linspace(0.0, scn_t.sim_time, 61)
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    res = rt.run(scn_t, seed + 3, replicas=FULL_REPLICAS, engine="temporal", grid=tgrid,
                 backend="cuda")
    wall = time.perf_counter() - t0
    if dict(LAUNCH_COUNTS) != {"faas_sweep_grid": 1}:
        raise AssertionError(f"the NHPP temporal run()'s launches: {dict(LAUNCH_COUNTS)}")
    tm = res.temporal
    # the rate peaks at a quarter period and bottoms out at three quarters
    P = prof_t.period
    hi, lo = int(np.argmin(np.abs(tgrid - P / 3))), int(np.argmin(np.abs(tgrid - 5 * P / 6)))
    print(f"temporal run [{card}]: {prof_t}, {FULL_REPLICAS} replicas, G=61, 1 launch, run() "
          f"{wall:.3f} s wall: total_at {tgrid[hi]:.0f} s {tm.total_at[hi]:.4f} (after the "
          f"peak), {tgrid[lo]:.0f} s {tm.total_at[lo]:.4f} (after the trough)", flush=True)
    if not np.isfinite(tm.total_at).all() or not tm.total_at[hi] > tm.total_at[lo]:
        raise AssertionError("the NHPP temporal curve does not follow the profile")
    errs["faas_sweep_grid"] = timestamp_run_held(
        torch, rt, dev, card, "NHPP temporal run()", scn_t, seed + 3, FULL_REPLICAS,
        "temporal", "faas_sweep_grid", dict(grid_times=row(np.tile(tgrid, (FULL_REPLICAS, 1)))),
        res)

    # ---- 5. a two-function fleet_sweep() with one NHPP function
    fns = (rt.FleetFunction(name="diurnal", rate_profile=rt.SinusoidalRate(0.9, 0.6, DAY / 2),
                            warm_service_process=t1(1.991), cold_service_process=t1(2.244),
                            expiration_threshold=60.0),
           rt.FleetFunction(name="steady", arrival_process=rt.ExpSimProcess(rate=0.5),
                            warm_service_process=t1(1.0), cold_service_process=t1(1.5),
                            expiration_threshold=60.0))
    fleet = rt.FleetScenario(functions=fns, n_cluster=FLEET_CLUSTER, sim_time=DAY,
                             skip_time=0.0, slots=64)
    fover = {"expiration_threshold": FLEET_NHPP_THRESHOLDS}
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    fgrid = rt.fleet_sweep(fleet, fover, seed + 4, replicas=FLEET_NHPP_REPLICAS, backend="cuda")
    wall = time.perf_counter() - t0
    if dict(LAUNCH_COUNTS) != {"fleet_sweep": 1}:
        raise AssertionError(f"the NHPP fleet_sweep()'s launches: {dict(LAUNCH_COUNTS)}")
    peak_c = float(fgrid.peak_cluster.max())
    print(f"fleet nhpp [{card}]: diurnal (NHPP) + steady, n_cluster {FLEET_CLUSTER}, "
          f"{FLEET_NHPP_REPLICAS} replicas x {len(FLEET_NHPP_THRESHOLDS)} thresholds, 1 launch, "
          f"fleet_sweep() {wall:.3f} s wall: cold start % "
          + ", ".join(f"{n} {100 * p:.4f}" for n, p in zip(fleet.names, fgrid.cold_start_prob[0]))
          + f" at 60 s; peak {peak_c:.0f}", flush=True)
    if peak_c > FLEET_CLUSTER or not np.isfinite(fgrid.cold_start_prob).all():
        raise AssertionError("the NHPP fleet passed its cap or is not finite")
    finp = fleet_inputs(fleet, fover, seed + 4, replicas=FLEET_NHPP_REPLICAS, device=dev)
    if not finp.staged["prestamped"]:
        raise AssertionError("the NHPP fleet's merged stream is not prestamped")
    fkw = dict(slots=64, queue_depth=0, prestamped=True)
    Kf = finp.staged["times"].shape[1]
    ms_f, out_k = timed(torch, lambda: fleet_sweep(*fleet_prefix(finp, Kf), **fkw,
                                                   live_bound=finp.live_bound), reps=3)
    cold_f = out_k[0][..., 0].double().cpu().numpy().reshape(len(FLEET_NHPP_THRESHOLDS), -1, 2)
    for i in range(len(FLEET_NHPP_THRESHOLDS)):
        for f in range(2):
            if not np.array_equal(cold_f[i, :, f], fgrid.summaries[i, f].n_cold):
                raise AssertionError("the timed NHPP fleet launch does not reproduce fleet_sweep()")
    part = fleet_prefix(finp, NHPP_PLAIN_EVENTS)
    out_k = fleet_sweep(*part, **fkw, live_bound=finp.live_bound)
    plain_f, out_p = plain_timed(torch, lambda: fleet_sweep_ref(*part, **fkw))
    errs["fleet_sweep"] = held_fleet(torch, out_k, out_p, "NHPP fleet prefix")
    print(f"timing [{card}]: fleet_sweep NHPP fleet N={out_k[0].shape[0]} F=2 M=64 K={Kf} "
          f"(merged in f64, cast once): {ms_f:.3f} ms; plain version {plain_f:.1f} ms on the "
          f"first {NHPP_PLAIN_EVENTS} events (counters equal, max|acc diff| "
          f"{errs['fleet_sweep']:.3e})", flush=True)
    del finp, part, out_k, out_p
    torch.cuda.empty_cache()
    return {"faas_sweep_win_prestamped": result}, errs


# ---- the f64 engine's phase (module docstring, item 13): kernels 8 and 9
# (csrc/scan_event_step.cu, csrc/par_scan_event_step.cu) through the front
# doors with backend="scan", on the reference's default substrate's cells
SCAN64_PLAIN_EVENTS = 4096  # every launch of the phase is held to plain on these
# f64 sums over slots (integrals, lifespans, window integrals, histogram
# bins) associate differently in the kernels and in torch
SCAN64_RTOL = 1e-10
# H100 SXM data sheet: f64 outside the tensor cores, at the full 700 W limit
PEAK_F64_OPS = 34e12
# f64 operations the data needs (integrals, lifespans and in-flight time
# are accrued per state span and per request, so no event integrates every
# live instance).  Per event inside the horizon: 20 on the row's scalars
# (clock 1, clipped intervals 6, occupancy and finish 2, reliability 5,
# response sums 2, window lookup 2, the chosen slot's update 2) and 2 on
# each live instance it finds (the idle test and the routing key's
# compare); per assignment 14 (the state that ends and the one that starts,
# accrue's 7 each); per exit 10 (its test, crash and lifespan); the
# histogram, per in-window expiry, a compare with each live instance for
# its order statistic and 4 on the row; each window crossing 13 on each
# live instance and 4 on the row (an empty slot adds nothing to any sum or
# decision, so the bound charges none of these to it)
SCAN64_OPS_PER_SLOT_EVENT = 2
SCAN64_OPS_PER_ROW_EVENT = 20
SCAN64_OPS_PER_ASSIGN = 14
SCAN64_OPS_PER_EXIT = 10
SCAN64_OPS_PER_EXPIRY_ROW = 4
SCAN64_OPS_PER_WINDOW_SLOT = 13
SCAN64_OPS_PER_WINDOW_ROW = 4
# the par scan: 2 on each live instance an event finds (the capacity test
# and the key's compare), 20 on the row; per assignment 2 on the row (the
# new busy, the larger of the old and the request's finish, and the test
# whether every sub-slot is taken: until then the row's free-by stays
# empty), 1 on each request in flight on the instance (the search for its
# first finished sub-slot passes those: a row fills from sub-slot 0), 4 (the
# request's time in flight) and 14 (accrual); per exit 10.  No event needs
# each live instance's c sub-slots (the in-flight overlap) or its integrals,
# and no assignment the sub-slots its row never used
PAR64_OPS_PER_SLOT_EVENT = 2
PAR64_OPS_PER_ROW_EVENT = 20
PAR64_OPS_PER_ROW_ASSIGN = 2
PAR64_OPS_PER_REQUEST = 4
# the paper's Fig. 3 (benchmarks/run.py:96-110) and routing study
# (benchmarks/run.py:259-278) at their own horizons
FIG3_SIM, FIG3_BINS, FIG3_REPLICAS = 5e4, 33, 4
ROUTING_SIM, ROUTING_REPLICAS = 5e4, 64
TABLE1_RUN_SIM, TABLE1_RUN_REPLICAS = 2e5, 4  # benchmarks/run.py:76-93
PAPER_RTOL = 0.05  # Table 1's instance count against the paper


def scan64_layout(scn, W=0, G=0, faults=False):
    from repro_torch.kernels.ref64 import ScanLayout

    return ScanLayout(W=W, H=scn.hist_bins if scn.track_histogram else 0, G=G,
                      rely=scn.reliability is not None, faults=faults)


def held64(torch, out_k, out_p, layout, what):
    """An f64 kernel against its plain version: every output but the
    accumulator equal (final pool, clock, activation plane, crash clocks,
    finish planes), every count, response sum and grid column equal, and
    the sums over slots within SCAN64_RTOL; returns the largest |acc
    difference|."""
    for name, a, b in zip(out_k._fields, out_k, out_p):
        if name != "acc" and ((a is None) != (b is None) or (a is not None and not torch.equal(a, b))):
            raise AssertionError(f"{what}: {name} differs from the plain version")
    acc_k, acc_p = out_k.acc, out_p.acc
    if acc_k.shape != acc_p.shape or acc_k.shape[1] != layout.cols:
        raise AssertionError(f"{what}: acc shapes {acc_k.shape} vs {acc_p.shape}")
    fl = layout.float_cols
    for c in range(layout.cols):
        if c not in fl and not torch.equal(acc_k[:, c], acc_p[:, c]):
            n = int((acc_k[:, c] != acc_p[:, c]).sum())
            raise AssertionError(f"{what}: acc column {c} differs in {n} rows")
    if fl:
        err = (acc_k[:, fl] - acc_p[:, fl]).abs()
        lim = SCAN64_RTOL * acc_p[:, fl].abs().clamp_min(1.0)
        if bool((err > lim).any()):
            raise AssertionError(f"{what}: a sum over slots is off by {err.max().item():.3e} "
                                 f"(rtol {SCAN64_RTOL})")
    return float((acc_k - acc_p).abs().max())


# the [R, K] event inputs of the f64 plain versions beside arr, warms, colds
SCAN64_SEQ = ("fail_u", "is_first", "child_pos", "crash_u")


def plain64_launch(torch, engine, *args, **kw):
    """The plain f64 version of ``engine`` (``"scan"``, ``"temporal"`` or
    ``"par"``; the backend launchers' arguments) with its event loop in
    chunks replayed from one CUDA graph (plain_in_graph): each chunk
    continues the last one's state (``state0``, ``first_event``) and defers
    the tail flush, which a last call with no events runs, so the result is
    one eager call's, bit for bit."""
    from repro_torch.kernels.ref64 import (ParScanOut, ScanOut, par_scan_sweep_ref,
                                           scan_sweep_ref)

    par = engine == "par"
    fn, Out = (par_scan_sweep_ref, ParScanOut) if par else (scan_sweep_ref, ScanOut)
    pool = () if par else args[:3]
    arr, warms, colds = args[-3:]
    fused = kw.get("fused_keys") is not None
    if fused:
        # fused draws: the chunks read no samples, only their event count
        # (the counter continues from first_event)
        K = kw.pop("fused_k")
        names, seq = [], [torch.empty((1, K), dtype=torch.uint8, device=pool[0].device)]
    else:
        names = [n for n in SCAN64_SEQ if kw.get(n) is not None]
        seq = [arr, warms, colds] + [kw.pop(n) for n in names]
        K = arr.shape[1]
    present = []  # the fields of Out a chunk's state carries (no None)

    def call(state, part, flush):
        st = k0 = None
        if state is not None:
            it = iter(state[:-1])
            st = Out(**{f: (next(it) if f in present else None) for f in Out._fields})
            k0 = state[-1]
        head = pool if st is None or par else (st.alive, st.creation, st.busy)
        first = 0 if k0 is None else k0
        if fused:
            return fn(*head, None, None, None, **kw, fused_k=part[0].shape[1], state0=st,
                      first_event=first, events=K, flush=flush), k0
        a, w, c, *rest = part
        return fn(*head, a, w, c, **kw, **dict(zip(names, rest)), state0=st,
                  first_event=first, events=K, flush=flush), k0

    def run(state, part):
        out, k0 = call(state, part, False)
        if not present:
            present.extend(f for f, x in zip(Out._fields, out) if x is not None)
        k = (torch.zeros((), dtype=torch.int64, device=part[0].device) if k0 is None
             else k0) + part[0].shape[1]
        return tuple(x for x in out if x is not None) + (k,)

    state = plain_in_graph(torch, run, seq)
    return call(state, [x[:, K:] for x in seq], True)[0]


# events of the eager plain runs that the CUDA-graph chunks are held to
GRAPH_CHECK_EVENTS = 640


def graph_equals_eager(torch, what, eager, chunked):
    """The plain f64 version in CUDA-graph chunks against one eager call on
    the same inputs: every output equal bit for bit."""
    a, b = eager(), chunked()
    for name, x, y in zip(a._fields, a, b):
        if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
            raise AssertionError(f"{what}: the CUDA-graph chunks' {name} differs from one "
                                 f"eager call")
    print(f"plain f64 {what}: {GRAPH_CHECK_EVENTS} events in {PLAIN_GRAPH_EVENTS}-event "
          f"CUDA-graph chunks equal one eager call bit for bit (every output)", flush=True)


class PlainInGraph:
    """A backend spec (``launch_for``) whose launchers are the plain f64
    versions replayed in CUDA-graph chunks (:func:`plain64_launch`)."""

    def __init__(self, torch):
        self.torch = torch

    def launch_for(self, engine):
        return lambda *a, **kw: plain64_launch(self.torch, engine, *a, **kw)


def hold_scan64(torch, dev, scn, samples, layout, what, engine="scan", **kw):
    """The pool-scan kernel and its plain version (in CUDA-graph chunks) on
    the first SCAN64_PLAIN_EVENTS events of ``samples`` (``kw`` as
    scan_launch takes them); returns (max |acc diff|, the plain version's
    ms)."""
    from repro_torch.core.execution import resolve_backend
    from repro_torch.core.simulator import scan_launch

    part = tuple(prefix(x, SCAN64_PLAIN_EVENTS) for x in samples)
    out_k = scan_launch(scn, resolve_backend("scan"), dev, part, engine=engine, **kw)
    plain_ms, out_p = plain_timed(torch, lambda: scan_launch(
        scn, PlainInGraph(torch), dev, part, engine=engine, **kw))
    err = held64(torch, out_k, out_p, layout, f"{what}, first {SCAN64_PLAIN_EVENTS} events")
    print(f"kernel==plain f64 {what}: first {SCAN64_PLAIN_EVENTS} events of {part[0].shape[0]} "
          f"rows, counters and state equal, max|acc diff| {err:.3e} (plain {plain_ms:.0f} ms)",
          flush=True)
    return err, plain_ms


# the held runs whose horizons fall inside the held prefix: each row's
# t_end on one of its events in the middle half of the prefix, and (for
# timestamps) this many events past it moved back inside it
INSIDE_BACK = 6


def horizon_inside(torch, part, prestamped, seed):
    """``part`` (a held prefix) with each row's horizon on one of its own
    events in the middle half, so that the prefix runs the inert tail and
    the deferred exits; a gap stream becomes its f64 timestamps when
    ``prestamped``, and INSIDE_BACK events past each horizon then come back
    up to 30 s before it.  Returns (part, t_end, skip, events past their
    horizons, events back inside after one past it)."""
    rng = np.random.default_rng(seed)
    arr = part[0]
    R, P = arr.shape
    dev = arr.device
    times = arr.double() if arr.dtype == torch.float64 else torch.cumsum(arr.double(), 1)
    real = (times < 1e29).sum(1).cpu().numpy()  # timestamp streams pad with PAD_TIME
    ends = np.minimum(rng.integers(P // 4, 3 * P // 4, R), np.maximum(real - 2, 0))
    t_end = times[torch.arange(R, device=dev), torch.as_tensor(ends, device=dev)] + 0.5
    if prestamped:
        times = times.clone()
        lo = ends[:, None] + 2
        idx = lo + (rng.uniform(size=(R, INSIDE_BACK)) * np.maximum(P - lo, 1)).astype(np.int64)
        back = t_end[:, None] - torch.as_tensor(rng.uniform(0.0, 30.0, (R, INSIDE_BACK)),
                                                dtype=torch.float64, device=dev)
        times.scatter_(1, torch.as_tensor(np.minimum(idx, P - 1), device=dev), back)
        part = (times,) + tuple(part[1:])
    over = times > t_end[:, None]
    seen = torch.cummax(over.to(torch.int8), 1).values.bool()
    t_end = t_end.cpu().numpy()
    return (part, t_end, 0.1 * t_end, int(over.sum()), int((seen & ~over).sum()))


def scan64_sweep_launch(scn, inp, bspec, dev):
    """A sweep's f64 launch on the inputs sweep_inputs staged."""
    from repro_torch.core.simulator import scan_launch

    wb = scn.window_bounds
    return scan_launch(
        scn, bspec, dev, inp.samples, t_exp=inp.thr_rows, t_end=inp.sim_rows,
        skip=inp.skip_rows, prestamped=inp.prestamped,
        window_rows=None if wb is None else np.tile(wb, (len(inp.thr_rows), 1)),
        t_timeout=inp.t_timeout_rows, p_fail=inp.p_fail_rows, faults=inp.fault_rows,
    )


def in_horizon(torch, arr, t_end, prestamped):
    """Events at or before each row's horizon, summed over the rows."""
    if prestamped:
        return int((arr <= torch.as_tensor(t_end, device=arr.device)[:, None]).sum())
    return arrivals_in_horizon(arr, torch.as_tensor(t_end, device=arr.device))


def scan64_bound_ms(C, M, K, n_active, live, assigns, exits, expiries=0, window_passes=0,
                    arr_bytes=4, cols=10, extra_bytes=0):
    """Least time for one pool-scan call: the staged bytes (each input read
    once, each output written once) at HBM rate, or the f64 operations this
    data needs at the f64 peak: ``n_active`` events inside their horizons,
    each on the row's scalars and on the live instances it finds (``live``,
    summed over those events: an empty slot holds nothing to route or
    retire), the rest only moving the clock; ``assigns`` state changes and
    ``exits`` exits, each accrued once; ``expiries`` in-window expiries the
    histogram orders among the live instances; ``window_passes`` window
    crossings."""
    nbytes = (C * K * (arr_bytes + 8) + 8 * 3 * C + extra_bytes
              + C * M * (1 + 8 + 8) * 2 + 8 * C + 8 * C * cols)
    per_event = live / max(n_active, 1)
    ops = (live * SCAN64_OPS_PER_SLOT_EVENT + n_active * SCAN64_OPS_PER_ROW_EVENT
           + (C * K - n_active) + assigns * SCAN64_OPS_PER_ASSIGN + exits * SCAN64_OPS_PER_EXIT
           + expiries * (per_event + SCAN64_OPS_PER_EXPIRY_ROW)
           + window_passes * (per_event * SCAN64_OPS_PER_WINDOW_SLOT
                              + SCAN64_OPS_PER_WINDOW_ROW))
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F64_OPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def par64_bound_ms(C, M, c, K, n_active, live, assigns, exits, occupancy):
    """The par scan's bound as :func:`scan64_bound_ms` counts it: the work
    on the ``live`` instances the in-horizon events find (summed over those
    events) and, per assignment, on the request's row and on the
    ``occupancy`` requests in flight on its instance (the run's mean per
    running instance)."""
    nbytes = C * K * 12 + 8 * 3 * C + C * M * (1 + 8) + C * M * c * 8 + 8 * C * 12
    ops = (live * PAR64_OPS_PER_SLOT_EVENT + n_active * PAR64_OPS_PER_ROW_EVENT
           + assigns * (PAR64_OPS_PER_ROW_ASSIGN + occupancy + PAR64_OPS_PER_REQUEST
                        + SCAN64_OPS_PER_ASSIGN)
           + exits * SCAN64_OPS_PER_EXIT + (C * K - n_active))
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F64_OPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def expect_launches(LAUNCH_COUNTS, want, what):
    if dict(LAUNCH_COUNTS) != want:
        raise AssertionError(f"{what}: launches {dict(LAUNCH_COUNTS)}, want {want}")


def z_against(card_v, card_se, ref_v, ref_se):
    return np.abs(np.asarray(card_v) - np.asarray(ref_v)) / np.hypot(
        np.asarray(card_se), np.asarray(ref_se))


def scan64_phase(torch, rt, dev, card):
    """The f64 engine's phase (module docstring, item 13); returns the
    kernels-line entries of kernels 8 and 9 and their largest differences."""
    from repro_torch.core.execution import resolve_backend
    from repro_torch.core.scenario import sweep_inputs
    from repro_torch.core.simulator import run_samples, scan_launch
    from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS

    errs = {"scan_sweep": 0.0, "par_scan_sweep": 0.0}
    plain = {}
    scan = resolve_backend("scan")
    S64 = dict(backend="scan")

    def hold(name, *a, **k):
        err, ms = hold_scan64(torch, dev, *a, **k)
        errs["scan_sweep"] = max(errs["scan_sweep"], err)
        plain.setdefault(name, ms)

    # ---- 1. Table 1 through run(), 4 replicas x 2e5 s
    scn1 = table1(rt, sim_time=TABLE1_RUN_SIM)
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    r1 = rt.run(scn1, seed=1, replicas=TABLE1_RUN_REPLICAS, **S64)
    wall = time.perf_counter() - t0
    expect_launches(LAUNCH_COUNTS, {"scan_sweep": 1}, "Table-1 run()")
    s = r1.summary
    print(f"f64 run: Table 1, {TABLE1_RUN_REPLICAS} replicas x {TABLE1_RUN_SIM:.0f} s, 1 launch, "
          f"{wall:.3f} s wall: servers {s.avg_server_count:.4f} (paper {PAPER_SERVERS}), "
          f"cold {100 * s.cold_start_prob:.3f}% (paper 0.14), running "
          f"{s.avg_running_count:.4f} (1.7902), idle {s.avg_idle_count:.4f} (5.8893), lifespan "
          f"{s.avg_lifespan:.1f} s (6307.7)", flush=True)
    if abs(s.avg_server_count / PAPER_SERVERS - 1) > PAPER_RTOL:
        raise AssertionError("the f64 Table-1 run() is more than 5% from the paper")
    # the same run with 6 windows: the same draws, the same base metrics
    scn1w = rt.Scenario.of(scn1, window_bounds=TABLE1_WINDOWS)
    LAUNCH_COUNTS.clear()
    r1w = rt.run(scn1w, seed=1, replicas=TABLE1_RUN_REPLICAS, **S64)
    expect_launches(LAUNCH_COUNTS, {"scan_sweep": 1}, "windowed Table-1 run()")
    for f in ("n_cold", "n_warm", "n_reject", "time_running", "time_idle", "lifespan_sum",
              "lifespan_count", "sum_cold_resp", "sum_warm_resp"):
        if not np.array_equal(getattr(r1w.summary, f), getattr(s, f)):
            raise AssertionError(f"the windowed run's {f} differs from the unwindowed run's")
    w = r1w.summary.windows
    print(f"f64 windowed run: {len(TABLE1_WINDOWS) - 1} windows, base metrics equal the "
          f"unwindowed run's; instances by window "
          + " ".join(f"{v:.3f}" for v in w.avg_instance_count) + "; cold % by window "
          + " ".join(f"{100 * v:.3f}" for v in w.cold_start_prob), flush=True)
    samples = run_samples(scn1w, 1, TABLE1_RUN_REPLICAS, None, None, dev, f64=True)
    hold("windows", scn1w, samples, scan64_layout(scn1w, W=len(TABLE1_WINDOWS) - 1),
         "Table-1 run() with windows", t_exp=scn1w.expiration_threshold,
         t_end=scn1w.sim_time, skip=scn1w.skip_time, prestamped=False,
         window_rows=np.tile(TABLE1_WINDOWS, (TABLE1_RUN_REPLICAS, 1)))
    del samples

    # ---- 2. the Table-1 sweep, without and with the histogram
    scn = table1(rt)
    sweeps = {}
    for hist in (False, True):
        scn_s = rt.Scenario.of(scn, track_histogram=hist)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        LAUNCH_COUNTS.clear()
        t0 = time.perf_counter()
        g = rt.sweep(scn_s, SWEEP_OVER, seed=0, replicas=SWEEP_REPLICAS, **S64)
        wall = time.perf_counter() - t0
        if not hist:
            staged64 = dict(grid=g, peak=torch.cuda.max_memory_allocated(), wall=wall)
        expect_launches(LAUNCH_COUNTS, {"scan_sweep": 1}, "the f64 Table-1 sweep")
        if not hist:
            sweep_launches = LAUNCH_COUNTS["scan_sweep"]
        if not g.ok.all():
            raise AssertionError("f64 sweep cells are not finite")
        servers = float(g.sel(arrival_rate=0.9, expiration_threshold=600.0).avg_server_count)
        sweeps[hist] = (g, wall)
        print(f"f64 sweep{' with histogram' if hist else ''}: {g.shape} cells x "
              f"{SWEEP_REPLICAS} replicas, 1 launch, {wall:.3f} s wall; (0.9/s, 600 s) "
              f"servers {servers:.4f} (paper {PAPER_SERVERS})", flush=True)
        if abs(servers / PAPER_SERVERS - 1) > PAPER_RTOL:
            raise AssertionError("the f64 Table-1 cell is more than 5% from the paper")
        if hist:
            for cell in g.summaries.ravel():
                if not np.allclose(cell.histogram.sum(1), cell.measured_time, rtol=1e-9):
                    raise AssertionError("a histogram's mass is not the measured time")
    g0, g1 = sweeps[False][0], sweeps[True][0]
    if not (np.array_equal(g0.cold_start_prob, g1.cold_start_prob)
            and np.array_equal(g0.avg_server_count, g1.avg_server_count)):
        raise AssertionError("the histogram changed the Table-1 sweep's metrics")
    for hist in (False, True):
        scn_s = rt.Scenario.of(scn, track_histogram=hist)
        inp = sweep_inputs(scn_s, SWEEP_OVER, 0, replicas=SWEEP_REPLICAS, device=dev, f64=True)
        C, K = inp.samples[0].shape
        lay = scan64_layout(scn_s)
        ms, out = timed(torch, lambda: scan64_sweep_launch(scn_s, inp, scan, dev), reps=3)
        cold = out.acc[:, 0].cpu().numpy().reshape(-1, SWEEP_REPLICAS)
        want = np.stack([c.n_cold for c in sweeps[hist][0].summaries.ravel()])
        if not np.array_equal(cold, want):
            raise AssertionError("the timed f64 launch does not reproduce sweep()")
        per_row = arrivals_per_row(inp.samples[0], torch.as_tensor(inp.sim_rows, device=dev))
        active = int(per_row.sum())
        # the instances each row holds on average over its measured time
        # (∫running + ∫idle over it), as the events inside the horizon find them
        held = (out.acc[:, 3] + out.acc[:, 4]) / torch.as_tensor(
            inp.sim_rows - inp.skip_rows, dtype=torch.float64, device=dev)
        live = float((per_row * held).sum())
        exits = int(out.acc[:, 8].sum())
        assigns = int(out.acc[:, :2].sum())
        b_ms, b_by = scan64_bound_ms(C, scn.slots, K, active, live, assigns, exits,
                                     expiries=exits if hist else 0, cols=lay.cols)
        name = "histogram" if hist else "base"
        hold(name, scn_s, inp.samples, lay, f"Table-1 sweep{' + histogram' if hist else ''}",
             t_exp=inp.thr_rows, t_end=inp.sim_rows, skip=inp.skip_rows, prestamped=False)
        if hist:
            # the inert tail and the deferred exits inside the held prefix
            part = tuple(prefix(x, SCAN64_PLAIN_EVENTS) for x in inp.samples)
            part, te, sk, past, _ = horizon_inside(torch, part, False, seed=13)
            if not past:
                raise AssertionError("no event of the held prefix is past its horizon")
            hold("inside", scn_s, part, lay, f"Table-1 sweep + histogram, {past} events past "
                 f"horizons inside the prefix", t_exp=inp.thr_rows, t_end=te, skip=sk,
                 prestamped=False)
            del part
        print(f"timing [{card}]: scan_sweep{' with histogram' if hist else ''} C={C} "
              f"M={scn.slots} K={K}: {ms:.3f} ms; {active} events in horizon of {C * K} = "
              f"{active / ms * 1e3:.4e} arrivals/s, {live / max(active, 1):.4f} live "
              f"instances an event; bound {b_ms:.3f} ms ({b_by}), {ms / b_ms:.1f}x; plain "
              f"{plain[name]:.0f} ms on the first {SCAN64_PLAIN_EVENTS} events (CUDA-graph "
              f"chunks); sweep() {sweeps[hist][1]:.3f} s wall", flush=True)
        if not hist:
            result8 = dict(launches=sweep_launches, ms=ms, plain_ms=plain[name], bound_ms=b_ms,
                           bound_by=b_by)
            # the inert tail alone: every horizon before the first event
            inp.sim_rows = np.full_like(inp.sim_rows, -1.0)
            inp.skip_rows = np.full_like(inp.skip_rows, -2.0)
            tail_ms, _ = timed(torch, lambda: scan64_sweep_launch(scn_s, inp, scan, dev), reps=3)
            past = C * K - active
            print(f"timing [{card}]: scan_sweep's inert tail: {past} events past their horizons "
                  f"({100 * past / (C * K):.1f}%); with every event past t_end the launch takes "
                  f"{tail_ms:.3f} ms, so the tail is ~{100 * tail_ms * past / (C * K) / ms:.1f}% "
                  f"of the {ms:.3f} ms", flush=True)
        del inp, out
    del sweeps, g0, g1
    torch.cuda.empty_cache()

    # ---- 3. Fig. 3 and the routing study
    scn3 = table1(rt, sim_time=FIG3_SIM, track_histogram=True, hist_bins=FIG3_BINS)
    LAUNCH_COUNTS.clear()
    s3 = rt.run(scn3, seed=0, replicas=FIG3_REPLICAS, **S64).summary
    expect_launches(LAUNCH_COUNTS, {"scan_sweep": 1}, "Fig. 3 run()")
    mass = s3.histogram.sum()
    if abs(mass / (FIG3_REPLICAS * s3.measured_time) - 1) > 1e-9:
        raise AssertionError(f"Fig. 3's histogram mass {mass} is not replicas x measured time")
    dist = s3.histogram.sum(0) / mass
    mode = int(np.argmax(dist))
    print(f"f64 Fig. 3: {FIG3_BINS} bins, {FIG3_REPLICAS} replicas x {FIG3_SIM:.0f} s: mass = "
          f"replicas x measured time; mode {mode} p(mode) {dist[mode]:.3f}, mean "
          f"{(np.arange(FIG3_BINS) * dist).sum():.3f} (servers {s3.avg_server_count:.3f})",
          flush=True)
    routing = {}
    for policy in ("newest", "oldest"):
        scn_r = table1(rt, sim_time=ROUTING_SIM, routing=policy)
        LAUNCH_COUNTS.clear()
        routing[policy] = rt.run(scn_r, seed=0, replicas=ROUTING_REPLICAS, **S64).summary
        expect_launches(LAUNCH_COUNTS, {"scan_sweep": 1}, f"routing={policy} run()")
    n, o = routing["newest"], routing["oldest"]
    print(f"f64 routing study, {ROUTING_REPLICAS} replicas x {ROUTING_SIM:.0f} s: lifespan "
          f"newest {n.avg_lifespan:.0f} s, oldest {o.avg_lifespan:.0f} s, ratio "
          f"{n.avg_lifespan / o.avg_lifespan:.2f}; cold % {100 * n.cold_start_prob:.3f} vs "
          f"{100 * o.cold_start_prob:.3f}; servers {n.avg_server_count:.3f} vs "
          f"{o.avg_server_count:.3f}", flush=True)
    scn_o = table1(rt, sim_time=ROUTING_SIM, routing="oldest", track_histogram=True,
                   hist_bins=FIG3_BINS)
    samples = run_samples(scn_o, 0, ROUTING_REPLICAS, None, None, dev, f64=True)
    hold("oldest", scn_o, samples, scan64_layout(scn_o), "oldest routing + histogram",
         t_exp=scn_o.expiration_threshold, t_end=scn_o.sim_time, skip=scn_o.skip_time,
         prestamped=False)
    del samples

    # ---- 4. the retry what-if at full width
    scn_r = table1(rt, sim_time=RETRY_SIM, skip_time=RETRY_SKIP, expiration_threshold=120.0,
                   reliability=retry_policy(rt))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    grid_r = rt.sweep(scn_r, RETRY_OVER, seed=4, replicas=RETRY_REPLICAS, **S64)
    wall = time.perf_counter() - t0
    expect_launches(LAUNCH_COUNTS, {"scan_sweep": 1}, "the f64 retry sweep")
    peak = torch.cuda.max_memory_allocated() / 2**30
    gp, gp_se, cp, cp_se = [], [], [], []
    for s in grid_r.summaries.ravel():
        if not (s.n_attempts == s.n_completions + s.n_timeout + s.n_fail + s.n_reject).all():
            raise AssertionError("an attempt is neither served nor rejected")
        k = len(s.n_cold)
        gp.append(s.goodput)
        gp_se.append(float(np.std(s.n_completions / s.measured_time, ddof=1) / np.sqrt(k)))
        cp.append(s.cold_start_prob)
        cp_se.append(float(np.std(s.n_cold / np.maximum(s.n_cold + s.n_warm, 1), ddof=1)
                           / np.sqrt(k)))
    for name, v, se in (("goodput", gp, gp_se), ("cold_start_prob", cp, cp_se)):
        z = z_against(v, se, REF_RETRY[name], REF_RETRY[name + "_se"])
        print(f"f64 retry sweep {name}: max {z.max():.2f} standard errors from the JAX "
              f"reference over {len(z)} cells", flush=True)
        if z.max() > REF_RETRY_SIGMAS:
            raise AssertionError(f"the f64 retry sweep's {name} is off the reference")
    inp = sweep_inputs(scn_r, RETRY_OVER, 4, replicas=RETRY_REPLICAS, device=dev, f64=True)
    Cr, Kr = inp.samples[0].shape
    print(f"f64 retry sweep: {grid_r.shape} cells x {RETRY_REPLICAS} replicas = {Cr} rows x "
          f"{Kr} attempts, 1 launch, {wall:.3f} s wall, peak {peak:.2f} GiB", flush=True)
    hold("retries", scn_r, inp.samples, scan64_layout(scn_r), "retry sweep",
         t_exp=inp.thr_rows, t_end=inp.sim_rows, skip=inp.skip_rows, prestamped=True,
         t_timeout=inp.t_timeout_rows, p_fail=inp.p_fail_rows)
    del inp, grid_r
    torch.cuda.empty_cache()

    # ---- 5. the fault sweep
    dip = rt.CapacityProfile(*FAULT_DIP)
    scn_f = table1(rt, sim_time=FAULT_SIM, skip_time=FAULT_SKIP, expiration_threshold=120.0,
                   max_concurrency=30,
                   faults=rt.FaultModel(crash_rate=FAULT_OVER["crash_rate"][0], capacity=dip))
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    grid_f = rt.sweep(scn_f, FAULT_OVER, seed=11, replicas=FAULT_REPLICAS, steps=FAULT_STEPS,
                      **S64)
    wall = time.perf_counter() - t0
    expect_launches(LAUNCH_COUNTS, {"scan_sweep": 1}, "the f64 fault sweep")
    worst = 0.0
    for name, (v, se) in fault_cell_stats(grid_f).items():
        z = z_against(v, se, REF_FAULT[name], REF_FAULT[name + "_se"])
        worst = max(worst, float(z.max()))
        if z.max() > REF_FAULT_SIGMAS:
            raise AssertionError(f"the f64 fault sweep's {name} is off the reference "
                                 f"({z.max():.2f} standard errors)")
    life = sum(float(s.lifespan_sum.sum()) for s in grid_f.summaries.ravel()) / max(
        sum(float(s.lifespan_count.sum()) for s in grid_f.summaries.ravel()), 1.0)
    print(f"f64 fault sweep: {grid_f.summaries.size * FAULT_REPLICAS} rows x K={FAULT_STEPS}, "
          f"1 launch, {wall:.3f} s wall; availability, cold-start probability and instances "
          f"within {worst:.2f} standard errors of the JAX reference in all cells; mean "
          f"lifespan {life:.1f} s", flush=True)
    inp = sweep_inputs(scn_f, FAULT_OVER, 11, replicas=FAULT_REPLICAS, device=dev,
                       steps=FAULT_STEPS, f64=True)
    hold("faults", scn_f, inp.samples, scan64_layout(scn_f, faults=True), "fault sweep",
         t_exp=inp.thr_rows, t_end=inp.sim_rows, skip=inp.skip_rows, prestamped=False,
         faults=inp.fault_rows)
    del inp, grid_f

    # ---- 6. the diurnal sweep on f64 timestamps
    profiles = nhpp_profiles(rt)
    t1 = lambda x: rt.ExpSimProcess(rate=1 / x)
    scn_n = rt.Scenario(rate_profile=profiles[0], warm_service_process=t1(1.991),
                        cold_service_process=t1(2.244), expiration_threshold=NHPP_THRESHOLDS[0],
                        sim_time=DAY, skip_time=0.0, slots=64, window_bounds=NHPP_WINDOWS)
    over = {"profile": profiles, "expiration_threshold": NHPP_THRESHOLDS}
    torch.cuda.empty_cache()
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    grid_n = rt.sweep(scn_n, over, seed=0, replicas=NHPP_REPLICAS, **S64)
    wall = time.perf_counter() - t0
    expect_launches(LAUNCH_COUNTS, {"scan_sweep": 1}, "the f64 diurnal sweep")
    st = nhpp_cell_stats(grid_n)
    worst = 0.0
    for m, key in (("cold", "cold_start_prob"), ("servers", "avg_server_count")):
        z = z_against(st[m], st[m + "_se"], REF_NHPP[key], REF_NHPP[key + "_se"])
        worst = max(worst, float(z.max()))
        if z.max() > REF_NHPP_SIGMAS:
            raise AssertionError(f"the f64 diurnal sweep's {key} is off the reference "
                                 f"({z.max():.2f} standard errors)")
    inp = sweep_inputs(scn_n, over, 0, replicas=NHPP_REPLICAS, device=dev, f64=True)
    if inp.samples[0].dtype != torch.float64:
        raise AssertionError("the diurnal sweep's timestamps are not f64")
    print(f"f64 diurnal sweep: {inp.samples[0].shape[0]} rows x K={inp.samples[0].shape[1]} "
          f"f64 timestamps, {len(NHPP_WINDOWS) - 1} windows, 1 launch, {wall:.3f} s wall; "
          f"cold-start probability and instances within {worst:.2f} standard errors of the "
          f"JAX reference in all cells", flush=True)
    hold("prestamped", scn_n, inp.samples,
         scan64_layout(scn_n, W=len(NHPP_WINDOWS) - 1), "diurnal sweep (f64 timestamps)",
         t_exp=inp.thr_rows, t_end=inp.sim_rows, skip=inp.skip_rows, prestamped=True,
         window_rows=np.tile(NHPP_WINDOWS, (len(inp.thr_rows), 1)))
    # horizons inside the held prefix, and events past them that come back
    part = tuple(prefix(x, SCAN64_PLAIN_EVENTS) for x in inp.samples)
    part, te, sk, past, back = horizon_inside(torch, part, True, seed=14)
    if not (past and back):
        raise AssertionError("the diurnal prefix has no event past its horizon and back")
    hold("inside_back", scn_n, part, scan64_layout(scn_n, W=len(NHPP_WINDOWS) - 1),
         f"diurnal sweep, horizons inside the prefix: {past} events past them, {back} back "
         f"inside", t_exp=inp.thr_rows, t_end=te, skip=sk, prestamped=True,
         window_rows=np.tile(NHPP_WINDOWS, (len(inp.thr_rows), 1)))
    del part
    del inp, grid_n
    torch.cuda.empty_cache()

    # ---- 7. the temporal engine with reliability and retries
    snaps = [rt.InstanceSnapshot(age=30.0, remaining=1.5),
             rt.InstanceSnapshot(age=120.0, idle_for=20.0)]
    scn_t = table1(rt, sim_time=TEMPORAL_SIM, skip_time=0.0, reliability=retry_policy(rt))
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    res_t = rt.run(scn_t, seed=3, replicas=FULL_REPLICAS, engine="temporal",
                   grid=TEMPORAL_GRID, initial_instances=snaps, **S64)
    wall = time.perf_counter() - t0
    expect_launches(LAUNCH_COUNTS, {"scan_sweep": 1}, "temporal run()")
    tm = res_t.temporal
    for f in ("running_at", "idle_at", "total_at", "cold_prob_at"):
        if not np.isfinite(getattr(tm, f)).all():
            raise AssertionError(f"f64 temporal {f} is not finite")
    at60 = int(np.argmin(np.abs(TEMPORAL_GRID - 60.0)))
    if not tm.cold_prob_at[at60] > tm.cold_prob_at[-1]:
        raise AssertionError("f64 temporal cold_prob_at(60 s) is not above its horizon value")
    print(f"f64 temporal: Table 1 with retries over {TEMPORAL_SIM:.0f} s, {FULL_REPLICAS} "
          f"replicas x K={3 * scn_t.steps_needed()} attempts, G={TEMPORAL_GRID.size}, 1 launch, "
          f"{wall:.3f} s wall: total_at 60 s {tm.total_at[at60]:.4f}, {TEMPORAL_SIM:.0f} s "
          f"{tm.total_at[-1]:.4f}; cold_prob_at {100 * tm.cold_prob_at[at60]:.3f}% and "
          f"{100 * tm.cold_prob_at[-1]:.3f}%; retries {res_t.summary.n_retry.sum():.0f}",
          flush=True)
    from repro_torch.core.temporal import _snapshots_to_pool

    samples = run_samples(scn_t, 3, FULL_REPLICAS, None, None, dev, f64=True)
    rel = scn_t.reliability
    tkw = dict(engine="temporal", t_exp=scn_t.expiration_threshold, t_end=scn_t.sim_time,
               skip=0.0, prestamped=True, t_timeout=rel.failure.t_timeout,
               p_fail=rel.failure.p_fail, pool=_snapshots_to_pool(snaps, scn_t.slots),
               grid=TEMPORAL_GRID)
    hold("grid", scn_t, samples, scan64_layout(scn_t, G=TEMPORAL_GRID.size),
         "temporal with retries", **tkw)
    part = tuple(prefix(x, GRAPH_CHECK_EVENTS) for x in samples)
    graph_equals_eager(
        torch, "temporal with retries (grid, pool, reliability, retries)",
        lambda: scan_launch(scn_t, resolve_backend("scan_ref"), dev, part, **tkw),
        lambda: scan_launch(scn_t, PlainInGraph(torch), dev, part, **tkw))
    del samples, part

    # ---- 8. the par engine on Fig. 1
    par, walls, par_launches = {}, {}, {}
    for c in PAR_CS:
        LAUNCH_COUNTS.clear()
        t0 = time.perf_counter()
        par[c] = rt.run(fig1(rt, c), seed=2, replicas=FULL_REPLICAS, engine="par",
                        **S64).summary
        walls[c] = time.perf_counter() - t0
        expect_launches(LAUNCH_COUNTS, {"par_scan_sweep": 1}, f"f64 par run() at c={c}")
        par_launches[c] = LAUNCH_COUNTS["par_scan_sweep"]
    one = rt.run(fig1(rt, 1), seed=2, replicas=FULL_REPLICAS, **S64).summary
    for f in ("n_cold", "n_warm", "n_reject", "lifespan_count"):
        if not np.array_equal(getattr(par[1], f), getattr(one, f)):
            raise AssertionError(f"f64 par at c = 1 differs from the pool scan in {f}")
    if not par[3].avg_server_count < par[1].avg_server_count:
        raise AssertionError("f64 Fig. 1: c = 3 does not need fewer instances than c = 1")
    sp = fig1(rt, 3)
    K_par = sp.steps_needed()
    samples = run_samples(sp, 2, FULL_REPLICAS, None, None, dev, f64=True)
    active = in_horizon(torch, samples[0], np.full(FULL_REPLICAS, sp.sim_time), False)
    launch = resolve_backend("scan").launch_for("par")
    plain_launch = PlainInGraph(torch).launch_for("par")
    rows = lambda v: torch.full((FULL_REPLICAS,), v, dtype=torch.float64, device=dev)
    par_times = {}
    for c in PAR_CS:
        kw = dict(t_exp=rows(sp.expiration_threshold), t_end=rows(sp.sim_time),
                  skip=rows(sp.skip_time), max_concurrency=sp.max_concurrency, concurrency=c,
                  slots=sp.slots)
        ms, out = timed(torch, lambda: launch(*samples, **kw), reps=3)
        if not np.array_equal(out.acc[:, 0].cpu().numpy(), par[c].n_cold):
            raise AssertionError(f"the timed f64 par launch at c={c} does not reproduce run()")
        part = [prefix(x, SCAN64_PLAIN_EVENTS) for x in samples]
        out_k = launch(*part, **kw)
        plain_ms, out_p = plain_timed(torch, lambda: plain_launch(*part, **kw))
        from repro_torch.kernels.ref64 import ScanLayout

        err = held64(torch, out_k, out_p, ScanLayout(par=True), f"f64 par c={c}")
        errs["par_scan_sweep"] = max(errs["par_scan_sweep"], err)
        if c in (3, 80):
            # the f64 timestamps of the same draws, horizons inside the held
            # prefix, and events past them that come back
            part, te, sk, past, back = horizon_inside(torch, part, True, seed=15 + c)
            if not (past and back):
                raise AssertionError("the par prefix has no event past its horizon and back")
            kw_in = dict(kw, t_end=torch.as_tensor(te, device=dev),
                         skip=torch.as_tensor(sk, device=dev), prestamped=True)
            err_in = held64(torch, launch(*part, **kw_in), plain_launch(*part, **kw_in),
                            ScanLayout(par=True), f"f64 par c={c}, horizons inside the prefix")
            errs["par_scan_sweep"] = max(errs["par_scan_sweep"], err_in)
            print(f"kernel==plain f64 par c={c}, f64 timestamps with horizons inside the "
                  f"first {SCAN64_PLAIN_EVENTS} events: {past} events past them, {back} back "
                  f"inside; counters and state equal, max|acc diff| {err_in:.3e}", flush=True)
        s = par[c]
        live = active * s.avg_server_count
        assigns = float((s.n_cold + s.n_warm).sum())
        b_ms, b_by = par64_bound_ms(FULL_REPLICAS, sp.slots, c, K_par, active, live, assigns,
                                    float(s.lifespan_count.sum()), s.avg_instance_occupancy)
        par_times[c] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        ref = f" (JAX reference {REF_FIG1[c]})" if c in REF_FIG1 else ""
        print(f"f64 par: Fig. 1, c={c}, {FULL_REPLICAS} replicas x K={K_par}: instances "
              f"{s.avg_server_count:.4f}{ref}, in flight {s.avg_in_flight:.4f} (reference "
              f"{REF_FIG1_IN_FLIGHT}), per running instance {s.avg_instance_occupancy:.4f}, "
              f"lifespan {s.avg_lifespan:.1f} s; run() {walls[c]:.3f} s wall", flush=True)
        print(f"timing [{card}]: par_scan_sweep c={c} C={FULL_REPLICAS} M={sp.slots} "
              f"K={K_par}: {ms:.3f} ms; {active} arrivals in horizon = "
              f"{active / ms * 1e3:.4e} arrivals/s, {s.avg_server_count:.4f} live instances "
              f"an event; bound {b_ms:.3f} ms ({b_by}), {ms / b_ms:.1f}x; plain "
              f"{plain_ms:.0f} ms on the first {SCAN64_PLAIN_EVENTS} events in CUDA-graph "
              f"chunks (held: max|acc diff| {err:.3e})", flush=True)
        if c == 3:
            part = [prefix(x, GRAPH_CHECK_EVENTS) for x in samples]
            graph_equals_eager(
                torch, "par c=3", lambda: resolve_backend("scan_ref").launch_for("par")(
                    *part, **kw), lambda: plain_launch(*part, **kw))
            kw_tail = dict(kw, t_end=rows(-1.0), skip=rows(-2.0))
            tail_ms, _ = timed(torch, lambda: launch(*samples, **kw_tail), reps=3)
            past = FULL_REPLICAS * K_par - active
            print(f"timing [{card}]: par_scan_sweep's inert tail at c=3: {past} events past "
                  f"their horizons ({100 * past / (FULL_REPLICAS * K_par):.1f}%); with every "
                  f"event past t_end the launch takes {tail_ms:.3f} ms, so the tail is "
                  f"~{100 * tail_ms * past / (FULL_REPLICAS * K_par) / ms:.1f}% of the "
                  f"{ms:.3f} ms", flush=True)
        del out, out_k, out_p, part
    print(f"f64 par: c=1 makes the pool scan's decisions on the same draws; ratio c=1/c=3 "
          f"{par[1].avg_server_count / par[3].avg_server_count:.3f}", flush=True)
    del samples
    torch.cuda.empty_cache()
    results = {"scan_sweep": result8,
               "par_scan_sweep": dict(launches=par_launches[3], **par_times[3])}
    return results, errs, staged64


# ---- the f64 fleet scan and the f64 engine's fused draws (module docstring, item 14)
FLEET64_PLAIN_EVENTS = 4096  # every launch of the phase is held to plain on these
FLEET16_CLUSTER = 48  # the catalog twice, renamed: 16 functions under one cluster
NHPP_FUSED_PROFILE = 14  # nhpp_profiles(rt)[14]: SinusoidalRate(0.9, 0.8, DAY)
NHPP_FUSED_REPLICAS = 1024
# f64 operations of each fused transform (drawplan.sample_dist in f64): the
# arithmetic of FUSED_F32_OPS and each libm call (log, sqrt, cos, exp, pow)
# counted as one operation, a floor: each is a polynomial of tens
FUSED64_OPS = {d: FUSED_F32_OPS[d] + FUSED_SFU_CALLS[d] for d in FUSED_F32_OPS}


def plain_fleet64(torch, args, kw):
    """The plain f64 fleet scan on ``args`` (the launch's ten inputs) with
    its event loop in CUDA-graph chunks (plain_in_graph): each chunk
    continues the last one's state (``state0``, no flush), a last call with
    no events flushes the tail, so the result is one eager call's."""
    from repro_torch.kernels.ref64 import FleetScanOut, fleet_scan_sweep_ref

    kw = dict(kw)
    kw.pop("live_bound", None)
    head, seq = args[:6], list(args[6:])
    names = [n for n in ("crash_u",) if kw.get(n) is not None]
    seq += [kw.pop(n) for n in names]
    K = seq[0].shape[1]
    present = []

    def call(state, part, flush):
        st = None
        if state is not None:
            it = iter(state)
            st = FleetScanOut(**{f: (next(it) if f in present else None)
                                 for f in FleetScanOut._fields})
        t, fids, w, c, *rest = part
        return fleet_scan_sweep_ref(*head, t, fids, w, c, **kw, **dict(zip(names, rest)),
                                    state0=st, flush=flush)

    def run(state, part):
        out = call(state, part, False)
        if not present:
            present.extend(f for f, x in zip(FleetScanOut._fields, out) if x is not None)
        return tuple(x for x in out if x is not None)

    state = plain_in_graph(torch, run, seq)
    return call(state, [x[:, K:] for x in seq], True)


def held_fleet64(torch, out_k, out_p, what):
    """Kernel 10 against its plain version: pools, clocks, crash clocks and
    queues equal, every accumulator column but the sums over slots equal,
    those within SCAN64_RTOL; returns the largest |acc difference|."""
    from repro_torch.kernels.ref64 import FLEET64_FLOAT_COLS

    for name, a, b in zip(out_k._fields, out_k, out_p):
        if name != "acc" and ((a is None) != (b is None) or (a is not None and not torch.equal(a, b))):
            raise AssertionError(f"{what}: {name} differs from the plain version")
    acc_k, acc_p = out_k.acc, out_p.acc
    fl = list(FLEET64_FLOAT_COLS)
    for c in range(acc_k.shape[-1]):
        if c not in fl and not torch.equal(acc_k[..., c], acc_p[..., c]):
            n = int((acc_k[..., c] != acc_p[..., c]).sum())
            raise AssertionError(f"{what}: acc column {c} differs in {n} (fleet, function) rows")
    err = (acc_k[..., fl] - acc_p[..., fl]).abs()
    if bool((err > SCAN64_RTOL * acc_p[..., fl].abs().clamp_min(1.0)).any()):
        raise AssertionError(f"{what}: a sum over slots is off by {err.max().item():.3e}")
    return float((acc_k - acc_p).abs().max())


def hold_fleet64(torch, inp, kw, what):
    """The f64 fleet launch on the first FLEET64_PLAIN_EVENTS events of
    ``inp``'s stream against its plain version in CUDA-graph chunks;
    returns (max |acc diff|, the plain version's ms)."""
    from repro_torch.kernels.fleet_scan_event_step import fleet_scan_sweep

    n = FLEET64_PLAIN_EVENTS
    part = fleet_prefix(inp, n)
    pkw = dict(kw)
    if pkw.get("crash_u") is not None:
        pkw["crash_u"] = prefix(pkw["crash_u"], n)
    out_k = fleet_scan_sweep(*part, **pkw, live_bound=inp.live_bound)
    plain_ms, out_p = plain_timed(torch, lambda: plain_fleet64(torch, part, pkw))
    err = held_fleet64(torch, out_k, out_p, f"{what}, first {n} events")
    print(f"kernel==plain f64 fleet {what}: first {n} events of "
          f"{inp.staged['times'].shape[1]}, {inp.t_exp.shape[0]} fleets: pools, clocks, "
          f"queues and counters equal, max|acc diff| {err:.3e} (plain {plain_ms:.0f} ms in "
          f"{PLAIN_GRAPH_EVENTS}-event CUDA-graph chunks)", flush=True)
    return err, plain_ms


def print_fleet64_resources(torch, card, what, F, live, N, M=64, Q=0, faults=False):
    """Kernel 10's instance at a launch's sizes: its registers and local
    memory a thread, the fleets a block the launch takes and the blocks an
    SM the card allows, so whether the launch's blocks fit the SMs in one
    wave."""
    from repro_torch.kernels.fleet_scan_event_step import resources

    r = resources(N, F, M, live, queue_depth=Q, faults=faults)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-N // r["fleets_per_block"])
    waves = -(-blocks // max(r["blocks_per_sm"] * sms, 1))
    print(f"kernel 10 resources [{card}] at {what}: L={r['entries']} table entries a lane, "
          f"columns in {'shared memory' if r['shared_columns'] else 'registers'}; "
          f"{r['registers']} registers and {r['local_bytes']} bytes of local memory (spills) "
          f"a thread ({'pinned' if r['pinned'] else 'unpinned'} instance), "
          f"{r['blocks_per_sm']} blocks of {r['fleets_per_block']} fleets an SM: "
          f"{blocks} blocks on {sms} SMs in {waves} wave(s)", flush=True)


def fleet64_launch(inp, fleet):
    """The launch fleet_sweep()/fleet_run() makes on the f64 fleet scan."""
    from repro_torch.kernels.fleet_scan_event_step import fleet_scan_sweep

    kw = dict(slots=fleet.slots, queue_depth=fleet.queue_depth,
              prestamped=inp.staged["prestamped"], **inp.faults)
    args = fleet_prefix(inp, inp.staged["times"].shape[1])
    return (lambda: fleet_scan_sweep(*args, **kw, live_bound=inp.live_bound)), kw


def fleet_pasta(inp, grid, cells):
    """Fleet-events in the horizons, and the live and acting-function live
    instances those events find, by PASTA from the grid's occupancies (as
    phase 6 counts them)."""
    F = grid.summaries.shape[-1]
    in_h = inp.staged["times"] <= inp.t_end[:1].item()
    per_row = in_h.sum(1).double().cpu().numpy()
    per_fn = np.stack([(in_h & (inp.staged["fids"] == f)).sum(1).double().cpu().numpy()
                       for f in range(F)])
    del in_h
    occ = np.array([[(s.time_running + s.time_idle) / s.measured_time for s in row]
                    for row in grid.summaries.reshape(cells, F)])
    return (int(per_row.sum()) * cells, float((occ * per_row).sum()),
            float((occ * per_fn).sum()))


# the f64 fleet scan (kernel 10) counted as scan64_bound_ms counts kernel
# 8: no event integrates or tests the fleet's live instances (integrals are
# accrued per state span, exits wait for the fleet's exit bound).  Per
# event inside the horizon, 2 on each live instance of the acting function
# (its idle test and the routing key's compare) and 16 on the fleet's
# scalars (kernel 8's 20 without reliability's 5 and the window lookup's 2,
# plus the function's limit, the cluster's capacity and the peak); 14 per
# assignment and 10 per exit (crashes and evictions included) as in kernel
# 8; 1 per request queued and 2 per request a drain serves (its wait and the
# wait's sum).  Faults add 4 on the fleet per event with a capacity profile
# (the segment test 2, the live count against the ceiling, the admission
# gate), 6 per cold start with crashes (the lifetime's 1 - u, log, division
# and clock, the exit bound's min, the interruption test) and, per
# eviction, the fleet's newest idle instance: 2 on each live instance
FLEET64_OPS_PER_FLEET_EVENT = 16
FLEET64_OPS_PER_ENQUEUE = 1
FLEET64_OPS_PER_QUEUE_SERVE = 2
FLEET64_CAP_OPS_PER_EVENT = 4
FLEET64_CRASH_OPS_PER_COLD = 6


def fleet64_bound_ms(N, F, S, K, n_active, live_events, acting_live_events, assigns, exits,
                     queued=0, served=0, fault=None, M=64):
    """Least time for one f64 fleet-scan call: N fleets of F functions
    reading a [S, K] stream (f64 times, warm, cold, fid; held once), the
    pools [N, F, M] and clocks written back, 18 f64 columns a function; the
    f64 operations this data needs at the f64 peak: ``n_active``
    fleet-events inside their horizons (the rest only move the clock), the
    ``acting_live_events`` live instances of the acting function those
    events find, ``assigns`` assignments, ``exits`` exits and the queue's
    ``queued`` and ``served`` requests.  ``fault`` (the profile's edge count
    E, -1 without capacity, whether crashes run, the cold starts, the
    evictions) adds the fault path's bytes and work; an eviction searches
    the fleet's live instances (``live_events / n_active`` an event)."""
    nbytes = (FLEET_STREAM_BYTES * S * K + 4 * S * K + 8 * N * (2 * F + 3) + 8 * N
              + 8 * N * F * 18 + 17 * N * F * M + 8 * N)
    ops = (acting_live_events * SCAN64_OPS_PER_SLOT_EVENT
           + n_active * FLEET64_OPS_PER_FLEET_EVENT + (N * K - n_active)
           + assigns * SCAN64_OPS_PER_ASSIGN + exits * SCAN64_OPS_PER_EXIT
           + queued * FLEET64_OPS_PER_ENQUEUE + served * FLEET64_OPS_PER_QUEUE_SERVE)
    if fault is not None:
        E, crashes, cold_starts, evictions = fault
        nbytes += 8 * N * F * 3 + (8 * N * (2 * E + 1) if E >= 0 else 0)
        if crashes:
            nbytes += 8 * N + 4 * S * K + 8 * N * F * M
            ops += cold_starts * FLEET64_CRASH_OPS_PER_COLD
        if E >= 0:
            ops += n_active * FLEET64_CAP_OPS_PER_EVENT
        ops += evictions * SCAN64_OPS_PER_SLOT_EVENT * live_events / max(n_active, 1)
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F64_OPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def fused64_bound_ms(C, M, K, n_active, live, assigns, exits, dists, rely=False,
                     window_passes=0, cols=10):
    """Least time for one fused kernel-8 launch: scan64_bound_ms's f64 work
    on what the data needs, without the sample bytes, plus the keys and f64
    parameters (8 and 16 bytes a row and stream) and the draws of every
    event in a horizon and one more a row: each stream's int32 threefry at
    the int32 peak, the transforms' f64 operations at the f64 peak."""
    streams = 3 + int(rely)
    nbytes = (8 * 3 * C + C * (8 * streams + 16 * 3) + C * M * (1 + 8 + 8) * 2 + 8 * C
              + 8 * C * cols)
    per_event = live / max(n_active, 1)
    drawn = n_active + C
    f64 = (live * SCAN64_OPS_PER_SLOT_EVENT + n_active * SCAN64_OPS_PER_ROW_EVENT
           + (C * K - n_active) + assigns * SCAN64_OPS_PER_ASSIGN + exits * SCAN64_OPS_PER_EXIT
           + window_passes * (per_event * SCAN64_OPS_PER_WINDOW_SLOT
                              + SCAN64_OPS_PER_WINDOW_ROW)
           + drawn * (sum(FUSED64_OPS["exp" if d == "nhpp" else d] for d in dists) + int(rely)))
    ints = drawn * streams * INT_OPS_PER_DRAW
    times = {"bytes": nbytes / PEAK_BYTES,
             "operations": max(f64 / PEAK_F64_OPS, ints / PEAK_INT32_OPS)}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def fused64_inputs(torch, rt, dev, scn, over, seed, replicas):
    """The fused launch sweep() (``over``) or run() (``over`` None) makes on
    the f64 engine: its keys and f64 parameters, and per-row values."""
    from repro_torch.core.scenario import fused_state, sweep_inputs

    if over is None:
        st = fused_state([scn], seed, replicas, scn.steps_needed(), dev, f64=True)
        vals = [np.full(replicas, v) for v in (scn.expiration_threshold, scn.sim_time,
                                               scn.skip_time)]
        rel = scn.reliability
        rows = (None, None) if rel is None else (np.full(replicas, rel.failure.timeout_or_inf),
                                                 np.full(replicas, rel.failure.p_fail))
        return st, (*vals, *rows)
    inp = sweep_inputs(scn, over, seed, replicas=replicas, device=dev, draws="fused", f64=True)
    return inp.fused, (inp.thr_rows, inp.sim_rows, inp.skip_rows, inp.t_timeout_rows,
                       inp.p_fail_rows)


def fused64_timed(torch, rt, dev, card, scn, over, seed, replicas, what, cells_of=None):
    """One fused kernel-8 launch at an entry point's width, timed by CUDA
    events (mean of 3), reproducing the entry point's cold starts
    (``cells_of``: its per-row n_cold), and held to the plain version on
    its first FLEET64_PLAIN_EVENTS events in CUDA-graph chunks; returns
    (ms, plain_ms, bound_ms, bound_by, err, acc)."""
    from repro_torch.core.execution import resolve_backend
    from repro_torch.core.simulator import scan_launch
    from repro_torch.core.drawplan import materialize_stream

    st, (thr, sim, skip, t_to, p_f) = fused64_inputs(torch, rt, dev, scn, over, seed, replicas)
    C, K = len(thr), st["n_steps"]
    W = 0 if scn.window_bounds is None else len(scn.window_bounds) - 1
    wrows = None if not W else np.tile(scn.window_bounds, (C, 1))
    kw = dict(t_exp=thr, t_end=sim, skip=skip, prestamped=False, window_rows=wrows,
              t_timeout=t_to, p_fail=p_f)
    scan = resolve_backend("scan")
    ms, out = timed(torch, lambda: scan_launch(scn, scan, dev, (), fused=st, **kw), reps=3)
    acc = out.acc
    if cells_of is not None and not np.array_equal(acc[:, 0].cpu().numpy(), cells_of):
        raise AssertionError(f"{what}: the timed fused launch does not reproduce the entry point")
    part = dict(st, n_steps=FLEET64_PLAIN_EVENTS)
    out_k = scan_launch(scn, scan, dev, (), fused=part, **kw)
    plain_ms, out_p = plain_timed(torch, lambda: scan_launch(
        scn, PlainInGraph(torch), dev, (), fused=part, **kw))
    lay = scan64_layout(scn, W=W)
    err = held64(torch, out_k, out_p, lay, f"fused {what}, first {FLEET64_PLAIN_EVENTS} events")
    # the events in the horizons: the counted arrivals (accepted candidates
    # past skip) and, off a materialized f64 prefix of each row's stream,
    # the candidates before skip
    p = st["params"][0]
    gaps = materialize_stream("exp" if st["dists"][0] == "nhpp" else st["dists"][0],
                              st["keys"][0], p, SKIP_PREFIX_EVENTS, dev,
                              dtype=torch.float64).cumsum(1)
    skip_t = torch.as_tensor(np.asarray(skip, np.float64), device=dev)
    before = int((gaps <= skip_t[:, None]).sum())
    active = int(acc[:, :3].sum()) + before
    held = (acc[:, 3] + acc[:, 4]) / torch.as_tensor(np.asarray(sim) - np.asarray(skip),
                                                     device=dev)
    live = float((held * acc[:, :3].sum(1)).sum())
    b_ms, b_by = fused64_bound_ms(C, scn.slots, K, active, live, int(acc[:, :2].sum()),
                                  int(acc[:, 8].sum()), st["dists"], rely=t_to is not None,
                                  window_passes=active + C * W if W else 0, cols=lay.cols)
    print(f"timing [{card}]: scan_sweep fused {what} C={C} M={scn.slots} K={K} "
          f"{'/'.join(st['dists'])}: {ms:.3f} ms; {active} arrivals in horizon = "
          f"{active / ms * 1e3:.4e} arrivals/s; bound {b_ms:.3f} ms ({b_by}; the draws' int32 "
          f"and f64 work included), {ms / b_ms:.1f}x; plain {plain_ms:.0f} ms on the first "
          f"{FLEET64_PLAIN_EVENTS} events in CUDA-graph chunks (held: max|acc diff| "
          f"{err:.3e})", flush=True)
    return ms, plain_ms, b_ms, b_by, err, acc


def fleet64_fused_phase(torch, rt, dev, card, staged64):
    """Phase 14 (module docstring, item 14): kernel 10 through fleet_sweep()
    and fleet_run() on backend "scan", kernel 8's fused path through run()
    and sweep() with Execution(backend="scan", draws="fused"); returns the
    kernels-line entries of fleet_scan_sweep, fleet_scan_sweep_fault and
    scan_sweep_fused and their largest differences."""
    import dataclasses

    from repro_torch.core.fleet import fleet_inputs
    from repro_torch.data.catalog import catalog_names, fleet_of
    from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS
    from repro_torch.kernels.fleet_event_step import fleet_sweep

    errs = {"fleet_scan_sweep": 0.0, "fleet_scan_sweep_fault": 0.0, "scan_sweep_fused": 0.0}
    launches = dict.fromkeys(errs, 0)
    results = {}
    S64 = dict(backend="scan")

    def count(key, what):
        if dict(LAUNCH_COUNTS) != {key: 1}:
            raise AssertionError(f"{what}: launches {dict(LAUNCH_COUNTS)}, want {{{key}: 1}}")
        launches[key] += 1

    def hold(key, inp, kw, what):
        e, ms = hold_fleet64(torch, inp, kw, what)
        errs[key] = max(errs[key], e)
        return ms

    # ---- 14.1 the catalog sweep (phase 6) on the f64 fleet scan
    names = list(catalog_names())
    fleet = fleet_of(names, n_cluster=FLEET_CLUSTER, skip_time=20.0, slots=64)
    over = {"expiration_threshold": FLEET_THRESHOLDS}
    torch.cuda.empty_cache()
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    grid = rt.fleet_sweep(fleet, over, 5, replicas=FLEET_REPLICAS, **S64)
    sweep_s = time.perf_counter() - t0
    count("fleet_scan_sweep", "the f64 catalog sweep")
    peak = float(grid.peak_cluster.max())
    if not grid.ok.all() or peak > FLEET_CLUSTER or grid.backend != "scan":
        raise AssertionError("the f64 catalog sweep is not finite or passed its cap")
    cell = grid.summaries[0]
    occ_r = sum((s.time_running + s.time_idle) / s.measured_time for s in cell)
    checks = [(f"{n} cold start", cell[f].cold_start_prob,
               float((cell[f].n_cold / np.maximum(cell[f].n_cold + cell[f].n_warm, 1)).std(ddof=1)),
               REF_FLEET_SCAN["cold_start_prob"][f], REF_FLEET_SCAN["cold_start_prob_se"][f])
              for f, n in enumerate(names)]
    checks.append(("avg cluster occupancy", float(occ_r.mean()), float(occ_r.std(ddof=1)),
                   REF_FLEET_SCAN["avg_cluster_occupancy"],
                   REF_FLEET_SCAN["avg_cluster_occupancy_se"]))
    worst = 0.0
    for what, got, sd, ref, ref_se in checks:
        z = abs(got - ref) / float(np.hypot(sd / np.sqrt(FLEET_REPLICAS), ref_se))
        worst = max(worst, z)
        if z > REF_FLEET_SIGMAS:
            raise AssertionError(f"f64 fleet 60 s cell: {what} {got:.6f} is {z:.2f} standard "
                                 f"errors off the JAX f64 fleet scan's {ref:.6f}")
    inp = fleet_inputs(fleet, over, 5, replicas=FLEET_REPLICAS, device=dev, f64=True)
    N, (S, K) = inp.t_exp.shape[0], inp.staged["times"].shape
    launch, kw = fleet64_launch(inp, fleet)
    # in turns with the f32 kernel on its own staging of the same seed:
    # f32, f64, f64, f32
    inp32 = fleet_inputs(fleet, over, 5, replicas=FLEET_REPLICAS, device=dev)
    args32 = fleet_prefix(inp32, inp32.staged["times"].shape[1])
    kw32 = dict(slots=64, queue_depth=0, prestamped=True, live_bound=inp32.live_bound)
    f32_ms, f64_ms = [], []
    for which in (0, 1, 1, 0):
        if which:
            ms_i, out = timed(torch, launch, reps=2)
            f64_ms.append(ms_i)
        else:
            ms_i, _ = timed(torch, lambda: fleet_sweep(*args32, **kw32), reps=2)
            f32_ms.append(ms_i)
    del inp32, args32
    ms = sum(f64_ms) / len(f64_ms)
    cold = out.acc[..., 0].cpu().numpy().reshape(len(FLEET_THRESHOLDS), -1, len(names))
    for i in range(len(FLEET_THRESHOLDS)):
        for f in range(len(names)):
            if not np.array_equal(cold[i, :, f], grid.summaries[i, f].n_cold):
                raise AssertionError("the timed f64 fleet launch does not reproduce fleet_sweep()")
    plain_ms = hold("fleet_scan_sweep", inp, kw, "catalog sweep")
    active, live, acting = fleet_pasta(inp, grid, len(FLEET_THRESHOLDS))
    F = len(names)
    tot = out.acc.sum((0, 1)).tolist()
    b_ms, b_by = fleet64_bound_ms(N, F, S, K, active, live, acting, tot[0] + tot[1], tot[8])
    print(f"f64 fleet sweep [{card}]: {F} functions x {len(FLEET_THRESHOLDS)} thresholds x "
          f"{FLEET_REPLICAS} replicas = {N} fleets x K={K} merged events, 1 launch: "
          f"fleet_sweep(backend='scan') {sweep_s:.3f} s wall; the 60 s cell within "
          f"{worst:.2f} standard errors of REF_FLEET_SCAN (limit {REF_FLEET_SIGMAS}); peak "
          f"{peak:.0f} <= {FLEET_CLUSTER}", flush=True)
    print(f"timing [{card}]: fleet_scan_sweep N={N} F={F} M=64 K={K} (live bound "
          f"{inp.live_bound}): {ms:.3f} ms ({', '.join(f'{x:.3f}' for x in f64_ms)}) against "
          f"the f32 fleet_sweep's {sum(f32_ms) / 2:.3f} ms "
          f"({', '.join(f'{x:.3f}' for x in f32_ms)}) in turns, "
          f"{ms / (sum(f32_ms) / 2):.2f}x; {active} fleet-events in horizon = "
          f"{active / ms * 1e3:.4e}/s; bound {b_ms:.3f} ms ({b_by}, f64), {ms / b_ms:.1f}x; "
          f"plain {plain_ms:.0f} ms on the first {FLEET64_PLAIN_EVENTS} events", flush=True)
    results["fleet_scan_sweep"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print_fleet64_resources(torch, card, "the catalog", F, inp.live_bound, N)
    del inp, launch, out, grid
    torch.cuda.empty_cache()

    # ---- 14.2 the queued fleet, through fleet_run()
    fleet_q = fleet_of(names, skip_time=20.0, slots=64, **FLEET_QUEUED)
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    sq = rt.fleet_run(fleet_q, 6, replicas=FLEET_REPLICAS, **S64).summary
    wall = time.perf_counter() - t0
    count("fleet_scan_sweep", "the f64 queued fleet")
    if sq.enqueued.sum() <= 0 or sq.max_peak_cluster > FLEET_QUEUED["n_cluster"]:
        raise AssertionError("the f64 queued fleet queued nothing or passed its cap")
    inp = fleet_inputs(fleet_q, {}, 6, replicas=FLEET_REPLICAS, device=dev, f64=True)
    launch, kw = fleet64_launch(inp, fleet_q)
    ms_q, _ = timed(torch, launch, reps=2)
    hold("fleet_scan_sweep", inp, kw, "queued")
    print(f"f64 fleet queued [{card}]: n_cluster={FLEET_QUEUED['n_cluster']} queue_depth="
          f"{FLEET_QUEUED['queue_depth']}, {FLEET_REPLICAS} replicas, 1 launch of "
          f"{ms_q:.3f} ms, {wall:.3f} s wall: enqueued "
          f"{100 * sq.enqueued.sum() / sq.arrivals.sum():.3f}% of arrivals, "
          f"mean queue wait {float(sq.queue_wait_sum.sum() / max(sq.queue_served.sum(), 1)):.4f}"
          f" s, peak {sq.max_peak_cluster:.0f}", flush=True)
    print_fleet64_resources(torch, card, "the queued fleet", F, inp.live_bound, FLEET_REPLICAS,
                            Q=FLEET_QUEUED["queue_depth"])
    del inp, launch

    # ---- 14.3 a 16-function fleet (the catalog twice, renamed), which the
    # f32 kernel cannot run
    fns16 = tuple(dataclasses.replace(f, name=f"{f.name}-{i}") for i in (1, 2)
                  for f in fleet.functions)
    fleet16 = dataclasses.replace(fleet, functions=fns16, n_cluster=FLEET16_CLUSTER)
    try:
        rt.fleet_run(fleet16, 8, replicas=2, backend="cuda")
    except ValueError as e:
        if "at most 8 functions" not in str(e):
            raise
    else:
        raise AssertionError("the f32 fleet kernel took 16 functions")
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    s16 = rt.fleet_run(fleet16, 8, replicas=FLEET_REPLICAS, **S64).summary
    wall = time.perf_counter() - t0
    count("fleet_scan_sweep", "the 16-function fleet")
    if s16.max_peak_cluster > FLEET16_CLUSTER or not np.isfinite(s16.cold_start_prob).all():
        raise AssertionError("the 16-function fleet passed its cap or is not finite")
    inp = fleet_inputs(fleet16, {}, 8, replicas=FLEET_REPLICAS, device=dev, f64=True)
    launch, kw = fleet64_launch(inp, fleet16)
    ms16, _ = timed(torch, launch, reps=2)
    hold("fleet_scan_sweep", inp, kw, "16 functions")
    print(f"f64 fleet 16 functions [{card}]: n_cluster {FLEET16_CLUSTER}, {FLEET_REPLICAS} "
          f"replicas x K={inp.staged['times'].shape[1]}, 1 launch ({ms16:.3f} ms), "
          f"fleet_run() {wall:.3f} s wall: occupancy {s16.avg_cluster_occupancy:.3f}, peak "
          f"{s16.max_peak_cluster:.0f}, cold start % "
          + " ".join(f"{100 * p:.2f}" for p in s16.cold_start_prob), flush=True)
    del inp, launch

    # ---- 14.4 a two-function fleet with one NHPP function (phase 12's)
    prof = nhpp_profiles(rt)[NHPP_FUSED_PROFILE]
    t1 = lambda s: rt.ExpSimProcess(rate=1 / s)
    fleet_n = rt.FleetScenario(
        functions=(rt.FleetFunction(name="diurnal", rate_profile=prof,
                                    warm_service_process=t1(1.991),
                                    cold_service_process=t1(2.244)),
                   rt.FleetFunction(name="steady", arrival_process=rt.ExpSimProcess(rate=0.5),
                                    warm_service_process=t1(1.991),
                                    cold_service_process=t1(2.244))),
        n_cluster=FLEET_CLUSTER, sim_time=DAY, skip_time=0.0, slots=64)
    fover = {"expiration_threshold": FLEET_NHPP_THRESHOLDS}
    LAUNCH_COUNTS.clear()
    gn = rt.fleet_sweep(fleet_n, fover, 9, replicas=FLEET_NHPP_REPLICAS, **S64)
    count("fleet_scan_sweep", "the NHPP fleet")
    if not gn.ok.all() or float(gn.peak_cluster.max()) > FLEET_CLUSTER:
        raise AssertionError("the f64 NHPP fleet is not finite or passed its cap")
    inp = fleet_inputs(fleet_n, fover, 9, replicas=FLEET_NHPP_REPLICAS, device=dev, f64=True)
    if inp.staged["times"].dtype != torch.float64:
        raise AssertionError("the f64 fleet's merged times are not f64")
    _, kw = fleet64_launch(inp, fleet_n)
    hold("fleet_scan_sweep", inp, kw, "NHPP")
    print(f"f64 fleet NHPP: {FLEET_NHPP_REPLICAS} replicas x K={inp.staged['times'].shape[1]} "
          f"f64 merged times, 1 launch: cold start % (60 s) "
          + " ".join(f"{100 * p:.3f}" for p in gn.cold_start_prob[0]), flush=True)
    del inp
    results["fleet_scan_sweep"]["launches"] = launches["fleet_scan_sweep"]

    # ---- 14.5 the catalog with faults (phase 11's), and chaos.py's dip fleet
    fleet_c = dataclasses.replace(fleet, faults=rt.FaultModel(
        crash_rate=CATALOG_CRASH_RATE, capacity=rt.CapacityProfile((0.4e5, 0.7e5), CATALOG_DIP)))
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    gc = rt.fleet_sweep(fleet_c, over, 5, replicas=FLEET_REPLICAS, **S64)
    wall = time.perf_counter() - t0
    count("fleet_scan_sweep_fault", "the f64 catalog with faults")
    if not gc.ok.all() or float(gc.peak_cluster.max()) > FLEET_CLUSTER:
        raise AssertionError("the f64 catalog with faults is not finite or passed its cap")
    inp = fleet_inputs(fleet_c, over, 5, replicas=FLEET_REPLICAS, device=dev, f64=True)
    launch, kw = fleet64_launch(inp, fleet_c)
    ms_f, out = timed(torch, launch, reps=2)
    cold = out.acc[..., 0].cpu().numpy().reshape(len(FLEET_THRESHOLDS), -1, F)
    if not all(np.array_equal(cold[i, :, f], gc.summaries[i, f].n_cold)
               for i in range(len(FLEET_THRESHOLDS)) for f in range(F)):
        raise AssertionError("the timed f64 fault launch does not reproduce fleet_sweep()")
    tot = out.acc.sum((0, 1)).tolist()
    plain_f = hold("fleet_scan_sweep_fault", inp, kw, "catalog with faults")
    active, live, acting = fleet_pasta(inp, gc, len(FLEET_THRESHOLDS))
    bf_ms, bf_by = fleet64_bound_ms(N, F, S, K, active, live, acting, tot[0] + tot[1], tot[8],
                                    fault=(2, True, tot[0], tot[16]))
    print(f"timing [{card}]: fleet_scan_sweep with faults N={N} F={F} K={K}: {ms_f:.3f} ms "
          f"(+{100 * (ms_f / ms - 1):.1f}% over 14.1's launch without faults); bound "
          f"{bf_ms:.3f} ms ({bf_by}, f64), {ms_f / bf_ms:.1f}x; crashes {tot[15]:.0f}, "
          f"evictions {tot[16]:.0f}, interrupted {tot[17]:.0f}; plain {plain_f:.0f} ms on the "
          f"first {FLEET64_PLAIN_EVENTS} events; fleet_sweep() {wall:.3f} s wall", flush=True)
    results["fleet_scan_sweep_fault"] = dict(ms=ms_f, plain_ms=plain_f, bound_ms=bf_ms,
                                             bound_by=bf_by)
    print_fleet64_resources(torch, card, "the catalog with faults", F, inp.live_bound, N,
                            faults=True)
    del inp, launch, out, gc
    torch.cuda.empty_cache()
    fn = lambda name, rate, warm, cold, thr, limit: rt.FleetFunction(
        name=name, arrival_process=rt.ExpSimProcess(rate=rate),
        warm_service_process=rt.ExpSimProcess(rate=warm),
        cold_service_process=rt.ExpSimProcess(rate=cold),
        expiration_threshold=thr, max_concurrency=limit)
    fleet_d = rt.FleetScenario(
        functions=(fn("api", 0.8, 0.5, 0.25, 60.0, 25), fn("batch", 0.3, 0.2, 0.1, 120.0, 20)),
        n_cluster=40, sim_time=DIP_T, skip_time=0.0,
        faults=rt.FaultModel(crash_rate=DIP_CRASH_RATE, capacity=rt.CapacityProfile(
            (0.4 * DIP_T, 0.7 * DIP_T), (40.0, 10.0, 40.0))))
    LAUNCH_COUNTS.clear()
    sd = rt.fleet_run(fleet_d, 12, replicas=DIP_FLEETS, **S64).summary
    count("fleet_scan_sweep_fault", "the f64 dip fleet")
    line = []
    for f, (name, s) in enumerate(zip(sd.functions, sd.summaries)):
        per = 1 - s.n_interrupt / np.maximum(s.n_cold + s.n_warm, 1)
        se = float(np.std(per, ddof=1) / np.sqrt(len(per)))
        ref, ref_se = REF_FLEET_FAULT["availability"][f], REF_FLEET_FAULT["availability_se"][f]
        z = abs(s.availability - ref) / float(np.hypot(se, ref_se))
        line.append(f"{name} {s.availability:.5f} (reference {ref:.5f}, {z:.2f} standard errors)")
        if z > REF_FAULT_SIGMAS:
            raise AssertionError(f"the f64 dip fleet's {name} availability is off the reference")
    if sd.max_peak_cluster > 40 or sum(s.n_evict.sum() for s in sd.summaries) <= 0:
        raise AssertionError("the f64 dip fleet passed its ceiling or evicted nothing")
    inp = fleet_inputs(fleet_d, {}, 12, replicas=DIP_FLEETS, device=dev, f64=True)
    _, kw = fleet64_launch(inp, fleet_d)
    hold("fleet_scan_sweep_fault", inp, kw, "dip")
    print(f"f64 fleet dip: {DIP_FLEETS} fleets, availability " + "; ".join(line)
          + f"; peak {sd.max_peak_cluster:.0f} <= 40", flush=True)
    del inp
    results["fleet_scan_sweep_fault"]["launches"] = launches["fleet_scan_sweep_fault"]

    # ---- 14.6 the Table-1 sweep with fused draws on the f64 engine
    fused = rt.Execution(backend="scan", draws="fused")
    scn = table1(rt)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    g = rt.sweep(scn, SWEEP_OVER, seed=10, replicas=SWEEP_REPLICAS, execution=fused)
    wall = time.perf_counter() - t0
    fpeak = torch.cuda.max_memory_allocated()
    count("scan_sweep_fused", "the fused f64 Table-1 sweep")
    servers = float(g.sel(arrival_rate=0.9, expiration_threshold=600.0).avg_server_count)
    if not g.ok.all() or abs(servers / PAPER_SERVERS - 1) > PAPER_RTOL:
        raise AssertionError("the fused f64 Table-1 cell is not finite or 5% from the paper")
    m_f, se_f = cell_server_stats(g)
    m_s, se_s = cell_server_stats(staged64["grid"])
    z = np.abs(m_f - m_s) / np.sqrt(se_f ** 2 + se_s ** 2)
    if z.max() > REF_RETRY_SIGMAS:
        raise AssertionError("a fused f64 cell is more than 4 standard errors from the staged one")
    want = np.concatenate([s.n_cold for s in g.summaries.ravel()])
    ms8, plain8, b8, b8_by, e8, _ = fused64_timed(torch, rt, dev, card, scn, SWEEP_OVER, 10,
                                                  SWEEP_REPLICAS, "Table-1 sweep", cells_of=want)
    errs["scan_sweep_fused"] = max(errs["scan_sweep_fused"], e8)
    print(f"fused f64 sweep [{card}]: {g.shape} cells x {SWEEP_REPLICAS} replicas, 1 launch, "
          f"{wall:.3f} s wall (staged f64 sweep: {staged64['wall']:.3f} s), peak "
          f"{fpeak / 2**30:.3f} GiB on the card (staged f64: {staged64['peak'] / 2**30:.3f} "
          f"GiB); (0.9/s, 600 s) servers {servers:.4f} (paper {PAPER_SERVERS}); per-cell "
          f"instances against the staged f64 sweep within {z.max():.2f} standard errors over "
          f"{z.size} cells; kernel {ms8:.3f} ms", flush=True)
    results["scan_sweep_fused"] = dict(ms=ms8, plain_ms=plain8, bound_ms=b8, bound_by=b8_by)
    del g
    torch.cuda.empty_cache()

    # ---- 14.7 the same sweep over 32,768 rows
    torch.cuda.reset_peak_memory_stats()
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    wide = rt.sweep(scn, SWEEP_OVER, seed=11, replicas=FUSED_WIDE_REPLICAS, execution=fused)
    wall = time.perf_counter() - t0
    wpeak = torch.cuda.max_memory_allocated()
    count("scan_sweep_fused", "the fused f64 sweep at 32,768 rows")
    w_servers = float(wide.sel(arrival_rate=0.9, expiration_threshold=600.0).avg_server_count)
    if not wide.ok.all() or abs(w_servers / PAPER_SERVERS - 1) > PAPER_RTOL:
        raise AssertionError("the 32,768-row fused f64 cell is not finite or 5% from the paper")
    rows = wide.summaries.size * FUSED_WIDE_REPLICAS
    want = np.concatenate([s.n_cold for s in wide.summaries.ravel()])
    del wide
    ms_w, _, b_w, _, e, _ = fused64_timed(torch, rt, dev, card, scn, SWEEP_OVER, 11,
                                          FUSED_WIDE_REPLICAS, f"Table-1 sweep at {rows} rows",
                                          cells_of=want)
    errs["scan_sweep_fused"] = max(errs["scan_sweep_fused"], e)
    print(f"fused f64 sweep at {FUSED_WIDE_REPLICAS} replicas: {rows} rows, 1 launch "
          f"({ms_w:.3f} ms, {ms_w / b_w:.1f}x its bound), {wall:.3f} s wall, peak "
          f"{wpeak / 2**30:.3f} GiB; (0.9/s, 600 s) servers {w_servers:.4f}", flush=True)
    torch.cuda.empty_cache()

    # ---- 14.8 a fused fail-only run() and a fused windowed sweep
    scn_f = table1(rt, reliability=rt.Reliability(rt.FailurePolicy(p_fail=0.05, t_timeout=8.0)))
    LAUNCH_COUNTS.clear()
    s = rt.run(scn_f, seed=12, replicas=FAIL_REPLICAS, execution=fused).summary
    count("scan_sweep_fused", "the fused f64 fail-only run")
    served = float((s.n_cold + s.n_warm).sum())
    want_to = float((s.n_warm.sum() * np.exp(-8 / 1.991) + s.n_cold.sum() * np.exp(-8 / 2.244))
                    / served)
    for name, got, want in (("failure", s.failure_prob, 0.05 * (1 - want_to)),
                            ("timeout", s.timeout_prob, want_to)):
        zz = abs(got - want) / np.sqrt(want * (1 - want) / served)
        if zz > REF_RETRY_SIGMAS:
            raise AssertionError(f"the fused f64 fail-only run's {name} probability is off")
    _, _, _, _, e, _ = fused64_timed(torch, rt, dev, card, scn_f, None, 12, FAIL_REPLICAS,
                                     "fail-only run", cells_of=s.n_cold)
    errs["scan_sweep_fused"] = max(errs["scan_sweep_fused"], e)
    scn_w = table1(rt, window_bounds=TABLE1_WINDOWS)
    LAUNCH_COUNTS.clear()
    gw = rt.sweep(scn_w, SWEEP_OVER, seed=10, replicas=SWEEP_REPLICAS, execution=fused)
    count("scan_sweep_fused", "the fused f64 windowed sweep")
    want = np.concatenate([c.n_cold for c in gw.summaries.ravel()])
    _, _, _, _, e, _ = fused64_timed(torch, rt, dev, card, scn_w, SWEEP_OVER, 10,
                                     SWEEP_REPLICAS, "windowed sweep", cells_of=want)
    errs["scan_sweep_fused"] = max(errs["scan_sweep_fused"], e)
    print(f"fused f64 fail-only run: {FAIL_REPLICAS} replicas, failures "
          f"{100 * s.failure_prob:.3f}%, timeouts {100 * s.timeout_prob:.3f}%; windowed sweep: "
          f"{len(TABLE1_WINDOWS) - 1} windows, instances by window (0.9/s, 600 s) "
          + " ".join(f"{v:.3f}" for v in gw.sel(arrival_rate=0.9, expiration_threshold=600.0)
                     .windowed_instance_count), flush=True)
    del gw

    # ---- 14.9 fused NHPP thinning: phase 12's diurnal what-if of one profile
    prof = nhpp_profiles(rt)[NHPP_FUSED_PROFILE]
    scn_n = rt.Scenario(rate_profile=prof, warm_service_process=t1(1.991),
                        cold_service_process=t1(2.244), expiration_threshold=NHPP_THRESHOLDS[0],
                        sim_time=DAY, skip_time=0.0, slots=64, window_bounds=NHPP_WINDOWS)
    nover = {"expiration_threshold": NHPP_THRESHOLDS}
    torch.cuda.empty_cache()
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    gn = rt.sweep(scn_n, nover, 14, replicas=NHPP_FUSED_REPLICAS, execution=fused)
    nwall = time.perf_counter() - t0
    count("scan_sweep_fused", "the fused NHPP sweep")
    worst = 0.0
    n = sum(gn.summaries[j].windows.n_arrivals.sum(0) for j in range(len(NHPP_THRESHOLDS)))
    expected = len(NHPP_THRESHOLDS) * NHPP_FUSED_REPLICAS * np.array(
        [sinusoid_integral(prof, a, b) for a, b in zip(NHPP_WINDOWS[:-1], NHPP_WINDOWS[1:])])
    zh = np.abs(n - expected) / np.sqrt(expected)
    if zh.max() > HOURLY_SIGMAS:
        raise AssertionError(f"fused NHPP: an hour's arrivals are {zh.max():.2f} standard "
                             "errors from the profile's integral")
    st = nhpp_cell_stats(gn)
    cells = slice(NHPP_FUSED_PROFILE * len(NHPP_THRESHOLDS),
                  (NHPP_FUSED_PROFILE + 1) * len(NHPP_THRESHOLDS))
    for m, key in (("cold", "cold_start_prob"), ("servers", "avg_server_count")):
        ref = np.asarray(REF_NHPP[key])[cells]
        ref_se = np.asarray(REF_NHPP[key + "_se"])[cells]
        zz = np.abs(st[m] - ref) / np.hypot(st[m + "_se"], ref_se)
        worst = max(worst, float(zz.max()))
        if zz.max() > REF_NHPP_SIGMAS:
            raise AssertionError(f"the fused NHPP sweep's {key} is off REF_NHPP")
    want = np.concatenate([c.n_cold for c in gn.summaries.ravel()])
    ms_n, _, _, _, e, _ = fused64_timed(torch, rt, dev, card, scn_n, nover, 14,
                                        NHPP_FUSED_REPLICAS, "NHPP sweep", cells_of=want)
    errs["scan_sweep_fused"] = max(errs["scan_sweep_fused"], e)
    ph12 = DIURNAL_STAGED
    print(f"fused f64 NHPP [{card}]: SinusoidalRate(0.9, 0.8, {DAY:.0f}) x "
          f"{len(NHPP_THRESHOLDS)} thresholds x {NHPP_FUSED_REPLICAS} replicas, 24 hourly "
          f"windows, 1 launch ({ms_n:.3f} ms): sweep() {nwall:.3f} s wall, against phase 12's "
          f"staged diurnal sweep() {ph12.get('sweep_s', float('nan')):.3f} s of which staging "
          f"{ph12.get('staging_s', float('nan')):.3f} s (16 profiles x 64 replicas, the same "
          f"4,096 rows); every hour within {zh.max():.2f} standard errors of the profile's "
          f"integral; cold starts and instances within {worst:.2f} standard errors of REF_NHPP "
          f"(limit {REF_NHPP_SIGMAS})", flush=True)
    results["scan_sweep_fused"]["launches"] = launches["scan_sweep_fused"]
    del gn
    torch.cuda.empty_cache()
    return results, errs


# ---- the online what-if phase (module docstring, item 15)

# benchmarks/run.py's online benchmark at its full size (not --quick): the
# service's knobs and its stream, a SinusoidalRate(1.2, 0.6, 800)
# realisation fed in 12 batches of 120 s; 512 replicas, the catalog and
# fault cells' count (3,072 rows a tick), where its 4 would leave the card idle
ONLINE_TRUTH = dict(base=1.2, amplitude=0.6, period=800.0)
ONLINE_CONFIG = dict(rate_ceiling=4.0, n_bins=16, bin_width=60.0,
                     thresholds=(30.0, 60.0, 120.0, 300.0, 600.0, 1200.0), replicas=512)
ONLINE_TICKS, ONLINE_BATCH = 12, 120.0
FLEET_ONLINE_TICKS = 8
ONLINE_SLO = 0.1
PLAN_SIM, PLAN_CHECK_SIM, PLAN_CHECK_REPLICAS = 2e4, 2e3, 32
# Fig. 5's grid (benchmarks/run.py:131-150)
FIG5_RATES, FIG5_THRESHOLDS = [0.2, 0.5, 1.0, 2.0], [60.0, 300.0, 600.0, 1200.0]
FIG5_SIM, FIG5_REPLICAS = 2e4, 2
# the ticks that may build, load or reserve: the first one
ONLINE_WARMUP_TICKS = 1
# the JAX reference's per-threshold cold-start probability at the last
# tick's profile of --seed 0's stream (its rates, which both packages fit
# bit for bit from the numpy trace), 512 replicas:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tools/online_reference.py --replicas 512
REF_ONLINE = dict(
    seed=0,
    replicas=512,
    steps=4227,
    thresholds=[
        30.0, 60.0, 120.0, 300.0, 600.0, 1200.0
    ],
    rates=[
        1.2308583333333332, 1.245543333333333, 1.084785791902773, 1.073779240740773,
        0.9452020789632474, 1.0415982176582474, 0.9617019257903534, 1.1638420978403534,
        1.1917431260576479, 1.232972728057648, 1.260085135082354, 1.2336869900823542,
        1.2464824001176489, 1.0139447001176487, 0.9643140001680699, 0.78111650016807
    ],
    cold_start_prob=[
        0.03389614914526842, 0.01902807076862013, 0.012621165774335549, 0.009578974096658215,
        0.0086908277206991, 0.008646396752499421
    ],
    cold_start_prob_se=[
        0.00019061672565947368, 0.00013554319330272, 9.854315755175227e-05, 6.087111781809885e-05,
        4.291526903197812e-05, 3.9226924695728246e-05
    ],
)
REF_ONLINE_SIGMAS = 4.0


def online_trace(seed: int) -> np.ndarray:
    """Phase 15's arrival stream: ONLINE_TICKS * ONLINE_BATCH seconds of a
    SinusoidalRate(ONLINE_TRUTH) realisation by numpy thinning (a
    homogeneous Poisson stream at the peak rate, each arrival kept with
    probability rate(t) / peak), from ``seed``."""
    rng = np.random.default_rng(seed)
    t_end = ONLINE_TICKS * ONLINE_BATCH
    peak = ONLINE_TRUTH["base"] * (1.0 + ONLINE_TRUTH["amplitude"])
    cand = np.sort(rng.uniform(0.0, t_end, rng.poisson(peak * t_end)))
    rate = ONLINE_TRUTH["base"] * (
        1.0 + ONLINE_TRUTH["amplitude"] * np.sin(2.0 * np.pi * cand / ONLINE_TRUTH["period"]))
    return cand[rng.uniform(size=cand.size) * peak <= rate]


def online_batches(seed: int) -> list:
    """The stream cut into the ticks' batches."""
    ts = online_trace(seed)
    return [ts[(ts >= i * ONLINE_BATCH) & (ts < (i + 1) * ONLINE_BATCH)]
            for i in range(ONLINE_TICKS)]


class launch_events:
    """Within the context each call of ``module.name`` is bracketed by a
    pair of CUDA events on the current stream (the kernel's wrapper: its
    output zeroing and the kernel); :meth:`ms` reads them."""

    def __init__(self, torch, module, name):
        self.torch, self.module, self.name = torch, module, name
        self.pairs = []

    def __enter__(self):
        fn = self.fn = getattr(self.module, self.name)
        event = lambda: self.torch.cuda.Event(enable_timing=True)

        def call(*a, **kw):
            start, end = event(), event()
            start.record()
            out = fn(*a, **kw)
            end.record()
            self.pairs.append((start, end))
            return out

        setattr(self.module, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def ms(self):
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.pairs]


def tick_costs(torch, LAUNCH_COUNTS, TRACE_COUNTS, tick):
    """One ``tick()``: its result, and its host wall, launches, what it
    made the process pay again (``online_tick``) and the allocator segments
    it reserved."""
    LAUNCH_COUNTS.clear()
    paid = TRACE_COUNTS["online_tick"]
    seg = torch.cuda.memory_stats().get("segment.all.allocated", 0)
    t0 = time.perf_counter()
    rec = tick()
    wall = time.perf_counter() - t0
    return rec, dict(wall=wall, launches=dict(LAUNCH_COUNTS),
                     paid=TRACE_COUNTS["online_tick"] - paid,
                     segments=torch.cuda.memory_stats().get("segment.all.allocated", 0) - seg)


def check_steady(rows, key, warmup, what):
    """Every tick launched ``key`` once; after ``warmup`` ticks none paid
    anything again or reserved a segment."""
    for i, r in enumerate(rows):
        if r["launches"] != {key: 1}:
            raise AssertionError(f"{what} tick {i}: launches {r['launches']}, want {{{key}: 1}}")
        if i >= warmup and (r["paid"] or r["segments"]):
            raise AssertionError(f"{what} tick {i}: online_tick +{r['paid']}, "
                                 f"{r['segments']} new allocator segments after warm-up")


def grids_equal(a, b, what):
    """Two GridResults bit for bit: every metric grid and every array of
    every per-cell summary."""
    for f in a._METRIC_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None) or (x is not None and not np.array_equal(x, y)):
            raise AssertionError(f"{what}: {f} differs")
    for idx in np.ndindex(a.shape):
        for f, x in vars(a.summaries[idx]).items():
            if isinstance(x, np.ndarray) and not np.array_equal(x, getattr(b.summaries[idx], f)):
                raise AssertionError(f"{what}: cell {idx} {f} differs")


def cold_se(summary):
    """The standard error of a cell's cold-start probability over its
    replicas."""
    per = summary.n_cold / np.maximum(summary.n_cold + summary.n_warm, 1)
    return float(per.std(ddof=1) / np.sqrt(len(per)))


def online_phase(torch, rt, dev, card, seed):
    """The online what-if phase (module docstring, item 15); returns the
    phase's launches of scan_sweep, faas_sweep and fleet_scan_sweep and the
    largest |acc difference| of kernels 8, 1 and 10 held to plain."""
    from repro_torch.core import scenario as scn_mod
    from repro_torch.core.execution import register_backend
    from repro_torch.core.fleet import fleet_inputs
    from repro_torch.core.scenario import TRACE_COUNTS
    from repro_torch.core.whatif import sweep_legacy
    from repro_torch.data.catalog import catalog_names, fleet_of
    from repro_torch.kernels import faas_event_step as fes
    from repro_torch.kernels import fleet_scan_event_step as k10
    from repro_torch.kernels import scan_event_step as k8
    from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS
    from repro_torch.serving import (OnlineConfig, OnlineFleetWhatIfService,
                                     OnlineWhatIfService, plan_fleet_thresholds)

    t_phase = time.perf_counter()
    launches = {"scan_sweep": 0, "faas_sweep": 0, "fleet_scan_sweep": 0}
    errs = {"scan_sweep": 0.0, "faas_sweep": 0.0, "fleet_scan_sweep": 0.0}
    base = table1(rt)
    batches = online_batches(seed)
    thresholds = ONLINE_CONFIG["thresholds"]
    R = ONLINE_CONFIG["replicas"]
    C = len(thresholds) * R

    # ---- 15a. the single-function service, overlapped, then a synchronous twin
    def drive(svc):
        rows, recs = [], []
        with launch_events(torch, k8, "scan_sweep") as ev:
            for b in batches:
                svc.observe(b)
                rec, row = tick_costs(torch, LAUNCH_COUNTS, TRACE_COUNTS, svc.tick)
                rows.append(row)
                if rec is not None:
                    recs.append(rec)
            t0 = time.perf_counter()
            rec = svc.flush()
            flush_s = time.perf_counter() - t0
        if rec is not None:
            recs.append(rec)
        return rows, recs, ev.ms(), flush_s

    svc = OnlineWhatIfService(base, OnlineConfig(**ONLINE_CONFIG))
    rows, recs, k8_ms, flush_s = drive(svc)
    twin = OnlineWhatIfService(base, OnlineConfig(**ONLINE_CONFIG, overlap=False))
    rows_s, recs_s, k8_ms_s, _ = drive(twin)
    check_steady(rows, "scan_sweep", ONLINE_WARMUP_TICKS, "15a overlapped")
    check_steady(rows_s, "scan_sweep", ONLINE_WARMUP_TICKS, "15a synchronous")
    launches["scan_sweep"] += len(rows) + len(rows_s)
    if [r.tick for r in recs] != list(range(ONLINE_TICKS)) or len(recs_s) != ONLINE_TICKS:
        raise AssertionError("15a: a tick's recommendation is missing")
    for a, b in zip(recs, recs_s):
        if (a.seed, a.profile, a.threshold, a.applied_threshold) != (
                b.seed, b.profile, b.threshold, b.applied_threshold):
            raise AssertionError(f"15a tick {a.tick}: overlapped and synchronous ticks differ")
        grids_equal(a.grid, b.grid, f"15a tick {a.tick}, overlapped against synchronous")
    print(f"online service [{card}]: Table 1's base under a {sum(len(b) for b in batches)}-"
          f"arrival SinusoidalRate(1.2, 0.6, 800) stream (--seed {seed}), {ONLINE_TICKS} "
          f"ticks of {ONLINE_BATCH:.0f} s batches, {C} rows x K={svc._steps} candidates a "
          f"tick (rate ceiling {ONLINE_CONFIG['rate_ceiling']}, {ONLINE_CONFIG['n_bins']} bins "
          f"of {ONLINE_CONFIG['bin_width']:.0f} s); overlapped / synchronous twin:", flush=True)
    for i, (r, s) in enumerate(zip(rows, rows_s)):
        rec = recs[i - 1] if i else None
        print(f"  tick {i:2d}: tick() {1e3 * r['wall']:.3f} / {1e3 * s['wall']:.3f} ms wall; "
              f"scan_sweep {k8_ms[i]:.3f} / {k8_ms_s[i]:.3f} ms; online_tick +{r['paid']} / "
              f"+{s['paid']}; new allocator segments {r['segments']} / {s['segments']}; "
              f"launches {r['launches']}; "
              + (f"returned tick {rec.tick}: raw {rec.threshold:.0f} s, applied "
                 f"{rec.applied_threshold:.0f} s" if rec else "returned None (warm-up)"),
              flush=True)
    steady = slice(ONLINE_WARMUP_TICKS, None)
    # the walls from the tick after the overlapped service's first drain
    walls = slice(ONLINE_WARMUP_TICKS + 1, None)
    w_o = 1e3 * np.array([r["wall"] for r in rows[walls]])
    w_s = 1e3 * np.array([r["wall"] for r in rows_s[walls]])
    print(f"online service [{card}]: tick() over ticks {walls.start}-{len(rows) - 1}: "
          f"{w_o.mean():.3f} ms overlapped ({w_o.min():.3f}-{w_o.max():.3f}), "
          f"{w_s.mean():.3f} ms synchronous ({w_s.min():.3f}-{w_s.max():.3f}), a ratio of "
          f"{w_o.mean() / w_s.mean():.3f}; flush() {1e3 * flush_s:.3f} ms; scan_sweep "
          f"{np.mean(k8_ms[steady]):.3f} ms a steady tick; online_tick at warm-up "
          f"{[r['paid'] for r in rows[:ONLINE_WARMUP_TICKS]]}, then 0", flush=True)

    # the last tick: offline equivalence, and its launch held to plain
    last = recs[-1]
    caught = {}
    real_launch = scn_mod.scan_launch

    def capture(scn_s, bspec, dev_, samples, **kw):
        out = real_launch(scn_s, bspec, dev_, samples, **kw)
        caught.update(scn=scn_s, samples=samples, kw=kw, out=out)
        return out

    scn_mod.scan_launch = capture
    LAUNCH_COUNTS.clear()
    try:
        off = svc.offline_equivalent(last)
    finally:
        scn_mod.scan_launch = real_launch
    expect_launches(LAUNCH_COUNTS, {"scan_sweep": 1}, "15a offline_equivalent(last)")
    launches["scan_sweep"] += LAUNCH_COUNTS["scan_sweep"]
    grids_equal(off, last.grid, "15a offline_equivalent(last)")
    plain_ms, out_p = plain_timed(torch, lambda: real_launch(
        caught["scn"], PlainInGraph(torch), dev, caught["samples"], **caught["kw"]))
    err = held64(torch, caught["out"], out_p, scan64_layout(caught["scn"]),
                 "15a last tick, every event")
    errs["scan_sweep"] = max(errs["scan_sweep"], err)
    print(f"online service [{card}]: offline_equivalent(last tick) bit for bit (every metric "
          f"grid and per-cell array); its launch held to the plain f64 version (scan_ref's "
          f"scan_sweep_ref, {PLAIN_GRAPH_EVENTS}-event CUDA-graph chunks) on all {C} rows x "
          f"{caught['samples'][0].shape[1]} events: counters and state equal, max|acc diff| "
          f"{err:.3e} (plain {plain_ms:.0f} ms)", flush=True)
    del caught, out_p
    cold = [float(last.grid.cold_start_prob[i]) for i in range(len(thresholds))]
    se = [cold_se(last.grid.summaries[i]) for i in range(len(thresholds))]
    if seed == REF_ONLINE["seed"]:
        if tuple(REF_ONLINE["rates"]) != last.profile.rates:
            raise AssertionError("15a: the last tick's profile is not the JAX reference's")
        z = z_against(cold, se, REF_ONLINE["cold_start_prob"], REF_ONLINE["cold_start_prob_se"])
        if float(z.max()) > REF_ONLINE_SIGMAS:
            raise AssertionError(f"15a: a cold-start probability is {z.max():.2f} standard "
                                 "errors off REF_ONLINE")
        held = (f"within {z.max():.2f} standard errors of REF_ONLINE (limit "
                f"{REF_ONLINE_SIGMAS}; the same profile, bit for bit)")
    else:
        held = "REF_ONLINE holds for --seed 0 only: not compared"
    print(f"online service [{card}]: the last tick's cold-start % by threshold "
          + ", ".join(f"{t:.0f} s {100 * c:.4f} (se {100 * e:.4f})"
                      for t, c, e in zip(thresholds, cold, se)) + f"; {held}", flush=True)

    # ---- 15b. the same ticks on the f32 block engine (synchronous)
    blk = OnlineWhatIfService(base, OnlineConfig(**ONLINE_CONFIG,
                                                 execution=rt.Execution(backend="cuda")))
    rows_b = []
    caught_b = {}
    real_faas = fes.faas_sweep

    def capture_faas(*a, **kw):
        out = real_faas(*a, **kw)
        if len(rows_b) == len(batches) - 1:  # the last tick's launch only
            caught_b.update(args=a, kw=kw, out=out)
        return out

    fes.faas_sweep = capture_faas  # the backend's row launcher calls it by name
    try:
        for b in batches:
            blk.observe(b)
            rec, row = tick_costs(torch, LAUNCH_COUNTS, TRACE_COUNTS, blk.tick)
            rows_b.append(row)
            if rec is None or rec.grid.backend != "cuda" or not rec.grid.ok.all():
                raise AssertionError("15b: a block-engine tick gave no finite advice")
    finally:
        fes.faas_sweep = real_faas
    check_steady(rows_b, "faas_sweep", ONLINE_WARMUP_TICKS, "15b")
    launches["faas_sweep"] += len(rows_b)
    if not caught_b["kw"].get("prestamped"):
        raise AssertionError("15b: the block-engine tick did not launch prestamped")
    # the last tick's own launch held to the plain version on every event
    plain_b_ms, out_p = plain_timed(torch, lambda: faas_ref_in_graph(
        torch, caught_b["args"], caught_b["kw"]))
    K_b = caught_b["args"][5].shape[1]
    errs["faas_sweep"] = held_against_plain(torch, caught_b["out"], out_p,
                                            f"15b last tick, all {K_b} events")
    del caught_b, out_p
    last_b = blk.history[-1]
    if last_b.profile != last.profile or last_b.seed != last.seed:
        raise AssertionError("15b: the last tick's profile or seed is not 15a's")
    cold_b = [float(last_b.grid.cold_start_prob[i]) for i in range(len(thresholds))]
    se_b = [cold_se(last_b.grid.summaries[i]) for i in range(len(thresholds))]
    z_b = z_against(cold_b, se_b, cold, se)
    if float(z_b.max()) > REF_ONLINE_SIGMAS:
        raise AssertionError(f"15b: a cold-start probability is {z_b.max():.2f} combined "
                             "standard errors off 15a's f64 tick")
    print(f"online service on backend='cuda' [{card}]: {len(rows_b)} synchronous ticks, one "
          f"faas_sweep launch (prestamped) each; tick() "
          f"{1e3 * np.mean([r['wall'] for r in rows_b[steady]]):.3f} ms a steady tick; "
          f"online_tick +{rows_b[0]['paid']} at warm-up, then 0; new allocator segments "
          f"{[r['segments'] for r in rows_b]}; the last tick's launch held to the plain "
          f"version on all {C} rows x {K_b} events in CUDA-graph chunks (counters and state "
          f"equal, max|acc diff| {errs['faas_sweep']:.3e}; plain {plain_b_ms:.0f} ms); its "
          f"cold-start % by threshold "
          + ", ".join(f"{t:.0f} s {100 * c:.4f}" for t, c in zip(thresholds, cold_b))
          + f", within {z_b.max():.2f} combined standard errors of 15a's f64 tick (limit "
          f"{REF_ONLINE_SIGMAS}); last raw threshold {last_b.threshold:.0f} s (f64 engine "
          f"{last.threshold:.0f} s)", flush=True)

    # ---- 15c. the fleet service on the catalog
    names = list(catalog_names())
    fleet = fleet_of(names, n_cluster=FLEET_CLUSTER, slots=64)
    fsvc = OnlineFleetWhatIfService(fleet, OnlineConfig(**ONLINE_CONFIG))
    rng = np.random.default_rng(seed + 1)
    span = FLEET_ONLINE_TICKS * ONLINE_BATCH
    streams = {f.name: np.sort(rng.uniform(0.0, span,
                                           rng.poisson(span / f.arrival_process.mean())))
               for f in fleet.functions}
    rows_f, recs_f = [], []
    with launch_events(torch, k10, "fleet_scan_sweep") as ev:
        for i in range(FLEET_ONLINE_TICKS):
            for n, ts in streams.items():
                fsvc.observe(n, ts[(ts >= i * ONLINE_BATCH) & (ts < (i + 1) * ONLINE_BATCH)])
            rec, row = tick_costs(torch, LAUNCH_COUNTS, TRACE_COUNTS, fsvc.tick)
            rows_f.append(row)
            recs_f.append(rec)
    k10_ms = ev.ms()
    check_steady(rows_f, "fleet_scan_sweep", ONLINE_WARMUP_TICKS, "15c")
    launches["fleet_scan_sweep"] += len(rows_f)
    for rec in recs_f:
        total = 0.0  # in the service's order (sum() compensates since Python 3.12)
        for p in rec.plans.values():
            total += p.predicted_avg_replicas
        if total != rec.predicted_total_replicas or rec.headroom != FLEET_CLUSTER - total:
            raise AssertionError(
                f"15c tick {rec.tick}: the total {rec.predicted_total_replicas!r} or the "
                f"headroom {rec.headroom!r} is off its plans' {total!r}: "
                + ", ".join(f"{n} {p.predicted_avg_replicas!r}" for n, p in rec.plans.items()))
    print(f"online fleet service [{card}]: the {len(names)}-function catalog, n_cluster "
          f"{FLEET_CLUSTER}, {FLEET_ONLINE_TICKS} ticks of {len(thresholds)} thresholds x {R} "
          f"replicas = {C} fleets x {fsvc._steps} candidates a function, one fleet_scan_sweep "
          "a tick:", flush=True)
    for i, (r, rec) in enumerate(zip(rows_f, recs_f)):
        print(f"  tick {i}: tick() {1e3 * r['wall']:.3f} ms wall, fleet_scan_sweep "
              f"{k10_ms[i]:.3f} ms; online_tick +{r['paid']}, new allocator segments "
              f"{r['segments']}; predicted {rec.predicted_total_replicas:.3f} replicas, headroom "
              f"{rec.headroom:.3f}; thresholds {[int(t) for t in rec.thresholds.values()]}",
              flush=True)
    lf = recs_f[-1]
    fleet_t = fsvc._fleet.with_rates(lf.rates)
    inp = fleet_inputs(fleet_t, {"expiration_threshold": list(thresholds)}, lf.seed,
                       replicas=R, device=dev, steps=fsvc._steps, f64=True)
    launch, kw = fleet64_launch(inp, fleet_t)
    cold_k = launch().acc[..., 0].cpu().numpy()
    for c, f in np.ndindex(lf.grid.summaries.shape):
        if not np.array_equal(cold_k[c * R:(c + 1) * R, f], lf.grid.summaries[c, f].n_cold):
            raise AssertionError("15c: the relaunched last tick does not reproduce its grid")
    e, _ = hold_fleet64(torch, inp, kw, "15c last tick")
    errs["fleet_scan_sweep"] = max(errs["fleet_scan_sweep"], e)
    del inp, cold_k

    # ---- 15d. plan_fleet_thresholds over the catalog fleet
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    plan = plan_fleet_thresholds(fleet, ONLINE_SLO, candidate_thresholds=thresholds,
                                 sim_time=PLAN_SIM, replicas=R)
    plan_s = time.perf_counter() - t0
    expect_launches(LAUNCH_COUNTS, {"scan_sweep": len(names)}, "15d plan_fleet_thresholds")
    launches["scan_sweep"] += len(names)
    if plan.feasible and plan.predicted_total_replicas > FLEET_CLUSTER:
        raise AssertionError("15d: a feasible plan is over the cluster")
    print(f"fleet plan [{card}]: {len(names)} scan_sweep launches of {C} rows at sim_time "
          f"{PLAN_SIM:.0f} s, {plan_s:.3f} s wall; feasible {plan.feasible}, predicted "
          f"{plan.predicted_total_replicas:.3f} of {FLEET_CLUSTER} (headroom "
          f"{plan.cluster_headroom:.3f}); thresholds {plan.thresholds}", flush=True)

    # the same plan, small, on the kernel and on scan_ref's plain f64 loop (in
    # CUDA-graph chunks, bit for bit one eager call: phase 13)
    @register_backend("scan_ref_graph", f64=True,
                      description="scan_ref's plain f64 loop in CUDA-graph chunks")
    def _plain_rows(*a, **kw):
        return plain64_launch(torch, "scan", *a, **kw)

    small = dict(candidate_thresholds=thresholds, sim_time=PLAN_CHECK_SIM,
                 replicas=PLAN_CHECK_REPLICAS, seed=3)
    LAUNCH_COUNTS.clear()
    p_k = plan_fleet_thresholds(fleet, ONLINE_SLO, **small)
    launches["scan_sweep"] += LAUNCH_COUNTS["scan_sweep"]
    t0 = time.perf_counter()
    p_p = plan_fleet_thresholds(fleet, ONLINE_SLO, **small,
                                execution=rt.Execution(backend="scan_ref_graph"))
    plain_plan_s = time.perf_counter() - t0
    if p_k.thresholds != p_p.thresholds or p_k.feasible != p_p.feasible:
        raise AssertionError(f"15d: the kernel's plan {p_k.thresholds} is not the plain "
                             f"version's {p_p.thresholds}")
    print(f"fleet plan [{card}]: at {PLAN_CHECK_REPLICAS} replicas and {PLAN_CHECK_SIM:.0f} s "
          f"the kernel and scan_ref's plain loop ({plain_plan_s:.1f} s) plan the same "
          f"thresholds {p_k.thresholds}", flush=True)

    # ---- 15e. sweep_legacy on Fig. 5's grid against one sweep()
    scn5 = table1(rt, sim_time=FIG5_SIM)
    cells = len(FIG5_RATES) * len(FIG5_THRESHOLDS)
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    legacy = sweep_legacy(scn5, FIG5_RATES, FIG5_THRESHOLDS, 1, replicas=FIG5_REPLICAS)
    legacy_s = time.perf_counter() - t0
    expect_launches(LAUNCH_COUNTS, {"scan_sweep": cells}, "15e sweep_legacy")
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    grid5 = rt.sweep(scn5, {"expiration_threshold": FIG5_THRESHOLDS,
                            "arrival_rate": FIG5_RATES}, 1, replicas=FIG5_REPLICAS)
    grid5_s = time.perf_counter() - t0
    expect_launches(LAUNCH_COUNTS, {"scan_sweep": 1}, "15e sweep")
    launches["scan_sweep"] += cells + 1
    for m in ("cold_start_prob", "avg_server_count", "avg_running_count", "wasted_ratio",
              "developer_cost", "provider_cost"):
        if not np.array_equal(getattr(legacy, m), getattr(grid5, m)):
            raise AssertionError(f"15e: sweep_legacy's {m} is not sweep()'s")
    print(f"sweep_legacy [{card}]: Fig. 5's {len(FIG5_THRESHOLDS)} x {len(FIG5_RATES)} grid "
          f"at {FIG5_SIM:.0f} s, {FIG5_REPLICAS} replicas: {cells} launches in "
          f"{legacy_s:.3f} s wall, one sweep() launch in {grid5_s:.3f} s, equal cell by cell "
          f"bit for bit; cold start % at (600 s, 1/s) {100 * grid5.cold_start_prob[2, 2]:.3f}",
          flush=True)
    print(f"online phase: {time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return launches, errs


# ---- the grid-sharding phase (module docstring, item 16)
SHARD_TWINS = 2  # the one-card plan: the grid in this many shards on cuda:0


@contextlib.contextmanager
def shard_timer(torch, backend, engine):
    """CUDA events around every row launch of ``backend``'s ``engine``
    launcher, on the current stream of the launch's device; yields the
    list of ``(device, start, end)`` the launches add, in launch order."""
    from repro_torch.core.execution import resolve_backend

    launchers = resolve_backend(backend).launchers
    real = launchers[engine]
    marks = []

    def timed_launch(*args, **kw):
        dev = args[0].device
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
        out = real(*args, **kw)
        end.record(torch.cuda.current_stream(dev))
        marks.append((dev, start, end))
        return out

    launchers[engine] = timed_launch
    try:
        yield marks
    finally:
        launchers[engine] = real


def sharding_phase(torch, rt, card):
    """The grid-sharding phase (module docstring, item 16); returns the
    phase's launches by kernel, counted by ``LAUNCH_COUNTS``."""
    import dataclasses

    from repro_torch.data.catalog import catalog_names, fleet_of
    from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS

    t_phase = time.perf_counter()
    n_gpus = torch.cuda.device_count()
    twice = rt.Execution(devices=("cuda:0",) * SHARD_TWINS, shard="grid")
    # in turns on the one card: unsharded, sharded, sharded, unsharded; then
    # every visible card where there are more
    turns = [("unsharded", None), (f"{SHARD_TWINS} shards on cuda:0", twice),
             (f"{SHARD_TWINS} shards on cuda:0", twice), ("unsharded", None)]
    if n_gpus > 1:
        turns.append((f"{n_gpus} GPUs", rt.Execution(devices=n_gpus, shard="grid")))
    else:
        print(f"sharding [{card}]: 1 GPU visible: each grid runs unsharded and in "
              f"{SHARD_TWINS} shards on cuda:0 (the cost of splitting, not a speed-up); "
              "no multi-GPU run", flush=True)
    scn = table1(rt)
    fleet = fleet_of(list(catalog_names()), n_cluster=FLEET_CLUSTER, skip_time=20.0, slots=64)
    fover = {"expiration_threshold": FLEET_THRESHOLDS}
    cells = [
        ("16a Table-1 sweep()", "scan_sweep", "scan", "scan",
         lambda ex: rt.sweep(scn, SWEEP_OVER, seed=0, replicas=SWEEP_REPLICAS, execution=ex)),
        ("16b Table-1 sweep()", "faas_sweep", "cuda", "scan",
         lambda ex: rt.sweep(scn, SWEEP_OVER, seed=0, replicas=SWEEP_REPLICAS, execution=ex)),
        ("16c Table-1 sweep(deferred=True)", "scan_sweep", "scan", "scan",
         lambda ex: rt.sweep(scn, SWEEP_OVER, seed=0, replicas=SWEEP_REPLICAS, execution=ex,
                             deferred=True).result()),
        ("16d catalog fleet_sweep()", "fleet_scan_sweep", "scan", "fleet",
         lambda ex: rt.fleet_sweep(fleet, fover, 5, replicas=FLEET_REPLICAS, execution=ex)),
    ]
    launches = {}
    for what, key, backend, engine, call in cells:
        ref = None
        for label, plan in turns:
            ex = rt.Execution(backend=backend) if plan is None else dataclasses.replace(
                plan, backend=backend)
            want = {key: ex.n_devices if plan is not None else 1}
            torch.cuda.synchronize()
            LAUNCH_COUNTS.clear()
            with shard_timer(torch, backend, engine) as marks:
                t0 = time.perf_counter()
                grid = call(ex)
                wall = time.perf_counter() - t0
            expect_launches(LAUNCH_COUNTS, want, f"{what} on {backend}, {label}")
            launches[key] = launches.get(key, 0) + LAUNCH_COUNTS[key]
            torch.cuda.synchronize()
            if ref is None:
                ref = grid
                if not grid.ok.all():
                    raise AssertionError(f"{what} on {backend}: cells not finite")
            else:
                grids_equal(grid, ref, f"{what} on {backend}, {label}")
            shards = "; ".join(f"{d} {s.elapsed_time(e):.3f} ms" for d, s, e in marks)
            print(f"sharding [{card}]: {what} on {backend}, {label}: {len(marks)} launch(es) "
                  f"[{shards}], {wall:.3f} s wall"
                  + ("" if plan is None else "; every cell equal to the unsharded grid bit "
                     "for bit"), flush=True)
    print(f"sharding phase: {time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return launches


def main() -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the non-stationary and online phases' draws and streams")
    opts = ap.parse_args()
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

    # ---- 2. build, one nvcc per source, in the background: phase 3's plain
    # versions (CPU-bound launches of small torch ops) run meanwhile
    built, build_error = {}, []

    def build():
        try:
            built.update(_build.build_all(SOURCES))
        except Exception as e:  # re-raised once the plain versions are done
            build_error.append(e)

    builder = threading.Thread(target=build)
    builder.start()

    # ---- 3. kernels vs plain versions on the card, small shapes: the plain
    # versions first, then each kernel on the same inputs
    C, M, K = 256, 64, 4096
    plain_small_ms = None
    faas_cases = []
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
        plain_small_ms, out_p = plain_timed(torch, lambda: faas_sweep_ref(*args, **kw))
        faas_cases.append((case, t_exp, max_c, prestamped, args, kw, out_p))

    par_cases = []
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
        ms_p, out_p = plain_timed(torch, lambda: faas_par_sweep_ref(rows[0], *samples, **kw))
        par_cases.append((case, c, t_exp, max_c, prestamped, rows[0], samples, kw, ms_p, out_p))

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
    grid_kw = dict(t_end=to(horizon * rng.uniform(0.5, 0.9, C)), skip=0.0,
                   max_concurrency=1000, grid_times=to(np.tile(grid_small, (C, 1))))
    grid_args = (*pool, torch.zeros((C,), dtype=torch.float32, device=dev),
                 to(60.0 * rng.uniform(0.5, 1.5, C)), *samples)
    grid_ms_p, grid_out_p = plain_timed(torch, lambda: faas_sweep_ref(*grid_args, **grid_kw))

    builder.join()
    if build_error:
        raise build_error[0]
    for name, info in built.items():
        print(f"build: {name} in {info['seconds']:.1f} s -> {info['path'].name}")
        if name in KERNEL_NAMES:
            print_ptxas(info["log"], KERNEL_NAMES[name])
        elif name.endswith("_scan"):
            print_scan_ptxas(info["log"])
        else:
            print_attention_ptxas(info["log"])
    sys.stdout.flush()

    for case, t_exp, max_c, prestamped, args, kw, out_p in faas_cases:
        out_k = faas_sweep(*args, **kw)
        err = held_against_plain(torch, out_k, out_p, f"faas case {case}")
        errs["faas_sweep"] = max(errs["faas_sweep"], err)
        tot = out_k[4].sum(0).tolist()
        print(f"kernel==plain faas case {case}: t_exp~{t_exp} max_c={max_c} "
              f"prestamped={prestamped} cold={tot[0]:.0f} warm={tot[1]:.0f} "
              f"reject={tot[2]:.0f} overflow={tot[7]:.0f} max|acc diff|={err:.3e}",
              flush=True)
        if max_c == 4 and tot[2] <= 0:
            raise AssertionError("the max_concurrency=4 case made no rejections")
    del faas_cases

    for case, c, t_exp, max_c, prestamped, thr, samples, kw, ms_p, out_p in par_cases:
        out_k = par_sweep(thr, *samples, **kw)
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
    del par_cases

    out_k = faas_sweep(*grid_args, **grid_kw)
    err = held_against_plain(torch, out_k, grid_out_p, "faas grid case")
    errs["faas_sweep_grid"] = err
    gsum = out_k[4][:, 8:].sum(0)
    print(f"kernel==plain faas grid case: C={C} M={M} K={K} G={G}, "
          f"{int(live.sum())} live instances at t=0; running counts "
          f"{gsum[:G].sum().item():.0f}, idle {gsum[G:2 * G].sum().item():.0f}, "
          f"no-idle points {gsum[2 * G:].sum().item():.0f}; grid columns and "
          f"counters equal; max|acc diff|={err:.3e} (plain {grid_ms_p:.0f} ms)", flush=True)
    if gsum[:G].sum() <= 0 or gsum[G:2 * G].sum() <= 0:
        raise AssertionError("the grid case counted no running or no idle instance")
    del grid_args, grid_kw, grid_out_p

    print(f"build and small-shape phase {time.perf_counter() - t_start:.1f} s; script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 4. the main paths through the entry points a user calls
    t_main = time.perf_counter()
    scn = table1(rt)
    torch.cuda.reset_peak_memory_stats()
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    grid = rt.sweep(scn, SWEEP_OVER, seed=0, replicas=SWEEP_REPLICAS, backend="cuda")
    sweep_s = time.perf_counter() - t0
    staged_peak = torch.cuda.max_memory_allocated()
    sweep_launches = LAUNCH_COUNTS["faas_sweep"]
    if sweep_launches < 1:
        raise AssertionError("sweep() did not launch the faas_sweep kernel")
    if not grid.ok.all():
        raise AssertionError(f"{int((~grid.ok).sum())} sweep cells are not finite")
    servers = float(grid.sel(arrival_rate=0.9, expiration_threshold=600.0).avg_server_count)
    print(f"sweep: {grid.shape} cells x {SWEEP_REPLICAS} replicas, "
          f"{sweep_launches} launch(es), {sweep_s:.2f} s wall, peak "
          f"{staged_peak / 2**30:.3f} GiB on the card; "
          f"(0.9/s, 600 s) avg servers {servers:.4f} (paper {PAPER_SERVERS})", flush=True)
    if abs(servers / PAPER_SERVERS - 1) > 0.05:
        raise AssertionError("the Table-1 cell is more than 5% from the paper")

    LAUNCH_COUNTS.clear()
    res = rt.run(table1(rt, sim_time=2e5), seed=1, replicas=64, backend="cuda")
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
        par_res[c] = rt.run(fig1(rt, c), seed=2, replicas=FULL_REPLICAS, engine="par",
                            backend="cuda")
        par_wall[c] = time.perf_counter() - t0
    par_launches = LAUNCH_COUNTS["par_sweep"]
    if par_launches != len(PAR_CS) or LAUNCH_COUNTS["faas_sweep"]:
        raise AssertionError(f"run(engine='par') launches: {dict(LAUNCH_COUNTS)}")
    base_c1 = rt.run(fig1(rt, 1), seed=2, replicas=FULL_REPLICAS, backend="cuda")
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
                   grid=TEMPORAL_GRID, initial_instances=snaps, backend="cuda")
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

    print(f"main-path phase {time.perf_counter() - t_main:.1f} s; script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 5. timing at the main paths' full widths, and the plain versions there
    t_main = time.perf_counter()
    inp = sweep_inputs(scn, SWEEP_OVER, 0, replicas=SWEEP_REPLICAS, device=dev)
    dts, warms, colds = inp.samples
    Cw, Kw = dts.shape
    row = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    args = (*fresh_pools(torch, Cw, scn.slots, dev), row(inp.thr_rows), dts, warms, colds)
    kw = dict(t_end=row(inp.sim_rows), skip=row(inp.skip_rows),
              max_concurrency=scn.max_concurrency)
    ms, out_k = timed(torch, lambda: faas_sweep(*args, **kw), reps=3)
    # the inert tail alone: the same launch with every horizon before the
    # first event, so that each 32-event batch only moves the clock
    tail_kw = dict(kw, t_end=torch.full_like(kw["t_end"], -1.0), skip=-2.0)
    tail_ms, _ = timed(torch, lambda: faas_sweep(*args, **tail_kw), reps=3)
    pargs = (*args[:5], *(prefix(x, F32_PLAIN_EVENTS) for x in args[5:]))
    plain_ms, out_p = plain_timed(torch, lambda: faas_ref_in_graph(torch, pargs, kw))
    errs["faas_sweep"] = max(errs["faas_sweep"], held_against_plain(
        torch, faas_sweep(*pargs, **kw), out_p, f"first {F32_PLAIN_EVENTS} events"))
    # the kernel steps every staged event; only those inside a row's
    # horizon are arrivals the sweep asked for
    events = Cw * Kw
    active = arrivals_in_horizon(dts, kw["t_end"])
    past = events - active
    counted = int(out_k[4][:, :3].double().sum())
    b_ms, b_by = bound_ms(Cw, scn.slots, Kw, active)
    b_all_ms, _ = bound_ms(Cw, scn.slots, Kw, events)
    print(f"timing [{card}]: faas_sweep C={Cw} M={scn.slots} K={Kw}: {ms:.3f} ms; "
          f"{active} arrivals in horizon ({100 * active / events:.1f}% of the "
          f"{events} staged events; {counted} past skip) = "
          f"{active / ms * 1e3:.4e} arrivals/s, {events / ms * 1e3:.4e} events "
          f"stepped/s; bound {b_ms:.3f} ms ({b_by}), {b_all_ms:.3f} ms if "
          f"every staged event were stepped; plain version {plain_ms:.1f} ms on the first "
          f"{F32_PLAIN_EVENTS} events in CUDA-graph chunks (max|acc diff| "
          f"{errs['faas_sweep']:.3e}); plain at C={C} M={M} K={K}: "
          f"{plain_small_ms:.1f} ms", flush=True)
    print(f"timing [{card}]: faas_sweep's inert tail: {past} events past their horizons "
          f"({100 * past / events:.1f}%); with every event past t_end the launch takes "
          f"{tail_ms:.3f} ms, so the tail is ~{100 * tail_ms * past / events / ms:.1f}% of the "
          f"{ms:.3f} ms", flush=True)
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
    plain_ms, out_p = plain_timed(torch, lambda: faas_ref_in_graph(torch, args, kw))
    errs["faas_sweep_grid"] = max(errs["faas_sweep_grid"], held_against_plain(
        torch, out_k, out_p, "temporal full width"))
    if not np.array_equal(out_k[4][:, 8:].double().mean(0).cpu().numpy()[:G], tm.running_at):
        raise AssertionError("the timed grid launch does not reproduce run()'s curves")
    active = arrivals_in_horizon(dts, kw["t_end"])
    hits = Ct * int((TEMPORAL_GRID > 0).sum())  # every point past t = 0 is hit once
    b_ms, b_by = bound_ms(Ct, scn_t.slots, n_t, active, G=G, grid_hits=hits)
    print(f"timing [{card}]: faas_sweep with grid C={Ct} M={scn_t.slots} K={n_t} G={G}: "
          f"{ms:.3f} ms; {active} arrivals in horizon = {active / ms * 1e3:.4e} "
          f"arrivals/s; bound {b_ms:.3f} ms ({b_by}); plain version {plain_ms:.1f} ms "
          f"in CUDA-graph chunks (grid columns and counters equal, max|acc diff| "
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
    for c in PAR_CS:
        kw = dict(t_end=full(sp.sim_time), skip=full(sp.skip_time),
                  max_concurrency=sp.max_concurrency, concurrency=c, slots=sp.slots)
        ms, out_k = timed(torch, lambda: par_sweep(full(sp.expiration_threshold),
                                                   dts, warms, colds, **kw), reps=3)
        if not np.array_equal(out_k[4][:, 0].double().cpu().numpy(), par_res[c].summary.n_cold):
            raise AssertionError(f"the timed par launch at c={c} does not reproduce run()")
        # live instances at arrivals: by PASTA, the time average of the run
        live = active * par_res[c].summary.avg_server_count
        b_ms, b_by = par_bound_ms(Cp, sp.slots, c, K_par, active, live)
        # the plain version is held to the kernel on the first events
        part = [x[:, :PAR_PLAIN_EVENTS].contiguous() for x in (dts, warms, colds)]
        out_k = par_sweep(full(sp.expiration_threshold), *part, **kw)
        plain_ms, out_p = plain_timed(torch, lambda: plain_in_graph(
            torch, lambda st, part: faas_par_sweep_ref(
                full(sp.expiration_threshold), *part, state0=st, **kw), part))
        held = f"first {PAR_PLAIN_EVENTS} of {K_par} events in CUDA-graph chunks"
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
    del dts, warms, colds
    torch.cuda.empty_cache()

    print(f"full-width timing phase {time.perf_counter() - t_main:.1f} s; script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 6. fleets
    t0 = time.perf_counter()
    results["fleet_sweep"], errs["fleet_sweep"] = fleet_phase(torch, rt, dev, card)
    print(f"fleet phase {time.perf_counter() - t0:.1f} s; script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 7. serving
    t0 = time.perf_counter()
    serve_results, serve_errs = serving_phase(torch, dev, card)
    results.update(serve_results)
    errs.update(serve_errs)
    print(f"serving phase {time.perf_counter() - t0:.1f} s; script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 8. serving the recurrent archs
    t0 = time.perf_counter()
    rec_results, rec_errs = recurrent_phase(torch, dev, card)
    results.update(rec_results)
    for name, e in rec_errs.items():
        errs[name] = max(errs[name], e)
    print(f"recurrent serving phase {time.perf_counter() - t0:.1f} s; script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 9. metric windows, reliability and retries
    t0 = time.perf_counter()
    rely_results, rely_errs = reliability_phase(torch, rt, dev, card, grid)
    results.update(rely_results)
    errs.update(rely_errs)
    print(f"reliability phase {time.perf_counter() - t0:.1f} s; script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 10. fused draws
    t0 = time.perf_counter()
    fused_results, fused_errs = fused_phase(torch, rt, dev, card, grid, staged_peak)
    results.update(fused_results)
    errs.update(fused_errs)
    print(f"fused draw phase {time.perf_counter() - t0:.1f} s; script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 11. platform faults
    t0 = time.perf_counter()
    fault_results, fault_errs = faults_phase(torch, rt, dev, card)
    results.update(fault_results)
    errs.update(fault_errs)
    print(f"fault phase {time.perf_counter() - t0:.1f} s; script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 12. non-stationary workloads
    t0 = time.perf_counter()
    ns_results, ns_errs = nonstationary_phase(torch, rt, dev, card, opts.seed)
    results.update(ns_results)
    for name, e in ns_errs.items():
        errs[name] = max(errs[name], e)
    print(f"non-stationary phase {time.perf_counter() - t0:.1f} s; script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 13. the f64 engine
    t0 = time.perf_counter()
    scan_results, scan_errs, staged64 = scan64_phase(torch, rt, dev, card)
    results.update(scan_results)
    errs.update(scan_errs)
    print(f"f64 engine phase {time.perf_counter() - t0:.1f} s; script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 14. the f64 fleet scan and the f64 engine's fused draws
    t0 = time.perf_counter()
    f14_results, f14_errs = fleet64_fused_phase(torch, rt, dev, card, staged64)
    results.update(f14_results)
    errs.update(f14_errs)
    del staged64
    print(f"f64 fleet and fused phase {time.perf_counter() - t0:.1f} s; script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 15. the online what-if service, the fleet planner, sweep_legacy
    t0 = time.perf_counter()
    online_launches, online_errs = online_phase(torch, rt, dev, card, opts.seed)
    for name, n in online_launches.items():
        results[name]["launches"] += n
    for name, e in online_errs.items():
        errs[name] = max(errs[name], e)
    print(f"online phase {time.perf_counter() - t0:.1f} s; script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 16. grid sharding through sweep() and fleet_sweep()
    t0 = time.perf_counter()
    for name, n in sharding_phase(torch, rt, card).items():
        results[name]["launches"] += n
    print(f"sharding phase {time.perf_counter() - t0:.1f} s; script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 17. kernels line, card line, device line
    print(json.dumps({"kernels": [
        dict(KERNELS[k], **dict(dict(library_ms=None), **results[k]), max_abs_err=errs[k])
        for k in KERNELS
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
