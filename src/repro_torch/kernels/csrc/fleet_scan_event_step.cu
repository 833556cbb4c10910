// Hopper (sm_90a) kernel of the f64 fleet scan (backend "scan", fleets).
//
// No Pallas kernel is replaced: the reference runs this loop as a lax.scan
// over repro/core/fleet.py::_make_fleet_step, then _fleet_flush (its f32
// twin, the Pallas _fleet_kernel, is fleet_event_step.cu's).  A fleet (one
// what-if cell x one replica) is F function pools of M slots under one
// cluster capacity ncl, running the K events of its stream row (f32 gaps
// or f64 times, the acting function's id, its warm and cold samples), in
// f64.  Per event, in the reference's order:
//   1. every pool integrates running and idle instance-time over the
//      interval clipped to [skip, t_end] (cut at each slot's crash clock);
//   2. every pool's instances with min(busy + t_exp, doom) <= t leave, with
//      their lifespans (an exit in (skip, t_end]) and crashes (doom strictly
//      before the expiry, in (skip, t_end]);
//   3. capacity churn: inside the horizon, the newest idle instances
//      fleet-wide above the ceiling in effect leave (creation, then the
//      lower flat id f*M + m on a tie), counted past skip;
//   4. inside the horizon, up to Q drain passes serve the acting function's
//      queue head: warm on its newest idle instance (lowest slot on a
//      tie), else cold under its limit, a free slot and the cluster
//      capacity; the first pass that serves nothing ends the drain (it
//      changes nothing, so neither would the passes after it);
//   5. inside the horizon the arrival: warm on the newest idle instance,
//      else cold under the limit, a free slot, ncl (and the ceiling), else
//      the queue if it has room, else rejected; a cold start stamps the
//      crash clock t + (-log(1 - u) / crash_rate) from the event's crash
//      uniform, and an arrival whose instance dies before its service ends
//      is interrupted;
//   6. the peak live count, on every event;
// then the tail flush: the lifespans and crashes of exits in (t_last,
// t_end].  Counters engage past skip; overflow (an arrival below its limit
// that finds no free slot) only needs the horizon.
//
// What bounds it on this card: operations, in a sequential chain per
// fleet: each event needs the exit test and the integrals of every live
// instance, the idle test and the newest key of the acting function's live
// instances, and O(1) scalar work, against 13 to 17 bytes of stream read
// once for every cell that shares it.
//
// What the design does about that (kernel 8's structure, scan_event_step.cu
// and scan64_common.cuh, with fleet_event_step.cu's fleet state):
//   - One warp per fleet.  The live instances sit in a compact table of L
//     entries a lane (function and slot, the creation's 64-bit order key,
//     busy, expiry and, with faults, the crash clock, in registers); the
//     host bounds the live count (core/fleet.py live_bound) and the launch
//     takes the narrowest L that holds it: L = 1 at the catalog's ncl = 24.
//     A cold start takes the lowest empty entry; a fleet that finds none
//     (a bound below the true count) gets NaN outputs.
//   - The alive bitmap is F x ceil(M/32) words in this warp's shared
//     memory, so the acting function's lowest free slot and live count are
//     one word a lane and a ballot: no limit on F but shared memory's.
//   - The per-function accumulators (18 f64 columns with faults) are in
//     this warp's shared memory too, and only lane 0 adds to them, in the
//     order the warp visits the changes (an exit pass walks the entries
//     that leave entry by entry, lanes in order), so two runs give the same
//     bits.
//   - The integrals are accrued per state span (scan64_common.cuh accrue):
//     a state adds accrue(hi) when it starts and gives back accrue(hi) when
//     it ends early (a warm start, an eviction; an exit accrues nothing past
//     its exit clock).  Where the clipped clock goes back (unsorted f64
//     times, negative gaps) every live state adds accrue(hi) -
//     accrue(hi_prev), the interval the reference counts again.
//   - Exits run only once the clock reaches a lower bound of the fleet's
//     earliest exit (lowered at each start, exact after each exit pass).
//   - Routing on order keys: the newest idle entry of the acting function
//     (or, for evictions, of the fleet) is two 32-bit reduxes of the
//     creation's key and one of the slot (or flat id) among the ties.
//   - The queues are rings (a head and a length a function) of (t, warm,
//     cold) f64 triples in shared memory, the same FIFO as the reference's
//     shifted arrays; they come out shifted, head first, NEG past the
//     length.
//   - Busy, creation and crash clocks are written through to the output
//     planes at each assignment by the slot's own lane, so dead slots keep
//     their last values as the reference's arrays do.
// Arithmetic is the plain version's (kernels/ref64.py fleet_scan_sweep_ref):
// each clock, finish, expiry and lifetime is one rounded f64 operation
// (built with --fmad=false), decisions compare the same values, and every
// counter, response sum, queue wait and the peak are sequential in event
// order, so they are equal bit for bit, as are the final pools, crash
// clocks and queues.  ∫running, ∫idle and Σlifespan add the same pieces in
// another order, so they agree to rounding.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "scan64_common.cuh"

using namespace scan64;

namespace {

constexpr int COLS = 15;        // per function (ref64.FLEET64_COLS)
constexpr int FAULT_COLS = 3;   // crashes, evictions, interrupted arrivals
constexpr int PEAK = 14;
constexpr int MAX_TABLE = 32;   // table entries a lane: 1,024 live instances
constexpr int MAX_SLOTS = 1024; // slots a function: 32 bitmap words

struct Args {
  const double* t_exp;  // [N, F]
  const double* limit;  // [N, F]
  const double* ncl;    // [N]
  const double* t_end;  // [N]
  const double* skip;   // [N]
  const long long* stream;  // [N]
  const void* times;    // [S, K] f32 gaps, or f64 times (times_f64)
  const uint8_t* fids;  // [S, K]
  const float* warms;   // [S, K]
  const float* colds;   // [S, K]
  const double* crash_rate;  // [N] (crashes)
  const float* crash_u;      // [S, K] (crashes)
  const double* cap_edges;   // [N, E] (capacity)
  const double* cap_values;  // [N, E+1] (capacity)
  uint8_t* alive_out;   // [N, F, M]
  double* creation_out; // [N, F, M]
  double* busy_out;     // [N, F, M]
  double* doom_out;     // [N, F, M] (crashes)
  double* t_out;        // [N]
  double* acc_out;      // [N, F, cols]
  double* qleft_out;    // [N, F]
  double* queue_out;    // [N, F, Q, 3] (Q > 0)
  int N, F, M, K, Q, E, S;
  int prestamped, times_f64, warps;
};

// this warp's shared memory: accumulators [F, cols], t_exp [F], limit [F],
// queue rings [F, Q, 3], then the bitmap [F, SF] and the rings' heads and
// lengths [F] each
__host__ __device__ inline size_t warp_smem(int F, int Q, int SF, int cols) {
  const size_t d = (size_t)F * cols + 2 * (size_t)F + 3 * (size_t)F * Q;
  const size_t u = (size_t)F * SF + 2 * (size_t)F;
  return ((8 * d + 4 * u + 15) / 16) * 16;
}

template <int L, bool FAULT>
struct Table {
  unsigned used = 0u;  // bit j: entry j holds a live instance
  int id[L];           // (function << 16) | slot
  u64 ck[L];           // okey(creation)
  double bsy[L], ex[L];
  double dm[FAULT ? L : 1];
  __device__ __forceinline__ double doom(int j) const {
    return FAULT ? dm[FAULT ? j : 0] : INFINITY;
  }
};

// The newest idle entry of function fa (fa < 0: of any function) at clock
// t, by the creation's order key, then the lowest slot (flat id f*M + m for
// fa < 0): the lane's own candidate and the warp's.
struct Newest {
  u64 key, best;
  unsigned idx, best_idx;
  int ent;
  __device__ __forceinline__ bool mine() const {
    return key != 0ull && key == best && idx == best_idx;
  }
};

template <int L, bool FAULT>
__device__ __forceinline__ Newest newest(const Table<L, FAULT>& p, int fa, int M, double t) {
  Newest n;
  n.key = 0ull;
  n.idx = UINT_MAX;
  n.ent = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int g = p.id[j] >> 16, m = p.id[j] & 0xffff;
    const bool cand = ((p.used >> j) & 1u) && (fa < 0 || g == fa) && p.bsy[j] <= t;
    const u64 k = cand ? p.ck[j] : 0ull;
    const unsigned x = fa < 0 ? (unsigned)(g * M + m) : (unsigned)m;
    if (k > n.key || (k != 0ull && k == n.key && x < n.idx)) {
      n.key = k;
      n.idx = x;
      n.ent = j;
    }
  }
  n.best = warp_max_key(n.key);
  n.best_idx = n.best != 0ull
                   ? __reduce_min_sync(FULL, n.key == n.best ? n.idx : UINT_MAX)
                   : UINT_MAX;
  return n;
}

// Function fa's lowest free slot (-1 if none) and live count, from its
// bitmap words (lane q reads word q).
__device__ __forceinline__ void slots_of(const unsigned* bits, int fa, int M, int SF, int lane,
                                         int& first_free, int& n_alive) {
  const unsigned w = lane < SF ? bits[fa * SF + lane] : FULL;
  const int left = M - lane * 32;
  const unsigned valid = lane < SF ? (left >= 32 ? FULL : (1u << left) - 1u) : 0u;
  n_alive = (int)__reduce_add_sync(FULL, (unsigned)__popc(w & valid));
  const unsigned fr = ~w & valid;
  const unsigned has = __ballot_sync(FULL, fr != 0u);
  first_free = -1;
  if (has) {
    const int q = __ffs(has) - 1;
    const unsigned word = __shfl_sync(FULL, fr, q);
    first_free = q * 32 + __ffs(word) - 1;
  }
}

template <int L, bool FAULT, bool QUEUE>
__global__ void __launch_bounds__(128) fleet_scan_kernel(const Args a) {
  extern __shared__ double smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int fleet = blockIdx.x * a.warps + wib;
  if (fleet >= a.N) return;  // the ragged last block: the whole warp leaves
  const int F = a.F, M = a.M, K = a.K, Q = QUEUE ? a.Q : 0;
  const int SF = (M + 31) >> 5;
  const bool crashes = FAULT && a.crash_u != nullptr;
  const bool capped = FAULT && a.cap_values != nullptr;
  const int cols = COLS + (FAULT ? FAULT_COLS : 0);
  const double qnan = __longlong_as_double(0x7ff8000000000000ll);
  const size_t fm = (size_t)fleet * F;
  double* acc_g = a.acc_out + fm * cols;

  const long long row = a.stream[fleet];
  if (row < 0 || row >= a.S) {  // no stream row to read: the fleet's outputs are NaN
    for (int i = lane; i < F * cols; i += 32) acc_g[i] = qnan;
    for (int i = lane; i < F; i += 32) a.qleft_out[fm + i] = qnan;
    if (lane == 0) a.t_out[fleet] = qnan;
    return;
  }

  // this warp's shared memory
  double* accs = (double*)((char*)smem + (size_t)wib * warp_smem(F, Q, SF, cols));
  double* texp_s = accs + (size_t)F * cols;
  double* lim_s = texp_s + F;
  double* ring = lim_s + F;  // [F, Q, 3]
  unsigned* bits = (unsigned*)(ring + (size_t)F * Q * 3);
  int* qhead = (int*)(bits + (size_t)F * SF);
  int* qlen = qhead + F;
  for (int i = lane; i < F * cols; i += 32) accs[i] = 0.0;
  for (int i = lane; i < F; i += 32) {
    texp_s[i] = a.t_exp[fm + i];
    lim_s[i] = a.limit[fm + i];
    qhead[i] = 0;
    qlen[i] = 0;
  }
  for (int i = lane; i < F * SF; i += 32) bits[i] = 0u;
  // the pools' planes: empty slots, written through at each assignment
  uint8_t* alive_g = a.alive_out + fm * M;
  double* cre_g = a.creation_out + fm * M;
  double* busy_g = a.busy_out + fm * M;
  double* doom_g = crashes ? a.doom_out + fm * M : nullptr;
  for (int i = lane; i < F * M; i += 32) {
    cre_g[i] = NEG;
    busy_g[i] = NEG;
    if (crashes) doom_g[i] = INFINITY;
  }
  __syncwarp();

  const double ncl = a.ncl[fleet], tend = a.t_end[fleet], skp = a.skip[fleet];
  const double crate = crashes ? a.crash_rate[fleet] : 0.0;
  const double* ce = capped ? a.cap_edges + (size_t)fleet * a.E : nullptr;
  const double* cv = capped ? a.cap_values + (size_t)fleet * (a.E + 1) : nullptr;
  double cap_now = 0.0, cap_lo = INFINITY, cap_hi = -INFINITY;

  Table<L, FAULT> p;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    p.id[j] = 0;
    p.ck[j] = 0ull;
    p.bsy[j] = NEG;
    p.ex[j] = NEG;
    if (FAULT) p.dm[FAULT ? j : 0] = INFINITY;
  }
  int live = 0;
  bool broken = false;
  double next_exit = INFINITY, peak = 0.0, t = 0.0;
  double hi_prev = fmin(fmax(t, skp), tend);

  // lane 0 adds v to function g's column c
  const auto add = [&](int g, int c, double v) {
    if (lane == 0) accs[g * cols + c] += v;
  };

  // Every live state's accrual moves from clipped clock `from0` to `to`:
  // function g gains accrue(to) - accrue(from0) of each of its states,
  // entry by entry, lanes in order.
  const auto settle = [&](double to, double from0) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const bool u = (p.used >> j) & 1u;
      double dr = 0.0, di = 0.0;
      if (u) {
        double ra, ia, rb, ib;
        accrue(p.bsy[j], p.ex[j], p.doom(j), to, tend, ra, ia);
        accrue(p.bsy[j], p.ex[j], p.doom(j), from0, tend, rb, ib);
        dr = ra - rb;
        di = ia - ib;
      }
      unsigned lanes = __ballot_sync(FULL, u);
      while (lanes) {
        const int src = __ffs(lanes) - 1;
        lanes &= lanes - 1;
        const int g = __shfl_sync(FULL, p.id[j], src) >> 16;
        const double r = __shfl_sync(FULL, dr, src), i = __shfl_sync(FULL, di, src);
        add(g, 3, r);
        add(g, 4, i);
      }
    }
  };

  // The exit pass at clock tn (clipped hi): entries whose exit clock is at
  // or before tn leave, with their lifespans and crashes; each gives back
  // what it accrued past hi.
  const auto exit_pass = [&](double tn, double hi) {
    unsigned gone = 0u;
    double nx = INFINITY;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if ((p.used >> j) & 1u) {
        const double x = FAULT ? fmin(p.ex[j], p.doom(j)) : p.ex[j];
        if (x <= tn)
          gone |= 1u << j;
        else
          nx = fmin(nx, x);
      }
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      unsigned lanes = __ballot_sync(FULL, (gone >> j) & 1u);
      if (!lanes) continue;  // warp-uniform
      const bool mine = (gone >> j) & 1u;
      const double d = p.doom(j), e = p.ex[j];
      const double x = FAULT ? fmin(e, d) : e;
      double r = 0.0, i = 0.0;
      if (mine) accrue(p.bsy[j], e, d, hi, tend, r, i);
      const double life = x - key_value(p.ck[j]);
      const int flags = (x > skp && x <= tend ? 1 : 0) |
                        (FAULT && d < e && d > skp && d <= tend ? 2 : 0);
      while (lanes) {
        const int src = __ffs(lanes) - 1;
        lanes &= lanes - 1;
        const int id = __shfl_sync(FULL, p.id[j], src);
        const int g = id >> 16, m = id & 0xffff;
        const double rs = __shfl_sync(FULL, r, src), is = __shfl_sync(FULL, i, src);
        const double ls = __shfl_sync(FULL, life, src);
        const int fl = __shfl_sync(FULL, flags, src);
        add(g, 3, -rs);
        add(g, 4, -is);
        if (fl & 1) {
          add(g, 7, ls);
          add(g, 8, 1.0);
        }
        if (FAULT && (fl & 2)) add(g, COLS, 1.0);
        if (lane == 0) bits[g * SF + (m >> 5)] &= ~(1u << (m & 31));
        --live;
      }
    }
    p.used &= ~gone;
    next_exit = warp_min(nx);
    __syncwarp();
  };

  // A warm start of the routed entry r of function fa, busy until fin:
  // its lane swaps the accrual; returns the instance's crash clock.
  const auto warm_start = [&](const Newest& r, int fa, double hi, double fin, double texp) {
    const bool win = r.mine();
    double dr = 0.0, di = 0.0, dc = INFINITY;
    int m = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (win && j == r.ent) {
        const double d = p.doom(j);
        double ra, ia, rb, ib;
        accrue(fin, fin + texp, d, hi, tend, ra, ia);
        accrue(p.bsy[j], p.ex[j], d, hi, tend, rb, ib);
        dr = ra - rb;
        di = ia - ib;
        dc = d;
        m = p.id[j] & 0xffff;
        p.bsy[j] = fin;
        p.ex[j] = fin + texp;
      }
    }
    if (win) busy_g[(size_t)fa * M + m] = fin;
    const int wl = __ffs(__ballot_sync(FULL, win)) - 1;
    add(fa, 3, __shfl_sync(FULL, dr, wl));
    add(fa, 4, __shfl_sync(FULL, di, wl));
    next_exit = fmin(next_exit, fin + texp);
    return FAULT ? __shfl_sync(FULL, dc, wl) : INFINITY;
  };

  // A cold start of function fa on slot m at clock tn, busy until fin,
  // crashing at dc: the lowest empty table entry takes it.
  const auto cold_start = [&](int fa, int m, double tn, double hi, double fin, double texp,
                              double dc) {
    int el = -1, ej = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (el < 0) {  // warp-uniform
        const unsigned e = __ballot_sync(FULL, !((p.used >> j) & 1u));
        if (e) {
          el = __ffs(e) - 1;
          ej = j;
        }
      }
    }
    if (el < 0) {
      broken = true;
      return;
    }
    const u64 k = okey(tn);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const bool hit = lane == el && j == ej;
      p.id[j] = hit ? (fa << 16) | m : p.id[j];
      p.ck[j] = hit ? k : p.ck[j];
      p.bsy[j] = hit ? fin : p.bsy[j];
      p.ex[j] = hit ? fin + texp : p.ex[j];
      if (FAULT) p.dm[FAULT ? j : 0] = hit ? dc : p.dm[FAULT ? j : 0];
    }
    if (lane == el) p.used |= 1u << ej;
    if (lane == 0) {
      bits[fa * SF + (m >> 5)] |= 1u << (m & 31);
      const size_t at = (size_t)fa * M + m;
      cre_g[at] = tn;
      busy_g[at] = fin;
      if (crashes) doom_g[at] = dc;
    }
    double r, i;
    accrue(fin, fin + texp, dc, hi, tend, r, i);
    add(fa, 3, r);
    add(fa, 4, i);
    next_exit = fmin(next_exit, fmin(fin + texp, dc));
    ++live;
    __syncwarp();
  };

  const float* t32 = (const float*)a.times;
  const double* t64 = (const double*)a.times;
  const size_t srow = (size_t)row * (size_t)K;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    const bool in = k < K;
    const double x_l = in ? (a.times_f64 ? t64[srow + k] : (double)t32[srow + k]) : 0.0;
    const int f_l = in ? (int)a.fids[srow + k] : 0;
    const float w_l = in ? a.warms[srow + k] : 0.f;
    const float c_l = in ? a.colds[srow + k] : 0.f;
    const float u_l = crashes && in ? a.crash_u[srow + k] : 0.f;
    const int n = min(32, K - k0);
    for (int i = 0; i < n; ++i) {
      const double x = __shfl_sync(FULL, x_l, i);
      const int fa = __shfl_sync(FULL, f_l, i);
      const double tn = a.prestamped ? x : t + x;
      const double hi = fmin(fmax(tn, skp), tend);
      // 1. the clipped clock went back: (hi, hi_prev] counts again
      if (hi < hi_prev) settle(hi, hi_prev);
      hi_prev = hi;
      // 2. the exits, once the clock reaches the bound
      if (tn >= next_exit) exit_pass(tn, hi);
      const bool active = tn <= tend, counted = tn > skp;
      // 3. capacity churn
      if (capped) {
        if (!(tn >= cap_lo && tn < cap_hi)) {
          const int seg = count_le(ce, a.E, tn);
          cap_now = __ldg(cv + seg);
          cap_lo = seg > 0 ? __ldg(ce + seg - 1) : -INFINITY;
          cap_hi = seg < a.E ? __ldg(ce + seg) : INFINITY;
        }
        const double over = (double)live - cap_now;
        if (over > 0.0 && active) {
          for (int q = 0; (double)q < over; ++q) {
            const Newest r = newest(p, -1, M, tn);
            if (r.best == 0ull) break;  // nothing idle is left
            const bool win = r.mine();
            double rr = 0.0, ri = 0.0, life = 0.0;
#pragma unroll
            for (int j = 0; j < L; ++j) {
              if (win && j == r.ent) {
                accrue(p.bsy[j], p.ex[j], p.doom(j), hi, tend, rr, ri);
                life = tn - key_value(p.ck[j]);
              }
            }
            if (win) p.used &= ~(1u << r.ent);
            const int wl = __ffs(__ballot_sync(FULL, win)) - 1;
            const int g = (int)(r.best_idx / (unsigned)M), m = (int)(r.best_idx % (unsigned)M);
            add(g, 3, -__shfl_sync(FULL, rr, wl));
            add(g, 4, -__shfl_sync(FULL, ri, wl));
            const double ls = __shfl_sync(FULL, life, wl);
            if (counted) {
              add(g, 7, ls);
              add(g, 8, 1.0);
              add(g, COLS + 1, 1.0);
            }
            if (lane == 0) bits[g * SF + (m >> 5)] &= ~(1u << (m & 31));
            --live;
            __syncwarp();
          }
        }
      }
      if (active && fa < F) {  // warp-uniform
        const double texp = texp_s[fa], lim = lim_s[fa];
        const double warm_s = (double)__shfl_sync(FULL, w_l, i);
        const double cold_s = (double)__shfl_sync(FULL, c_l, i);
        // 4. drain passes ahead of the arrival (no faults with queues)
        if (QUEUE) {
          for (int pass = 0; pass < Q; ++pass) {
            const int len = qlen[fa];
            if (len == 0) break;
            const int h = qhead[fa];
            const double* hq = ring + ((size_t)fa * Q + h) * 3;
            const double ht = hq[0], hw = hq[1], hc = hq[2];
            const Newest r = newest(p, fa, M, tn);
            const bool warm = r.best != 0ull;
            bool cold = false;
            int free_j = -1, n_alive = 0;
            if (!warm) {
              slots_of(bits, fa, M, SF, lane, free_j, n_alive);
              cold = (double)n_alive < lim && free_j >= 0 && (double)live < ncl;
              if (!cold) break;  // nothing served: nothing changes
            }
            if (warm) {
              warm_start(r, fa, hi, tn + hw, texp);
            } else {
              cold_start(fa, free_j, tn, hi, tn + hc, texp, INFINITY);
            }
            if (counted) {
              add(fa, warm ? 1 : 0, 1.0);
              add(fa, warm ? 6 : 5, warm ? hw : hc);
              add(fa, 12, 1.0);
              add(fa, 13, tn - ht);
            }
            if (lane == 0) {
              qhead[fa] = h + 1 == Q ? 0 : h + 1;
              qlen[fa] = len - 1;
            }
            __syncwarp();
          }
        }
        // 5. the arrival
        const Newest r = newest(p, fa, M, tn);
        const bool is_warm = r.best != 0ull;
        bool is_cold = false, is_enq = false, intr = false;
        if (is_warm) {
          const double fin = tn + warm_s;
          const double dc = warm_start(r, fa, hi, fin, texp);
          intr = crashes && dc < fin;
        } else {
          int free_j, n_alive;
          slots_of(bits, fa, M, SF, lane, free_j, n_alive);
          const bool any_free = free_j >= 0, below = (double)n_alive < lim;
          is_cold = below && any_free && (double)live < ncl &&
                    (!capped || (double)live < cap_now);
          if (below && !any_free) add(fa, 9, 1.0);  // overflow
          if (is_cold) {
            const double fin = tn + cold_s;
            double dc = INFINITY;
            if (crashes) {
              const double u = (double)__shfl_sync(FULL, u_l, i);
              dc = tn + (crate > 0.0 ? -log(1.0 - u) / crate : INFINITY);
            }
            cold_start(fa, free_j, tn, hi, fin, texp, dc);
            intr = crashes && dc < fin;
          } else if (QUEUE) {
            const int len = qlen[fa];
            is_enq = len < Q;
            if (is_enq) {
              if (lane == 0) {
                int pos = qhead[fa] + len;
                if (pos >= Q) pos -= Q;
                double* e = ring + ((size_t)fa * Q + pos) * 3;
                e[0] = tn;
                e[1] = warm_s;
                e[2] = cold_s;
                qlen[fa] = len + 1;
              }
              __syncwarp();
            }
          }
        }
        if (counted) {
          if (is_warm) {
            add(fa, 1, 1.0);
            add(fa, 6, warm_s);
          } else if (is_cold) {
            add(fa, 0, 1.0);
            add(fa, 5, cold_s);
          } else if (is_enq) {
            add(fa, 11, 1.0);
          } else {
            add(fa, 2, 1.0);
          }
          add(fa, 10, 1.0);
          if (intr) add(fa, COLS + 2, 1.0);
        }
      }
      // 6. the fleet-wide peak, on every event
      peak = fmax(peak, (double)live);
      t = tn;
    }
  }

  // the tail flush: the lifespans and crashes of exits in (t_last, t_end]
  // (the live states accrued their integrals up to t_end already)
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const bool u = (p.used >> j) & 1u;
    const double d = p.doom(j), e = p.ex[j];
    const double x = FAULT ? fmin(e, d) : e;
    const bool tail = u && x <= tend && x > skp;
    const double life = x - key_value(p.ck[j]);
    const int cr = FAULT && tail && d < e;
    unsigned lanes = __ballot_sync(FULL, tail);
    while (lanes) {
      const int src = __ffs(lanes) - 1;
      lanes &= lanes - 1;
      const int g = __shfl_sync(FULL, p.id[j], src) >> 16;
      add(g, 7, __shfl_sync(FULL, life, src));
      add(g, 8, 1.0);
      if (FAULT && __shfl_sync(FULL, cr, src)) add(g, COLS, 1.0);
    }
  }
  __syncwarp();

  // ---- outputs
  broken = __any_sync(FULL, broken);
  for (int i = lane; i < F * M; i += 32) {
    const int g = i / M, m = i - g * M;
    alive_g[i] = (uint8_t)((bits[g * SF + (m >> 5)] >> (m & 31)) & 1u);
  }
  for (int i = lane; i < F * cols; i += 32) {
    const int c = i % cols;
    acc_g[i] = broken ? qnan : (c == PEAK ? peak : accs[i]);
  }
  for (int g = lane; g < F; g += 32) {
    a.qleft_out[fm + g] = broken ? qnan : (double)qlen[g];
    if (QUEUE) {
      double* qo = a.queue_out + (fm + g) * (size_t)Q * 3;
      for (int q = 0; q < Q; ++q) {
        int pos = qhead[g] + q;
        if (pos >= Q) pos -= Q;
        const double* e = ring + ((size_t)g * Q + pos) * 3;
        const bool held = q < qlen[g];
        qo[3 * q] = held ? e[0] : NEG;
        qo[3 * q + 1] = held ? e[1] : NEG;
        qo[3 * q + 2] = held ? e[2] : NEG;
      }
    }
  }
  if (lane == 0) a.t_out[fleet] = t;
}

template <int L, bool FAULT, bool QUEUE>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  const auto kern = fleet_scan_kernel<L, FAULT, QUEUE>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<(a.N + a.warps - 1) / a.warps, 32 * a.warps, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int L = 1>
int launch_table(const Args& a, int entries, size_t smem, cudaStream_t st) {
  if constexpr (L < MAX_TABLE) {
    if (L < entries) return launch_table<L * 2>(a, entries, smem, st);
  }
  if (a.crash_u != nullptr || a.cap_values != nullptr) return launch<L, true, false>(a, smem, st);
  if (a.Q > 0) return launch<L, false, true>(a, smem, st);
  return launch<L, false, false>(a, smem, st);
}

int table_entries(int live) {
  int L = 1;
  while (L < MAX_TABLE && 32 * L < live) L *= 2;
  return L;
}

}  // namespace

// Shared memory a warp takes (bytes) for F functions, queue depth Q, M
// slots and faults or not: the wrapper sizes its launch by it.
extern "C" long long fleet_scan_warp_smem(int F, int Q, int M, int faults) {
  return (long long)warp_smem(F, Q, (M + 31) / 32, COLS + (faults ? FAULT_COLS : 0));
}

// Plain C entry, bound with ctypes.  ptrs (22, in this order): t_exp, limit
// [N, F], ncl, t_end, skip [N] (f64), stream [N] (int64), times [S, K] (f32
// gaps, or f64 when times_f64), fids [S, K] (uint8), warms, colds [S, K]
// (f32), crash_rate [N] (f64), crash_u [S, K] (f32), cap_edges [N, E],
// cap_values [N, E+1] (f64); outputs alive [N, F, M] (uint8), creation,
// busy, doom [N, F, M], t [N], acc [N, F, cols], qleft [N, F] and queue
// [N, F, Q, 3] (f64).  A null optional input turns its path off (faults
// not with Q > 0).  ints (12): N, F, M, K, Q, E, S, prestamped, times_f64,
// live (a bound of every fleet's live count), warps (fleets a block),
// device; then the stream.  Returns the CUDA error code (0 = ok).
extern "C" int fleet_scan_f64(void* const* ptrs, const int* ints, void* stream) {
  Args a;
  a.t_exp = (const double*)ptrs[0];
  a.limit = (const double*)ptrs[1];
  a.ncl = (const double*)ptrs[2];
  a.t_end = (const double*)ptrs[3];
  a.skip = (const double*)ptrs[4];
  a.stream = (const long long*)ptrs[5];
  a.times = ptrs[6];
  a.fids = (const uint8_t*)ptrs[7];
  a.warms = (const float*)ptrs[8];
  a.colds = (const float*)ptrs[9];
  a.crash_rate = (const double*)ptrs[10];
  a.crash_u = (const float*)ptrs[11];
  a.cap_edges = (const double*)ptrs[12];
  a.cap_values = (const double*)ptrs[13];
  a.alive_out = (uint8_t*)ptrs[14];
  a.creation_out = (double*)ptrs[15];
  a.busy_out = (double*)ptrs[16];
  a.doom_out = (double*)ptrs[17];
  a.t_out = (double*)ptrs[18];
  a.acc_out = (double*)ptrs[19];
  a.qleft_out = (double*)ptrs[20];
  a.queue_out = (double*)ptrs[21];
  a.N = ints[0];
  a.F = ints[1];
  a.M = ints[2];
  a.K = ints[3];
  a.Q = ints[4];
  a.E = ints[5];
  a.S = ints[6];
  a.prestamped = ints[7];
  a.times_f64 = ints[8];
  const int live = ints[9];
  a.warps = ints[10];
  const int device = ints[11];
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool crash = a.crash_u != nullptr, capped = a.cap_values != nullptr;
  if (a.N < 1 || a.F < 1 || a.F > 32767 || a.M < 1 || a.M > MAX_SLOTS || a.K < 0 || a.Q < 0 ||
      a.S < 1 || live < 1 || a.warps < 1 || a.warps > 4 || ((crash || capped) && a.Q > 0) ||
      (crash && (a.crash_rate == nullptr || a.doom_out == nullptr)) ||
      (capped && (a.E < 0 || (a.E > 0 && a.cap_edges == nullptr))) ||
      (a.Q > 0 && a.queue_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!capped) a.E = 0;
  const int cols = COLS + (crash || capped ? FAULT_COLS : 0);
  const size_t smem = (size_t)a.warps * warp_smem(a.F, a.Q, (a.M + 31) / 32, cols);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const int fm = a.F * a.M;
  return launch_table(a, table_entries(live < fm ? live : fm), smem, (cudaStream_t)stream);
}
