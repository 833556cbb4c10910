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
// fleet: each event needs the idle test and the newest key of the acting
// function's live instances and O(1) scalar work, against 13 to 17 bytes
// of stream read once for every cell that shares it.  So one fleet's chain
// and the warp's issue set the time: every instruction an event costs.
//
// What this design does (kernel 8's structure, scan_event_step.cu and
// scan64_common.cuh, with fleet_event_step.cu's fleet state):
//   - One warp per fleet.  The live instances sit in a compact table of L
//     entries a lane (function and slot, the creation's 64-bit order key,
//     busy, expiry and, with faults, the crash clock, in registers); the
//     host bounds the live count (core/fleet.py live_bound) and the launch
//     takes the narrowest L that holds it: L = 1 at the catalog's ncl = 24.
//     A cold start takes the lowest empty entry; a fleet that finds none
//     (a bound below the true count) gets NaN outputs.
//   - Per-function state in the owning lane's registers (F <= 32 and L <=
//     8): lane f holds function f's t_exp, limit, queue head and length and
//     the columns an arrival or a drain pass adds to: its counters (32-bit
//     integers, converted once at the end: adding 1.0 in f64 is exact below
//     2^53, so the bits are the same) and its response and queue-wait sums,
//     added in event order as the reference adds them.  The acting function
//     fa is warp-uniform, so an add is `if (lane == fa) c += v`: no shared
//     memory, no shuffle.  The arrivals column is cold + warm - queue-served
//     + rejected + enqueued, counted once at the end.  The columns that
//     change only where an instance leaves (the integrals, lifespans,
//     crashes, evictions) are in the warp's shared memory, function g's
//     added by lane g % 32 (one thread, so in program order): in registers
//     they made the L = 1 instance spill at its 80-register cap.  Past 32
//     functions, and at L >= 16 where the table takes the registers, every
//     column, t_exp, limit and queue pointer is in shared memory.
//   - Per-entry integrals: each table entry keeps its own part of ∫running
//     and ∫idle (in registers; in shared memory at L >= 16, with the
//     expiries, which keeps the widest tables' spills down), accrued per
//     state span (scan64_common.cuh accrue): a state adds accrue(hi) when it
//     starts and gives back accrue(hi) when it ends early (a warm start, an
//     eviction; an exit accrues nothing past its exit clock).  A warm start
//     then changes its own lane's registers only (the idle state that ends
//     accrued no running time past hi, so only its idle part is given
//     back).  An entry's part is added to its function's columns when it
//     leaves (an exit pass, an eviction, the tail flush), in the fixed order
//     the warp visits entries (entry index, then lane), so two runs give the
//     same bits.  Where the clipped clock goes back (unsorted f64 times,
//     negative gaps) every live entry adds accrue(hi) - accrue(hi_prev),
//     the interval the reference counts again.
//   - The pools' planes are written when an instance leaves (its creation,
//     busy and crash clock, by its entry's lane) and for the live entries
//     at the end, so a dead slot keeps the values its last instance held,
//     as the reference's arrays do, without a store at each start.
//   - The alive bitmap is F x ceil(M/32) words in this warp's shared
//     memory; word g*SF + q is read and written by lane q alone, so the
//     acting function's lowest free slot and live count are one word a
//     lane and a ballot.
//   - Exits run only once the clock reaches a lower bound of the fleet's
//     earliest exit (lowered at each start, exact after each exit pass).
//     A quiet event (inside the horizon, the clock not going back, no exit
//     or capacity step due: one warp-uniform test) goes straight to the
//     routing.
//   - Routing on order keys: the newest idle entry of the acting function
//     (or, for evictions, of the fleet) by a ballot of the lanes with a
//     candidate; only where two or more lanes hold one, reduxes of the
//     key's high word, its low word and the slot (or flat id), each only
//     among the ties left.
//   - Samples are loaded 32 events at a time, one per lane (coalesced),
//     and broadcast per event with __shfl_sync.  Loading the next batch
//     during this one, and broadcasting each event's time and function
//     during the event before (kernel 8's), did not pay here: the
//     registers they hold made the L = 1 instance spill at its cap, and
//     the catalog ran 2.4% and 3.5% slower with them (in turns, NVIDIA
//     H100 80GB HBM3 at 700 W).
//   - The queues are rings (a head and a length a function) of (t, warm,
//     cold) f64 triples in shared memory, the same FIFO as the reference's
//     shifted arrays; they come out shifted, head first, NEG past the
//     length.
//   - The peak changes only at a cold start (an event's exits and evictions
//     come before its starts), so it is taken there.
//   - L = 1 has two instances: ptxas' own register choice (87 at the
//     catalog, 5 blocks of 4 fleets an SM) and one pinned at 6 blocks an SM
//     (at most 80 registers a thread), with which the catalog's 768 blocks
//     fit the 132 SMs in one wave.  A launch takes the pinned one only
//     where it needs fewer waves (choose_pin): where the waves are the
//     same, the spare registers of the other pay.
// PERF.md section 6 times each lever taken out alone at the catalog sweep.
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
constexpr int MAX_TABLE = 32;   // table entries a lane: 1,024 live instances
constexpr int MAX_SLOTS = 1024; // slots a function: 32 bitmap words
constexpr int REG_FUNCTIONS = 32;  // functions a warp's lanes own in registers
constexpr int BIG_TABLE = 16;   // from here integrals, expiries and columns are in shared memory
constexpr int PINNED_BLOCKS = 6;  // blocks an SM of the pinned L = 1 instance

// the columns (ref64.FLEET64_COLS, then the fault columns)
enum : int {
  C_COLD = 0, C_WARM = 1, C_REJECT = 2, C_RUN = 3, C_IDLE = 4, C_CRESP = 5, C_WRESP = 6,
  C_LIFE = 7, C_NLIFE = 8, C_OVER = 9, C_ARRIVE = 10, C_ENQ = 11, C_QSRV = 12, C_QWAIT = 13,
  C_PEAK = 14, C_CRASH = 15, C_EVICT = 16, C_INTR = 17
};
// The columns an arrival or a drain pass adds to, which a lane keeps in
// registers (counters, then f64 sums); the others change only where an
// instance leaves and stay in shared memory.
constexpr int NCOUNT = 7, NSUM = 3;
__host__ __device__ constexpr int count_slot(int c) {
  return c == C_COLD ? 0 : c == C_WARM ? 1 : c == C_REJECT ? 2 : c == C_OVER ? 3
       : c == C_ENQ ? 4 : c == C_QSRV ? 5 : c == C_INTR ? 6 : -1;
}
__host__ __device__ constexpr int sum_slot(int c) {
  return c == C_CRESP ? 0 : c == C_WRESP ? 1 : c == C_QWAIT ? 2 : -1;
}

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

// Byte offsets of this warp's shared memory: the entries' integrals [L,
// 32] (run, idle) and expiries [L, 32] at L >= BIG_TABLE; the accumulators
// [F, cols]; with the per-function state in shared memory, t_exp and
// limit [F]; the queue rings [F, Q, 3]; the bitmap [F, SF]; with the
// per-function state in shared memory, the rings' heads and lengths [F].
struct Layout {
  size_t integ, ex, acc, texp, lim, ring, bits, qhead, qlen, bytes;
};

__host__ __device__ inline Layout layout(int F, int Q, int SF, int cols, int L, bool shared_cols) {
  Layout o;
  size_t at = 0;
  o.integ = at;
  at += L >= BIG_TABLE ? (size_t)L * 32 * 16 : 0;
  o.ex = at;
  at += L >= BIG_TABLE ? (size_t)L * 32 * 8 : 0;
  o.acc = at;
  at += 8 * (size_t)F * cols;
  o.texp = at;
  at += shared_cols ? 8 * (size_t)F : 0;
  o.lim = at;
  at += shared_cols ? 8 * (size_t)F : 0;
  o.ring = at;
  at += 24 * (size_t)F * Q;
  o.bits = at;
  at += 4 * (size_t)F * SF;
  o.qhead = at;
  at += shared_cols ? 4 * (size_t)F : 0;
  o.qlen = at;
  at += shared_cols ? 4 * (size_t)F : 0;
  o.bytes = (at + 15) / 16 * 16;
  return o;
}

// entries a lane of the narrowest table holding `live` instances in 32 lanes
__host__ __device__ inline int table_entries(int live) {
  int L = 1;
  while (L < MAX_TABLE && 32 * L < live) L *= 2;
  return L;
}

// A lane's table entries.  At L >= BIG_TABLE the expiries sit in the
// warp's shared memory (ex_s: [L, 32], this lane's column), which keeps
// the widest tables' spills down.
template <int L, bool FAULT>
struct Table {
  static constexpr bool EX_SHARED = L >= BIG_TABLE;
  unsigned used = 0u;  // bit j: entry j holds a live instance
  int id[L];           // (function << 16) | slot
  u64 ck[L];           // okey(creation)
  double bsy[L];
  double ex_r[EX_SHARED ? 1 : L];
  double* ex_s;
  double dm[FAULT ? L : 1];
  __device__ __forceinline__ double doom(int j) const {
    return FAULT ? dm[FAULT ? j : 0] : INFINITY;
  }
  __device__ __forceinline__ double& ex(int j) {
    return EX_SHARED ? ex_s[j * 32] : ex_r[EX_SHARED ? 0 : j];
  }
};

// The per-function state: t_exp, the limit, the queue's head and length
// and the columns an event adds to in the owning lane's registers (SHARED
// false: lane g holds function g), or in the warp's shared memory
// (SHARED); the columns that change where an instance leaves in shared
// memory either way, added by lane g % 32.  g is warp-uniform in every
// call.
template <bool SHARED>
struct Functions {
  int lane, cols;
  double texp = 0.0, lim = 0.0;
  int qh = 0, ql = 0;
  int n[NCOUNT];
  double s[NSUM];
  double *acc, *texp_s, *lim_s;
  int *qhead_s, *qlen_s;

  __device__ __forceinline__ double texp_of(int g) const {
    return SHARED ? texp_s[g] : __shfl_sync(FULL, texp, g);
  }
  __device__ __forceinline__ double lim_of(int g) const {
    return SHARED ? lim_s[g] : __shfl_sync(FULL, lim, g);
  }
  __device__ __forceinline__ void queue_of(int g, int& h, int& len) const {
    if (SHARED) {
      h = qhead_s[g];
      len = qlen_s[g];
    } else {
      h = __shfl_sync(FULL, qh, g);
      len = __shfl_sync(FULL, ql, g);
    }
  }
  __device__ __forceinline__ void set_queue(int g, int h, int len) {
    if (SHARED) {
      if (lane == 0) {
        qhead_s[g] = h;
        qlen_s[g] = len;
      }
      __syncwarp();
    } else if (lane == g) {
      qh = h;
      ql = len;
    }
  }
  template <int C>
  __device__ __forceinline__ void count(int g) {
    if constexpr (!SHARED && count_slot(C) >= 0) {
      if (lane == g) ++n[count_slot(C)];
    } else if (lane == (g & 31)) {
      acc[(size_t)g * cols + C] += 1.0;
    }
  }
  template <int C>
  __device__ __forceinline__ void add(int g, double v) {
    if constexpr (!SHARED && sum_slot(C) >= 0) {
      if (lane == g) s[sum_slot(C)] += v;
    } else if (lane == (g & 31)) {
      acc[(size_t)g * cols + C] += v;
    }
  }
  // function g's column C as the output holds it (counters to f64); lane g
  // % 32 reads it
  template <int C>
  __device__ __forceinline__ double column(int g) const {
    if constexpr (!SHARED && count_slot(C) >= 0) return (double)n[count_slot(C)];
    if constexpr (!SHARED && sum_slot(C) >= 0) return s[sum_slot(C)];
    return acc[(size_t)g * cols + C];
  }
};

// The newest idle entry of function fa (fa < 0: of any function) at clock
// t, by the creation's order key, then the lowest slot (flat id f*M + m for
// fa < 0).  Each lane takes its own candidate (ent); a ballot of the lanes
// holding one decides when one lane does, else reduxes of the key's high
// word, low word and the slot, each among the ties left.  `win`: this lane
// holds the winner (one lane, if `any`); `wl`: that lane.
struct Newest {
  bool any, win;
  int ent, wl;
};

template <int L, bool FAULT>
__device__ __forceinline__ Newest newest(const Table<L, FAULT>& p, int fa, int M, double t,
                                         int lane) {
  u64 key = 0ull;
  unsigned idx = UINT_MAX;
  int ent = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int g = p.id[j] >> 16, m = p.id[j] & 0xffff;
    const bool cand = ((p.used >> j) & 1u) && (fa < 0 || g == fa) && p.bsy[j] <= t;
    const u64 k = cand ? p.ck[j] : 0ull;
    const unsigned x = fa < 0 ? (unsigned)(g * M + m) : (unsigned)m;
    if (k > key || (k != 0ull && k == key && x < idx)) {
      key = k;
      idx = x;
      ent = j;
    }
  }
  unsigned c = __ballot_sync(FULL, key != 0ull);
  Newest n;
  n.any = c != 0u;
  n.ent = ent;
  if (c & (c - 1u)) {  // warp-uniform: two or more lanes hold a candidate
    const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
    const unsigned bh = __reduce_max_sync(FULL, key != 0ull ? hi : 0u);
    c = __ballot_sync(FULL, key != 0ull && hi == bh);
    if (c & (c - 1u)) {
      const bool tie = (c >> lane) & 1u;
      const unsigned bl = __reduce_max_sync(FULL, tie ? lo : 0u);
      c = __ballot_sync(FULL, tie && lo == bl);
      if (c & (c - 1u)) {
        const bool tie2 = (c >> lane) & 1u;
        const unsigned bi = __reduce_min_sync(FULL, tie2 ? idx : UINT_MAX);
        c = __ballot_sync(FULL, tie2 && idx == bi);
      }
    }
  }
  n.win = (c >> lane) & 1u;
  n.wl = __ffs(c) - 1;
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

// PIN (L = 1 only): at most 80 registers a thread, so that 6 blocks of 4
// fleets fit an SM and the catalog's 768 blocks fit the 132 SMs in one
// wave; the launch takes it only where it saves a wave (choose_pin).
// SHARED: the per-function state in shared memory (F > 32, or L >=
// BIG_TABLE); QUEUE: queue_depth > 0 (never with FAULT)
template <int L, bool FAULT, bool QUEUE, bool SHARED, bool PIN>
__global__ void __launch_bounds__(128, PIN ? PINNED_BLOCKS : 1)
    fleet_scan_kernel(const Args a) {
  constexpr bool BIG = L >= BIG_TABLE;  // the entries' integrals and expiries in shared memory
  extern __shared__ __align__(16) unsigned char smem[];
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
  const Layout lay = layout(F, Q, SF, cols, L, SHARED);
  unsigned char* wsm = smem + (size_t)wib * lay.bytes;
  double2* integ = (double2*)(wsm + lay.integ);  // [L, 32] (BIG)
  double* ring = (double*)(wsm + lay.ring);      // [F, Q, 3]
  unsigned* bits = (unsigned*)(wsm + lay.bits);  // [F, SF]
  Functions<SHARED> fs;
  fs.lane = lane;
  fs.cols = cols;
  fs.acc = (double*)(wsm + lay.acc);
  fs.texp_s = (double*)(wsm + lay.texp);
  fs.lim_s = (double*)(wsm + lay.lim);
  fs.qhead_s = (int*)(wsm + lay.qhead);
  fs.qlen_s = (int*)(wsm + lay.qlen);
#pragma unroll
  for (int c = 0; c < NCOUNT; ++c) fs.n[c] = 0;
#pragma unroll
  for (int c = 0; c < NSUM; ++c) fs.s[c] = 0.0;
  for (int i = lane; i < F * cols; i += 32) fs.acc[i] = 0.0;
  if (SHARED) {
    for (int i = lane; i < F; i += 32) {
      fs.texp_s[i] = a.t_exp[fm + i];
      fs.lim_s[i] = a.limit[fm + i];
      fs.qhead_s[i] = 0;
      fs.qlen_s[i] = 0;
    }
  } else if (lane < F) {
    fs.texp = a.t_exp[fm + lane];
    fs.lim = a.limit[fm + lane];
  }
  for (int i = lane; i < F * SF; i += 32) bits[i] = 0u;
  // the pools' planes: empty slots, then each instance's values when it
  // leaves, and the live ones' at the end
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
  p.ex_s = (double*)(wsm + lay.ex) + lane;
  double er[BIG ? 1 : L], ei[BIG ? 1 : L];  // the entries' integrals (run, idle)
#pragma unroll
  for (int j = 0; j < L; ++j) {
    p.id[j] = 0;
    p.ck[j] = 0ull;
    p.bsy[j] = NEG;
    p.ex(j) = NEG;
    if (FAULT) p.dm[FAULT ? j : 0] = INFINITY;
    if (!BIG) {
      er[BIG ? 0 : j] = 0.0;
      ei[BIG ? 0 : j] = 0.0;
    }
  }
  int live = 0, peak = 0;
  bool broken = false;
  double next_exit = INFINITY, t = 0.0;
  double hi_prev = fmin(fmax(t, skp), tend);

  // entry j's integrals (j a runtime index: a select over the registers)
  const auto integrals = [&](int j, double& r, double& i) {
    if constexpr (BIG) {
      const double2 v = integ[j * 32 + lane];
      r = v.x;
      i = v.y;
    } else {
#pragma unroll
      for (int jj = 0; jj < L; ++jj) {
        if (jj == j) {
          r = er[BIG ? 0 : jj];
          i = ei[BIG ? 0 : jj];
        }
      }
    }
  };
  // this lane's entry j leaves: its slot's planes take its values
  const auto store_planes = [&](int j) {
    const int g = p.id[j] >> 16, m = p.id[j] & 0xffff;
    const size_t at = (size_t)g * M + m;
    cre_g[at] = key_value(p.ck[j]);
    busy_g[at] = p.bsy[j];
    if (crashes) doom_g[at] = p.doom(j);
  };

  // Every live state's accrual moves from clipped clock `from0` to `to`:
  // each entry gains accrue(to) - accrue(from0).
  const auto settle = [&](double to, double from0) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if ((p.used >> j) & 1u) {
        double ra, ia, rb, ib;
        accrue(p.bsy[j], p.ex(j), p.doom(j), to, tend, ra, ia);
        accrue(p.bsy[j], p.ex(j), p.doom(j), from0, tend, rb, ib);
        if constexpr (BIG) {
          double2& v = integ[j * 32 + lane];
          v.x += ra - rb;
          v.y += ia - ib;
        } else {
          er[BIG ? 0 : j] += ra - rb;
          ei[BIG ? 0 : j] += ia - ib;
        }
      }
    }
  };

  // The exit pass at clock tn (clipped hi): entries whose exit clock is at
  // or before tn leave, each giving back what it accrued past hi; their
  // integrals, lifespans and crashes go to their functions' columns.
  const auto exit_pass = [&](double tn, double hi) {
    unsigned gone = 0u;
    double nx = INFINITY;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if ((p.used >> j) & 1u) {
        const double x = FAULT ? fmin(p.ex(j), p.doom(j)) : p.ex(j);
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
      const double d = p.doom(j), e = p.ex(j);
      const double x = FAULT ? fmin(e, d) : e;
      double r = 0.0, i = 0.0;
      if (mine) {
        double rr, ri;
        accrue(p.bsy[j], e, d, hi, tend, rr, ri);
        integrals(j, r, i);
        r -= rr;
        i -= ri;
        store_planes(j);
      }
      const double life = x - key_value(p.ck[j]);
      const int flags = (x > skp && x <= tend ? 1 : 0) |
                        (FAULT && d < e && d > skp && d <= tend ? 2 : 0);
      while (lanes) {
        const int src = __ffs(lanes) - 1;
        lanes &= lanes - 1;
        const int id = __shfl_sync(FULL, p.id[j], src);
        const int g = id >> 16, m = id & 0xffff;
        fs.template add<C_RUN>(g, __shfl_sync(FULL, r, src));
        fs.template add<C_IDLE>(g, __shfl_sync(FULL, i, src));
        const double ls = __shfl_sync(FULL, life, src);
        const int fl = __shfl_sync(FULL, flags, src);
        if (fl & 1) {
          fs.template add<C_LIFE>(g, ls);
          fs.template count<C_NLIFE>(g);
        }
        if (FAULT && (fl & 2)) fs.template count<C_CRASH>(g);
        if (lane == (m >> 5)) bits[g * SF + (m >> 5)] &= ~(1u << (m & 31));
        --live;
      }
    }
    p.used &= ~gone;
    next_exit = warp_min(nx);
    __syncwarp();
  };

  // A warm start of the routed entry, busy until fin, expiring at ex_new:
  // its lane swaps the accrual; returns whether its instance dies before
  // fin (crashes).  The idle state that ends has busy <= t <= t_end, so
  // busy <= hi: it accrued no running time past hi and idle time from hi.
  const auto warm_start = [&](const Newest& r, double hi, double fin, double ex_new) {
    bool intr = false;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (r.win && j == r.ent) {
        const double d = p.doom(j);
        double ra, ia;
        accrue(fin, ex_new, d, hi, tend, ra, ia);
        const double ib = fmax(fmin(fmin(p.ex(j), d), tend) - hi, 0.0);
        if constexpr (BIG) {
          double2& v = integ[j * 32 + lane];
          v.x += ra;
          v.y += ia - ib;
        } else {
          er[BIG ? 0 : j] += ra;
          ei[BIG ? 0 : j] += ia - ib;
        }
        p.bsy[j] = fin;
        p.ex(j) = ex_new;
        intr = d < fin;
      }
    }
    next_exit = fmin(next_exit, ex_new);
    return crashes && __any_sync(FULL, intr);
  };

  // A cold start of function fa on slot m at clock tn, busy until fin,
  // expiring at ex_new, crashing at dc: the lowest empty table entry takes
  // it.
  const auto cold_start = [&](int fa, int m, double tn, double hi, double fin, double ex_new,
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
    double r, i;
    accrue(fin, ex_new, dc, hi, tend, r, i);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const bool hit = lane == el && j == ej;
      p.id[j] = hit ? (fa << 16) | m : p.id[j];
      p.ck[j] = hit ? k : p.ck[j];
      p.bsy[j] = hit ? fin : p.bsy[j];
      if (hit) p.ex(j) = ex_new;
      if (FAULT) p.dm[FAULT ? j : 0] = hit ? dc : p.dm[FAULT ? j : 0];
      if (!BIG) {
        er[BIG ? 0 : j] = hit ? r : er[BIG ? 0 : j];
        ei[BIG ? 0 : j] = hit ? i : ei[BIG ? 0 : j];
      }
    }
    if (lane == el) {
      p.used |= 1u << ej;
      if (BIG) integ[ej * 32 + lane] = make_double2(r, i);
    }
    if (lane == (m >> 5)) bits[fa * SF + (m >> 5)] |= 1u << (m & 31);
    next_exit = fmin(next_exit, fmin(ex_new, dc));
    ++live;
    peak = max(peak, live);
  };

  const float* t32 = (const float*)a.times;
  const double* t64 = (const double*)a.times;
  const size_t srow = (size_t)row * (size_t)K;
  // lane l's sample of event k0 + l (zeros past K)
  const auto load = [&](int k0, double& x, int& f, float& w, float& c, float& u) {
    const int k = k0 + lane;
    const bool in = k < K;
    x = in ? (a.times_f64 ? t64[srow + k] : (double)t32[srow + k]) : 0.0;
    f = in ? (int)a.fids[srow + k] : 0;
    w = in ? a.warms[srow + k] : 0.f;
    c = in ? a.colds[srow + k] : 0.f;
    u = crashes && in ? a.crash_u[srow + k] : 0.f;
  };
  for (int k0 = 0; k0 < K; k0 += 32) {
    double x_l;
    int f_l;
    float w_l, c_l, u_l;
    load(k0, x_l, f_l, w_l, c_l, u_l);
    const int n = min(32, K - k0);
    for (int i = 0; i < n; ++i) {
      const double x = __shfl_sync(FULL, x_l, i);
      const int fa = __shfl_sync(FULL, f_l, i);
      const double tn = a.prestamped ? x : t + x;
      const double hi = fmin(fmax(tn, skp), tend);
      // a quiet event moves no clock-driven state: inside the horizon, the
      // clock not going back (so neither does the clipped one), no exit
      // and no capacity step due
      bool quiet = tn <= tend && tn >= t && tn < next_exit;
      if (capped) quiet = quiet && tn >= cap_lo && tn < cap_hi && (double)live <= cap_now;
      if (!quiet) {
        // 1. the clipped clock went back: (hi, hi_prev] counts again
        if (hi < hi_prev) settle(hi, hi_prev);
        // 2. the exits, once the clock reaches the bound
        if (tn >= next_exit) exit_pass(tn, hi);
        // 3. capacity churn
        if (capped) {
          if (!(tn >= cap_lo && tn < cap_hi)) {
            const int seg = count_le(ce, a.E, tn);
            cap_now = __ldg(cv + seg);
            cap_lo = seg > 0 ? __ldg(ce + seg - 1) : -INFINITY;
            cap_hi = seg < a.E ? __ldg(ce + seg) : INFINITY;
          }
          const double over = (double)live - cap_now;
          if (over > 0.0 && tn <= tend) {
            const bool counted = tn > skp;
            for (int q = 0; (double)q < over; ++q) {
              const Newest r = newest(p, -1, M, tn, lane);
              if (!r.any) break;  // nothing idle is left
              double rs = 0.0, is = 0.0, ls = 0.0;
              int id = 0;
              if (r.win) {
#pragma unroll
                for (int j = 0; j < L; ++j) {
                  if (j == r.ent) {
                    double rr, ri;
                    accrue(p.bsy[j], p.ex(j), p.doom(j), hi, tend, rr, ri);
                    integrals(j, rs, is);
                    rs -= rr;
                    is -= ri;
                    ls = tn - key_value(p.ck[j]);
                    id = p.id[j];
                    store_planes(j);
                  }
                }
                p.used &= ~(1u << r.ent);
              }
              id = __shfl_sync(FULL, id, r.wl);
              const int g = id >> 16, m = id & 0xffff;
              fs.template add<C_RUN>(g, __shfl_sync(FULL, rs, r.wl));
              fs.template add<C_IDLE>(g, __shfl_sync(FULL, is, r.wl));
              ls = __shfl_sync(FULL, ls, r.wl);
              if (counted) {
                fs.template add<C_LIFE>(g, ls);
                fs.template count<C_NLIFE>(g);
                fs.template count<C_EVICT>(g);
              }
              if (lane == (m >> 5)) bits[g * SF + (m >> 5)] &= ~(1u << (m & 31));
              --live;
              __syncwarp();
            }
          }
        }
      }
      hi_prev = hi;
      if (tn <= tend && fa < F) {  // warp-uniform
        const bool counted = tn > skp;
        const double texp = fs.texp_of(fa);
        int qh = 0, ql = 0;
        if (QUEUE) fs.queue_of(fa, qh, ql);
        const int qh0 = qh, ql0 = ql;
        // 4. drain passes ahead of the arrival (no faults with queues)
        if (QUEUE) {
          for (int pass = 0; pass < Q && ql > 0; ++pass) {
            const double* hq = ring + ((size_t)fa * Q + qh) * 3;
            const double ht = hq[0], hw = hq[1], hc = hq[2];
            const Newest r = newest(p, fa, M, tn, lane);
            int free_j = -1, n_alive = 0;
            if (!r.any) {
              slots_of(bits, fa, M, SF, lane, free_j, n_alive);
              const bool cold = (double)n_alive < fs.lim_of(fa) && free_j >= 0 &&
                                (double)live < ncl;
              if (!cold) break;  // nothing served: nothing changes
            }
            if (r.any) {
              const double fin = tn + hw;
              warm_start(r, hi, fin, fin + texp);
            } else {
              const double fin = tn + hc;
              cold_start(fa, free_j, tn, hi, fin, fin + texp, INFINITY);
            }
            if (counted) {
              if (r.any) {
                fs.template count<C_WARM>(fa);
                fs.template add<C_WRESP>(fa, hw);
              } else {
                fs.template count<C_COLD>(fa);
                fs.template add<C_CRESP>(fa, hc);
              }
              fs.template count<C_QSRV>(fa);
              fs.template add<C_QWAIT>(fa, tn - ht);
            }
            qh = qh + 1 == Q ? 0 : qh + 1;
            --ql;
          }
        }
        // 5. the arrival
        const double warm_s = (double)__shfl_sync(FULL, w_l, i);
        const Newest r = newest(p, fa, M, tn, lane);
        if (r.any) {
          const double fin = tn + warm_s;
          const bool intr = warm_start(r, hi, fin, fin + texp);
          if (counted) {
            fs.template count<C_WARM>(fa);
            fs.template add<C_WRESP>(fa, warm_s);
            if (crashes && intr) fs.template count<C_INTR>(fa);
          }
        } else {
          const double cold_s = (double)__shfl_sync(FULL, c_l, i);
          int free_j, n_alive;
          slots_of(bits, fa, M, SF, lane, free_j, n_alive);
          const bool any_free = free_j >= 0, below = (double)n_alive < fs.lim_of(fa);
          const bool is_cold = below && any_free && (double)live < ncl &&
                               (!capped || (double)live < cap_now);
          if (below && !any_free) fs.template count<C_OVER>(fa);  // overflow
          if (is_cold) {
            const double fin = tn + cold_s;
            double dc = INFINITY;
            if (crashes) {
              const double u = (double)__shfl_sync(FULL, u_l, i);
              dc = tn + (crate > 0.0 ? -log(1.0 - u) / crate : INFINITY);
            }
            cold_start(fa, free_j, tn, hi, fin, fin + texp, dc);
            if (counted) {
              fs.template count<C_COLD>(fa);
              fs.template add<C_CRESP>(fa, cold_s);
              if (crashes && dc < fin) fs.template count<C_INTR>(fa);
            }
          } else if (QUEUE && ql < Q) {
            if (lane == 0) {
              int pos = qh + ql;
              if (pos >= Q) pos -= Q;
              double* e = ring + ((size_t)fa * Q + pos) * 3;
              e[0] = tn;
              e[1] = warm_s;
              e[2] = cold_s;
            }
            __syncwarp();
            ++ql;
            if (counted) fs.template count<C_ENQ>(fa);
          } else if (counted) {
            fs.template count<C_REJECT>(fa);
          }
        }
        if (QUEUE && (qh != qh0 || ql != ql0)) fs.set_queue(fa, qh, ql);  // warp-uniform
      }
      t = tn;
    }
  }

  // the tail flush: every live entry's integrals (accrued up to t_end
  // already) go to its function's columns, with the lifespans and crashes
  // of exits in (t_last, t_end]; its planes take its values
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const bool u = (p.used >> j) & 1u;
    unsigned lanes = __ballot_sync(FULL, u);
    if (!lanes) continue;  // warp-uniform
    const double d = p.doom(j), e = p.ex(j);
    const double x = FAULT ? fmin(e, d) : e;
    const bool tail = u && x <= tend && x > skp;
    const double life = x - key_value(p.ck[j]);
    const int flags = (tail ? 1 : 0) | (FAULT && tail && d < e ? 2 : 0);
    double r = 0.0, i = 0.0;
    if (u) {
      integrals(j, r, i);
      store_planes(j);
    }
    while (lanes) {
      const int src = __ffs(lanes) - 1;
      lanes &= lanes - 1;
      const int g = __shfl_sync(FULL, p.id[j], src) >> 16;
      fs.template add<C_RUN>(g, __shfl_sync(FULL, r, src));
      fs.template add<C_IDLE>(g, __shfl_sync(FULL, i, src));
      const double ls = __shfl_sync(FULL, life, src);
      const int fl = __shfl_sync(FULL, flags, src);
      if (fl & 1) {
        fs.template add<C_LIFE>(g, ls);
        fs.template count<C_NLIFE>(g);
      }
      if (FAULT && (fl & 2)) fs.template count<C_CRASH>(g);
    }
  }
  __syncwarp();

  // ---- outputs
  broken = __any_sync(FULL, broken);
  for (int i = lane; i < F * M; i += 32) {
    const int g = i / M, m = i - g * M;
    alive_g[i] = (uint8_t)((bits[g * SF + (m >> 5)] >> (m & 31)) & 1u);
  }
  // function g's row, by lane g % 32; the arrivals: every counted arrival
  // was served warm or cold, queued or rejected, and the served count
  // includes the queue's
  for (int g = lane; g < F; g += 32) {
    double* o = acc_g + (size_t)g * cols;
    double v[COLS + FAULT_COLS];
    v[C_COLD] = fs.template column<C_COLD>(g);
    v[C_WARM] = fs.template column<C_WARM>(g);
    v[C_REJECT] = fs.template column<C_REJECT>(g);
    v[C_RUN] = fs.template column<C_RUN>(g);
    v[C_IDLE] = fs.template column<C_IDLE>(g);
    v[C_CRESP] = fs.template column<C_CRESP>(g);
    v[C_WRESP] = fs.template column<C_WRESP>(g);
    v[C_LIFE] = fs.template column<C_LIFE>(g);
    v[C_NLIFE] = fs.template column<C_NLIFE>(g);
    v[C_OVER] = fs.template column<C_OVER>(g);
    v[C_ENQ] = fs.template column<C_ENQ>(g);
    v[C_QSRV] = fs.template column<C_QSRV>(g);
    v[C_QWAIT] = fs.template column<C_QWAIT>(g);
    v[C_ARRIVE] = v[C_COLD] + v[C_WARM] - v[C_QSRV] + v[C_REJECT] + v[C_ENQ];
    v[C_PEAK] = (double)peak;
    if constexpr (FAULT) {
      v[C_CRASH] = fs.template column<C_CRASH>(g);
      v[C_EVICT] = fs.template column<C_EVICT>(g);
      v[C_INTR] = fs.template column<C_INTR>(g);
    }
#pragma unroll
    for (int c = 0; c < COLS + (FAULT ? FAULT_COLS : 0); ++c) o[c] = broken ? qnan : v[c];
  }
  for (int g = lane; g < F; g += 32) {
    int qh = 0, ql = 0;
    if (QUEUE) {
      if (SHARED) {
        qh = fs.qhead_s[g];
        ql = fs.qlen_s[g];
      } else {
        qh = fs.qh;
        ql = fs.ql;
      }
    }
    a.qleft_out[fm + g] = broken ? qnan : (double)ql;
    if (QUEUE) {
      double* qo = a.queue_out + (fm + g) * (size_t)Q * 3;
      for (int q = 0; q < Q; ++q) {
        int pos = qh + q;
        if (pos >= Q) pos -= Q;
        const double* e = ring + ((size_t)g * Q + pos) * 3;
        const bool held = q < ql;
        qo[3 * q] = held ? e[0] : NEG;
        qo[3 * q + 1] = held ? e[1] : NEG;
        qo[3 * q + 2] = held ? e[2] : NEG;
      }
    }
  }
  if (lane == 0) a.t_out[fleet] = t;
}

using Kernel = void (*)(const Args);

// the instance for the table size and the paths
template <int L, bool PIN>
Kernel instance(bool faults, bool queue, bool shared_cols) {
  if constexpr (L < BIG_TABLE) {
    if (!shared_cols)
      return faults ? fleet_scan_kernel<L, true, false, false, PIN>
             : queue ? fleet_scan_kernel<L, false, true, false, PIN>
                     : fleet_scan_kernel<L, false, false, false, PIN>;
  }
  return faults ? fleet_scan_kernel<L, true, false, true, PIN>
         : queue ? fleet_scan_kernel<L, false, true, true, PIN>
                 : fleet_scan_kernel<L, false, false, true, PIN>;
}

// the instance for a table of `entries` entries a lane and the paths
template <int L = 1>
Kernel pick(int entries, bool faults, bool queue, bool shared_cols, bool pin) {
  if constexpr (L < MAX_TABLE) {
    if (L < entries) return pick<L * 2>(entries, faults, queue, shared_cols, pin);
  }
  if constexpr (L == 1) {
    if (pin) return instance<1, true>(faults, queue, shared_cols);
  }
  return instance<L, false>(faults, queue, shared_cols);
}

// the launch's table size, path, instance and shared memory a warp
struct Plan {
  int L, cols;
  bool faults, queue, shared_cols, pinned;
  Kernel kern;
  size_t warp_bytes;
};

Plan plan(int F, int Q, int M, bool faults, int live) {
  Plan o;
  const int fm = F * M;
  o.L = table_entries(live < fm ? live : fm);
  o.faults = faults;
  o.queue = Q > 0;
  o.shared_cols = F > REG_FUNCTIONS || o.L >= BIG_TABLE;
  o.pinned = false;
  o.cols = COLS + (faults ? FAULT_COLS : 0);
  o.kern = pick(o.L, faults, o.queue, o.shared_cols, false);
  o.warp_bytes = layout(F, Q, (M + 31) / 32, o.cols, o.L, o.shared_cols).bytes;
  return o;
}

cudaError_t allow_smem(Kernel k, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute((const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// waves of `blocks` blocks of `warps` fleets that instance k takes on the card
cudaError_t waves(Kernel k, int blocks, int warps, size_t smem, int sms, int* out) {
  cudaError_t err = allow_smem(k, smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)k, 32 * warps,
                                                        smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = (blocks + per_sm * sms - 1) / (per_sm * sms);
  return cudaSuccess;
}

// At L = 1, the pinned instance where it runs the launch's N fleets in
// fewer waves than ptxas' own register choice; otherwise the unpinned one,
// whose spare registers pay where the waves are the same (the queued fleet
// of 512 fleets, one wave either way, and 40 functions, 6 blocks an SM
// either way, run faster unpinned; the catalog sweep, one wave against
// two, pinned: PERF.md section 6 has the times).  Sets the launch's shared
// memory on the chosen instance.
cudaError_t choose_pin(Plan& pl, int N, int warps, int device) {
  const size_t smem = (size_t)warps * pl.warp_bytes;
  if (pl.L != 1) return allow_smem(pl.kern, smem);
  const int blocks = (N + warps - 1) / warps;
  int sms = 0, own = 0, pinned = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const Kernel pin = pick(1, pl.faults, pl.queue, pl.shared_cols, true);
  if (err == cudaSuccess) err = waves(pl.kern, blocks, warps, smem, sms, &own);
  if (err == cudaSuccess) err = waves(pin, blocks, warps, smem, sms, &pinned);
  if (err != cudaSuccess) return err;
  if (pinned < own) {
    pl.kern = pin;
    pl.pinned = true;
  }
  return cudaSuccess;
}

}  // namespace

// Shared memory a warp takes (bytes) for F functions, queue depth Q, M
// slots, faults or not, and a bound of the live count: the wrapper sizes
// its launch by it.
extern "C" long long fleet_scan_warp_smem(int F, int Q, int M, int faults, int live) {
  return (long long)plan(F, Q, M, faults != 0, live).warp_bytes;
}

// The instance a launch of N fleets of these sizes runs with `warps` fleets
// a block: out = (registers a thread, local memory a thread in bytes,
// blocks an SM the occupancy calculator allows, table entries a lane,
// per-function state in shared memory, pinned).  Returns the CUDA error
// code.
extern "C" int fleet_scan_resources(int N, int F, int Q, int M, int faults, int live, int warps,
                                    int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Plan pl = plan(F, Q, M, faults != 0, live);
  err = choose_pin(pl, N, warps, device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes at;
  err = cudaFuncGetAttributes(&at, (const void*)pl.kern);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, (const void*)pl.kern, 32 * warps,
                                                      (size_t)warps * pl.warp_bytes);
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = blocks;
  out[3] = pl.L;
  out[4] = pl.shared_cols ? 1 : 0;
  out[5] = pl.pinned ? 1 : 0;
  return (int)err;
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
  Plan pl = plan(a.F, a.Q, a.M, crash || capped, live);
  const size_t smem = (size_t)a.warps * pl.warp_bytes;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  err = choose_pin(pl, a.N, a.warps, device);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchKernel((const void*)pl.kern, dim3((a.N + a.warps - 1) / a.warps),
                         dim3(32 * a.warps), args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
