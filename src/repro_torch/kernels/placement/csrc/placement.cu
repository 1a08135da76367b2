// Placement kernels for Hopper (sm_90a), FP64, bound through a plain C
// interface (ctypes).  Built by build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
// `-fmad=false` is part of the contract: nvcc would otherwise contract
// `a*b+c` into one DFMA (one rounding instead of two), and the results
// must be bitwise equal to the plain PyTorch versions (ref.py, ops.py),
// which round every multiply and every add.  The terms at risk are
// `idle_on_sum*c2+e_base` (score_lane), `(nl-nf)*idle_bt+su_bt` and
// `end*lk_c1+hv*lk_c2` (the window's full pass and commit).
//
// score_fleet_kernel + fold_blocks_kernel
//   Replaces the Pallas `_score_kernel` / `score_fleet`
//   (src/repro/kernels/placement/kernel.py).  One thread per endpoint
//   lane computes the fused objective (`score_lane`), then a block-wide
//   (value, index) minimum that breaks ties to the lower index; a second
//   one-thread launch folds the per-block minima in block order with a
//   strict `<`, so the result is numpy's first-min argmin.
//   Bound on this card: at fleet widths (32..1024 lanes) the work is a
//   few kilobytes, so the two launches' latency bounds it, not bytes or
//   FP64 operations; the design keeps it to two launches and one pass
//   over the inputs.
//
// greedy_window_kernel
//   Replaces the XLA `lax.scan` `_greedy_scan` (src/repro/kernels/
//   placement/ops.py) with `score_fleet` fused into it: one persistent
//   launch per arrival window, one CTA per ordering heuristic, the task loop
//   inside the kernel.  Threads own endpoint lanes (lane e: thread e % NT,
//   several lanes a thread above 992 lanes); one more warp, the helper,
//   keeps each lane's slot summary.  Any number of lanes and cores.
//   Bound on this card: the bytes it must move take microseconds at 3.35
//   TB/s; what bounds it is the serial chain of T dependent steps, each an
//   argmin over the lanes whose winner's commit the next step's scores
//   read (kernel_sweeps.py's chain probe runs that chain alone).  What the
//   design keeps off that chain:
//   - the task stream is staged in shared memory by cp.async a ring block
//     (128 steps) ahead, and each lane's operands of a task (its profile
//     entries, transfer add and lookahead term) two steps ahead by the
//     lane's own thread, so no step reads the tables on its chain;
//   - every thread computes the commit of its best lane before the argmin
//     decides, beside the scores and the reduction; the owner of the
//     winning lane only stores it;
//   - the core-slot matrix stays out of the step: each lane keeps its
//     first-min slot and the minimum of its other slots, which is all a
//     commit reads; the helper warp rescans the winning row (without that
//     slot) while the owner commits and merges the new end time after,
//     handing its words to the lanes through release/acquire flags, not
//     block barriers (one warp of lanes needs none);
//   - the argmin is three 32-bit __reduce_min_sync on ordered 64-bit keys
//     of the doubles (the lowest value, then the lowest lane at it), not
//     a shuffle butterfly, then the same once across the warps.
//   The lane state (6 base and 5 run registers, the slot summaries, the
//   staged flags), the prefetched operands and the slot matrix sit in
//   shared memory when they fit, in that order of need, and in global
//   memory (the output buffers, a scratch) when they do not, so the kernel
//   takes any fleet the reference places.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kScoreThreads = 256;

__device__ __forceinline__ double inf_d() { return __longlong_as_double(0x7ff0000000000000LL); }

// The fused MHRA objective of one lane; op order of ref.score_lanes_plain.
__device__ __forceinline__ double score_lane(
    double e_base, double nl, double g_base, double lk, double fw, double wt,
    bool alive, double c_cur, double idle_on_sum, double a1, double b1,
    double g1, double w_idle_on) {
  const double c2 = nl > c_cur ? nl : c_cur;   // never NaN
  const double e_s = idle_on_sum * c2 + e_base;
  double obj = a1 * e_s + b1 * c2;
  obj = obj + g1 * (w_idle_on * c2 + g_base);
  obj = obj + lk;
  obj = obj + fw;
  obj = obj + wt;
  return alive ? obj : inf_d();
}

// (value, index) lexicographic minimum: the lower index wins ties.
__device__ __forceinline__ void lex_min(double& v, int& i, double ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Warp-wide lexicographic argmin; lane 0 ends with the result.
__device__ __forceinline__ void warp_argmin(double& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const double ov = __shfl_down_sync(kFull, v, off);
    const int oi = __shfl_down_sync(kFull, i, off);
    lex_min(v, i, ov, oi);
  }
}

// Block-wide lexicographic argmin.  Every thread calls it; warp 0 returns
// with the block's (value, index) in all its lanes.  `s_v`/`s_i` hold one
// entry per warp.
__device__ __forceinline__ void block_argmin(double& v, int& i, double* s_v, int* s_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmin(v, i);
  if (lane == 0) {
    s_v[warp] = v;
    s_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? s_v[lane] : inf_d();
    i = lane < nw ? s_i[lane] : INT_MAX;
    warp_argmin(v, i);
    v = __shfl_sync(kFull, v, 0);
    i = __shfl_sync(kFull, i, 0);
  }
}

__global__ void __launch_bounds__(kScoreThreads) score_fleet_kernel(
    const double* __restrict__ e_base, const double* __restrict__ nl,
    const double* __restrict__ g_base, const double* __restrict__ lk,
    const double* __restrict__ fw, const double* __restrict__ wt,
    const uint8_t* __restrict__ alive, double c_cur, double idle_on_sum,
    double a1, double b1, double g1, double w_idle_on, int lanes,
    double* __restrict__ obj, double* __restrict__ blk_min,
    int* __restrict__ blk_idx) {
  __shared__ double s_v[32];
  __shared__ int s_i[32];
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  double v = inf_d();
  int i = INT_MAX;
  if (e < lanes) {
    v = score_lane(e_base[e], nl[e], g_base[e], lk[e], fw[e], wt[e],
                   alive[e] != 0, c_cur, idle_on_sum, a1, b1, g1, w_idle_on);
    obj[e] = v;
    i = e;
  }
  block_argmin(v, i, s_v, s_i);
  if (threadIdx.x == 0) {
    blk_min[blockIdx.x] = v;
    blk_idx[blockIdx.x] = i;
  }
}

__global__ void fold_blocks_kernel(const double* __restrict__ blk_min,
                                   const int* __restrict__ blk_idx, int nblk,
                                   double* __restrict__ min_out,
                                   int* __restrict__ idx_out) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  double m = blk_min[0];
  int ix = blk_idx[0];
  for (int b = 1; b < nblk; ++b) {
    if (blk_min[b] < m) {  // strict: an earlier block wins ties
      m = blk_min[b];
      ix = blk_idx[b];
    }
  }
  *min_out = m;
  *idx_out = ix;
}

// Scalar slots of `scal`.
enum {
  kA1, kB1, kG1, kIdleOnSum, kWIdleOn, kLamB1, kLamA1, kAlpha, kSf1, kSf2,
  kFBeta, kFMu, kNScal
};
// Per-heuristic scalar carry `hs`; on chip also the run-basis sums of a
// run boundary and the committed end time handed to the helper warp.
enum { kCCur, kTj, kCSumB, kTjB, kCgSumB, kNHs, kCSumF = kNHs, kCgSumF, kEndV, kNHsChip };
// Rows of the task stream: xs_i (H, 5, T) int32, xs_d (H, 5, T) float64.
enum { kTi, kHv, kSig, kShared, kNewRun, kNXi };
enum { kReady, kNb, kUTw, kUOj, kUFd, kNXd };
// A lane's operands of a step, copied two steps ahead: pf[row][u % 3][E].
enum { kPfRt, kPfEn, kPfAdd, kPfHv, kNPf };
constexpr int kPfAhead = 2, kPfSlots = kPfAhead + 1;
// What lives in shared memory (the rest in global memory).
enum { kPfOnChip = 1, kStateOnChip = 2, kSlotsOnChip = 4 };
// Words the lanes and the helper warp hand each other: the step whose
// argmin is published, whose commit is written, whose slot summary is
// refreshed; the winning lane, by step parity.
enum { kFlagEi, kFlagCommit, kFlagSum, kPubEi, kNHand = kPubEi + 2 };

constexpr int kRing = 128;            // steps of the task stream a ring block
constexpr int kMaxLaneThreads = 992;  // + the helper warp = 1024
constexpr size_t kMaxSmem = 232448;   // a block's dynamic shared memory

// Byte offsets of the window kernel's shared memory; -1 where the array
// lives in global memory.
struct WinLayout {
  int ring_d, red_v, hs, pf, base, run, min2, slots, ring_i, red_i, hand, k1, staged,
      total;
};

__host__ __device__ inline int take(int& at, long long bytes) {
  const int here = at;
  at += static_cast<int>((bytes + 15) / 16 * 16);
  return here;
}

__host__ __device__ inline WinLayout win_layout(int E, int C, int S, int mode) {
  WinLayout l;
  int o = 0;
  const bool st = mode & kStateOnChip;
  l.ring_d = take(o, 2LL * kNXd * kRing * 8);
  l.red_v = take(o, 2 * 32 * 8);
  l.hs = take(o, kNHsChip * 8);
  l.pf = (mode & kPfOnChip) ? take(o, 1LL * kPfSlots * kNPf * E * 8) : -1;
  l.base = st ? take(o, 6LL * E * 8) : -1;
  l.run = st ? take(o, 5LL * E * 8) : -1;
  l.min2 = st ? take(o, 1LL * E * 8) : -1;
  l.slots = (mode & kSlotsOnChip) ? take(o, 1LL * E * C * 8) : -1;
  l.ring_i = take(o, 2LL * kNXi * kRing * 4);
  l.red_i = take(o, 2 * 32 * 4);
  l.hand = take(o, kNHand * 4);
  l.k1 = st ? take(o, 1LL * E * 4) : -1;
  l.staged = st ? take(o, 1LL * S * E) : -1;
  l.total = o;
  return l;
}

struct WinArgs {
  int n_ep, E, C, T, n_units, S, NT, lpt, mode;
  const double* scal;     // (12,)
  const double* lane_c;   // (5, E): idle_bt su_bt qd rates wt
  const uint8_t* alive;   // (E,)
  const double* rt_tab;   // (P, E)
  const double* en_tab;   // (P, E)
  const double* fen_tab;  // (P,)
  const double* frt_tab;  // (P,)
  const double* add_tab;  // (S, E)
  const double* hv_tab;   // (V, E)
  const int* xs_i;        // (H, 5, T): ti hv_id sig shared_s new_run
  const double* xs_d;     // (H, 5, T): ready_s nb u_tw u_oj u_fd
  const double* base_in;  // (H, 6, E): mins first last dyn const const_g
  const double* slots_in; // (H, E, C)
  const double* run_in;   // (H, 5, E): e_base nl g_base lk fw
  const uint8_t* staged_in;  // (H, S, E)
  const double* hs_in;    // (H, 5): c_cur tj c_sum_b tj_b cg_sum_b
  double* base_out;
  double* slots_out;      // the slot matrix, updated in place when off chip
  double* run_out;
  uint8_t* staged_out;
  double* hs_out;
  int* ei_out;            // (H, T)
  double* start_out;      // (H, T)
  double* end_out;        // (H, T)
  int* k1_scr;            // (H, E): each lane's first-min slot, off chip
  double* min2_scr;       // (H, E): the minimum of its other slots, off chip
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A hand-off word: released after the data it guards, acquired before it.
__device__ __forceinline__ void publish(int* flag, int v) {
  asm volatile("st.release.cta.b32 [%0], %1;" ::"l"(flag), "r"(v) : "memory");
}
__device__ __forceinline__ void await_flag(const int* flag, int v) {
  int got;
  long long spins = 0;
  do {
    asm volatile("ld.acquire.cta.b32 %0, [%1];" : "=r"(got) : "l"(flag) : "memory");
    // a hand-off that never comes is a fault: end the launch with an error
    // (seconds of spinning) rather than hang the card
    if (++spins > (1LL << 28)) __trap();
  } while (got < v);
}
// The lane threads' barrier (the helper warp runs on its own).
__device__ __forceinline__ void lanes_sync(int NT) {
  if (NT == 32)
    __syncwarp();
  else
    asm volatile("bar.sync 1, %0;" ::"r"(NT) : "memory");
}

// max and min of two doubles that are never NaN: one compare and a
// select (fmax and fmin also handle NaN operands, in five instructions)
__device__ __forceinline__ double dmax(double x, double y) { return x > y ? x : y; }
__device__ __forceinline__ double dmin(double x, double y) { return x < y ? x : y; }

// numpy's pairwise sum (np.add.reduce: sequential under 8 terms, 8
// accumulators up to 128, halved above) of x[0:n] and of y[0:n] at once,
// walking the split tree with a fixed stack instead of recursion.
__device__ void pairwise_sum2(const double* x, const double* y, int n, double& sx,
                              double& sy) {
  int off[32], len[32], side[32];
  double lx[32], ly[32];
  int top = 0;
  off[0] = 0;
  len[0] = n;
  side[0] = 0;
  double rx = 0.0, ry = 0.0;
  for (;;) {
    const int o = off[top], m = len[top];
    if (m > 128) {          // descend into the left half
      int m2 = m / 2;
      m2 -= m2 % 8;
      ++top;
      off[top] = o;
      len[top] = m2;
      side[top] = 0;
      continue;
    }
    if (m < 8) {
      rx = 0.0;
      ry = 0.0;
      for (int i = 0; i < m; ++i) {
        rx = rx + x[o + i];
        ry = ry + y[o + i];
      }
    } else {
      double r[8], q[8];
      for (int j = 0; j < 8; ++j) {
        r[j] = x[o + j];
        q[j] = y[o + j];
      }
      int i = 8;
      for (; i < m - (m % 8); i += 8)
        for (int j = 0; j < 8; ++j) {
          r[j] = r[j] + x[o + i + j];
          q[j] = q[j] + y[o + i + j];
        }
      rx = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
      ry = ((q[0] + q[1]) + (q[2] + q[3])) + ((q[4] + q[5]) + (q[6] + q[7]));
      for (; i < m; ++i) {
        rx = rx + x[o + i];
        ry = ry + y[o + i];
      }
    }
    // climb: a left half waits for its right half, a right half completes
    // its parent (left + right)
    for (;;) {
      if (top == 0) {
        sx = rx;
        sy = ry;
        return;
      }
      if (side[top] == 0) {
        lx[top] = rx;
        ly[top] = ry;
        side[top] = 1;
        const int p = top - 1;
        off[top] = off[p] + len[top];
        len[top] = len[p] - len[top];
        break;
      }
      rx = lx[top] + rx;
      ry = ly[top] + ry;
      --top;
    }
  }
}

// Doubles as unsigned keys in the same order (no NaN; -0 taken as +0, so
// that equal values have equal keys), for the warp's integer reductions.
__device__ __forceinline__ unsigned long long order_key(double x) {
  const long long b = __double_as_longlong(x + 0.0);
  return b < 0 ? ~static_cast<unsigned long long>(b)
               : static_cast<unsigned long long>(b) | 0x8000000000000000ull;
}
__device__ __forceinline__ double from_key(unsigned long long k) {
  return __longlong_as_double(k >> 63 ? static_cast<long long>(k & 0x7fffffffffffffffull)
                                      : static_cast<long long>(~k));
}
// The warp's lowest key (every lane gets it).
__device__ __forceinline__ unsigned long long warp_min_key(unsigned long long key) {
  const unsigned hi = static_cast<unsigned>(key >> 32), lo = static_cast<unsigned>(key);
  const unsigned mh = __reduce_min_sync(kFull, hi);
  const unsigned ml = __reduce_min_sync(kFull, hi == mh ? lo : 0xffffffffu);
  return (static_cast<unsigned long long>(mh) << 32) | ml;
}
// The lowest index among the lanes that hold the warp's lowest key: a
// first-min argmin in three integer reductions.
__device__ __forceinline__ int warp_first_min(unsigned long long key, unsigned idx) {
  const unsigned long long m = warp_min_key(key);
  return static_cast<int>(__reduce_min_sync(kFull, key == m ? idx : 0xffffffffu));
}

// What a commit of a lane writes, computed before the argmin decides
// whether the lane wins.
struct Commit {
  double start_v, end_v, nf_v, nl_v, nd_v, c_e, cg_e, m2, nl2, e_b, g_b, lk_e, tj2;
  int sk;
  bool staged2;
};

// MAXT 256 takes windows of up to 224 lanes, one a thread; 1024 any.
template <int MAXT>
__global__ void __launch_bounds__(MAXT) greedy_window_kernel(const WinArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = a.E, C = a.C, T = a.T, S = a.S, NT = a.NT, n_ep = a.n_ep;
  const WinLayout lay = win_layout(E, C, S, a.mode);
  const int h = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const bool helper = tid >= NT;
  const int lane = tid & 31, warp = tid >> 5, NW = NT >> 5;
  const int lpt = MAXT <= 256 ? 1 : a.lpt;

  double* ring_d = reinterpret_cast<double*>(smem + lay.ring_d);
  int* ring_i = reinterpret_cast<int*>(smem + lay.ring_i);
  double* red_v = reinterpret_cast<double*>(smem + lay.red_v);
  int* red_i = reinterpret_cast<int*>(smem + lay.red_i);
  double* hs = reinterpret_cast<double*>(smem + lay.hs);
  int* hand = reinterpret_cast<int*>(smem + lay.hand);
  // a block of up to 256 threads (224 lanes) always has its lane state and
  // operands on chip (win_plan), which the compiler then knows
  constexpr bool small = MAXT <= 256;
  double* pf = (small || lay.pf >= 0) ? reinterpret_cast<double*>(smem + lay.pf) : nullptr;
  const bool on_chip = small || (a.mode & kStateOnChip);
  double* base = on_chip ? reinterpret_cast<double*>(smem + lay.base)
                         : a.base_out + (size_t)h * 6 * E;
  double* run = on_chip ? reinterpret_cast<double*>(smem + lay.run)
                        : a.run_out + (size_t)h * 5 * E;
  double* min2 = on_chip ? reinterpret_cast<double*>(smem + lay.min2)
                         : a.min2_scr + (size_t)h * E;
  int* k1 = on_chip ? reinterpret_cast<int*>(smem + lay.k1) : a.k1_scr + (size_t)h * E;
  uint8_t* staged = on_chip ? smem + lay.staged : a.staged_out + (size_t)h * S * E;
  double* slots = lay.slots >= 0 ? reinterpret_cast<double*>(smem + lay.slots)
                                 : a.slots_out + (size_t)h * E * C;
  const int* xi = a.xs_i + (size_t)h * kNXi * T;
  const double* xd = a.xs_d + (size_t)h * kNXd * T;
  const double* lane_c = a.lane_c;
  // a small block's thread has one lane: its constants stay in registers
  double my_c[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
  bool my_alive = false;
  if (small && tid < E) {
    for (int r = 0; r < 5; ++r) my_c[r] = lane_c[r * E + tid];
    my_alive = a.alive[tid] != 0;
  }
  auto lc = [&](int r, int e) { return small ? my_c[r] : lane_c[r * E + e]; };

  // ---- the carry in; each lane's slot summary from its row ------------
  for (int k = tid; k < 6 * E; k += nthr) base[k] = a.base_in[(size_t)h * 6 * E + k];
  for (int k = tid; k < 5 * E; k += nthr) run[k] = a.run_in[(size_t)h * 5 * E + k];
  for (int k = tid; k < S * E; k += nthr) staged[k] = a.staged_in[(size_t)h * S * E + k];
  for (size_t k = tid; k < (size_t)E * C; k += nthr)
    slots[k] = a.slots_in[(size_t)h * E * C + k];
  for (int e = tid; e < E; e += nthr) {
    const double* row = a.slots_in + ((size_t)h * E + e) * C;
    double m1 = row[0], m2 = inf_d();
    int i1 = 0;
    for (int c = 1; c < C; ++c) {
      const double x = row[c];
      if (x < m1) {
        m2 = m1;
        m1 = x;
        i1 = c;
      } else {
        m2 = dmin(m2, x);
      }
    }
    k1[e] = i1;
    min2[e] = m2;
  }
  if (tid < kNHs) hs[tid] = a.hs_in[h * kNHs + tid];
  if (tid < 3) hand[tid] = -1;   // kFlagEi, kFlagCommit, kFlagSum

  const double a1 = a.scal[kA1], b1 = a.scal[kB1], g1 = a.scal[kG1];
  const double idle_on_sum = a.scal[kIdleOnSum], w_idle_on = a.scal[kWIdleOn];
  const double lam_b1 = a.scal[kLamB1], lam_a1 = a.scal[kLamA1];
  const double alpha = a.scal[kAlpha], sf1 = a.scal[kSf1], sf2 = a.scal[kSf2];
  const double f_beta = a.scal[kFBeta], f_mu = a.scal[kFMu];

  // ring block b of the task stream (steps b*kRing ...) into slot b & 1
  auto issue_ring = [&](int b) {
    const int t0 = b * kRing, slot = b & 1;
    for (int k = tid; k < (kNXi + kNXd) * kRing; k += NT) {
      const int r = k / kRing, j = k % kRing;
      if (t0 + j >= a.n_units) continue;
      if (r < kNXi)
        cp_async4(ring_i + (slot * kNXi + r) * kRing + j, xi + (size_t)r * T + t0 + j);
      else
        cp_async8(ring_d + (slot * kNXd + r - kNXi) * kRing + j,
                  xd + (size_t)(r - kNXi) * T + t0 + j);
    }
    cp_async_commit();
  };
  auto xsi = [&](int r, int t) {
    return ring_i[(((t / kRing) & 1) * kNXi + r) * kRing + t % kRing];
  };
  auto xsd = [&](int r, int t) {
    return ring_d[(((t / kRing) & 1) * kNXd + r) * kRing + t % kRing];
  };
  // this thread's lanes' operands of step u, into slot u % 3
  auto prefetch = [&](int u) {
    if (pf == nullptr) return;
    const int par = u % kPfSlots;
    const size_t ti = xsi(kTi, u), sig = xsi(kSig, u), hv = xsi(kHv, u);
    for (int i = 0, e = tid; i < lpt && e < E; ++i, e += NT) {
      cp_async8(pf + (kPfRt * kPfSlots + par) * E + e, a.rt_tab + ti * E + e);
      cp_async8(pf + (kPfEn * kPfSlots + par) * E + e, a.en_tab + ti * E + e);
      cp_async8(pf + (kPfAdd * kPfSlots + par) * E + e, a.add_tab + sig * E + e);
      cp_async8(pf + (kPfHv * kPfSlots + par) * E + e, a.hv_tab + hv * E + e);
    }
    cp_async_commit();
  };
  // a lane's operand of step t (a row of pf, or the table at idx)
  auto opnd = [&](int row, int par, int e, const double* tab, size_t idx) {
    return pf != nullptr ? pf[(row * kPfSlots + par) * E + e] : tab[idx * E + e];
  };

  if (!helper && a.n_units > 0) issue_ring(0);
  cp_async_wait_all();
  __syncthreads();
  for (int u = 0; !helper && u < kPfAhead && u < a.n_units; ++u) prefetch(u);
  // the run basis, the same in every lane thread
  double c_sum_b = hs[kCSumB], tj_b = hs[kTjB], cg_sum_b = hs[kCgSumB];

  for (int t = 0; t < a.n_units && !helper; ++t) {
    // this thread's copies of step t's operands (and of any older ring
    // block); step t+1's may still be in flight
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kPfAhead - 1) : "memory");
    if (t % kRing == 0 && t + kRing < a.n_units) issue_ring(t / kRing + 1);
    const int par = t % kPfSlots;
    const int ti = xsi(kTi, t), hv = xsi(kHv, t), sig = xsi(kSig, t);
    const bool shared_s = xsi(kShared, t) != 0, new_run = xsi(kNewRun, t) != 0;
    const double ready_s = xsd(kReady, t), nb = xsd(kNb, t);
    const double u_tw = xsd(kUTw, t), u_oj = xsd(kUOj, t), u_fd = xsd(kUFd, t);
    const double lk_c1 = lam_b1 * u_tw;
    const double lk_c2 = lam_a1 * u_oj;
    if (t + kPfAhead < a.n_units) prefetch(t + kPfAhead);
    const double c_cur = hs[kCCur], tj = hs[kTj];

    // 1. On a run boundary: the full pass, against run-basis sums in
    // numpy's pairwise order (one thread, over the n_ep true lanes).
    if (new_run) {
      if (tid == 0) pairwise_sum2(base + 4 * E, base + 5 * E, n_ep, hs[kCSumF], hs[kCgSumF]);
      lanes_sync(NT);
      c_sum_b = hs[kCSumF];
      cg_sum_b = hs[kCgSumF];
      tj_b = tj;
      const double fen = a.fen_tab[ti], frt = a.frt_tab[ti];
      for (int i = 0, e = tid; i < lpt && e < E; ++i, e += NT) {
        const bool st = staged[sig * E + e] != 0;
        const double rt = opnd(kPfRt, par, e, a.rt_tab, ti);
        const double en = opnd(kPfEn, par, e, a.en_tab, ti);
        const double eff_add = st ? 0.0 : opnd(kPfAdd, par, e, a.add_tab, sig);
        const double eff_ready = (st ? 0.0 : ready_s) + lc(2, e);
        const double stat = c_sum_b - base[4 * E + e];
        const double stat_g = cg_sum_b - base[5 * E + e];
        double start = dmax(base[e], eff_ready);
        start = dmax(start, nb);
        const double end = start + rt;
        const double nf = dmin(base[E + e], start);
        const double nl = dmax(base[2 * E + e], end);
        const double nd = base[3 * E + e] + en;
        const double span = (nl - nf) * lc(0, e) + lc(1, e);
        double eb = stat + nd;
        eb = eb + span;
        eb = eb + eff_add;
        eb = eb + tj;
        const double gb = (span + nd) * lc(3, e) + stat_g;
        const double lkf = end * lk_c1 + opnd(kPfHv, par, e, a.hv_tab, hv) * lk_c2;
        const double dj = fen - en;
        double fjv = dj <= 0.0 ? 0.0 : dj * u_fd;
        const double ds = frt - rt;
        double fsv = ds <= 0.0 ? 0.0 : ds * u_fd;
        fjv = fjv * alpha / sf1;
        fsv = fsv * f_beta / sf2;
        run[e] = eb;
        run[E + e] = nl;
        run[2 * E + e] = gb;
        run[3 * E + e] = lkf;
        run[4 * E + e] = (fjv + fsv) * f_mu;
      }
    }

    // 2. Every lane scores; each thread keeps its first-min lane.
    double v = inf_d();
    int vi = tid;
    for (int i = 0, e = tid; i < lpt && e < E; ++i, e += NT) {
      const double obj = score_lane(run[e], run[E + e], run[2 * E + e], run[3 * E + e],
                                    run[4 * E + e], lc(4, e), (small ? my_alive : a.alive[e] != 0),
                                    c_cur, idle_on_sum, a1, b1, g1, w_idle_on);
      if (i == 0 || obj < v) {
        v = obj;
        vi = e;
      }
    }

    // 3. The commit of that lane, as if it wins, beside the scores and the
    // argmin (with one lane a thread the lane is known before its score).
    // Its second half waits for the helper's refresh of the slot summary
    // of the last step's lane.
    Commit cm;
    const int e = vi;
    const bool st_e = staged[sig * E + e] != 0;
    const double add_e = opnd(kPfAdd, par, e, a.add_tab, sig);
    const double idle_e = lc(0, e), su_e = lc(1, e);
    const double qd_e = lc(2, e), rate_e = lc(3, e);
    const double rt_e = opnd(kPfRt, par, e, a.rt_tab, ti);
    const double en_e = opnd(kPfEn, par, e, a.en_tab, ti);
    const double hv_e = opnd(kPfHv, par, e, a.hv_tab, hv);
    const double ready_e = (st_e ? 0.0 : ready_s) + qd_e;
    cm.tj2 = tj + (st_e ? 0.0 : add_e);
    cm.staged2 = st_e || shared_s;
    cm.start_v = dmax(base[e], ready_e);
    cm.start_v = dmax(cm.start_v, nb);
    cm.end_v = cm.start_v + rt_e;
    cm.nf_v = dmin(cm.start_v, base[E + e]);
    cm.nl_v = dmax(cm.end_v, base[2 * E + e]);
    cm.nd_v = base[3 * E + e] + en_e;
    cm.c_e = (cm.nl_v - cm.nf_v) * idle_e + su_e + cm.nd_v;
    cm.cg_e = rate_e * cm.c_e;
    const double ready2 = (cm.staged2 ? 0.0 : ready_s) + qd_e;
    // 4. First-min argmin: three integer reductions on ordered keys in the
    // warp, then the same across the warps; beside the helper's refresh.
    const unsigned long long key = order_key(v);
    const unsigned long long wkey = warp_min_key(key);
    int ei = static_cast<int>(__reduce_min_sync(
        kFull, key == wkey ? static_cast<unsigned>(vi) : 0xffffffffu));
    if (NW > 1) {
      unsigned long long* red_k = reinterpret_cast<unsigned long long*>(red_v);
      const int rb = (t & 1) * 32;
      if (lane == 0) {
        red_k[rb + warp] = wkey;
        red_i[rb + warp] = ei;
      }
      lanes_sync(NT);
      ei = warp_first_min(lane < NW ? red_k[rb + lane] : ~0ull,
                          lane < NW ? static_cast<unsigned>(red_i[rb + lane])
                                    : 0xffffffffu);
    }
    // the winner to the helper, which scans its row while the lanes
    // finish the commit
    if (tid == 0) {
      hand[kPubEi + (t & 1)] = ei;
      publish(hand + kFlagEi, t);
    }
    await_flag(hand + kFlagSum, t - 1);
    // the first-min slot takes end_v: the new minimum is the lower of end_v
    // and the others' minimum; then the committed lane's refresh against
    // the frozen run basis
    cm.sk = k1[e];
    cm.m2 = dmin(cm.end_v, min2[e]);
    double s2 = dmax(cm.m2, ready2);
    s2 = dmax(s2, nb);
    const double e2 = s2 + rt_e;
    const double nf2 = dmin(s2, cm.nf_v);
    cm.nl2 = dmax(e2, cm.nl_v);
    cm.e_b = (c_sum_b - cm.c_e) + (cm.nd_v + en_e);
    cm.e_b = cm.e_b + ((cm.nl2 - nf2) * idle_e + su_e);
    cm.e_b = cm.e_b + (cm.staged2 ? 0.0 : add_e);
    cm.e_b = cm.e_b + tj_b;
    cm.g_b = (cg_sum_b - cm.cg_e)
        + rate_e * (((cm.nl2 - nf2) * idle_e + su_e) + (cm.nd_v + en_e));
    cm.lk_e = e2 * lk_c1 + hv_e * lk_c2;


    // 5. The thread that owns the winning lane writes its commit.
    if (ei % NT == tid) {
      slots[(size_t)ei * C + cm.sk] = cm.end_v;
      staged[sig * E + ei] = cm.staged2 ? 1 : 0;
      base[ei] = cm.m2;
      base[E + ei] = cm.nf_v;
      base[2 * E + ei] = cm.nl_v;
      base[3 * E + ei] = cm.nd_v;
      base[4 * E + ei] = cm.c_e;
      base[5 * E + ei] = cm.cg_e;
      run[ei] = cm.e_b;          // fw (row 4) is per-run, never refreshed
      run[E + ei] = cm.nl2;
      run[2 * E + ei] = cm.g_b;
      run[3 * E + ei] = cm.lk_e;
      hs[kCCur] = dmax(c_cur, cm.end_v);
      hs[kTj] = cm.tj2;
      hs[kEndV] = cm.end_v;
      publish(hand + kFlagCommit, t);
      // the outputs after the release, which would otherwise wait for them
      a.ei_out[(size_t)h * T + t] = ei;
      a.start_out[(size_t)h * T + t] = cm.start_v;
      a.end_out[(size_t)h * T + t] = cm.end_v;
    }
    lanes_sync(NT);
  }

  // The helper warp: after each step's argmin, the winning lane's row
  // without its first-min slot; after the commit, that slot's new value
  // merged in: the lane's new first-min slot and the minimum of the rest.
  for (int t = 0; t < a.n_units && helper; ++t) {
    await_flag(hand + kFlagEi, t);
    const int e = hand[kPubEi + (t & 1)];
    const unsigned k = static_cast<unsigned>(k1[e]);
    // first-min key and slot of the row without slot k, and the least key
    // of the rest, in ordered keys (~0: none)
    const double* row = slots + (size_t)e * C;
    unsigned long long mine = ~0ull, rest = ~0ull;
    unsigned at = 0xffffffffu;
    for (int c = lane; c < C; c += 32) {
      if (static_cast<unsigned>(c) == k) continue;
      const unsigned long long x = order_key(row[c]);
      if (x < mine) {
        rest = mine < rest ? mine : rest;
        mine = x;
        at = c;
      } else {
        rest = x < rest ? x : rest;
      }
    }
    unsigned long long m1 = warp_min_key(mine);
    unsigned i1 = __reduce_min_sync(kFull, mine == m1 ? at : 0xffffffffu);
    unsigned long long m2 = warp_min_key(at == i1 ? rest : mine);
    await_flag(hand + kFlagCommit, t);
    // slot k's new value merged in
    const unsigned long long ke = order_key(hs[kEndV]);
    if (ke < m1 || (ke == m1 && k < i1)) {
      m2 = m1;
      m1 = ke;
      i1 = k;
    } else {
      m2 = ke < m2 ? ke : m2;
    }
    if (lane == 0) {
      k1[e] = static_cast<int>(i1);
      min2[e] = m2 == ~0ull ? inf_d() : from_key(m2);
      publish(hand + kFlagSum, t);
    }
    __syncwarp();
  }

  cp_async_wait_all();
  if (tid == 0) {
    hs[kCSumB] = c_sum_b;
    hs[kTjB] = tj_b;
    hs[kCgSumB] = cg_sum_b;
  }
  __syncthreads();
  for (int t = a.n_units + tid; t < T; t += nthr) {
    a.ei_out[(size_t)h * T + t] = 0;
    a.start_out[(size_t)h * T + t] = 0.0;
    a.end_out[(size_t)h * T + t] = 0.0;
  }
  if (on_chip) {
    for (int k = tid; k < 6 * E; k += nthr) a.base_out[(size_t)h * 6 * E + k] = base[k];
    for (int k = tid; k < 5 * E; k += nthr) a.run_out[(size_t)h * 5 * E + k] = run[k];
    for (int k = tid; k < S * E; k += nthr) a.staged_out[(size_t)h * S * E + k] = staged[k];
  }
  if (lay.slots >= 0)
    for (size_t k = tid; k < (size_t)E * C; k += nthr)
      a.slots_out[(size_t)h * E * C + k] = slots[k];
  if (tid < kNHs) a.hs_out[h * kNHs + tid] = hs[tid];
}

// Launch plan of a window of E lanes, C core slots and S input
// signatures: lanes per thread, lane threads (the helper warp comes on
// top), what lives in shared memory and its bytes.
struct WinPlan {
  int lpt, nt, mode;
  size_t smem;
};

WinPlan win_plan(int E, int C, int S) {
  WinPlan p;
  p.lpt = (E + kMaxLaneThreads - 1) / kMaxLaneThreads;
  p.nt = ((E + p.lpt - 1) / p.lpt + 31) / 32 * 32;
  // the lane state first (every step reads it), then the step operands,
  // then the slot matrix (the helper's, off the step's chain).  The
  // operands go on chip only beside the lane state: with the state in
  // global memory, their copies cost more than they save (PERF.md).
  const int modes[] = {7, 3, 2, 0};
  p.mode = 0;
  for (int mode : modes) {
    if ((size_t)win_layout(E, C, S, mode).total <= kMaxSmem) {
      p.mode = mode;
      break;
    }
  }
  p.smem = win_layout(E, C, S, p.mode).total;
  return p;
}

template <int MAXT>
int launch_window(const WinArgs& a, const WinPlan& p, int H, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      greedy_window_kernel<MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  greedy_window_kernel<MAXT><<<H, p.nt + 32, p.smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gf_score_fleet(const void* e_base, const void* nl, const void* g_base,
                   const void* lk, const void* fw, const void* wt,
                   const void* alive, double c_cur, double idle_on_sum,
                   double a1, double b1, double g1, double w_idle_on,
                   int lanes, void* obj, void* blk_min, void* blk_idx,
                   void* min_out, void* idx_out, void* stream) {
  const int nblk = (lanes + kScoreThreads - 1) / kScoreThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  score_fleet_kernel<<<nblk, kScoreThreads, 0, s>>>(
      static_cast<const double*>(e_base), static_cast<const double*>(nl),
      static_cast<const double*>(g_base), static_cast<const double*>(lk),
      static_cast<const double*>(fw), static_cast<const double*>(wt),
      static_cast<const uint8_t*>(alive), c_cur, idle_on_sum, a1, b1, g1,
      w_idle_on, lanes, static_cast<double*>(obj),
      static_cast<double*>(blk_min), static_cast<int*>(blk_idx));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_blocks_kernel<<<1, 32, 0, s>>>(
      static_cast<const double*>(blk_min), static_cast<const int*>(blk_idx),
      nblk, static_cast<double*>(min_out), static_cast<int*>(idx_out));
  return static_cast<int>(cudaGetLastError());
}

// The window's launch plan: lanes per thread, lane threads, the shared-
// memory mode (bit 0: the step operands, bit 1: the lane state, bit 2:
// the slot matrix) and its bytes.
void gf_greedy_window_plan(int E, int C, int S, int* lpt, int* nt, int* mode,
                           size_t* smem) {
  const WinPlan p = win_plan(E, C, S);
  *lpt = p.lpt;
  *nt = p.nt;
  *mode = p.mode;
  *smem = p.smem;
}

// E lanes (a multiple of 32), C core slots, T steps (n_units real), S
// input signatures, H heuristics (one CTA each).  k1_scr (H, E) int32 and
// min2_scr (H, E) float64 are scratch.  Returns a CUDA error code.
int gf_greedy_window(int n_ep, int E, int C, int T, int n_units, int S, int H,
                     const void* scal, const void* lane_c, const void* alive,
                     const void* rt_tab, const void* en_tab,
                     const void* fen_tab, const void* frt_tab,
                     const void* add_tab, const void* hv_tab,
                     const void* xs_i, const void* xs_d,
                     const void* base_in, const void* slots_in,
                     const void* run_in, const void* staged_in,
                     const void* hs_in, void* base_out, void* slots_out,
                     void* run_out, void* staged_out, void* hs_out,
                     void* ei_out, void* start_out, void* end_out,
                     void* k1_scr, void* min2_scr, void* stream) {
  if (E < 32 || E % 32 || C < 1 || H < 1 || n_ep < 1 || n_ep > E || n_units < 0 ||
      n_units > T || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const WinPlan p = win_plan(E, C, S);
  WinArgs a{n_ep, E, C, T, n_units, S, p.nt, p.lpt, p.mode,
            static_cast<const double*>(scal), static_cast<const double*>(lane_c),
            static_cast<const uint8_t*>(alive), static_cast<const double*>(rt_tab),
            static_cast<const double*>(en_tab), static_cast<const double*>(fen_tab),
            static_cast<const double*>(frt_tab), static_cast<const double*>(add_tab),
            static_cast<const double*>(hv_tab), static_cast<const int*>(xs_i),
            static_cast<const double*>(xs_d), static_cast<const double*>(base_in),
            static_cast<const double*>(slots_in), static_cast<const double*>(run_in),
            static_cast<const uint8_t*>(staged_in), static_cast<const double*>(hs_in),
            static_cast<double*>(base_out), static_cast<double*>(slots_out),
            static_cast<double*>(run_out), static_cast<uint8_t*>(staged_out),
            static_cast<double*>(hs_out), static_cast<int*>(ei_out),
            static_cast<double*>(start_out), static_cast<double*>(end_out),
            static_cast<int*>(k1_scr), static_cast<double*>(min2_scr)};
  auto st = static_cast<cudaStream_t>(stream);
  // fewer threads a block leave each more registers; the small instance
  // takes its lane state and operands on chip for granted
  const bool small = p.nt + 32 <= 256 && (p.mode & (kStateOnChip | kPfOnChip)) ==
                                              (kStateOnChip | kPfOnChip);
  return small ? launch_window<256>(a, p, H, st) : launch_window<1024>(a, p, H, st);
}

}  // extern "C"
