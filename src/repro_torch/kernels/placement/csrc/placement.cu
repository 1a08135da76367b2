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
//   launch per arrival window.  One CTA per ordering heuristic, one
//   thread per endpoint lane (E <= 1024, a multiple of 32).  The task
//   loop runs inside the kernel; the (6,E) base registers, the (5,E) run
//   registers and the (E,C) core slots stay in shared memory for the
//   whole window; the profile tables and per-task streams are read from
//   global memory once per step.
//   Bound on this card: the bytes it must move (the tables and streams
//   read once) take microseconds at 3.35 TB/s; what bounds it is the
//   serial chain of T dependent steps, each a block-wide argmin, a
//   commit by one warp and two barriers.  The design keeps the chain on
//   one SM per heuristic with no host round trip and no global-memory
//   carry; using only H of the 132 SMs is left for later work.
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
  const double c2 = fmax(nl, c_cur);
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

// Warp-wide minimum; every lane ends with the result.
__device__ __forceinline__ double warp_min_all(double v) {
  for (int off = 16; off > 0; off >>= 1) v = fmin(v, __shfl_xor_sync(kFull, v, off));
  return v;
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

// np.sum's pairwise association over x[0:n] (numpy's pairwise_sum:
// sequential under 8, 8-way unrolled blocks up to 128, halved above).
__device__ double pairwise_sum(const double* x, int n) {
  if (n < 8) {
    double res = 0.0;
    for (int i = 0; i < n; ++i) res = res + x[i];
    return res;
  }
  if (n <= 128) {
    double r[8];
    for (int j = 0; j < 8; ++j) r[j] = x[j];
    int i = 8;
    for (; i < n - (n % 8); i += 8)
      for (int j = 0; j < 8; ++j) r[j] = r[j] + x[i + j];
    double res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; ++i) res = res + x[i];
    return res;
  }
  int n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_sum(x, n2) + pairwise_sum(x + n2, n - n2);
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
// Per-heuristic scalar carry `hs`.
enum { kCCur, kTj, kCSumB, kTjB, kCgSumB, kNHs };

__global__ void __launch_bounds__(1024) greedy_window_kernel(
    int n_ep, int E, int C, int T, int n_units, int S,
    const double* __restrict__ scal,     // (12,)
    const double* __restrict__ lane_c,   // (5, E): idle_bt su_bt qd rates wt
    const uint8_t* __restrict__ alive,   // (E,)
    const double* __restrict__ rt_tab,   // (P, E)
    const double* __restrict__ en_tab,   // (P, E)
    const double* __restrict__ fen_tab,  // (P,)
    const double* __restrict__ frt_tab,  // (P,)
    const double* __restrict__ add_tab,  // (S, E)
    const double* __restrict__ hv_tab,   // (V, E)
    const int* __restrict__ xs_i,        // (H, 3, T): ti hv_id sig
    const double* __restrict__ xs_d,     // (H, 5, T): ready_s nb u_tw u_oj u_fd
    const uint8_t* __restrict__ xs_b,    // (H, 2, T): shared_s new_run
    const double* __restrict__ base_in,  // (H, 6, E): mins first last dyn const const_g
    const double* __restrict__ slots_in, // (H, E, C)
    const double* __restrict__ run_in,   // (H, 5, E): e_base nl g_base lk fw
    const uint8_t* __restrict__ staged_in,  // (H, S, E)
    const double* __restrict__ hs_in,    // (H, 5): c_cur tj c_sum_b tj_b cg_sum_b
    double* __restrict__ base_out, double* __restrict__ slots_out,
    double* __restrict__ run_out, uint8_t* __restrict__ staged_out,
    double* __restrict__ hs_out, int* __restrict__ ei_out,
    double* __restrict__ start_out, double* __restrict__ end_out) {
  extern __shared__ double smem[];
  double* s_base = smem;              // (6, E)
  double* s_run = s_base + 6 * E;     // (5, E)
  double* s_slots = s_run + 5 * E;    // (E, C)
  double* s_hs = s_slots + E * C;     // kNHs scalars + 2 run-basis sums
  double* s_rv = s_hs + 8;            // one (value) per warp
  int* s_ri = reinterpret_cast<int*>(s_rv + 32);  // one (index) per warp

  const int h = blockIdx.x;
  const int e = threadIdx.x;
  const int lane = e & 31;
  const int warp = e >> 5;

  for (int r = 0; r < 6; ++r) s_base[r * E + e] = base_in[((size_t)h * 6 + r) * E + e];
  for (int r = 0; r < 5; ++r) s_run[r * E + e] = run_in[((size_t)h * 5 + r) * E + e];
  for (int k = e; k < E * C; k += E) s_slots[k] = slots_in[(size_t)h * E * C + k];
  uint8_t* st_h = staged_out + (size_t)h * S * E;
  for (int s = 0; s < S; ++s) st_h[s * E + e] = staged_in[((size_t)h * S + s) * E + e];
  if (e < kNHs) s_hs[e] = hs_in[h * kNHs + e];

  const double idle_bt = lane_c[e], su_bt = lane_c[E + e], qd = lane_c[2 * E + e];
  const double rates = lane_c[3 * E + e], wt = lane_c[4 * E + e];
  const bool alv = alive[e] != 0;
  const double a1 = scal[kA1], b1 = scal[kB1], g1 = scal[kG1];
  const double idle_on_sum = scal[kIdleOnSum], w_idle_on = scal[kWIdleOn];
  const double lam_b1 = scal[kLamB1], lam_a1 = scal[kLamA1];
  const double alpha = scal[kAlpha], sf1 = scal[kSf1], sf2 = scal[kSf2];
  const double f_beta = scal[kFBeta], f_mu = scal[kFMu];

  const int* xi = xs_i + (size_t)h * 3 * T;
  const double* xd = xs_d + (size_t)h * 5 * T;
  const uint8_t* xb = xs_b + (size_t)h * 2 * T;
  __syncthreads();

  // Pad steps (t >= n_units) only write old values back in the scan, so
  // the loop stops at n_units.
  for (int t = 0; t < n_units; ++t) {
    const int ti = xi[t], hv = xi[T + t], sig = xi[2 * T + t];
    const double ready_s = xd[t], nb = xd[T + t];
    const double u_tw = xd[2 * T + t], u_oj = xd[3 * T + t], u_fd = xd[4 * T + t];
    const bool shared_s = xb[t] != 0, new_run = xb[T + t] != 0;
    const double lk_c1 = lam_b1 * u_tw;
    const double lk_c2 = lam_a1 * u_oj;

    // 1-2. On a run boundary: the full pass, against run-basis sums in
    // numpy's pairwise order (one thread, over the n_ep true lanes).
    if (new_run) {
      if (e == 0) {
        s_hs[5] = pairwise_sum(s_base + 4 * E, n_ep);
        s_hs[6] = pairwise_sum(s_base + 5 * E, n_ep);
      }
      __syncthreads();
      const bool st = st_h[sig * E + e] != 0;
      const double rt = rt_tab[(size_t)ti * E + e], en = en_tab[(size_t)ti * E + e];
      const double eff_add = st ? 0.0 : add_tab[sig * E + e];
      const double eff_ready = (st ? 0.0 : ready_s) + qd;
      const double c_sum_f = s_hs[5], cg_sum_f = s_hs[6], tj = s_hs[kTj];
      const double stat = c_sum_f - s_base[4 * E + e];
      const double stat_g = cg_sum_f - s_base[5 * E + e];
      double start = fmax(s_base[e], eff_ready);
      start = fmax(start, nb);
      const double end = start + rt;
      const double nf = fmin(s_base[E + e], start);
      const double nl = fmax(s_base[2 * E + e], end);
      const double nd = s_base[3 * E + e] + en;
      const double span = (nl - nf) * idle_bt + su_bt;
      double eb = stat + nd;
      eb = eb + span;
      eb = eb + eff_add;
      eb = eb + tj;
      const double gb = (span + nd) * rates + stat_g;
      const double lkf = end * lk_c1 + hv_tab[hv * E + e] * lk_c2;
      const double dj = fen_tab[ti] - en;
      double fjv = dj <= 0.0 ? 0.0 : dj * u_fd;
      const double ds = frt_tab[ti] - rt;
      double fsv = ds <= 0.0 ? 0.0 : ds * u_fd;
      fjv = fjv * alpha / sf1;
      fsv = fsv * f_beta / sf2;
      s_run[e] = eb;
      s_run[E + e] = nl;
      s_run[2 * E + e] = gb;
      s_run[3 * E + e] = lkf;
      s_run[4 * E + e] = (fjv + fsv) * f_mu;
      if (e == 0) {
        s_hs[kCSumB] = c_sum_f;
        s_hs[kTjB] = tj;
        s_hs[kCgSumB] = cg_sum_f;
      }
    }

    // 3. Every lane scores and joins the block argmin.
    double v = score_lane(s_run[e], s_run[E + e], s_run[2 * E + e],
                          s_run[3 * E + e], s_run[4 * E + e], wt, alv,
                          s_hs[kCCur], idle_on_sum, a1, b1, g1, w_idle_on);
    int ei = e;
    block_argmin(v, ei, s_rv, s_ri);

    // 4. Warp 0 commits: every lane computes the same scalars, the lanes
    // split the slot scan, lane 0 writes.
    if (warp == 0) {
      const bool st_e = st_h[sig * E + ei] != 0;
      const double add_e = add_tab[sig * E + ei];
      const double idle_e = lane_c[ei], su_e = lane_c[E + ei];
      const double qd_e = lane_c[2 * E + ei], rate_e = lane_c[3 * E + ei];
      const double rt_e = rt_tab[(size_t)ti * E + ei], en_e = en_tab[(size_t)ti * E + ei];
      const double hv_e = hv_tab[hv * E + ei];
      const double c_cur = s_hs[kCCur], tj = s_hs[kTj];
      const double c_sum_b = s_hs[kCSumB], tj_b = s_hs[kTjB], cg_sum_b = s_hs[kCgSumB];
      const double ready_e = (st_e ? 0.0 : ready_s) + qd_e;
      const double tj2 = tj + (st_e ? 0.0 : add_e);
      const bool staged_e2 = st_e || shared_s;
      double start_v = fmax(s_base[ei], ready_e);
      start_v = fmax(start_v, nb);
      const double end_v = start_v + rt_e;
      const double nf_v = fmin(start_v, s_base[E + ei]);
      const double nl_v = fmax(end_v, s_base[2 * E + ei]);
      const double nd_v = s_base[3 * E + ei] + en_e;
      // first-min core slot (like list.index(min)), then the new slot min
      double* row = s_slots + (size_t)ei * C;
      double sv = inf_d();
      int sk = INT_MAX;
      for (int c = lane; c < C; c += 32) lex_min(sv, sk, row[c], c);
      warp_argmin(sv, sk);
      sk = __shfl_sync(kFull, sk, 0);
      double mv = inf_d();
      for (int c = lane; c < C; c += 32) mv = fmin(mv, c == sk ? end_v : row[c]);
      const double m2 = warp_min_all(mv);
      const double c_e = (nl_v - nf_v) * idle_e + su_e + nd_v;
      const double cg_e = rate_e * c_e;
      // refresh of the committed lane against the frozen run basis
      const double ready2 = (staged_e2 ? 0.0 : ready_s) + qd_e;
      double s2 = fmax(m2, ready2);
      s2 = fmax(s2, nb);
      const double e2 = s2 + rt_e;
      const double nf2 = fmin(s2, nf_v);
      const double nl2 = fmax(e2, nl_v);
      double e_b = (c_sum_b - c_e) + (nd_v + en_e);
      e_b = e_b + ((nl2 - nf2) * idle_e + su_e);
      e_b = e_b + (staged_e2 ? 0.0 : add_e);
      e_b = e_b + tj_b;
      const double g_b = (cg_sum_b - cg_e)
          + rate_e * (((nl2 - nf2) * idle_e + su_e) + (nd_v + en_e));
      const double lk_e = e2 * lk_c1 + hv_e * lk_c2;
      __syncwarp();
      if (lane == 0) {
        row[sk] = end_v;
        st_h[sig * E + ei] = staged_e2 ? 1 : 0;
        s_base[ei] = m2;
        s_base[E + ei] = nf_v;
        s_base[2 * E + ei] = nl_v;
        s_base[3 * E + ei] = nd_v;
        s_base[4 * E + ei] = c_e;
        s_base[5 * E + ei] = cg_e;
        s_run[ei] = e_b;             // fw (row 4) is per-run, never refreshed
        s_run[E + ei] = nl2;
        s_run[2 * E + ei] = g_b;
        s_run[3 * E + ei] = lk_e;
        s_hs[kCCur] = fmax(c_cur, end_v);
        s_hs[kTj] = tj2;
        ei_out[(size_t)h * T + t] = ei;
        start_out[(size_t)h * T + t] = start_v;
        end_out[(size_t)h * T + t] = end_v;
      }
    }
    // 5.
    __syncthreads();
  }

  for (int t = n_units + e; t < T; t += E) {
    ei_out[(size_t)h * T + t] = 0;
    start_out[(size_t)h * T + t] = 0.0;
    end_out[(size_t)h * T + t] = 0.0;
  }
  for (int r = 0; r < 6; ++r) base_out[((size_t)h * 6 + r) * E + e] = s_base[r * E + e];
  for (int r = 0; r < 5; ++r) run_out[((size_t)h * 5 + r) * E + e] = s_run[r * E + e];
  for (int k = e; k < E * C; k += E) slots_out[(size_t)h * E * C + k] = s_slots[k];
  if (e < kNHs) hs_out[h * kNHs + e] = s_hs[e];
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

size_t gf_greedy_window_smem(int E, int C) {
  return (static_cast<size_t>(11 * E + E * C + 8 + 32)) * sizeof(double)
      + 32 * sizeof(int);
}

int gf_greedy_window(int n_ep, int E, int C, int T, int n_units, int S, int H,
                     const void* scal, const void* lane_c, const void* alive,
                     const void* rt_tab, const void* en_tab,
                     const void* fen_tab, const void* frt_tab,
                     const void* add_tab, const void* hv_tab,
                     const void* xs_i, const void* xs_d, const void* xs_b,
                     const void* base_in, const void* slots_in,
                     const void* run_in, const void* staged_in,
                     const void* hs_in, void* base_out, void* slots_out,
                     void* run_out, void* staged_out, void* hs_out,
                     void* ei_out, void* start_out, void* end_out,
                     void* stream) {
  const size_t smem = gf_greedy_window_smem(E, C);
  cudaError_t err = cudaFuncSetAttribute(
      greedy_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  greedy_window_kernel<<<H, E, smem, static_cast<cudaStream_t>(stream)>>>(
      n_ep, E, C, T, n_units, S, static_cast<const double*>(scal),
      static_cast<const double*>(lane_c), static_cast<const uint8_t*>(alive),
      static_cast<const double*>(rt_tab), static_cast<const double*>(en_tab),
      static_cast<const double*>(fen_tab), static_cast<const double*>(frt_tab),
      static_cast<const double*>(add_tab), static_cast<const double*>(hv_tab),
      static_cast<const int*>(xs_i), static_cast<const double*>(xs_d),
      static_cast<const uint8_t*>(xs_b), static_cast<const double*>(base_in),
      static_cast<const double*>(slots_in), static_cast<const double*>(run_in),
      static_cast<const uint8_t*>(staged_in), static_cast<const double*>(hs_in),
      static_cast<double*>(base_out), static_cast<double*>(slots_out),
      static_cast<double*>(run_out), static_cast<uint8_t*>(staged_out),
      static_cast<double*>(hs_out), static_cast<int*>(ei_out),
      static_cast<double*>(start_out), static_cast<double*>(end_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
