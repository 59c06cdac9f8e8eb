// Banded pYIN Viterbi decode for NVIDIA Hopper (sm_90a), with a plain C
// interface that aegis_tpu_torch/core/pyin_cuda.py loads through ctypes.
//
// Replaces the two Pallas TPU kernels of aegis_tpu/core/pyin_pallas.py:
//   viterbi_fwd  <- _fwd_kernel  (forward max-plus pass, pyin_pallas.py:98)
//   viterbi_back <- _back_kernel (backtrace, pyin_pallas.py:198)
//
// Semantics are those of the dense lax.scan decode, viterbi_decode in
// aegis_tpu/core/pyin.py, state for state: two chains (voiced, unvoiced)
// of n pitch states; each step takes, per destination state j, the max and
// first argmax over ALL sources i of delta[i] + log(trans[i, j] + 1e-30),
// then stay/switch between the chains and the log observation.  Every
// candidate the kernels compare carries the dense scan's own float32 score
// (one add of the same two operands), and the best is always the largest
// score with the smallest source index, so backpointers, final delta and
// states are identical to the scan's, ties included.
//
// The forward pass.  What bounds it: a serial chain of T - 1 dependent
// steps.  One step is n(2w+1) - w(w+1) in-band (source, destination) pairs
// per chain (n = 450: 81k at w = 101, 44k at w = 51), each an add and a
// compare, so the floor of a step is instruction issue, not bytes; measured
// on the H100, about half of a step scales with the pairs and the SMs that
// share them, the rest (a thread's own chain, the merge, the block maximum,
// the barrier) does not (PERF.md has the runs).  What the design does:
//   * The transition score of a pair depends only on |i - j| and on the
//     source's row class, min(i, n-1-i, w) (its distance from the nearer
//     edge decides its row sum; all interior sources share one row).  The
//     host sends that (w+1, w+1) table (core/tables.py::band_class_table,
//     checked bit for bit against the (n, 2w+1) band); the kernel expands
//     each row symmetrically into shared memory, so the step loop reads no
//     global memory for scores.  Where n < 2w + 1 the class is the source
//     itself; where the expanded table does not fit shared memory the
//     compact one is read through the read-only path instead.
//   * A thread owns a tile of D = 8 consecutive destinations and every S-th
//     group of four of their sources: two 16-byte loads of delta serve 64
//     pair scores; four scores fold into one maximum and one compare with
//     the running best.  (Hopper's three-way integer minima on the scores'
//     bit patterns were 0 to 4 % faster, but order negative floats only;
//     PERF.md has the runs.)  The S partial results are merged by a
//     transposing shuffle reduction that leaves each destination with one
//     owner lane, in destination order across the warp, so the backpointer
//     stores are coalesced; the owner then finds the winning group's first
//     source.
//   * Out of the band the dense matrix holds one constant, log_floor.  The
//     best such candidate is the global first argmax g of delta + log_floor
//     whenever g lies outside the destination's band; when g lies inside,
//     the in-band candidate g beats every out-of-band one (its score is
//     larger by log_floor's distance to the band, ~59, far above float32
//     rounding for |delta| < 2^27, which T <= 2^20 frames guarantees).
//     So one (max, first index) reduction a step replaces the four prefix /
//     suffix scans of the first version; it rides on the step's only barrier.
//   * A thread-block cluster of up to 8 CTAs shares one sequence: each CTA
//     owns a range of destination tiles and keeps all of delta, written by
//     the owners into every CTA's shared memory (distributed shared memory),
//     one cluster barrier a step.  The wrapper picks the cluster by B.
//   * Observations of frame t + 1 are loaded into registers at the top of
//     step t, a whole step ahead of their use; backpointer stores are
//     fire-and-forget; delta is double-buffered, so one barrier a step
//     suffices.
//   * Large pitch grids (viterbi_fwd_wide_kernel).  viterbi_fwd_kernel gives
//     each thread one tile, so a CTA's tiles must fit its 512 threads, and
//     the block maximum takes one warp's lanes, so the cluster may hold 32
//     warps: n up to 512 in every variant.  Past that (n = 900 at 0.05
//     semitone a bin, 2250 at 0.02) the wide kernel deals the CTA's tiles
//     to its threads in passes, tile p * (threads / S) + thread / S in pass
//     p, so a thread owns one tile a pass and `passes` tiles a step.  Its
//     own delta no longer fits registers: each owner writes its new delta
//     straight into the other buffer (in every CTA) and folds it into a
//     running (max, first index) that it publishes at the end of the step;
//     the next step reduces those in two levels (each lane over every 32nd
//     warp, then a butterfly that compares indices as well as values), so
//     the cluster may hold any number of warps.  The pairs, the merge, the
//     out-of-band rule and the stay / switch are those of the one-pass
//     kernel, so its results are the same.  Shared memory bounds n: the
//     double-buffered delta, the row offsets and the warp maxima must fit
//     (n up to about 10 400 at w = 501, 11 300 at w = 51 on an H100); the
//     expanded table goes to shared memory only where it fits beside them.
//
// The backtrace.  What bounds it: T dependent loads.  The frames are cut
// into chunks of C; viterbi_back_maps_kernel walks every chunk down from
// every entry state in parallel and stores the exit state (C dependent
// loads); viterbi_back_walk_kernel then finds the final argmax by a block
// reduction, hops down the chunk maps to its chunk's entry state (at most
// T / C loads) and re-walks its own chunk writing the states (C loads):
// about 2 C + T / C dependent loads instead of T, all from L2, where the
// forward pass has just put the backpointers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 512;  // the most threads a CTA is launched with
constexpr unsigned kFullMask = 0xffffffffu;

// (value, index) ordered as jnp.argmax orders candidates: the larger value
// wins; on equal values the smaller index.
__device__ __forceinline__ void take_better(float& v, int& i, float v2,
                                            int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Warp-wide (max, first index) of values whose indices ascend with the
// lane: a butterfly on the value, then the lowest lane that holds the max
// supplies the index.  All lanes return the result.
__device__ __forceinline__ void warp_first_max(float& v, int& i) {
  float m = v;
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFullMask, m, off));
  const unsigned hit = __ballot_sync(kFullMask, v == m);
  i = __shfl_sync(kFullMask, i, __ffs(hit) - 1);
  v = m;
}

// Warp-wide (max, first index) of values in any index order: a butterfly
// that takes the better pair each round.  All lanes return the result.
__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const float v2 = __shfl_xor_sync(kFullMask, v, off);
    const int i2 = __shfl_xor_sync(kFullMask, i, off);
    take_better(v, i, v2, i2);
  }
}

// One round of the transposing merge over lanes s and s ^ M: the lane whose
// bit M is clear keeps the lower half of the L live destinations and sends
// the upper half, its partner the other way round.
template <int L, int M>
struct Merge {
  static __device__ __forceinline__ void run(float* mv, int* bv, float* mu,
                                             int* bu, int s) {
    const bool upper = (s & M) != 0;
#pragma unroll
    for (int k = 0; k < L / 2; ++k) {
      const int h = k + L / 2;
      float keep_v = upper ? mv[h] : mv[k];
      int keep_bv = upper ? bv[h] : bv[k];
      float keep_u = upper ? mu[h] : mu[k];
      int keep_bu = upper ? bu[h] : bu[k];
      const float send_v = upper ? mv[k] : mv[h];
      const int send_bv = upper ? bv[k] : bv[h];
      const float send_u = upper ? mu[k] : mu[h];
      const int send_bu = upper ? bu[k] : bu[h];
      take_better(keep_v, keep_bv, __shfl_xor_sync(kFullMask, send_v, M),
                  __shfl_xor_sync(kFullMask, send_bv, M));
      take_better(keep_u, keep_bu, __shfl_xor_sync(kFullMask, send_u, M),
                  __shfl_xor_sync(kFullMask, send_bu, M));
      mv[k] = keep_v;
      bv[k] = keep_bv;
      mu[k] = keep_u;
      bu[k] = keep_bu;
    }
    Merge<L / 2, M / 2>::run(mv, bv, mu, bu, s);
  }
};
// Once a lane is down to one destination, the lanes that still share it
// (S > D) finish with butterfly rounds: both partners keep the result.
template <int M>
struct Merge<1, M> {
  static __device__ __forceinline__ void run(float* mv, int* bv, float* mu,
                                             int* bu, int s) {
    take_better(mv[0], bv[0], __shfl_xor_sync(kFullMask, mv[0], M),
                __shfl_xor_sync(kFullMask, bv[0], M));
    take_better(mu[0], bu[0], __shfl_xor_sync(kFullMask, mu[0], M),
                __shfl_xor_sync(kFullMask, bu[0], M));
    Merge<1, M / 2>::run(mv, bv, mu, bu, s);
  }
};
template <int L>
struct Merge<L, 0> {
  static __device__ __forceinline__ void run(float*, int*, float*, int*, int) {}
};
template <>
struct Merge<1, 0> {
  static __device__ __forceinline__ void run(float*, int*, float*, int*, int) {}
};

// Groups of four sources are dealt to the S lanes of a tile in turn (lane
// s takes groups s, S + s, ...): the groups a lane takes.
__host__ __device__ inline int groups_per_lane(int w, int D, int S) {
  return (2 * w + D + 4 * S - 1) / (4 * S);
}
// Sources of a tile that its lanes walk between them, 2w + D rounded up.
__host__ __device__ inline int tile_span(int w, int D, int S) {
  return 4 * S * groups_per_lane(w, D, S);
}
// Floats in one symmetric row of the expanded score table: the span and
// D - 1 more slots, a multiple of 4.
__host__ __device__ inline int row_stride(int w, int D, int S) {
  return (tile_span(w, D, S) + D - 1 + 3) / 4 * 4;
}
// States a delta buffer holds: w pads below state 0 (so a tile's first
// source sits on a 16-byte boundary), the states, and pads up to the last
// tile's last source; the pads hold -inf and never win.
__host__ __device__ inline int delta_stride(int n, int w, int D, int S) {
  const int span = tile_span(w, D, S);
  return (n + (span > 2 * w ? span : 2 * w) + D + 3) / 4 * 4;
}

// The score of source i into destination j, |i - j| within the tile's
// reach: row_off is the source's row offset into the table.
template <int D, bool kTabSmem>
__device__ __forceinline__ float pair_score(const float* __restrict__ table,
                                            int row_off, int i, int j, int w,
                                            float log_floor) {
  if (kTabSmem) return table[row_off + (i - j) + (w + D - 1)];
  const int x = i - j;
  const int ax = x < 0 ? -x : x;
  return ax <= w ? __ldg(table + row_off + ax) : log_floor;
}

// One lane's pass over its share of a tile's sources (every S-th group of
// four, in index order) for the tile's D destinations: per destination and
// chain the best score and the first source of the group that raised it.
// A group of -inf scores raises nothing, so a destination whose in-band
// sources are all -inf keeps INT_MAX.
template <int D, int S, bool kTabSmem>
__device__ __forceinline__ void scan_tile(
    float (&mv)[D], int (&bv)[D], float (&mu)[D], int (&bu)[D],
    const float* dvp, const float* dup, const int* row_off,
    const float* __restrict__ table, int lo, int n_groups, int s, int j0,
    int w, float log_floor) {
  for (int m = 0; m < n_groups; ++m) {
    const int i = lo + 4 * (m * S + s);
    // w + i = j0 + a multiple of 4: 16-byte aligned
    const float4 dv4 = *reinterpret_cast<const float4*>(dvp + w + i);
    const float4 du4 = *reinterpret_cast<const float4*>(dup + w + i);
    const int4 off4 = *reinterpret_cast<const int4*>(row_off + w + i);
#pragma unroll
    for (int e = 0; e < D; ++e) {
      const int j = j0 + e;
      const float l0 =
          pair_score<D, kTabSmem>(table, off4.x, i, j, w, log_floor);
      const float l1 =
          pair_score<D, kTabSmem>(table, off4.y, i + 1, j, w, log_floor);
      const float l2 =
          pair_score<D, kTabSmem>(table, off4.z, i + 2, j, w, log_floor);
      const float l3 =
          pair_score<D, kTabSmem>(table, off4.w, i + 3, j, w, log_floor);
      // the maximum of the four first, then one compare a group
      const float a = fmaxf(fmaxf(dv4.x + l0, dv4.y + l1),
                            fmaxf(dv4.z + l2, dv4.w + l3));
      const float b = fmaxf(fmaxf(du4.x + l0, du4.y + l1),
                            fmaxf(du4.z + l2, du4.w + l3));
      if (a > mv[e]) {
        mv[e] = a;
        bv[e] = i;
      }
      if (b > mu[e]) {
        mu[e] = b;
        bu[e] = i;
      }
    }
  }
}

// D destinations a thread, S lanes a destination tile (powers of two; with
// S > D the S / D lanes that end on one destination share it, and the
// first of them owns it).  Four sources' scores and the running best fold
// into one maximum and one compare a group (scan_tile); afterwards the owner
// finds the winning group's first source that attains the maximum.  Only
// float adds and comparisons touch a score, so scores of either sign and
// -inf give the dense scan's results.  The expanded score table lies in
// shared memory, or the compact one in global memory.
template <int D, int S, bool kTabSmem>
__global__ void __launch_bounds__(kMaxThreads)
viterbi_fwd_kernel(const float* __restrict__ log_obs_v,  // (B, T, n)
                   const float* __restrict__ log_obs_u,  // (B, T)
                   const float* __restrict__ tab,        // (n_cls, w+1)
                   int* __restrict__ psi_v,              // (B, T, n)
                   int* __restrict__ psi_u,              // (B, T, n)
                   float* __restrict__ delta_last,       // (B, 2, n)
                   int T, int n, int w, int n_cls, int per_source,
                   int csize, int tiles_per_cta, float log_init,
                   float log_floor, float log_stay, float log_switch) {
  static_assert(S <= 2 * D, "at most two lanes share a destination");
  static_assert(D % 4 == 0, "a tile starts on a group of four sources");
  constexpr int R = D >= S ? D / S : 1;      // destinations a lane ends with
  constexpr int kShare = S > D ? S / D : 1;  // lanes that end on the same
  extern __shared__ __align__(16) float smem[];
  const int rs = row_stride(w, D, S);
  const int np = delta_stride(n, w, D, S);
  const int tab_floats = kTabSmem ? (n_cls * rs + 3) / 4 * 4 : 0;
  // [expanded table] [delta: buffer, chain, padded state] [row offsets]
  // [warp maxima] [their indices]
  float* etab = smem;
  float* dbuf = smem + tab_floats;
  int* row_off = reinterpret_cast<int*>(dbuf + 2 * 2 * np);  // [w + state]
  float* wred_val = reinterpret_cast<float*>(row_off + np);
  int* wred_idx = reinterpret_cast<int*>(wred_val + 2 * 2 * 32);
  const float* table = kTabSmem ? etab : tab;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // a cluster of csize CTAs shares one sequence: CTA `rank` owns
  // tiles_per_cta destination tiles, every CTA keeps all of delta
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = csize > 1 ? (int)cluster.block_rank() : 0;
  const int warp = rank * (blockDim.x >> 5) + (tid >> 5);  // across the CTAs
  const int n_warps = csize * (blockDim.x >> 5);
  const int s = tid % S;
  const int group = rank * tiles_per_cta + tid / S;
  const int j0 = group * D;  // the tile's first destination
  const bool tile_live = tid / S < tiles_per_cta && j0 < n;
  const size_t seq = blockIdx.x / csize;
  const float* obs_v = log_obs_v + seq * T * n;
  const float* obs_u = log_obs_u + seq * T;
  int* pv_out = psi_v + seq * T * n;
  int* pu_out = psi_u + seq * T * n;

  if (kTabSmem) {
    // row c, slot k holds the score at offset x = k - (w + D - 1): the
    // compact entry |x| inside the band, log_floor beyond it
    for (int k = tid; k < n_cls * rs; k += blockDim.x) {
      const int x = k % rs - (w + D - 1);
      const int ax = x < 0 ? -x : x;
      etab[k] = ax <= w ? tab[(k / rs) * (w + 1) + ax] : log_floor;
    }
  }
  for (int k = tid; k < np; k += blockDim.x) {
    // slot k is state i = k - w; a pad takes the row of the nearest state
    int i = k - w;
    i = i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
    int cls = i < n - 1 - i ? i : n - 1 - i;
    cls = cls < w ? cls : w;
    if (per_source) cls = i;
    row_off[k] = cls * (kTabSmem ? rs : w + 1);
    if (k < w || k >= w + n) {
#pragma unroll
      for (int b = 0; b < 4; ++b) dbuf[b * np + k] = -INFINITY;
    }
  }

  // this thread's share of the tile's sources: every S-th group of four,
  // pads included
  const int lo = j0 - w;
  const int n_groups = tile_live ? groups_per_lane(w, D, S) : 0;

  // the destinations this lane owns after the merge, and their delta;
  // a lane of a tile that is not live owns none
  const int j_own =
      tile_live && s % kShare == 0 ? j0 + (s / kShare) * R : n;
  // no CTA writes another's shared memory before that CTA has started
  if (csize > 1) cluster.sync();
  float dv[R], du[R], ov_next[R];
  float ou_next = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool live = j_own + r < n;
    dv[r] = live ? log_init + obs_v[j_own + r] : -INFINITY;
    du[r] = live ? log_init + obs_u[0] : -INFINITY;
    ov_next[r] = 0.0f;
    if (live) {  // frame 0 has no predecessor
      pv_out[j_own + r] = 0;
      pu_out[j_own + r] = 0;
      if (T > 1) ov_next[r] = obs_v[(size_t)n + j_own + r];
    }
  }
  if (T > 1) ou_next = obs_u[1];

  for (int t = 1; t < T; ++t) {
    const int cur = (t - 1) & 1;
    // delta of frame t-1, indexed by w + state
    float* dvp = dbuf + (cur * 2 + 0) * np;
    float* dup = dbuf + (cur * 2 + 1) * np;
    // observations of this frame arrived a step ago; ask for the next
    float ov[R];
    const float ou = ou_next;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ov[r] = ov_next[r];
      if (t + 1 < T && j_own + r < n)
        ov_next[r] = obs_v[(size_t)(t + 1) * n + j_own + r];
    }
    if (t + 1 < T) ou_next = obs_u[t + 1];

    // publish delta of frame t-1 and this warp's (max, first index) of
    // delta + log_floor, the out-of-band candidate
    float gv = -INFINITY, gu = -INFINITY;
    int gvi = INT_MAX, gui = INT_MAX;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (j_own + r < n) {
        if (csize > 1) {
          for (int q = 0; q < csize; ++q) {
            cluster.map_shared_rank(dvp, q)[w + j_own + r] = dv[r];
            cluster.map_shared_rank(dup, q)[w + j_own + r] = du[r];
          }
        } else {
          dvp[w + j_own + r] = dv[r];
          dup[w + j_own + r] = du[r];
        }
        const float fv = dv[r] + log_floor;
        const float fu = du[r] + log_floor;
        if (fv > gv || gvi == INT_MAX) {
          gv = fv;
          gvi = j_own + r;
        }
        if (fu > gu || gui == INT_MAX) {
          gu = fu;
          gui = j_own + r;
        }
      }
    }
    warp_first_max(gv, gvi);
    warp_first_max(gu, gui);
    if (lane == 0) {
      for (int q = 0; q < csize; ++q) {
        float* val = csize > 1 ? cluster.map_shared_rank(wred_val, q) : wred_val;
        int* idx = csize > 1 ? cluster.map_shared_rank(wred_idx, q) : wred_idx;
        val[(cur * 2 + 0) * 32 + warp] = gv;
        idx[(cur * 2 + 0) * 32 + warp] = gvi;
        val[(cur * 2 + 1) * 32 + warp] = gu;
        idx[(cur * 2 + 1) * 32 + warp] = gui;
      }
    }
    // delta of frame t-1 and the warp maxima are visible (in every CTA)
    if (csize > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
    gv = lane < n_warps ? wred_val[(cur * 2 + 0) * 32 + lane] : -INFINITY;
    gvi = lane < n_warps ? wred_idx[(cur * 2 + 0) * 32 + lane] : INT_MAX;
    gu = lane < n_warps ? wred_val[(cur * 2 + 1) * 32 + lane] : -INFINITY;
    gui = lane < n_warps ? wred_idx[(cur * 2 + 1) * 32 + lane] : INT_MAX;
    warp_first_max(gv, gvi);
    warp_first_max(gu, gui);

    // in-band candidates of the tile, this thread's sources in index
    // order: (best score, the first source of its group of four)
    float mv[D], mu[D];
    int bv[D], bu[D];
#pragma unroll
    for (int e = 0; e < D; ++e) {
      mv[e] = mu[e] = -INFINITY;
      bv[e] = bu[e] = INT_MAX;
    }
    scan_tile<D, S, kTabSmem>(mv, bv, mu, bu, dvp, dup, row_off, table, lo,
                              n_groups, s, j0, w, log_floor);
    Merge<D, S / 2>::run(mv, bv, mu, bu, s);

    // the lane's own destinations: out-of-band candidate, stay / switch
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = j_own + r;
      if (j < n) {
        float best_v = mv[r], best_u = mu[r];
        int from_v = bv[r], from_u = bu[r];
        // the winning group's first source that attains the maximum; with
        // every in-band score -inf, the first in-band source
        const int first_in = j > w ? j - w : 0;
        const int gv0 = from_v == INT_MAX ? first_in : from_v;
        const int gu0 = from_u == INT_MAX ? first_in : from_u;
        from_v = gv0;
        from_u = gu0;
#pragma unroll
        for (int k = 3; k >= 0; --k) {
          if (dvp[w + gv0 + k] +
                  pair_score<D, kTabSmem>(table, row_off[w + gv0 + k],
                                          gv0 + k, j, w, log_floor) ==
              best_v)
            from_v = gv0 + k;
          if (dup[w + gu0 + k] +
                  pair_score<D, kTabSmem>(table, row_off[w + gu0 + k],
                                          gu0 + k, j, w, log_floor) ==
              best_u)
            from_u = gu0 + k;
        }
        if (gvi < j - w || gvi > j + w) take_better(best_v, from_v, gv, gvi);
        if (gui < j - w || gui > j + w) take_better(best_u, from_u, gu, gui);
        const size_t at = (size_t)t * n + j;
        const float stay = best_v + log_stay;
        const float sw = best_u + log_switch;
        const bool take_stay = stay >= sw;
        dv[r] = (take_stay ? stay : sw) + ov[r];
        pv_out[at] = take_stay ? from_v : from_u + n;
        const float sw2 = best_v + log_switch;
        const float st2 = best_u + log_stay;
        const bool take_sw = sw2 >= st2;
        du[r] = (take_sw ? sw2 : st2) + ou;
        pu_out[at] = take_sw ? from_v : from_u + n;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (j_own + r < n) {
      delta_last[seq * 2 * n + j_own + r] = dv[r];
      delta_last[seq * 2 * n + n + j_own + r] = du[r];
    }
  }
  // no CTA leaves while another may still write its shared memory
  if (csize > 1) cluster.sync();
}

// The forward pass for grids that viterbi_fwd_kernel cannot take in one
// launch (the header's "Large pitch grids"): the CTA's tiles in `passes`
// passes of its threads, each owner's new delta written straight into the
// next buffer, and a block maximum over any number of warps.  Template
// arguments and the pairs of a tile are those of viterbi_fwd_kernel.  The
// shared-memory set-up and each destination's step repeat that kernel's
// lines on purpose: moving them into shared inline functions changed its
// sm_90a machine code (eight instructions more, by cuobjdump -sass), and
// the launches up to 512 states keep the code they had.
template <int D, int S, bool kTabSmem>
__global__ void __launch_bounds__(kMaxThreads)
viterbi_fwd_wide_kernel(const float* __restrict__ log_obs_v,  // (B, T, n)
                        const float* __restrict__ log_obs_u,  // (B, T)
                        const float* __restrict__ tab,        // (n_cls, w+1)
                        int* __restrict__ psi_v,              // (B, T, n)
                        int* __restrict__ psi_u,              // (B, T, n)
                        float* __restrict__ delta_last,       // (B, 2, n)
                        int T, int n, int w, int n_cls, int per_source,
                        int csize, int tiles_per_cta, int passes,
                        float log_init, float log_floor, float log_stay,
                        float log_switch) {
  static_assert(S <= 2 * D, "at most two lanes share a destination");
  static_assert(D % 4 == 0, "a tile starts on a group of four sources");
  constexpr int R = D >= S ? D / S : 1;      // destinations a lane ends with
  constexpr int kShare = S > D ? S / D : 1;  // lanes that end on the same
  extern __shared__ __align__(16) float smem[];
  const int rs = row_stride(w, D, S);
  const int np = delta_stride(n, w, D, S);
  const int tab_floats = kTabSmem ? (n_cls * rs + 3) / 4 * 4 : 0;
  const int n_warps = csize * (blockDim.x >> 5);  // across the cluster
  // [expanded table] [delta: buffer, chain, padded state] [row offsets]
  // [warp maxima: buffer, chain, warp] [their indices]
  float* etab = smem;
  float* dbuf = smem + tab_floats;
  int* row_off = reinterpret_cast<int*>(dbuf + 2 * 2 * np);  // [w + state]
  float* wred_val = reinterpret_cast<float*>(row_off + np);
  int* wred_idx = reinterpret_cast<int*>(wred_val + 2 * 2 * n_warps);
  const float* table = kTabSmem ? etab : tab;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = csize > 1 ? (int)cluster.block_rank() : 0;
  const int warp = rank * (blockDim.x >> 5) + (tid >> 5);  // across the CTAs
  const int s = tid % S;
  const int tiles_per_pass = blockDim.x / S;
  const size_t seq = blockIdx.x / csize;
  const float* obs_v = log_obs_v + seq * T * n;
  const float* obs_u = log_obs_u + seq * T;
  int* pv_out = psi_v + seq * T * n;
  int* pu_out = psi_u + seq * T * n;
  float* d_out = delta_last + seq * 2 * n;

  if (kTabSmem) {
    for (int k = tid; k < n_cls * rs; k += blockDim.x) {
      const int x = k % rs - (w + D - 1);
      const int ax = x < 0 ? -x : x;
      etab[k] = ax <= w ? tab[(k / rs) * (w + 1) + ax] : log_floor;
    }
  }
  for (int k = tid; k < np; k += blockDim.x) {
    int i = k - w;
    i = i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
    int cls = i < n - 1 - i ? i : n - 1 - i;
    cls = cls < w ? cls : w;
    if (per_source) cls = i;
    row_off[k] = cls * (kTabSmem ? rs : w + 1);
    if (k < w || k >= w + n) {
#pragma unroll
      for (int b = 0; b < 4; ++b) dbuf[b * np + k] = -INFINITY;
    }
  }

  // the first tile of pass p this thread's lanes work on, and whether the
  // CTA owns it; the destinations this lane owns in it after the merge
  auto tile_of = [&](int p) { return p * tiles_per_pass + tid / S; };
  auto owned = [&](int p) {
    const int lt = tile_of(p);
    const int j0 = (rank * tiles_per_cta + lt) * D;
    return lt < tiles_per_cta && j0 < n && s % kShare == 0
               ? j0 + (s / kShare) * R
               : n;
  };
  // delta slot w + j of buffer b, chain c, in every CTA of the cluster
  auto publish = [&](int b, int c, int j, float v) {
    float* at = dbuf + (b * 2 + c) * np + w + j;
    if (csize > 1) {
      for (int q = 0; q < csize; ++q) *cluster.map_shared_rank(at, q) = v;
    } else {
      *at = v;
    }
  };
  // this warp's (max, first index) of delta + log_floor over the frame
  // just computed, for the step that reads buffer b
  auto publish_max = [&](int b, float hv, int hvi, float hu, int hui) {
    warp_best(hv, hvi);
    warp_best(hu, hui);
    if (lane == 0) {
      for (int q = 0; q < csize; ++q) {
        float* val = csize > 1 ? cluster.map_shared_rank(wred_val, q) : wred_val;
        int* idx = csize > 1 ? cluster.map_shared_rank(wred_idx, q) : wred_idx;
        val[(b * 2 + 0) * n_warps + warp] = hv;
        idx[(b * 2 + 0) * n_warps + warp] = hvi;
        val[(b * 2 + 1) * n_warps + warp] = hu;
        idx[(b * 2 + 1) * n_warps + warp] = hui;
      }
    }
  };

  // no CTA writes another's shared memory before that CTA has started
  if (csize > 1) cluster.sync();
  {  // frame 0 has no predecessor
    float hv = -INFINITY, hu = -INFINITY;
    int hvi = INT_MAX, hui = INT_MAX;
    for (int p = 0; p < passes; ++p) {
      const int j_own = owned(p);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = j_own + r;
        if (j < n) {
          const float dv = log_init + obs_v[j];
          const float du = log_init + obs_u[0];
          publish(0, 0, j, dv);
          publish(0, 1, j, du);
          pv_out[j] = 0;
          pu_out[j] = 0;
          take_better(hv, hvi, dv + log_floor, j);
          take_better(hu, hui, du + log_floor, j);
          if (T == 1) {
            d_out[j] = dv;
            d_out[n + j] = du;
          }
        }
      }
    }
    publish_max(0, hv, hvi, hu, hui);
  }

  for (int t = 1; t < T; ++t) {
    const int cur = (t - 1) & 1;
    const int nxt = t & 1;
    // delta of frame t-1 and its warp maxima are visible (in every CTA)
    if (csize > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
    const float* dvp = dbuf + (cur * 2 + 0) * np;
    const float* dup = dbuf + (cur * 2 + 1) * np;
    // the out-of-band candidate: (max, first index) of delta + log_floor,
    // each lane over every 32nd warp, then across the lanes
    float gv = -INFINITY, gu = -INFINITY;
    int gvi = INT_MAX, gui = INT_MAX;
    for (int q = lane; q < n_warps; q += 32) {
      take_better(gv, gvi, wred_val[(cur * 2 + 0) * n_warps + q],
                  wred_idx[(cur * 2 + 0) * n_warps + q]);
      take_better(gu, gui, wred_val[(cur * 2 + 1) * n_warps + q],
                  wred_idx[(cur * 2 + 1) * n_warps + q]);
    }
    warp_best(gv, gvi);
    warp_best(gu, gui);
    const float ou = obs_u[t];

    float hv = -INFINITY, hu = -INFINITY;
    int hvi = INT_MAX, hui = INT_MAX;
    for (int p = 0; p < passes; ++p) {
      const int lt = tile_of(p);
      const int j0 = (rank * tiles_per_cta + lt) * D;
      const bool tile_live = lt < tiles_per_cta && j0 < n;
      const int j_own = owned(p);
      float ov[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        ov[r] = j_own + r < n ? obs_v[(size_t)t * n + j_own + r] : 0.0f;

      float mv[D], mu[D];
      int bv[D], bu[D];
#pragma unroll
      for (int e = 0; e < D; ++e) {
        mv[e] = mu[e] = -INFINITY;
        bv[e] = bu[e] = INT_MAX;
      }
      scan_tile<D, S, kTabSmem>(mv, bv, mu, bu, dvp, dup, row_off, table,
                                j0 - w,
                                tile_live ? groups_per_lane(w, D, S) : 0, s,
                                j0, w, log_floor);
      Merge<D, S / 2>::run(mv, bv, mu, bu, s);

#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = j_own + r;
        if (j < n) {
          float best_v = mv[r], best_u = mu[r];
          int from_v = bv[r], from_u = bu[r];
          const int first_in = j > w ? j - w : 0;
          const int gv0 = from_v == INT_MAX ? first_in : from_v;
          const int gu0 = from_u == INT_MAX ? first_in : from_u;
          from_v = gv0;
          from_u = gu0;
#pragma unroll
          for (int k = 3; k >= 0; --k) {
            if (dvp[w + gv0 + k] +
                    pair_score<D, kTabSmem>(table, row_off[w + gv0 + k],
                                            gv0 + k, j, w, log_floor) ==
                best_v)
              from_v = gv0 + k;
            if (dup[w + gu0 + k] +
                    pair_score<D, kTabSmem>(table, row_off[w + gu0 + k],
                                            gu0 + k, j, w, log_floor) ==
                best_u)
              from_u = gu0 + k;
          }
          if (gvi < j - w || gvi > j + w) take_better(best_v, from_v, gv, gvi);
          if (gui < j - w || gui > j + w) take_better(best_u, from_u, gu, gui);
          const size_t at = (size_t)t * n + j;
          const float stay = best_v + log_stay;
          const float sw = best_u + log_switch;
          const bool take_stay = stay >= sw;
          const float dv = (take_stay ? stay : sw) + ov[r];
          pv_out[at] = take_stay ? from_v : from_u + n;
          const float sw2 = best_v + log_switch;
          const float st2 = best_u + log_stay;
          const bool take_sw = sw2 >= st2;
          const float du = (take_sw ? sw2 : st2) + ou;
          pu_out[at] = take_sw ? from_v : from_u + n;
          publish(nxt, 0, j, dv);
          publish(nxt, 1, j, du);
          take_better(hv, hvi, dv + log_floor, j);
          take_better(hu, hui, du + log_floor, j);
          if (t == T - 1) {
            d_out[j] = dv;
            d_out[n + j] = du;
          }
        }
      }
    }
    publish_max(nxt, hv, hvi, hu, hui);
  }
  // no CTA leaves while another may still write its shared memory
  if (csize > 1) cluster.sync();
}

// One step down the backpointers from state s at frame t.
__device__ __forceinline__ int step_down(const int* __restrict__ pv,
                                         const int* __restrict__ pu, int n,
                                         int t, int s) {
  return s < n ? pv[(size_t)t * n + s] : pu[(size_t)t * n + (s - n)];
}

// Chunk k spans the frames k C + 1 .. min((k + 1) C, T - 1): maps[k][e] is
// the state at frame k C when the state at the chunk's top frame is e.
// One block per (chunk, sequence), one thread per entry state.
__global__ void viterbi_back_maps_kernel(const int* __restrict__ psi_v,
                                         const int* __restrict__ psi_u,
                                         int* __restrict__ maps,  // (B, K, 2n)
                                         int T, int n, int C, int K) {
  const int k = blockIdx.x;
  const size_t seq = blockIdx.y;
  const int* pv = psi_v + seq * T * n;
  const int* pu = psi_u + seq * T * n;
  const int top = (k + 1) * C < T - 1 ? (k + 1) * C : T - 1;
  for (int e = threadIdx.x; e < 2 * n; e += blockDim.x) {
    int s = e;
    for (int t = top; t > k * C; --t) s = step_down(pv, pu, n, t, s);
    maps[(seq * K + k) * 2 * n + e] = s;
  }
}

// One block per (chunk, sequence): first argmax of the concatenated final
// delta (block reduction), down the chunk maps above this chunk, then the
// chunk's own frames.  Thread 0 walks; T = 1 has no chunk and one block.
__global__ void viterbi_back_walk_kernel(const float* __restrict__ delta_last,
                                         const int* __restrict__ psi_v,
                                         const int* __restrict__ psi_u,
                                         const int* __restrict__ maps,
                                         int* __restrict__ states,  // (B, T)
                                         int T, int n, int C, int K) {
  __shared__ float wval[32];
  __shared__ int widx[32];
  const int k = blockIdx.x;
  const size_t seq = blockIdx.y;
  const float* dl = delta_last + seq * 2 * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  // each thread takes a contiguous run, so indices ascend with the thread
  const int per = (2 * n + blockDim.x - 1) / blockDim.x;
  float best = -INFINITY;
  int at = INT_MAX;
  for (int q = threadIdx.x * per; q < (threadIdx.x + 1) * per && q < 2 * n;
       ++q) {
    if (dl[q] > best || at == INT_MAX) {
      best = dl[q];
      at = q;
    }
  }
  warp_first_max(best, at);
  if (lane == 0) {
    wval[warp] = best;
    widx[warp] = at;
  }
  __syncthreads();
  if (warp != 0) return;
  best = lane < n_warps ? wval[lane] : -INFINITY;
  at = lane < n_warps ? widx[lane] : INT_MAX;
  warp_first_max(best, at);
  if (lane != 0) return;

  int s = at;  // the state at frame T - 1
  int* out = states + seq * T;
  if (k == K - 1 || K == 0) out[T - 1] = s;
  if (K == 0) return;
  const int* pv = psi_v + seq * T * n;
  const int* pu = psi_u + seq * T * n;
  for (int q = K - 1; q > k; --q) s = maps[(seq * K + q) * 2 * n + s];
  const int top = (k + 1) * C < T - 1 ? (k + 1) * C : T - 1;
  for (int t = top; t > k * C; --t) {
    s = step_down(pv, pu, n, t, s);
    out[t - 1] = s;
  }
}

template <int D, int S>
cudaError_t launch_fwd(const float* obs_v, const float* obs_u,
                       const float* tab, int* psi_v, int* psi_u,
                       float* delta_last, int B, int T, int n, int w,
                       int n_cls, int per_source, float log_init,
                       float log_floor, float log_stay, float log_switch,
                       int max_smem, int csize, cudaStream_t stream) {
  const int groups = (n + D - 1) / D;
  const int tiles_per_cta = (groups + csize - 1) / csize;
  // the lanes the CTA's tiles take; one thread each in viterbi_fwd_kernel
  // while they fit 512 threads and the cluster 32 warps, else the wide
  // kernel's passes (core/pyin_cuda.py::forward_launch mirrors this)
  const int lanes = tiles_per_cta * S;
  int threads = (lanes + 31) / 32 * 32;
  const bool wide = threads > kMaxThreads || csize * (threads / 32) > 32;
  int passes = 1;
  if (wide) {
    passes = (lanes + kMaxThreads - 1) / kMaxThreads;
    threads = ((lanes + passes - 1) / passes + 31) / 32 * 32;
  }
  const int warp_slots = wide ? csize * (threads / 32) : 32;
  const int np = delta_stride(n, w, D, S);
  const size_t fixed = (2 * 2 * np + 2 * 2 * warp_slots) * sizeof(float) +
                       (np + 2 * 2 * warp_slots) * sizeof(int);
  const size_t table =
      ((size_t)n_cls * row_stride(w, D, S) + 3) / 4 * 4 * sizeof(float);
  const bool in_smem = fixed + table <= (size_t)max_smem;
  const size_t bytes = fixed + (in_smem ? table : 0);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * csize);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cudaLaunchAttribute cluster_dim;
  cluster_dim.id = cudaLaunchAttributeClusterDimension;
  cluster_dim.val.clusterDim.x = csize;
  cluster_dim.val.clusterDim.y = 1;
  cluster_dim.val.clusterDim.z = 1;
  config.attrs = &cluster_dim;
  config.numAttrs = csize > 1 ? 1 : 0;
  if (wide) {
    auto kernel = in_smem ? viterbi_fwd_wide_kernel<D, S, true>
                          : viterbi_fwd_wide_kernel<D, S, false>;
    if (bytes > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return err;
    }
    return cudaLaunchKernelEx(&config, kernel, obs_v, obs_u, tab, psi_v,
                              psi_u, delta_last, T, n, w, n_cls, per_source,
                              csize, tiles_per_cta, passes, log_init,
                              log_floor, log_stay, log_switch);
  }
  auto kernel = in_smem ? viterbi_fwd_kernel<D, S, true>
                        : viterbi_fwd_kernel<D, S, false>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  return cudaLaunchKernelEx(&config, kernel, obs_v, obs_u, tab, psi_v, psi_u,
                            delta_last, T, n, w, n_cls, per_source, csize,
                            tiles_per_cta, log_init, log_floor, log_stay,
                            log_switch);
}

}  // namespace

// Each entry point launches its kernels on `stream` and returns the first
// CUDA error, 0 when every launch was taken.

// tile: 88 (D = 8 destinations a thread, S = 8 lanes a tile) or 96 (D = 8,
// S = 16: two lanes a destination, for clusters, whose CTAs have few
// warps).  max_smem: the bytes of shared memory a block may take (the
// expanded table goes to shared memory only if it fits).  cluster: the CTAs
// (1, 2, 4 or 8, one thread-block cluster) that share a sequence.  Any
// n whose delta buffers fit max_smem is taken: viterbi_fwd_kernel where a
// CTA's tiles fit its threads, viterbi_fwd_wide_kernel past that.
extern "C" int aegis_viterbi_fwd(const void* log_obs_v, const void* log_obs_u,
                                 const void* tab, void* psi_v, void* psi_u,
                                 void* delta_last, int B, int T, int n, int w,
                                 int n_cls, int per_source, float log_init,
                                 float log_floor, float log_stay,
                                 float log_switch, int tile, int max_smem,
                                 int cluster, void* stream) {
  if (B < 1 || T < 1 || T > (1 << 20) || n < 1 || w < 0 ||
      n_cls < 1 || cluster < 1 || cluster > 8)
    return static_cast<int>(cudaErrorInvalidValue);
#define AEGIS_FWD(D, S)                                                      \
  static_cast<int>(launch_fwd<D, S>(                                         \
      static_cast<const float*>(log_obs_v),                                  \
      static_cast<const float*>(log_obs_u), static_cast<const float*>(tab),  \
      static_cast<int*>(psi_v), static_cast<int*>(psi_u),                    \
      static_cast<float*>(delta_last), B, T, n, w, n_cls, per_source,        \
      log_init, log_floor, log_stay, log_switch, max_smem, cluster,          \
      static_cast<cudaStream_t>(stream)))
  switch (tile) {
    case 88: return AEGIS_FWD(8, 8);
    case 96: return AEGIS_FWD(8, 16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef AEGIS_FWD
}

// maps: scratch of (B, K, 2n) int32 with K = ceil((T - 1) / C) chunks.
extern "C" int aegis_viterbi_back(const void* delta_last, const void* psi_v,
                                  const void* psi_u, void* maps, void* states,
                                  int B, int T, int n, int C, void* stream) {
  if (B < 1 || T < 1 || n < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int K = (T - 1 + C - 1) / C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K > 0) {
    const int threads = 2 * n < 1024 ? (2 * n + 31) / 32 * 32 : 1024;
    viterbi_back_maps_kernel<<<dim3(K, B), threads, 0, st>>>(
        static_cast<const int*>(psi_v), static_cast<const int*>(psi_u),
        static_cast<int*>(maps), T, n, C, K);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  viterbi_back_walk_kernel<<<dim3(K > 0 ? K : 1, B), 128, 0, st>>>(
      static_cast<const float*>(delta_last), static_cast<const int*>(psi_v),
      static_cast<const int*>(psi_u), static_cast<const int*>(maps),
      static_cast<int*>(states), T, n, C, K);
  return static_cast<int>(cudaGetLastError());
}
