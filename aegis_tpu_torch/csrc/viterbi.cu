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
// then stay/switch between the chains and the log observation.
//   * In the band |i - j| <= w the score reads the (n, 2w+1) band table.
//   * Out of the band the dense matrix holds the constant log_floor, so the
//     out-of-band candidates are the prefix maximum of delta + log_floor
//     over i < j - w and the suffix maximum over i > j + w.  Both are taken
//     of the rounded sums delta[i] + log_floor, with the first index on
//     ties, so they equal the dense scan's values and indices exactly.
//   * Candidates are visited in source order (left, band, right) and only a
//     strictly greater score replaces the best, so ties go to the smallest
//     source index as jnp.argmax does.  (The Pallas kernel breaks ties the
//     other way; this port follows the scan.)
//
// What bounds it: a serial chain of T dependent steps on ONE SM per
// sequence; each step does about 2 * n * (2w + 1) max-adds (n = 450:
// 183k at w = 101, 93k at w = 51) plus two block barriers.  The card's
// other SMs serve other sequences of a batch (one CTA per sequence).
// What the design does about it: delta lives in shared memory
// (double-buffered, so one barrier pair per step suffices), the band table
// (365 KB at w = 101) is read through the read-only path and stays in L2,
// the backpointers are written coalesced, and nothing else touches device
// memory inside the step loop.  The band is read in its (n, 2w+1) layout,
// lane j walking row j, so one warp-wide load of it touches 32 cache lines
// (PERF.md records what that costs).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kMaxStates = 512;  // one thread per state
constexpr int kMaxWarps = kMaxStates / 32;
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

__global__ void __launch_bounds__(kMaxStates)
viterbi_fwd_kernel(const float* __restrict__ log_obs_v,  // (B, T, n)
                   const float* __restrict__ log_obs_u,  // (B, T)
                   const float* __restrict__ band,       // (n, 2w+1)
                   int* __restrict__ psi_v,              // (B, T, n)
                   int* __restrict__ psi_u,              // (B, T, n)
                   float* __restrict__ delta_last,       // (B, 2, n)
                   int T, int n, int w, float log_init, float log_floor,
                   float log_stay, float log_switch) {
  // delta of the previous frame, [buffer][chain][state]
  __shared__ float dbuf[2][2][kMaxStates];
  // prefix / suffix (max, first argmax) of delta + log_floor, [chain][state]
  __shared__ float pre_val[2][kMaxStates];
  __shared__ int pre_idx[2][kMaxStates];
  __shared__ float suf_val[2][kMaxStates];
  __shared__ int suf_idx[2][kMaxStates];
  // per-warp totals of the two scans, [chain][warp]
  __shared__ float wpre_val[2][kMaxWarps];
  __shared__ int wpre_idx[2][kMaxWarps];
  __shared__ float wsuf_val[2][kMaxWarps];
  __shared__ int wsuf_idx[2][kMaxWarps];

  const int j = threadIdx.x;
  const bool live = j < n;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int n_warps = blockDim.x >> 5;
  const size_t seq = blockIdx.x;
  const float* obs_v = log_obs_v + seq * T * n;
  const float* obs_u = log_obs_u + seq * T;
  int* pv_out = psi_v + seq * T * n;
  int* pu_out = psi_u + seq * T * n;
  const int width = 2 * w + 1;

  float d[2];  // this thread's delta of the current frame, [chain]
  d[0] = live ? log_init + obs_v[j] : -INFINITY;
  d[1] = live ? log_init + obs_u[0] : -INFINITY;
  if (live) {  // frame 0 has no predecessor
    pv_out[j] = 0;
    pu_out[j] = 0;
  }

  for (int t = 1; t < T; ++t) {
    const int prev = (t - 1) & 1;
    float pv[2], sv[2];
    int pi[2], si[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      dbuf[prev][c][j] = d[c];
      pv[c] = sv[c] = d[c] + log_floor;
      pi[c] = si[c] = live ? j : INT_MAX;
    }
    // warp-level inclusive prefix and suffix scans
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float v_up = __shfl_up_sync(kFullMask, pv[c], off);
        const int i_up = __shfl_up_sync(kFullMask, pi[c], off);
        const float v_dn = __shfl_down_sync(kFullMask, sv[c], off);
        const int i_dn = __shfl_down_sync(kFullMask, si[c], off);
        if (lane >= off) take_better(pv[c], pi[c], v_up, i_up);
        if (lane + off < 32) take_better(sv[c], si[c], v_dn, i_dn);
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (lane == 31) {
        wpre_val[c][warp] = pv[c];
        wpre_idx[c][warp] = pi[c];
      }
      if (lane == 0) {
        wsuf_val[c][warp] = sv[c];
        wsuf_idx[c][warp] = si[c];
      }
    }
    __syncthreads();  // delta of frame t-1 and the warp totals are visible
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      for (int k = 0; k < warp; ++k)
        take_better(pv[c], pi[c], wpre_val[c][k], wpre_idx[c][k]);
      for (int k = warp + 1; k < n_warps; ++k)
        take_better(sv[c], si[c], wsuf_val[c][k], wsuf_idx[c][k]);
      pre_val[c][j] = pv[c];
      pre_idx[c][j] = pi[c];
      suf_val[c][j] = sv[c];
      suf_idx[c][j] = si[c];
    }
    __syncthreads();  // the full prefix / suffix maxima are visible

    if (live) {
      const int lo = j - w;
      const int hi = j + w;
      float mv = -INFINITY, mu = -INFINITY;
      int bv = 0, bu = 0;
      if (lo > 0) {  // sources 0 .. lo-1, out of the band
        mv = pre_val[0][lo - 1];
        bv = pre_idx[0][lo - 1];
        mu = pre_val[1][lo - 1];
        bu = pre_idx[1][lo - 1];
      }
      // row[i] = band[j, i - lo]: the score of source i, |i - j| <= w
      const float* row = band + ((size_t)j * width + w - j);
      const float* dv = dbuf[prev][0];
      const float* du = dbuf[prev][1];
      const int i0 = lo > 0 ? lo : 0;
      const int i1 = hi < n - 1 ? hi : n - 1;
      for (int i = i0; i <= i1; ++i) {
        const float lt = __ldg(row + i);
        const float a = dv[i] + lt;
        const float b = du[i] + lt;
        if (a > mv) {
          mv = a;
          bv = i;
        }
        if (b > mu) {
          mu = b;
          bu = i;
        }
      }
      if (hi + 1 < n) {  // sources hi+1 .. n-1, out of the band
        if (suf_val[0][hi + 1] > mv) {
          mv = suf_val[0][hi + 1];
          bv = suf_idx[0][hi + 1];
        }
        if (suf_val[1][hi + 1] > mu) {
          mu = suf_val[1][hi + 1];
          bu = suf_idx[1][hi + 1];
        }
      }
      const size_t at = (size_t)t * n + j;
      const float stay = mv + log_stay;
      const float sw = mu + log_switch;
      const bool take_stay = stay >= sw;
      d[0] = (take_stay ? stay : sw) + obs_v[at];
      pv_out[at] = take_stay ? bv : bu + n;
      const float sw2 = mv + log_switch;
      const float st2 = mu + log_stay;
      const bool take_sw = sw2 >= st2;
      d[1] = (take_sw ? sw2 : st2) + obs_u[t];
      pu_out[at] = take_sw ? bv : bu + n;
    }
  }
  if (live) {
    delta_last[seq * 2 * n + j] = d[0];
    delta_last[seq * 2 * n + n + j] = d[1];
  }
}

// One thread per sequence: first argmax of the concatenated final delta,
// then the walk down the backpointers to frame 0.
__global__ void viterbi_back_kernel(const float* __restrict__ delta_last,
                                    const int* __restrict__ psi_v,
                                    const int* __restrict__ psi_u,
                                    int* __restrict__ states,  // (B, T)
                                    int B, int T, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t seq = b;
  const float* dl = delta_last + seq * 2 * n;
  float best = dl[0];
  int s = 0;
  for (int k = 1; k < 2 * n; ++k) {
    if (dl[k] > best) {
      best = dl[k];
      s = k;
    }
  }
  const int* pv = psi_v + seq * T * n;
  const int* pu = psi_u + seq * T * n;
  int* out = states + seq * T;
  out[T - 1] = s;
  for (int t = T - 1; t > 0; --t) {
    s = s < n ? pv[(size_t)t * n + s] : pu[(size_t)t * n + (s - n)];
    out[t - 1] = s;
  }
}

}  // namespace

// Each entry point launches its kernel on `stream` and returns
// cudaGetLastError(): 0 when the launch was taken.

extern "C" int aegis_viterbi_fwd(const void* log_obs_v, const void* log_obs_u,
                                 const void* band, void* psi_v, void* psi_u,
                                 void* delta_last, int B, int T, int n, int w,
                                 float log_init, float log_floor,
                                 float log_stay, float log_switch,
                                 void* stream) {
  if (B < 1 || T < 1 || n < 1 || n > kMaxStates || w < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (n + 31) / 32 * 32;
  viterbi_fwd_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_obs_v), static_cast<const float*>(log_obs_u),
      static_cast<const float*>(band), static_cast<int*>(psi_v),
      static_cast<int*>(psi_u), static_cast<float*>(delta_last), T, n, w,
      log_init, log_floor, log_stay, log_switch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int aegis_viterbi_back(const void* delta_last, const void* psi_v,
                                  const void* psi_u, void* states, int B, int T,
                                  int n, void* stream) {
  if (B < 1 || T < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  viterbi_back_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(delta_last), static_cast<const int*>(psi_v),
      static_cast<const int*>(psi_u), static_cast<int*>(states), B, T, n);
  return static_cast<int>(cudaGetLastError());
}
