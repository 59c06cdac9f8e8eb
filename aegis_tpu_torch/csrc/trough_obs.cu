// The pYIN trough probabilities and their scatter into pitch bins as one
// kernel for NVIDIA Hopper (sm_90a), with a plain C interface that
// aegis_tpu_torch/core/pyin_cuda.py loads through ctypes.
//
// Replaces no TPU kernel: aegis_tpu/core/pyin.py writes these two stages
// as XLA ops.  The port ran them as PyTorch ops, core/pyin.py::
// trough_probabilities (a loop of ~25 small kernels over each of the 100
// thresholds) and the per-lag scatter_add_ of core/pyin.py::observations
// (one a lag, 526 at 44 100 Hz): ~3 000 of the ~3 600 launches of a v1
// tile or fused call, each ~1.8 us on the card for almost no work.  Those
// loops stay the plain version, and the CPU's path.
//
// What it computes: obs (R, n) of rows yin (R, L), the trough mask
// (R, L) and the pitch bin of each lag (R, L), bit for bit the loops' on
// the card.  For each threshold s_i (in the order of the table) the troughs
// under it share the Beta prior beta_i by Boltzmann rank:
//   acc[l] += beta_i * (exp(-lam * rank(l)) * (1 - e^-lam)
//                        / -expm1(-lam * max(n_below, 1)))
// and where no trough is under it, beta_i * no_trough_prob goes to the
// lowest trough (the first one on ties); then obs[r, bin(l)] sums acc[l]
// over the lags in ascending order from 0.  Every product, quotient and sum
// is the loops' own float32 operation, written with the _rn intrinsics so
// that none is contracted into an FMA; expf and expm1f are the math
// library's, as PyTorch's exp and expm1 call them.  The scatter's sums are
// those of the float atomicAdd that scatter_add_ runs on the card
// (atom.add.f32), which flushes subnormal inputs and results to zero: the
// kernel adds with add.rn.ftz.f32, so that a Boltzmann weight of rank 44
// or more (exp(-88) is subnormal) vanishes in the bin as it does there.
// Heights are not NaN, as core/pyin.py::cmndf_frames gives them.
//
// What bounds it: memory.  It reads yin, the mask and the int64 bins once
// (13 L bytes a row) and writes obs (4 n bytes a row): at 44 100 Hz
// (L = 526, n = 450) 8.6 kB a row, 45 MB or 14 us at 3.35 TB/s for the
// R = 5 249 rows of a 60 s take.  The arithmetic is small: the work that
// depends on the data is a division and a few adds for each trough under
// each threshold.
//
// Design:
//   * One warp a row, four rows a CTA; the thresholds, their priors, the
//     Boltzmann numerator exp(-lam * rank) * (1 - e^-lam) of every rank and
//     the denominator -expm1(-lam * count) of every below-count in shared
//     memory for the CTA.  Every shape comes from the arguments.
//   * The warp walks the row once, coalesced, and keeps only the
//     candidates: troughs under the largest threshold (no other trough is
//     ever under one, so its probability stays 0, as does every lag that
//     is not a trough), in ascending lag order, with their heights and
//     bins, in shared memory.  Where no trough is under any threshold the
//     lowest trough alone is kept: it takes the no-trough share at every
//     threshold.
//   * The below-count of every threshold and its denominator come first,
//     lanes over thresholds.  The threshold loop is then a compare, a
//     ballot, a popcount for the rank, one division and two float
//     operations for each candidate under the threshold, the sums in
//     shared memory, each owned by one lane.
//   * The scatter: the first candidate of each bin sums the bin's
//     candidates in lag order and writes the bin, over a row of zeros; it
//     does not need the bins to be monotone in the lag.
//   * No allocation, no atomics: the result does not depend on the launch
//     or on scheduling.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;  // rows a CTA, one warp each
constexpr unsigned kFullMask = 0xffffffffu;

// a + b as the card's float atomicAdd computes it: rounded to nearest even,
// subnormal inputs and result flushed to zero
__device__ __forceinline__ float atomic_add_sum(float a, float b) {
  float sum;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(sum) : "f"(a), "f"(b));
  return sum;
}

__global__ void __launch_bounds__(kWarps * 32)
trough_obs_kernel(const float* __restrict__ yin,         // (R, L), stride ld
                  const bool* __restrict__ mask,         // (R, L)
                  const int64_t* __restrict__ bins,      // (R, L)
                  const float* __restrict__ thresholds,  // (K,)
                  const float* __restrict__ beta_probs,  // (K,)
                  float* __restrict__ obs,               // (R, n)
                  int R, int L, int ld, int n, int K, float neg_lam,
                  float one_m, float no_trough_prob) {
  // [thresholds][priors] (K each) and [numerators][denominators] (L each)
  // for the CTA, then for each warp [heights][sums][bins] of its
  // candidates (L each) and [denominators][below-counts] of the thresholds
  // (K each)
  extern __shared__ __align__(16) float smem[];
  float* s_thr = smem;
  float* s_bp = s_thr + K;
  float* s_num = s_bp + K;
  float* s_den = s_num + L;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* c_y = s_den + L + warp * (3 * L + 2 * K);
  float* c_acc = c_y + L;
  int* c_bin = reinterpret_cast<int*>(c_acc + L);
  float* t_den = reinterpret_cast<float*>(c_bin + L);
  int* t_below = reinterpret_cast<int*>(t_den + K);

  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    s_thr[i] = thresholds[i];
    s_bp[i] = beta_probs[i];
  }
  // rank i's numerator; the denominator of i + 1 troughs below
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    s_num[i] = __fmul_rn(expf(__fmul_rn(neg_lam, __int2float_rn(i))), one_m);
    s_den[i] = -expm1f(__fmul_rn(neg_lam, __int2float_rn(i + 1)));
  }
  __syncthreads();
  const int r = blockIdx.x * kWarps + warp;
  if (r >= R) return;
  const float* yrow = yin + (size_t)r * ld;
  const bool* mrow = mask + (size_t)r * L;
  const int64_t* brow = bins + (size_t)r * L;
  float* orow = obs + (size_t)r * n;
  const unsigned lanes_below = (1u << lane) - 1u;

  // the largest threshold: a trough under none keeps probability 0
  float top = -INFINITY;
  for (int i = lane; i < K; i += 32) top = fmaxf(top, s_thr[i]);
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    top = fmaxf(top, __shfl_xor_sync(kFullMask, top, off));

  // one walk of the row: the candidates in lag order, the lowest trough
  // (first lag on ties) and the lowest candidate's index
  int M = 0;
  bool any_trough = false;
  float low = INFINITY;
  int low_lag = INT_MAX;
  float low_c = INFINITY;
  int low_m = INT_MAX;
  for (int j0 = 0; j0 < L; j0 += 32) {
    const int j = j0 + lane;
    const bool trough = j < L && mrow[j];
    const float y = trough ? yrow[j] : INFINITY;
    if (y < low) {
      low = y;
      low_lag = j;
    }
    const bool cand = trough && y < top;
    const unsigned hit = __ballot_sync(kFullMask, cand);
    any_trough |= __any_sync(kFullMask, trough);
    if (cand) {
      const int m = M + __popc(hit & lanes_below);
      c_y[m] = y;
      c_bin[m] = static_cast<int>(brow[j]);
      if (y < low_c) {
        low_c = y;
        low_m = m;
      }
    }
    M += __popc(hit);
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const float v = __shfl_xor_sync(kFullMask, low, off);
    const int l = __shfl_xor_sync(kFullMask, low_lag, off);
    if (v < low || (v == low && l < low_lag)) {
      low = v;
      low_lag = l;
    }
    const float vc = __shfl_xor_sync(kFullMask, low_c, off);
    const int mc = __shfl_xor_sync(kFullMask, low_m, off);
    if (vc < low_c || (vc == low_c && mc < low_m)) {
      low_c = vc;
      low_m = mc;
    }
  }

  for (int k = lane; k < n; k += 32) orow[k] = 0.0f;
  if (!any_trough) return;
  if (M == 0) {
    // no trough under any threshold: the lowest one takes every
    // threshold's no-trough share (lag 0 where every height is +inf, as
    // the loops' argmin gives it)
    if (lane == 0) {
      c_y[0] = low;
      c_bin[0] = static_cast<int>(brow[low_lag < L ? low_lag : 0]);
    }
    M = 1;
    low_m = 0;
  }
  __syncwarp();

  // each threshold's below-count and denominator
  for (int i = lane; i < K; i += 32) {
    const float thr = s_thr[i];
    int count = 0;
    for (int m = 0; m < M; ++m) count += c_y[m] < thr;
    t_below[i] = count;
    t_den[i] = s_den[max(count, 1) - 1];
  }
  for (int m = lane; m < M; m += 32) c_acc[m] = 0.0f;
  __syncwarp();

  for (int i = 0; i < K; ++i) {
    const int below = t_below[i];
    if (below == 0) {
      if (lane == (low_m & 31))
        c_acc[low_m] = __fadd_rn(c_acc[low_m],
                                 __fmul_rn(s_bp[i], no_trough_prob));
      continue;
    }
    const float thr = s_thr[i], bp = s_bp[i], den = t_den[i];
    int rank0 = 0;  // candidates under the threshold in earlier chunks
    for (int m0 = 0; m0 < M && rank0 < below; m0 += 32) {
      const int m = m0 + lane;
      const bool under = m < M && c_y[m] < thr;
      const unsigned hit = __ballot_sync(kFullMask, under);
      if (under) {
        const float pmf =
            __fdiv_rn(s_num[rank0 + __popc(hit & lanes_below)], den);
        c_acc[m] = __fadd_rn(c_acc[m], __fmul_rn(bp, pmf));
      }
      rank0 += __popc(hit);
    }
  }
  __syncwarp();

  // the scatter: each bin's first candidate sums the bin in lag order
  for (int m = lane; m < M; m += 32) {
    const int b = c_bin[m];
    bool first = b >= 0 && b < n;
    for (int q = 0; q < m && first; ++q) first = c_bin[q] != b;
    if (!first) continue;
    float sum = 0.0f;
    for (int q = m; q < M; ++q)
      if (c_bin[q] == b) sum = atomic_add_sum(sum, c_acc[q]);
    orow[b] = sum;
  }
}

}  // namespace

// The dynamic shared memory a CTA takes; core/pyin_cuda.py::
// trough_obs_launch computes the same.
static size_t trough_obs_smem(int L, int K) {
  return sizeof(float) *
         (2 * ((size_t)K + L) + kWarps * (3 * (size_t)L + 2 * K));
}

// Launches trough_obs_kernel on `stream` for R rows; returns the CUDA
// error of the launch, 0 when it was taken.  ld: the floats from one row of
// yin to the next (CMNDF rows are a slice of a wider plane); the mask, the
// bins and obs are contiguous.  neg_lam: -lam in float32; one_m: 1 - e^-lam
// in float32.  max_smem: the bytes of shared memory a block may take on
// this card.
extern "C" int aegis_trough_obs(const void* yin, const void* mask,
                                const void* bins, const void* thresholds,
                                const void* beta_probs, void* obs, int R,
                                int L, int ld, int n, int K, float neg_lam,
                                float one_m, float no_trough_prob,
                                int max_smem, void* stream) {
  const size_t bytes = trough_obs_smem(L, K);
  if (R < 1 || L < 1 || ld < 1 || n < 1 || K < 1 ||
      bytes > (size_t)max_smem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        trough_obs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned ctas = (unsigned)((R + kWarps - 1) / kWarps);
  trough_obs_kernel<<<ctas, kWarps * 32, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(yin), static_cast<const bool*>(mask),
      static_cast<const int64_t*>(bins),
      static_cast<const float*>(thresholds),
      static_cast<const float*>(beta_probs), static_cast<float*>(obs), R, L,
      ld, n, K, neg_lam, one_m, no_trough_prob);
  return static_cast<int>(cudaGetLastError());
}
