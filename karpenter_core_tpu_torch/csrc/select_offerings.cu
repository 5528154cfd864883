// K13: the policy objective's offering selection.
//
// Replaces `select_offerings` (karpenter_core_tpu/ops/objective.py:87), the
// jitted argmin the reference runs after the solve when the policy objective
// is on.  For every new-node slot n it picks the (instance type, zone,
// capacity type) cell of least score among the cells the slot allows; the
// semantics, the FMAs and the sum order are in kernels/objective.py.
//
// Bound on the H100: operations.  At full width (N = 8,192 slots,
// I = 1,000 types, Z = 3, CT = 2: 49M cells) it must read the bool viable
// plane (8.2 MB: 2.4 us at 3.35 TB/s) and do about eight operations a cell
// (two passes of mask, select and compare): 0.39 G / 67 T/s = 5.9 us.
// Design: three launches on the caller's stream.
//   1. cell_scores: one thread a cell (6,000) writes expected[j] and the
//      masked score (+inf where the price is not finite): the score does
//      not depend on the slot, so it is computed once.
//   2. select: one block a slot.  The slot's allowed (zone, ct) pairs go to
//      shared memory; threads stride over the instance types (coalesced
//      viable bytes) and read only the cells the slot allows.  Pass 1 takes
//      the NaN-propagating minimum; pass 2 the first tied cell and the first
//      tied spot cell (order-independent minimum of indices), so the answer
//      does not depend on the block's reduction order.
//   3. fleet_sum: one block sums price and expected over the active slots
//      in XLA's CPU order: windows of 32 in order from +0, the vector padded
//      evenly at both ends, repeated until at most 32 remain; one thread
//      adds those in order.  Padding is skipped: adding +0.0 to a sum begun
//      at +0.0 changes nothing.
// Float arithmetic is spelled with the _rn intrinsics so nvcc contracts
// nothing beyond the two FMAs that XLA's own code contains.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 32;
constexpr int kSumThreads = 1024;
constexpr int kNone = 0x7fffffff;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || isnan(a)) ? a : b;  // NaN in either argument wins
}

__global__ void cell_scores_kernel(int cells, int zct, float cw, float tw, float ra,
                                   const float* __restrict__ price,
                                   const float* __restrict__ risk,
                                   const float* __restrict__ thr, float* __restrict__ expected,
                                   float* __restrict__ masked) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cells) return;
  const float p = price[j];
  const float one = __fmaf_rn(ra, risk[j], 1.0f);
  const float e = __fmul_rn(p, one);
  const float penalty = __fmul_rn(tw, thr[j / zct]);
  expected[j] = e;
  masked[j] = isfinite(p) ? __fmaf_rn(cw, e, -penalty) : INFINITY;
}

__global__ void __launch_bounds__(kThreads) select_kernel(
    int n_it, int n_z, int n_ct, int spot_pref, const uint8_t* __restrict__ viable,
    const uint8_t* __restrict__ zone, const uint8_t* __restrict__ ct,
    const uint8_t* __restrict__ open_, const int32_t* __restrict__ pod_count,
    const float* __restrict__ price, const uint8_t* __restrict__ is_spot,
    const float* __restrict__ expected, const float* __restrict__ masked,
    int32_t* __restrict__ sel_it, int32_t* __restrict__ sel_zone, int32_t* __restrict__ sel_ct,
    float* __restrict__ sel_price, float* __restrict__ sel_expected,
    uint8_t* __restrict__ active) {
  extern __shared__ uint8_t s_zc[];  // [Z * CT]: the row's allowed (zone, ct) pairs
  __shared__ float s_min[kWarps];
  __shared__ int s_first[kWarps];
  __shared__ int s_spot[kWarps];
  __shared__ float s_best;
  const int n = blockIdx.x;
  const int zct = n_z * n_ct;
  const uint8_t* vrow = viable + (size_t)n * n_it;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < zct; k += kThreads) {
    s_zc[k] = (zone[(size_t)n * n_z + k / n_ct] && ct[(size_t)n * n_ct + k % n_ct]) ? 1 : 0;
  }
  __syncthreads();

  // pass 1: the row's minimum score.  A cell the row does not allow scores
  // +inf, which never lowers a minimum, so only allowed cells are read
  float best = INFINITY;
  for (int i = threadIdx.x; i < n_it; i += kThreads) {
    if (!vrow[i]) continue;
    const float* row = masked + (size_t)i * zct;
    for (int k = 0; k < zct; ++k) {
      if (s_zc[k]) best = nan_min(best, row[k]);
    }
  }
  for (int off = 16; off > 0; off >>= 1) best = nan_min(best, __shfl_down_sync(0xffffffffu, best, off));
  if (lane == 0) s_min[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = s_min[0];
    for (int w = 1; w < kWarps; ++w) b = nan_min(b, s_min[w]);
    s_best = b;
  }
  __syncthreads();
  best = s_best;

  // pass 2: the first tied cell and the first tied spot cell.  Below +inf
  // only allowed cells can tie; at +inf every cell ties (the disallowed ones
  // score +inf), so the first tie is cell 0 and the first spot tie the first
  // spot capacity type of cell (0, 0, *); a NaN minimum ties nothing
  int first = kNone, first_spot = kNone;
  if (best == INFINITY) {
    if (threadIdx.x == 0) {
      first = 0;
      for (int c = n_ct - 1; c >= 0; --c) {
        if (is_spot[c]) first_spot = c;
      }
    }
  } else {
    for (int i = threadIdx.x; i < n_it; i += kThreads) {
      if (!vrow[i]) continue;
      const float* row = masked + (size_t)i * zct;
      for (int k = 0; k < zct; ++k) {
        if (s_zc[k] && row[k] == best) {
          const int j = i * zct + k;
          first = min(first, j);
          if (is_spot[k % n_ct]) first_spot = min(first_spot, j);
        }
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    first = min(first, __shfl_down_sync(0xffffffffu, first, off));
    first_spot = min(first_spot, __shfl_down_sync(0xffffffffu, first_spot, off));
  }
  if (lane == 0) {
    s_first[warp] = first;
    s_spot[warp] = first_spot;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      first = min(first, s_first[w]);
      first_spot = min(first_spot, s_spot[w]);
    }
    const int sel = (spot_pref && first_spot != kNone) ? first_spot
                    : (first != kNone ? first : 0);
    sel_it[n] = sel / zct;
    sel_zone[n] = (sel % zct) / n_ct;
    sel_ct[n] = sel % n_ct;
    sel_price[n] = price[sel];
    sel_expected[n] = expected[sel];
    active[n] = (open_[n] && pod_count[n] > 0 && isfinite(best)) ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kSumThreads) fleet_sum_kernel(
    int n, const uint8_t* __restrict__ active, const float* __restrict__ sel_price,
    const float* __restrict__ sel_expected, float* __restrict__ scratch, int max_windows,
    float* __restrict__ sums) {
  // level 0 reads the masked selections; level k writes buffer k % 2, each
  // buffer [2][max_windows] (price sums, then expected sums)
  int len = n;
  int level = 0;
  const float* src_p = nullptr;
  const float* src_e = nullptr;
  while (len > kWindow) {
    const int windows = (len + kWindow - 1) / kWindow;
    const int lo = (windows * kWindow - len) / 2;
    float* dst_p = scratch + (size_t)(level & 1) * 2 * max_windows;
    float* dst_e = dst_p + max_windows;
    for (int w = threadIdx.x; w < windows; w += kSumThreads) {
      float sp = 0.0f, se = 0.0f;
      for (int k = 0; k < kWindow; ++k) {
        const int idx = w * kWindow + k - lo;
        if (idx < 0 || idx >= len) continue;
        float p, e;
        if (level == 0) {
          const bool on = active[idx] != 0;
          p = on ? sel_price[idx] : 0.0f;
          e = on ? sel_expected[idx] : 0.0f;
        } else {
          p = src_p[idx];
          e = src_e[idx];
        }
        sp = __fadd_rn(sp, p);
        se = __fadd_rn(se, e);
      }
      dst_p[w] = sp;
      dst_e[w] = se;
    }
    __syncthreads();
    src_p = dst_p;
    src_e = dst_e;
    len = windows;
    ++level;
  }
  if (threadIdx.x == 0) {
    float sp = 0.0f, se = 0.0f;
    for (int idx = 0; idx < len; ++idx) {
      float p, e;
      if (level == 0) {
        const bool on = active[idx] != 0;
        p = on ? sel_price[idx] : 0.0f;
        e = on ? sel_expected[idx] : 0.0f;
      } else {
        p = src_p[idx];
        e = src_e[idx];
      }
      sp = __fadd_rn(sp, p);
      se = __fadd_rn(se, e);
    }
    sums[0] = sp;
    sums[1] = se;
  }
}

}  // namespace

extern "C" int kc_select_offerings(
    int n, int n_it, int n_z, int n_ct, float cw, float tw, float ra, int spot_pref,
    const void* viable, const void* zone, const void* ct, const void* open_,
    const void* pod_count, const void* price, const void* risk, const void* thr,
    const void* is_spot, void* sel_it, void* sel_zone, void* sel_ct, void* sel_price,
    void* sel_expected, void* active, void* sums, void* scratch, void* stream_p) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
  const int zct = n_z * n_ct;
  const int cells = n_it * zct;
  if (n <= 0 || cells <= 0) return static_cast<int>(cudaErrorInvalidValue);
  float* expected = static_cast<float*>(scratch);
  float* masked = expected + cells;
  float* levels = masked + cells;
  const int max_windows = (n + kWindow - 1) / kWindow;
  cell_scores_kernel<<<(cells + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      cells, zct, cw, tw, ra, static_cast<const float*>(price), static_cast<const float*>(risk),
      static_cast<const float*>(thr), expected, masked);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  select_kernel<<<n, kThreads, zct, stream>>>(
      n_it, n_z, n_ct, spot_pref, static_cast<const uint8_t*>(viable),
      static_cast<const uint8_t*>(zone), static_cast<const uint8_t*>(ct),
      static_cast<const uint8_t*>(open_), static_cast<const int32_t*>(pod_count),
      static_cast<const float*>(price), static_cast<const uint8_t*>(is_spot), expected, masked,
      static_cast<int32_t*>(sel_it), static_cast<int32_t*>(sel_zone),
      static_cast<int32_t*>(sel_ct), static_cast<float*>(sel_price),
      static_cast<float*>(sel_expected), static_cast<uint8_t*>(active));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fleet_sum_kernel<<<1, kSumThreads, 0, stream>>>(
      n, static_cast<const uint8_t*>(active), static_cast<const float*>(sel_price),
      static_cast<const float*>(sel_expected), levels, max_windows,
      static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}
