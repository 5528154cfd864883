// K17: the relax family's crossover, seeded rounding and exact audit.
//
// Replaces relax_core's :264-318 (karpenter_core_tpu/relax/kernel.py):
//   - crossover: each class with support moves its whole count m to the
//     first argmin of where(support, cost_eff, BIG); a class without
//     support keeps the iterate (all zeros);
//   - relaxed_cost: the float32 sum of where(support, cost * x, 0) over
//     [C, S] in XLA's CPU order: windows of up to 32 x 32 (the whole of an
//     axis of at most 32; a longer axis padded evenly at both ends to a
//     multiple of 32), each summed row-major from +0, repeated on the
//     window sums until neither axis is longer than 32, then those summed
//     row-major from +0;
//   - rounding: x_r = x * (1 - 1e-6), n0 = floor(x_r), deficit = max(m -
//     sum n0, 0), fq = floor(frac(x_r) * 2^20) (-1 off the support); the
//     deficit goes one pod a cell to the first cells in the stable order
//     (fq desc, position in the seeded permutation asc);
//   - audit: a rounded cell survives only if its template (tstar) admits it
//     on the exact planes: instance type and zone rectangles, merged-
//     requirement intersection, per-node intake >= 1, key compatibility and
//     an available offering among the allowed capacity types (a bitwise any;
//     the reference's bf16 einsum of 0/1 values tested > 0.5).
//
// Bound on the H100: bytes.  It reads three [C, S] f32 planes and a few
// small ones and writes n_ok (about 1 MB at the headline: 0.3 us at
// 3.35 TB/s).  Design: launch 1 runs one block of 1,024 threads a class
// row: an argmin reduction (ties to the lower index), the floors in shared
// memory, the stable order as a bitonic sort of 64-bit keys (the negated
// fraction with its sign bit flipped, then the permutation position) over
// the next power of two, and the audit, with one atomicAdd of the row's
// violations.  Launch 2 is one block that sums the products in XLA's
// order (one thread a window, the levels in shared memory).
// Float arithmetic is spelled with the _rn intrinsics (no contraction).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 32;
constexpr float kBig = 1e30f;
constexpr float kShave = 0.999999f;  // float32(1 - 1e-6)
constexpr float kFracQ = 1048576.0f;

__device__ __forceinline__ int sat_i32(float v) {  // XLA's saturating convert
  if (isnan(v)) return 0;
  if (v >= 2147483648.0f) return 2147483647;
  if (v <= -2147483648.0f) return (int)0x80000000;
  return (int)v;
}

__global__ void __launch_bounds__(kThreads) relax_round_kernel(
    int n_c, int n_t, int n_i, int n_z, int n_ct, int p2, const float* __restrict__ x,
    const float* __restrict__ cost, const float* __restrict__ cost_eff,
    const uint8_t* __restrict__ support, const int32_t* __restrict__ counts,
    const int32_t* __restrict__ perm, const int32_t* __restrict__ tstar,
    const uint8_t* __restrict__ it_int, const int32_t* __restrict__ per_pod,
    const uint8_t* __restrict__ key_ok, const uint8_t* __restrict__ tmpl_it,
    const uint8_t* __restrict__ cls_it, const uint8_t* __restrict__ tmpl_zone,
    const uint8_t* __restrict__ cls_zone, const uint8_t* __restrict__ tmpl_ct,
    const uint8_t* __restrict__ cls_ct, const uint8_t* __restrict__ it_avail,
    int32_t* __restrict__ n_ok, int32_t* __restrict__ violations,
    float* __restrict__ products) {
  extern __shared__ unsigned long long keys[];  // [p2]
  const int n_s = n_i * n_z;
  int* fq = reinterpret_cast<int*>(keys + p2);  // [n_s]
  int* n0 = fq + n_s;                             // [n_s]
  uint8_t* add = reinterpret_cast<uint8_t*>(n0 + n_s);  // [n_s]
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_int[kWarps];
  __shared__ int s_jstar, s_any, s_deficit;
  const int c = blockIdx.x;
  const size_t row = (size_t)c * n_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // crossover: the first argmin of where(support, cost_eff, BIG)
  float bv = INFINITY;
  int bi = 0x7fffffff;
  int any = 0;
  for (int j = threadIdx.x; j < n_s; j += blockDim.x) {
    const bool s = support[row + j] != 0;
    any |= s ? 1 : 0;
    const float v = s ? cost_eff[row + j] : kBig;
    if (v < bv || (v == bv && j < bi)) {
      bv = v;
      bi = j;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, o);
    const int oi = __shfl_down_sync(0xffffffffu, bi, o);
    if (ov < bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
    any |= __shfl_down_sync(0xffffffffu, any, o);
  }
  if (lane == 0) {
    s_val[warp] = bv;
    s_idx[warp] = bi;
    s_int[warp] = any;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = s_val[0];
    int i0 = s_idx[0], a = s_int[0];
    for (int w = 1; w < kWarps; ++w) {
      if (s_val[w] < v || (s_val[w] == v && s_idx[w] < i0)) {
        v = s_val[w];
        i0 = s_idx[w];
      }
      a |= s_int[w];
    }
    s_jstar = i0;
    s_any = a;
  }
  __syncthreads();
  const int jstar = s_jstar;
  const bool has_support = s_any != 0;
  const float m = (float)counts[c];

  // floors and fractions
  int n0_sum = 0;
  for (int j = threadIdx.x; j < n_s; j += blockDim.x) {
    const bool s = support[row + j] != 0;
    const float xv = has_support ? ((j == jstar && s) ? m : 0.0f) : x[row + j];
    products[row + j] = s ? __fmul_rn(cost[row + j], xv) : 0.0f;
    const float x_r = __fmul_rn(xv, kShave);
    const float n0f = floorf(x_r);
    const int n0i = sat_i32(n0f);
    n0[j] = n0i;
    n0_sum += n0i;
    fq[j] = s ? sat_i32(floorf(__fmul_rn(__fsub_rn(x_r, n0f), kFracQ))) : -1;
    add[j] = 0;
  }
  for (int o = 16; o > 0; o >>= 1) n0_sum += __shfl_down_sync(0xffffffffu, n0_sum, o);
  if (lane == 0) s_int[warp] = n0_sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_int[w];
    s_deficit = max(counts[c] - total, 0);
  }
  // the stable order (fq desc, seeded position asc) as ascending 64-bit keys
  for (int k = threadIdx.x; k < p2; k += blockDim.x) {
    unsigned long long key = ~0ull;
    if (k < n_s) {
      const unsigned int hi = (unsigned int)(-fq[perm[k]]) ^ 0x80000000u;
      key = ((unsigned long long)hi << 32) | (unsigned int)k;
    }
    keys[k] = key;
  }
  __syncthreads();
  for (int k = 2; k <= p2; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      for (int i = threadIdx.x; i < p2; i += blockDim.x) {
        const int ixj = i ^ jj;
        if (ixj > i) {
          const unsigned long long a = keys[i], b = keys[ixj];
          if (((i & k) == 0) ? (a > b) : (a < b)) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const int take = min(s_deficit, n_s);
  for (int r = threadIdx.x; r < take; r += blockDim.x)
    add[perm[(int)(keys[r] & 0xffffffffull)]] = 1;
  __syncthreads();

  // the audit at the chosen template
  int viol = 0;
  for (int j = threadIdx.x; j < n_s; j += blockDim.x) {
    const bool s = support[row + j] != 0;
    const int nr = s ? n0[j] + (int)add[j] : 0;
    const int t = tstar[row + j];
    const int i = j / n_z, z = j - (j / n_z) * n_z;
    const size_t cti = ((size_t)c * n_t + t) * n_i + i;
    bool ok = tmpl_it[(size_t)t * n_i + i] && cls_it[(size_t)c * n_i + i] && it_int[cti] &&
              per_pod[cti] >= 1 && key_ok[(size_t)c * n_t + t] &&
              tmpl_zone[(size_t)t * n_z + z] && cls_zone[(size_t)c * n_z + z];
    if (ok) {
      bool offer = false;
      for (int k = 0; k < n_ct; ++k)
        offer = offer || (tmpl_ct[(size_t)t * n_ct + k] && cls_ct[(size_t)c * n_ct + k] &&
                          it_avail[((size_t)i * n_z + z) * n_ct + k]);
      ok = offer;
    }
    const bool bad = nr > 0 && !ok;
    if (bad) viol += nr;
    n_ok[row + j] = bad ? 0 : nr;
  }
  for (int o = 16; o > 0; o >>= 1) viol += __shfl_down_sync(0xffffffffu, viol, o);
  if (lane == 0 && viol != 0) atomicAdd(violations, viol);
}

struct Plan {
  int w, n, lo;  // window, windows, leading pad of one axis
};

__device__ __forceinline__ Plan window_plan(int n) {
  if (n <= kWindow) return Plan{n, 1, 0};
  const int count = (n + kWindow - 1) / kWindow;
  return Plan{kWindow, count, (count * kWindow - n) / 2};
}

// XLA's CPU order for the sum of v[R, S]: while an axis is longer than 32,
// each window (32 along a long axis, the whole of a short one) is summed
// row-major from +0 (pads +0); then what is left, row-major from +0
__global__ void __launch_bounds__(kThreads) relax_cost_sum_kernel(int n_c, int n_s,
                                                            const float* __restrict__ products,
                                                            float* __restrict__ out) {
  extern __shared__ float level[];  // two buffers of the first level's size
  const Plan r0 = window_plan(n_c), c0 = window_plan(n_s);
  float* bufs[2] = {level, level + (size_t)r0.n * c0.n};
  const float* cur = products;
  int rows = n_c, cols = n_s, which = 0;
  while (rows > kWindow || cols > kWindow) {
    const Plan pr = window_plan(rows), pc = window_plan(cols);
    float* dst = bufs[which];
    for (int o = threadIdx.x; o < pr.n * pc.n; o += blockDim.x) {
      const int a = o / pc.n, b = o - (o / pc.n) * pc.n;
      float acc = 0.0f;
      for (int rr = 0; rr < pr.w; ++rr) {
        const int r = a * pr.w + rr - pr.lo;
        for (int cc = 0; cc < pc.w; ++cc) {
          const int col = b * pc.w + cc - pc.lo;
          const bool in = r >= 0 && r < rows && col >= 0 && col < cols;
          acc = __fadd_rn(acc, in ? cur[(size_t)r * cols + col] : 0.0f);
        }
      }
      dst[o] = acc;
    }
    __syncthreads();
    cur = dst;
    rows = pr.n;
    cols = pc.n;
    which ^= 1;
  }
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int k = 0; k < rows * cols; ++k) acc = __fadd_rn(acc, cur[k]);
    *out = acc;
  }
}

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" int kc_relax_round(int n_c, int n_t, int n_i, int n_z, int n_ct, const void* x,
                              const void* cost, const void* cost_eff, const void* support,
                              const void* counts, const void* perm, const void* tstar,
                              const void* it_int, const void* per_pod, const void* key_ok,
                              const void* tmpl_it, const void* cls_it, const void* tmpl_zone,
                              const void* cls_zone, const void* tmpl_ct, const void* cls_ct,
                              const void* it_avail, void* n_ok, void* violations,
                              void* relaxed_cost, void* products, void* stream_p) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
  const long long n_s = (long long)n_i * n_z;
  if (n_c <= 0 || n_t <= 0 || n_s <= 0 || n_s >= (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int p2 = next_pow2((int)n_s);
  const size_t smem = sizeof(unsigned long long) * p2 + sizeof(int) * 2 * n_s + n_s;
  cudaError_t err = cudaFuncSetAttribute(relax_round_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  relax_round_kernel<<<n_c, kThreads, smem, stream>>>(
      n_c, n_t, n_i, n_z, n_ct, p2, static_cast<const float*>(x),
      static_cast<const float*>(cost), static_cast<const float*>(cost_eff),
      static_cast<const uint8_t*>(support), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(perm), static_cast<const int32_t*>(tstar),
      static_cast<const uint8_t*>(it_int), static_cast<const int32_t*>(per_pod),
      static_cast<const uint8_t*>(key_ok), static_cast<const uint8_t*>(tmpl_it),
      static_cast<const uint8_t*>(cls_it), static_cast<const uint8_t*>(tmpl_zone),
      static_cast<const uint8_t*>(cls_zone), static_cast<const uint8_t*>(tmpl_ct),
      static_cast<const uint8_t*>(cls_ct), static_cast<const uint8_t*>(it_avail),
      static_cast<int32_t*>(n_ok), static_cast<int32_t*>(violations),
      static_cast<float*>(products));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_w = (n_s + kWindow - 1) / kWindow, r_w = (n_c + kWindow - 1) / kWindow;
  const size_t smem2 = sizeof(float) * 2 * (size_t)(n_w * r_w);
  err = cudaFuncSetAttribute(relax_cost_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  relax_cost_sum_kernel<<<1, kThreads, smem2, stream>>>(n_c, (int)n_s,
                                                  static_cast<const float*>(products),
                                                  static_cast<float*>(relaxed_cost));
  return static_cast<int>(cudaGetLastError());
}
