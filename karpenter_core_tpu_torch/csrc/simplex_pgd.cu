// K16: the relax family's projected-gradient loop on the class simplices.
//
// Replaces `_simplex_project` (karpenter_core_tpu/relax/kernel.py:94) and
// the `lax.while_loop` around it (:220-251): with cost_eff, mu and lr
// formed as relax_core forms them,
//
//   x = project(0); it = 0; delta = inf
//   while it < max_iters and delta > tol:
//     x1 = project(fma(-lr, fma(mu, x, cost_eff), x))
//     delta = max over every class and cell of |x1 - x| / max(m, 1)
//     x = x1; it += 1
//
// where project(y) sorts where(support, y, -BIG) descending, scans it in
// XLA's CPU order (blocks of 16 summed in order from +0, the block totals
// scanned the same way recursively, each block's exclusive prefix added to
// it), counts ys[j] * (j + 1) > css[j] - m, clips that to [1, S] as rho and
// thresholds at theta = (css[rho - 1] - m) / rho.
//
// Bound on the H100: operations, and really latency.  Each iteration sorts
// C rows of S values (S log^2 S compare-exchanges in a bitonic network) and
// scans them; at the headline (C = 16, S = 3,000, 8 iterations) that is
// about 16 * 8 * 4,096 * 78 / 2 = 20 M compare-exchanges, 0.3 us at the
// card's scalar rate, far below the launch-and-barrier latency of a loop
// whose condition is global.
// Design: ONE cooperative launch of C blocks (one block a class row, 1,024
// threads, the row's iterate, step, sorted values and scan in shared
// memory).  After each iteration every block writes its row's step maximum
// to its own slot of that iteration, passes a grid barrier (an atomic
// arrival count and a generation word, which the cooperative launch makes
// safe: it fails instead of running when the C blocks cannot all be
// resident), then reads all C slots and takes their maximum (exact in any
// order), so every block reaches the same decision with no host read.
// The sort is a bitonic network over the next power of two (pads -inf);
// only the sorted values are used, so the order of equal values does not
// matter.  The scan is written out by hand in XLA's order: a library block
// scan would add in another order.  Float arithmetic is spelled with the
// _rn intrinsics so nvcc contracts nothing beyond XLA's three FMAs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kScanBlock = 16;
constexpr int kMaxLevels = 10;
constexpr float kBig = 1e30f;
constexpr float kRankEps = 3e-3f;
constexpr float kMu0 = 1e-3f;
constexpr float kScaleFloor = 1e-20f;

struct Params {
  int n_c, n_s, p2, lvl_len, max_iters;
  float tol;
  const float* cost;
  const uint8_t* support;
  const float* cost_max;
  const int32_t* counts;
  float* x_out;
  float* ce_out;
  int32_t* out;
  float* deltas;          // [max_iters + 1][n_c]
  unsigned int* barrier;  // [count, generation]
};

__device__ int level_plan(int n, int* sizes) {
  int depth = 0;
  sizes[0] = n;
  while (sizes[depth] > kScanBlock && depth + 1 < kMaxLevels) {
    sizes[depth + 1] = (sizes[depth] + kScanBlock - 1) / kScanBlock;
    ++depth;
  }
  return depth;
}

// inclusive float32 scan of a[0, n) in XLA's CPU order; lvl holds the block
// totals of every level
__device__ void xla_cumsum(float* a, int n, float* lvl) {
  int sizes[kMaxLevels];
  float* bufs[kMaxLevels];
  const int depth = level_plan(n, sizes);
  bufs[0] = a;
  float* next = lvl;
  for (int l = 1; l <= depth; ++l) {
    bufs[l] = next;
    next += sizes[l];
  }
  for (int l = 0; l < depth; ++l) {
    float* buf = bufs[l];
    const int nl = sizes[l];
    for (int b = threadIdx.x; b < sizes[l + 1]; b += blockDim.x) {
      float acc = 0.0f;
      const int lo = b * kScanBlock;
      const int hi = min(lo + kScanBlock, nl);
      for (int j = lo; j < hi; ++j) {
        acc = __fadd_rn(acc, buf[j]);
        buf[j] = acc;
      }
      if (hi - lo < kScanBlock) acc = __fadd_rn(acc, 0.0f);  // the zero padding
      bufs[l + 1][b] = acc;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float* buf = bufs[depth];
    float acc = 0.0f;
    for (int j = 0; j < sizes[depth]; ++j) {
      acc = __fadd_rn(acc, buf[j]);
      buf[j] = acc;
    }
  }
  __syncthreads();
  for (int l = depth - 1; l >= 0; --l) {
    float* buf = bufs[l];
    const float* up = bufs[l + 1];
    for (int j = threadIdx.x; j < sizes[l]; j += blockDim.x) {
      const int b = j / kScanBlock;
      buf[j] = __fadd_rn(b == 0 ? 0.0f : up[b - 1], buf[j]);
    }
    __syncthreads();
  }
}

__device__ void bitonic_desc(float* v, int p2) {
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p2; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const float a = v[i], b = v[ixj];
          const bool desc = (i & k) == 0;
          if (desc ? (a < b) : (a > b)) {
            v[i] = b;
            v[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

__device__ int block_sum_int(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const int total = red[0];
  __syncthreads();
  return total;
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float total = red[0];
  __syncthreads();
  return total;
}

// x1 = project(y) of this block's row.  x1 may alias ys: the sorted values
// are last read before the count's reduction, and theta reads css only
__device__ void project(const Params& p, const float* y, const uint8_t* sup, float m,
                        float* ys, float* css, float* lvl, int* ired, float* x1) {
  const int n_s = p.n_s;
  for (int j = threadIdx.x; j < p.p2; j += blockDim.x)
    ys[j] = j < n_s ? (sup[j] ? y[j] : -kBig) : -INFINITY;
  __syncthreads();
  bitonic_desc(ys, p.p2);
  for (int j = threadIdx.x; j < n_s; j += blockDim.x) css[j] = ys[j];
  __syncthreads();
  xla_cumsum(css, n_s, lvl);
  int cnt = 0;
  for (int j = threadIdx.x; j < n_s; j += blockDim.x)
    cnt += __fmul_rn(ys[j], (float)(j + 1)) > __fsub_rn(css[j], m) ? 1 : 0;
  const int rho = min(max(block_sum_int(cnt, ired), 1), n_s);
  const float theta = __fdiv_rn(__fsub_rn(css[rho - 1], m), (float)rho);
  for (int j = threadIdx.x; j < n_s; j += blockDim.x)
    x1[j] = sup[j] ? fmaxf(__fsub_rn(y[j], theta), 0.0f) : 0.0f;
  __syncthreads();
}

__device__ void grid_barrier(unsigned int* count, unsigned int* gen, unsigned int n_blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int g = atomicAdd(gen, 0u);
    __threadfence();
    if (atomicAdd(count, 1u) == n_blocks - 1) {
      atomicExch(count, 0u);
      __threadfence();
      atomicAdd(gen, 1u);
    } else {
      while (atomicAdd(gen, 0u) == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) simplex_pgd_kernel(Params p) {
  extern __shared__ float smem[];
  const int n_s = p.n_s;
  float* x = smem;
  float* ce = x + n_s;
  float* y = ce + n_s;
  float* css = y + n_s;
  float* ys = css + n_s;
  float* lvl = ys + p.p2;
  float* fred = lvl + p.lvl_len;
  int* ired = reinterpret_cast<int*>(fred + kWarps);
  uint8_t* sup = reinterpret_cast<uint8_t*>(ired + kWarps);
  const int c = blockIdx.x;
  const size_t row = (size_t)c * n_s;

  const float m = (float)p.counts[c];
  const float scale = fmaxf(p.cost_max[c], kScaleFloor);
  const float eps_s = __fmul_rn(scale, kRankEps);
  const float inv_s = __fdiv_rn(1.0f, (float)n_s);
  const float mu = __fdiv_rn(__fmul_rn(scale, kMu0), fmaxf(m, 1.0f));
  const float lr = __fdiv_rn(1.0f, __fmul_rn(mu, 2.0f));
  const float norm = fmaxf(m, 1.0f);
  for (int j = threadIdx.x; j < n_s; j += blockDim.x) {
    const bool s = p.support[row + j] != 0;
    sup[j] = s;
    const float e = __fmaf_rn(eps_s, __fmul_rn((float)j, inv_s), s ? p.cost[row + j] : 0.0f);
    ce[j] = e;
    p.ce_out[row + j] = e;
    y[j] = 0.0f;
  }
  __syncthreads();
  project(p, y, sup, m, ys, css, lvl, ired, x);

  int it = 0;
  float delta = INFINITY;
  while (it < p.max_iters && delta > p.tol) {
    for (int j = threadIdx.x; j < n_s; j += blockDim.x)
      y[j] = __fmaf_rn(-lr, __fmaf_rn(mu, x[j], ce[j]), x[j]);
    __syncthreads();
    project(p, y, sup, m, ys, css, lvl, ired, ys);  // x1 into the sorted buffer
    float d = 0.0f;
    for (int j = threadIdx.x; j < n_s; j += blockDim.x) {
      d = fmaxf(d, __fdiv_rn(fabsf(__fsub_rn(ys[j], x[j])), norm));
      x[j] = ys[j];
    }
    d = block_max(d, fred);
    float* slot = p.deltas + (size_t)it * p.n_c;
    if (threadIdx.x == 0) slot[c] = d;
    grid_barrier(p.barrier, p.barrier + 1, (unsigned int)p.n_c);
    float dmax = 0.0f;
    for (int cc = 0; cc < p.n_c; ++cc) dmax = fmaxf(dmax, __ldcg(slot + cc));
    delta = dmax;
    ++it;
  }
  for (int j = threadIdx.x; j < n_s; j += blockDim.x) p.x_out[row + j] = x[j];
  if (c == 0 && threadIdx.x == 0) {
    p.out[0] = it;
    p.out[1] = delta <= p.tol ? 1 : 0;
  }
}

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" int kc_simplex_pgd(int n_c, int n_s, int max_iters, float tol, const void* cost,
                              const void* support, const void* cost_max, const void* counts,
                              void* x_out, void* ce_out, void* out, void* scratch,
                              void* stream_p) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
  if (n_c <= 0 || n_s <= 0 || max_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.n_c = n_c;
  p.n_s = n_s;
  p.p2 = next_pow2(n_s);
  p.lvl_len = n_s / (kScanBlock - 1) + kMaxLevels + 1;
  p.max_iters = max_iters;
  p.tol = tol;
  p.cost = static_cast<const float*>(cost);
  p.support = static_cast<const uint8_t*>(support);
  p.cost_max = static_cast<const float*>(cost_max);
  p.counts = static_cast<const int32_t*>(counts);
  p.x_out = static_cast<float*>(x_out);
  p.ce_out = static_cast<float*>(ce_out);
  p.out = static_cast<int32_t*>(out);
  // scratch (int32 words): [barrier count, barrier generation, deltas...]
  p.barrier = static_cast<unsigned int*>(scratch);
  p.deltas = reinterpret_cast<float*>(static_cast<unsigned int*>(scratch) + 2);
  const size_t smem = sizeof(float) * ((size_t)4 * n_s + p.p2 + p.lvl_len + kWarps) +
                      sizeof(int) * kWarps + (size_t)n_s;
  cudaError_t err = cudaFuncSetAttribute(
      simplex_pgd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, simplex_pgd_kernel, kThreads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((long long)per_sm * sms < n_c)  // the C blocks could not all be resident
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(simplex_pgd_kernel),
                                    dim3(n_c), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
