// K8: the set-up of every lane of one consolidation sweep pass.
//
// Replaces the set-up of `sweep.one_prefix`
// (karpenter_core_tpu/ops/consolidate.py:69-78) under `jax.vmap` over the
// pass's prefix sizes k[s]:
//
//   subset[s,e] = rank[e] < k[s]          (rank: position in disruption order,
//                                          1 << 30 for a non-candidate or a
//                                          padded row, so it never enters)
//   open[s,e]   = open_[e] & ~subset[s,e]  (the lane's nodes with the first
//                                          k[s] candidates closed)
//   count[s,c]  = base[c] + sum_e ex_cls_count[c,e] * subset[s,e]
//                                         (the displaced pods rejoin their class)
//
// Bound on the H100: bytes.  At S = 64 lanes, C = 16 classes and E = 6,144
// existing nodes it must read the C x E count plane (393 KB) and write the
// S x E masks (393 KB): 0.24 us at 3.35 TB/s, far below the launch latency.
// Design: one block of 256 threads per (lane, class) pair; the block walks
// the class's row of the count plane, coalesced, and reduces its partial
// sums by warp shuffles and one shared-memory step.  The blocks of class 0
// also write the lane's open mask.  The count plane (393 KB) stays in L2
// across the S blocks that read each row.
//
// Integer sums match the reference's int32 sums bit for bit: they run in
// unsigned arithmetic, which wraps as int32 addition does in XLA (and, being
// associative, in any order).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) sweep_lanes_kernel(
    int n_ex, int n_cls,
    const int32_t* __restrict__ rank,          // [E]
    const uint8_t* __restrict__ open_,         // [E]
    const int32_t* __restrict__ base,          // [C]
    const int32_t* __restrict__ ex_cls_count,  // [C, E]
    const int32_t* __restrict__ sizes,         // [S]
    uint8_t* __restrict__ lane_open,           // [S, E]
    int32_t* __restrict__ count_out) {         // [S, C]
  const int s = blockIdx.x;
  const int c = blockIdx.y;
  const int32_t k = sizes[s];
  const int32_t* row = ex_cls_count + static_cast<size_t>(c) * n_ex;
  uint8_t* open_row = lane_open + static_cast<size_t>(s) * n_ex;
  uint32_t partial = 0;
  for (int e = threadIdx.x; e < n_ex; e += kThreads) {
    const bool sub = rank[e] < k;
    if (c == 0) open_row[e] = (open_[e] && !sub) ? 1 : 0;
    if (c < n_cls && sub) partial += static_cast<uint32_t>(row[e]);
  }
  for (int off = 16; off > 0; off >>= 1) {
    partial += __shfl_down_sync(0xffffffffu, partial, off);
  }
  __shared__ uint32_t warp_sums[kWarps];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = partial;
  __syncthreads();
  if (threadIdx.x == 0 && c < n_cls) {
    uint32_t total = static_cast<uint32_t>(base[c]);
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    count_out[static_cast<size_t>(s) * n_cls + c] = static_cast<int32_t>(total);
  }
}

}  // namespace

extern "C" int kc_sweep_lanes(
    int n_lanes, int n_ex, int n_cls,
    const void* rank, const void* open_, const void* base, const void* ex_cls_count,
    const void* sizes, void* lane_open, void* count_out, void* stream) {
  if (n_lanes <= 0) return 0;
  if (n_cls > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_lanes, n_cls > 0 ? n_cls : 1);
  sweep_lanes_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n_ex, n_cls, static_cast<const int32_t*>(rank), static_cast<const uint8_t*>(open_),
      static_cast<const int32_t*>(base), static_cast<const int32_t*>(ex_cls_count),
      static_cast<const int32_t*>(sizes), static_cast<uint8_t*>(lane_open),
      static_cast<int32_t*>(count_out));
  return static_cast<int>(cudaGetLastError());
}
