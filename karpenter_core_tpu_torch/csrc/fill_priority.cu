// K2: fill a quota of pods over node slots in priority order.
//
// Replaces `_fill_by_priority` (karpenter_core_tpu/ops/solve.py:419), the
// jnp program behind every placement fill (and, twice per call, behind
// `_fill_with_pref` :432):
//
//   order    = stable ascending argsort(priority)
//   before   = exclusive cumsum(cap[order])            (int32, wrapping)
//   assigned[order] = clip(quota - before, 0, cap[order])
//
// Bound on the H100: latency.  At the main path's N=8192 slots it moves
// 96 KB; the time is the launch and the block's passes over shared memory.
// Design: one block of 1024 threads holds the whole plane in registers
// (ITEMS per thread, blocked arrangement), sorts (priority, index) pairs with
// CUB's BlockRadixSort — a stable LSD radix sort, so equal priorities keep
// index order exactly as jnp.argsort — then takes the exclusive sum of the
// sorted caps with CUB's BlockScan and scatters the clipped fill back.  The
// scan runs on uint32 so the int32 wraparound of the reference's cumsum is
// defined behaviour here.  The plane is padded to 1024*ITEMS with
// (INT_MAX, index >= N, cap 0) entries, which sort after every real entry
// and add nothing to the scan.  The quota is read from device memory, so the
// caller never synchronises to pass it.  ITEMS is 1..16: N <= 16384, twice
// the main path's slot count (the slot-exhaustion retry doubles it).

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

template <int ITEMS>
struct FillTypes {
  using Sort = cub::BlockRadixSort<int, kThreads, ITEMS, int>;
  using Scan = cub::BlockScan<unsigned int, kThreads>;
  union Storage {
    typename Sort::TempStorage sort;
    typename Scan::TempStorage scan;
  };
};

template <int ITEMS>
__global__ void __launch_bounds__(kThreads) fill_priority_kernel(
    int n, const int32_t* __restrict__ quota_p, const int32_t* __restrict__ cap,
    const int32_t* __restrict__ priority, int32_t* __restrict__ out) {
  using T = FillTypes<ITEMS>;
  extern __shared__ __align__(16) unsigned char smem[];
  typename T::Storage& storage = *reinterpret_cast<typename T::Storage*>(smem);

  int keys[ITEMS];
  int idx[ITEMS];
  for (int j = 0; j < ITEMS; ++j) {
    const int g = threadIdx.x * ITEMS + j;
    keys[j] = g < n ? priority[g] : 2147483647;
    idx[j] = g;
  }
  typename T::Sort(storage.sort).Sort(keys, idx);
  __syncthreads();  // the scan reuses the sort's shared memory

  unsigned int c[ITEMS];
  unsigned int before[ITEMS];
  for (int j = 0; j < ITEMS; ++j) c[j] = idx[j] < n ? static_cast<unsigned int>(cap[idx[j]]) : 0u;
  typename T::Scan(storage.scan).ExclusiveSum(c, before);

  const unsigned int quota = static_cast<unsigned int>(*quota_p);
  for (int j = 0; j < ITEMS; ++j) {
    if (idx[j] >= n) continue;
    const int cj = static_cast<int>(c[j]);
    int a = static_cast<int>(quota - before[j]);  // int32 wraparound, as the reference
    a = a < 0 ? 0 : a;
    a = a > cj ? cj : a;
    out[idx[j]] = a;
  }
}

template <int ITEMS>
int launch(int n, const void* quota, const void* cap, const void* priority, void* out,
           cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(typename FillTypes<ITEMS>::Storage));
  cudaError_t err = cudaFuncSetAttribute(
      fill_priority_kernel<ITEMS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_priority_kernel<ITEMS><<<1, kThreads, smem, stream>>>(
      n, static_cast<const int32_t*>(quota), static_cast<const int32_t*>(cap),
      static_cast<const int32_t*>(priority), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int kc_fill_priority_max_n() { return kThreads * 16; }

extern "C" int kc_fill_priority(int n, const void* quota, const void* cap,
                                const void* priority, void* out, void* stream_p) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
  if (n <= 0) return 0;
  const int items = (n + kThreads - 1) / kThreads;
  if (items <= 1) return launch<1>(n, quota, cap, priority, out, stream);
  if (items <= 2) return launch<2>(n, quota, cap, priority, out, stream);
  if (items <= 4) return launch<4>(n, quota, cap, priority, out, stream);
  if (items <= 8) return launch<8>(n, quota, cap, priority, out, stream);
  if (items <= 16) return launch<16>(n, quota, cap, priority, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
