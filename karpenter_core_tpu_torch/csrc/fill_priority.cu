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
//
// Above 16,384 slots (an existing cluster that large, or a retry past it)
// a multi-block path takes over, in five launches on the caller's stream:
//   1. keys: the sort's keys (below) and the slot indices, its values;
//   2. CUB's device-wide radix sort of (key, index) pairs.  An LSD
//      radix sort is stable, and the values enter in index order, so equal
//      priorities keep index order as jnp.argsort does;
//   3. tile_sums: the uint32 sum of the sorted caps of each 1,024-slot tile;
//   4. tile_offsets: one block's exclusive scan of the tile sums;
//   5. clip_scatter: each tile's exclusive scan (warp shuffles, then the
//      warps' totals), plus its tile offset, gives every slot's `before`;
//      the clipped fill is scattered to the slot's index.
// The wrapper allocates the scratch (kc_fill_priority_scratch_bytes).  The
// scans run on uint32, as the one-block path does, so the int32 wraparound
// of the reference's cumsum stays defined; the quota is read on the device.
//
// Tenant axis: cap, priority and out may be B tenants' planes stacked
// ([B, N]) with one quota each ([B]); each tenant is filled on its own.
// The one-block path runs one block a tenant (grid = B).  The multi-block
// path sorts 64-bit keys (tenant << 32 | priority with its sign bit
// flipped), so one stable device-wide sort leaves each tenant's entries in
// its own segment, in (priority, index) order; the tile sums, tile offsets
// and clip-and-scatter then run a grid row a tenant and restart at each
// segment.  A solo call is B = 1 (its keys' top half is zero).

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>
#include <cub/device/device_radix_sort.cuh>
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
  // this block's tenant
  const size_t tb = blockIdx.x;
  quota_p += tb;
  cap += tb * n;
  priority += tb * n;
  out += tb * n;

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
int launch(int n_batch, int n, const void* quota, const void* cap, const void* priority,
           void* out, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(typename FillTypes<ITEMS>::Storage));
  cudaError_t err = cudaFuncSetAttribute(
      fill_priority_kernel<ITEMS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_priority_kernel<ITEMS><<<n_batch, kThreads, smem, stream>>>(
      n, static_cast<const int32_t*>(quota), static_cast<const int32_t*>(cap),
      static_cast<const int32_t*>(priority), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// -- the multi-block path ------------------------------------------------------

constexpr int kTileThreads = 256;
constexpr int kTileItems = 4;
constexpr int kTile = kTileThreads * kTileItems;
constexpr int kOneBlock = kThreads * 16;

size_t align_up(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

// the sort's keys and values: key = tenant << 32 | (priority ^ sign bit),
// so unsigned order is (tenant, signed priority); value = the flat index
__global__ void keys_kernel(long long total, int n, const int32_t* __restrict__ priority,
                            unsigned long long* __restrict__ keys, int32_t* __restrict__ idx) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const unsigned long long tb = static_cast<unsigned long long>(g / n);
  keys[g] = (tb << 32) | (static_cast<uint32_t>(priority[g]) ^ 0x80000000u);
  idx[g] = static_cast<int32_t>(g);
}

// the exclusive prefix of `v` over the block's threads, and the block total
__device__ __forceinline__ unsigned int block_exclusive_scan(unsigned int v, unsigned int* total) {
  __shared__ unsigned int warp_sums[kTileThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned int incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  unsigned int warp_base = 0, all = 0;
  for (int w = 0; w < kTileThreads / 32; ++w) {
    if (w < warp) warp_base += warp_sums[w];
    all += warp_sums[w];
  }
  __syncthreads();  // warp_sums is reused by the next call
  *total = all;
  return warp_base + incl - v;
}

__global__ void __launch_bounds__(kTileThreads) tile_sums_kernel(
    int n, int tiles, const int32_t* __restrict__ cap, const int32_t* __restrict__ order,
    unsigned int* __restrict__ tile_sums) {
  // grid (tiles, B): this tenant's segment of the sorted order
  order += static_cast<size_t>(blockIdx.y) * n;
  tile_sums += static_cast<size_t>(blockIdx.y) * tiles;
  const int base = blockIdx.x * kTile + threadIdx.x * kTileItems;
  unsigned int local = 0;
  for (int j = 0; j < kTileItems; ++j) {
    if (base + j < n) local += static_cast<unsigned int>(cap[order[base + j]]);
  }
  unsigned int total;
  block_exclusive_scan(local, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kTileThreads) tile_offsets_kernel(
    int tiles, unsigned int* __restrict__ tile_sums) {
  tile_sums += static_cast<size_t>(blockIdx.x) * tiles;  // one block a tenant
  // in place: tile sums -> exclusive tile offsets, kTileThreads tiles a round
  unsigned int carry = 0;
  for (int start = 0; start < tiles; start += kTileThreads) {
    const int t = start + threadIdx.x;
    const unsigned int v = t < tiles ? tile_sums[t] : 0u;
    unsigned int total;
    const unsigned int excl = block_exclusive_scan(v, &total);
    if (t < tiles) tile_sums[t] = carry + excl;
    carry += total;
  }
}

__global__ void __launch_bounds__(kTileThreads) clip_scatter_kernel(
    int n, const int32_t* __restrict__ quota_p, const int32_t* __restrict__ cap,
    const int32_t* __restrict__ order, const unsigned int* __restrict__ tile_offsets,
    int tiles, int32_t* __restrict__ out) {
  // grid (tiles, B): the order holds flat indices, so cap and out stay whole
  quota_p += blockIdx.y;
  order += static_cast<size_t>(blockIdx.y) * n;
  tile_offsets += static_cast<size_t>(blockIdx.y) * tiles;
  const int base = blockIdx.x * kTile + threadIdx.x * kTileItems;
  unsigned int c[kTileItems];
  int idx[kTileItems];
  unsigned int local = 0;
  for (int j = 0; j < kTileItems; ++j) {
    idx[j] = base + j < n ? order[base + j] : -1;
    c[j] = idx[j] >= 0 ? static_cast<unsigned int>(cap[idx[j]]) : 0u;
    local += c[j];
  }
  unsigned int total;
  unsigned int before = tile_offsets[blockIdx.x] + block_exclusive_scan(local, &total);
  const unsigned int quota = static_cast<unsigned int>(*quota_p);
  for (int j = 0; j < kTileItems; ++j) {
    if (idx[j] >= 0) {
      const int cj = static_cast<int>(c[j]);
      int a = static_cast<int>(quota - before);  // int32 wraparound, as the reference
      a = a < 0 ? 0 : a;
      a = a > cj ? cj : a;
      out[idx[j]] = a;
    }
    before += c[j];
  }
}

size_t cub_bytes(long long total) {
  size_t bytes = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, bytes, static_cast<const unsigned long long*>(nullptr),
                                  static_cast<unsigned long long*>(nullptr),
                                  static_cast<const int*>(nullptr), static_cast<int*>(nullptr),
                                  static_cast<int>(total));
  return bytes;
}

// scratch layout: keys in, keys out, indices in, indices out, tile sums,
// CUB's storage
size_t multi_scratch_bytes(int n_batch, int n) {
  const long long total = static_cast<long long>(n_batch) * n;
  const size_t tiles = (static_cast<size_t>(n) + kTile - 1) / kTile;
  return 2 * align_up(static_cast<size_t>(total) * 8) + 2 * align_up(static_cast<size_t>(total) * 4)
      + align_up(tiles * n_batch * 4) + align_up(cub_bytes(total));
}

int launch_multi(int n_batch, int n, const void* quota, const void* cap, const void* priority,
                 void* out, void* scratch, cudaStream_t stream) {
  const long long total = static_cast<long long>(n_batch) * n;
  unsigned char* p = static_cast<unsigned char*>(scratch);
  const size_t kplane = align_up(static_cast<size_t>(total) * 8);
  const size_t iplane = align_up(static_cast<size_t>(total) * 4);
  unsigned long long* keys_in = reinterpret_cast<unsigned long long*>(p);
  unsigned long long* keys_out = reinterpret_cast<unsigned long long*>(p + kplane);
  int32_t* idx_in = reinterpret_cast<int32_t*>(p + 2 * kplane);
  int32_t* idx_out = reinterpret_cast<int32_t*>(p + 2 * kplane + iplane);
  const int tiles = (n + kTile - 1) / kTile;
  unsigned int* tile_sums = reinterpret_cast<unsigned int*>(p + 2 * kplane + 2 * iplane);
  void* cub_tmp = p + 2 * kplane + 2 * iplane + align_up(static_cast<size_t>(tiles) * n_batch * 4);
  size_t cub_size = cub_bytes(total);
  // sort only the key bits in use: the priority's 32 and the tenant's
  int end_bit = 32;
  while ((1LL << (end_bit - 32)) < n_batch) ++end_bit;

  keys_kernel<<<static_cast<unsigned int>((total + 255) / 256), 256, 0, stream>>>(
      total, n, static_cast<const int32_t*>(priority), keys_in, idx_in);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cub::DeviceRadixSort::SortPairs(cub_tmp, cub_size, keys_in, keys_out, idx_in, idx_out,
                                        static_cast<int>(total), 0, end_bit, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_sums_kernel<<<dim3(tiles, n_batch), kTileThreads, 0, stream>>>(
      n, tiles, static_cast<const int32_t*>(cap), idx_out, tile_sums);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_offsets_kernel<<<n_batch, kTileThreads, 0, stream>>>(tiles, tile_sums);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  clip_scatter_kernel<<<dim3(tiles, n_batch), kTileThreads, 0, stream>>>(
      n, static_cast<const int32_t*>(quota), static_cast<const int32_t*>(cap), idx_out,
      tile_sums, tiles, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int kc_fill_priority_max_n() { return kOneBlock; }

extern "C" size_t kc_fill_priority_scratch_bytes(int n_batch, int n) {
  return n > kOneBlock ? multi_scratch_bytes(n_batch, n) : 0;
}

extern "C" int kc_fill_priority_multi(int n_batch, int n, const void* quota, const void* cap,
                                      const void* priority, void* out, void* scratch,
                                      void* stream_p) {
  if (n <= 0 || n_batch <= 0) return 0;
  if (n_batch > 65535 || static_cast<long long>(n_batch) * n > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_multi(n_batch, n, quota, cap, priority, out, scratch,
                      static_cast<cudaStream_t>(stream_p));
}

extern "C" int kc_fill_priority(int n_batch, int n, const void* quota, const void* cap,
                                const void* priority, void* out, void* stream_p) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
  if (n <= 0 || n_batch <= 0) return 0;
  const int items = (n + kThreads - 1) / kThreads;
  if (items <= 1) return launch<1>(n_batch, n, quota, cap, priority, out, stream);
  if (items <= 2) return launch<2>(n_batch, n, quota, cap, priority, out, stream);
  if (items <= 4) return launch<4>(n_batch, n, quota, cap, priority, out, stream);
  if (items <= 8) return launch<8>(n_batch, n, quota, cap, priority, out, stream);
  if (items <= 16) return launch<16>(n_batch, n, quota, cap, priority, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
