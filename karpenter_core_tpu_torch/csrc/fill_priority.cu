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
// Bound on the H100: latency.  At the main path's N = 8,192 slots a tenant
// moves 96 KB (cap and priority read once, the fill written once): 0.03 us
// at 3.35 TB/s.  The time is the launch and a chain of block-wide steps, so
// the design takes as few steps as the input allows.
//
// One block of 512 threads a tenant (grid = B), up to 16,384 slots (L =
// ceil(N / 512) consecutive slots a thread, read with 16-byte loads where
// the plane is aligned: a warp's loads cover whole sectors); 32 threads for
// a plane of at most 32.
//   1. Drop the zeros.  A slot with cap == 0 adds nothing to the cumsum and
//      gets clip(x, 0, 0) = 0 wherever the sort would put it, so only the
//      kept slots (cap != 0) are ranked.  A negative cap keeps its place by
//      key, and clip gives it its cap back, as the twin's
//      minimum(clamp(x, 0), cap) does.
//   2. One block-wide scan of (kept count, max, min, cap sum) a thread.  If
//      the kept priorities already run in index order (the thread's own in
//      order, its first >= the max of the threads before it) the stable
//      order is index order, and the scan's cap sums are the prefix: clip
//      and store, no sort.  The existing-node fills that take hole
//      preferences, the hole fill of `_fill_with_pref` and any slot fill
//      whose pod counts do not fall with the index take this path.
//   3. Otherwise the kept slots are compacted, in index order, into shared
//      memory as (key, slot): the key is the priority with its sign bit
//      flipped, so unsigned order is signed order; only the key bits below
//      the highest bit where the min and max differ are sorted (every key
//      shares the bits above).  Up to 32 kept slots: warp 0 ranks each key
//      against the others by shuffles (ties by position).  More: stable LSD
//      radix passes of 8 bits in shared memory (`radix_pass`), first over
//      the top 8 key bits alone, then (from the compacted order again) the
//      top 16, then every bit; an attempt that leaves the keys in order is
//      done, since equal keys share every digit and so kept index order.
//      The slot fills' keys, pod count * N + slot, are in order after the top
//      16 bits whenever N is a power of two (a digit window then never mixes
//      two pod counts' slots out of order); the top 8 suffice when the pod
//      counts are close.  Random keys take up to 7 passes.
//   4. The sorted caps' exclusive sum (a warp's rounds gathered at once, its
//      rounds scanned with shuffles, the warps' sums added), clipped, is
//      written by slot into shared memory over a plane of zeros and copied
//      out whole with 16-byte stores.
// The sums run on uint32, so the int32 wraparound of the reference's cumsum
// is defined behaviour here; the quota is read on the device, so the caller
// never synchronises to pass it.  Shared memory: two (key, slot) buffers of
// 512 L entries (6 bytes an entry) and the 8 KB of per-warp digit counts,
// 104 KB at L = 16, so two blocks fit an SM up to 8,192 slots
// (`__launch_bounds__(512, 2)`): at B = 147 every tenant's block is resident
// at once.  The launcher sets the dynamic shared-memory attribute once a
// template.
// ptxas (sm_90a, -O3 -Xptxas -v): 64 registers at L = 1..16 (the cap of
// two 512-thread blocks an SM), with 144-248 bytes of stack a thread
// (spills, through L1); 128 registers and 8 bytes at L = 32; the 32-thread
// kernel 24 registers, no spill.  Static shared memory 8,928 bytes (the
// summary scan, the warps' sums), beside the dynamic buffers above.
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

#include <cub/block/block_scan.cuh>
#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxItems = 32;
constexpr int kOneBlock = kThreads * kMaxItems;
constexpr int kI32Max = 2147483647;
constexpr int kI32Min = -2147483647 - 1;

__device__ __forceinline__ int clip_fill(unsigned int quota, unsigned int before, int cap) {
  int a = static_cast<int>(quota - before);  // int32 wraparound, as the reference
  a = a < 0 ? 0 : a;
  return a > cap ? cap : a;
}

// one thread's slots: how many are kept, the max and min of their
// priorities, and the (wrapping) sum of every cap
struct Summary {
  unsigned int count;
  int hi;
  int lo;
  unsigned int caps;
};

struct SummaryOp {
  __device__ __forceinline__ Summary operator()(const Summary& a, const Summary& b) const {
    return {a.count + b.count, a.hi > b.hi ? a.hi : b.hi, a.lo < b.lo ? a.lo : b.lo,
            a.caps + b.caps};
  }
};

constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;

// the kernel's dynamic shared memory: two buffers of compacted (key, index)
// pairs (keys 4 bytes, slot indices 2: N <= 16,384) and the per-warp digit
// counts of one radix pass
template <int T, int L>
constexpr size_t smem_bytes() {
  constexpr size_t m = static_cast<size_t>(T) * L;
  return 2 * (4 * m + 2 * m) + 2 * static_cast<size_t>(kDigits) * (T / 32);
}

template <int L>
__device__ __forceinline__ void load_items(const int32_t* __restrict__ src, int base, int n,
                                           bool vec, int (&v)[L]) {
  if constexpr (L % 4 == 0) {
    if (vec && base + L <= n) {
#pragma unroll
      for (int j = 0; j < L; j += 4) {
        const int4 q = *reinterpret_cast<const int4*>(src + base + j);
        v[j] = q.x;
        v[j + 1] = q.y;
        v[j + 2] = q.z;
        v[j + 3] = q.w;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < L; ++j) v[j] = base + j < n ? src[base + j] : 0;
}

template <int L>
__device__ __forceinline__ void store_items(int32_t* __restrict__ dst, int base, int n, bool vec,
                                            const int (&v)[L]) {
  if constexpr (L % 4 == 0) {
    if (vec && base + L <= n) {
#pragma unroll
      for (int j = 0; j < L; j += 4) {
        *reinterpret_cast<int4*>(dst + base + j) = make_int4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (base + j < n) dst[base + j] = v[j];
  }
}

// up to 32 kept entries: warp 0 ranks each key against the others (ties by
// position, which is index order), then scans the caps in rank order
__device__ void warp_fill(const unsigned int* __restrict__ keys_s,
                          const uint16_t* __restrict__ idx_s,
                          int n_kept, const int32_t* __restrict__ cap, int32_t* __restrict__ out,
                          unsigned int quota, int* __restrict__ ranked) {
  const int lane = threadIdx.x & 31;
  const unsigned int key = lane < n_kept ? keys_s[lane] : 0xffffffffu;
  const int idx = lane < n_kept ? idx_s[lane] : -1;
  int rank = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const unsigned int kj = __shfl_sync(0xffffffffu, key, j);
    rank += (kj < key) || (kj == key && j < lane);
  }
  ranked[rank] = idx;
  __syncwarp();
  const int i = ranked[lane];
  const unsigned int c = i >= 0 ? static_cast<unsigned int>(cap[i]) : 0u;
  unsigned int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (i >= 0) out[i] = clip_fill(quota, incl - c, static_cast<int>(c));
}

// the lanes of this warp whose digit equals this lane's: one ballot a digit
// bit (invalid lanes carry bit 8, which no digit has)
__device__ __forceinline__ unsigned int peers_of(unsigned int d) {
  unsigned int peers = 0xffffffffu;
#pragma unroll
  for (int b = 0; b <= kDigitBits; ++b) {
    const unsigned int set = __ballot_sync(0xffffffffu, (d >> b) & 1u);
    peers &= (d >> b) & 1u ? set : ~set;
  }
  return peers;
}

// a lane's group: __match_any_sync where a round holds few distinct digits
// (the top bits of keys in near order), else the ballots
__device__ __forceinline__ unsigned int group(unsigned int d, bool few) {
  return few ? __match_any_sync(0xffffffffu, d) : peers_of(d);
}

// one stable LSD radix pass over the digit (key >> shift) & mask, up to 8
// bits, of n entries in shared memory, from (keys_in, idx_in) to (keys_out,
// idx_out).  Warp w takes the entries [w R 32, (w + 1) R 32), R = `rounds`,
// 32 at a time, grouped by digit (`group`), so a lane's rank among its
// equals is the count of lower lanes in its group.
// (1) each group's leader adds its group's size to the warp's count of
// that digit (a warp's 256 counts side by side, so a round's distinct
// digits hit distinct banks); (2) one exclusive scan of the counts in
// (digit, warp) order
// gives each warp's first slot for each digit; (3) the warps replay their
// rounds and write each entry to its slot plus its rank, the leader moving
// the warp's slot on.  Entries move in (digit, warp, round, lane) order,
// which is their order within each digit: the pass is stable.
template <int T>
__device__ void radix_pass(const unsigned int* __restrict__ keys_in,
                           const uint16_t* __restrict__ idx_in, unsigned int* __restrict__ keys_out,
                           uint16_t* __restrict__ idx_out, uint16_t* __restrict__ counts,
                           typename cub::BlockScan<unsigned int, T>::TempStorage& scan_storage,
                           int n, int rounds, int shift, unsigned int mask, bool few) {
  constexpr int kWarps = T / 32;
  constexpr int kPerThread = kDigits * kWarps / T;  // 8
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned int below = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < kDigits * kWarps; i += T) counts[i] = 0;
  __syncthreads();
  // two rounds at a time: their loads and matches overlap
  const int begin = warp * rounds * 32;
  for (int r = 0; r < rounds; r += 2) {
    const int i0 = begin + r * 32 + lane;
    const int i1 = r + 1 < rounds ? i0 + 32 : n;
    const unsigned int d0 = i0 < n ? (keys_in[i0] >> shift) & mask : kDigits;
    const unsigned int d1 = i1 < n ? (keys_in[i1] >> shift) & mask : kDigits;
    const unsigned int p0 = group(d0, few);
    const unsigned int p1 = group(d1, few);
    if (i0 < n && lane == __ffs(p0) - 1) counts[warp * kDigits + d0] += __popc(p0);
    __syncwarp();
    if (i1 < n && lane == __ffs(p1) - 1) counts[warp * kDigits + d1] += __popc(p1);
    __syncwarp();
  }
  __syncthreads();
  // the counts in (digit, warp) order: thread t scans entries 8 t .. 8 t + 7
  unsigned int mine[kPerThread];
  unsigned int sum = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = threadIdx.x * kPerThread + j;
    mine[j] = counts[(e % kWarps) * kDigits + e / kWarps];
    sum += mine[j];
  }
  unsigned int first;
  cub::BlockScan<unsigned int, T>(scan_storage).ExclusiveSum(sum, first);
  __syncthreads();  // every count is read before the first is overwritten
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = threadIdx.x * kPerThread + j;
    counts[(e % kWarps) * kDigits + e / kWarps] = static_cast<uint16_t>(first);
    first += mine[j];
  }
  __syncthreads();
  for (int r = 0; r < rounds; r += 2) {
    const int i0 = begin + r * 32 + lane;
    const int i1 = r + 1 < rounds ? i0 + 32 : n;
    const unsigned int k0 = i0 < n ? keys_in[i0] : 0u;
    const unsigned int k1 = i1 < n ? keys_in[i1] : 0u;
    const uint16_t s0 = i0 < n ? idx_in[i0] : 0;
    const uint16_t s1 = i1 < n ? idx_in[i1] : 0;
    const unsigned int d0 = i0 < n ? (k0 >> shift) & mask : kDigits;
    const unsigned int d1 = i1 < n ? (k1 >> shift) & mask : kDigits;
    const unsigned int p0 = group(d0, few);
    const unsigned int p1 = group(d1, few);
    if (i0 < n) {
      const int slot = counts[warp * kDigits + d0] + __popc(p0 & below);
      keys_out[slot] = k0;
      idx_out[slot] = s0;
    }
    __syncwarp();
    if (i0 < n && lane == __ffs(p0) - 1) counts[warp * kDigits + d0] += __popc(p0);
    __syncwarp();
    if (i1 < n) {
      const int slot = counts[warp * kDigits + d1] + __popc(p1 & below);
      keys_out[slot] = k1;
      idx_out[slot] = s1;
    }
    __syncwarp();
    if (i1 < n && lane == __ffs(p1) - 1) counts[warp * kDigits + d1] += __popc(p1);
    __syncwarp();
  }
  __syncthreads();
}

// the summary scan's storage, reused by the radix passes' count scans
template <int T>
union ScanStorage {
  typename cub::BlockScan<Summary, T>::TempStorage summary;
  typename cub::BlockScan<unsigned int, T>::TempStorage caps;
};

template <int T, int L>
__global__ void __launch_bounds__(T, (L <= 16 ? 2 : 1)) fill_priority_kernel(
    int n, int vec, const int32_t* __restrict__ quota_p, const int32_t* __restrict__ cap,
    const int32_t* __restrict__ priority, int32_t* __restrict__ out) {
  using SummaryScan = cub::BlockScan<Summary, T>;
  __shared__ ScanStorage<T> scan_storage;
  __shared__ int ranked[32];
  __shared__ unsigned int warp_sums[T / 32];
  extern __shared__ __align__(16) unsigned char smem[];
  // this block's tenant
  const size_t tb = blockIdx.x;
  const unsigned int quota = static_cast<unsigned int>(quota_p[tb]);
  cap += tb * n;
  priority += tb * n;
  out += tb * n;

  const int base = threadIdx.x * L;
  int c[L];
  int p[L];
  load_items<L>(cap, base, n, vec, c);
  load_items<L>(priority, base, n, vec, p);


  // 1-2. the kept slots' count, max and min, and whether they run in order
  Summary mine = {0u, kI32Min, kI32Max, 0u};
  int first = kI32Max;
  bool ordered = true;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    mine.caps += static_cast<unsigned int>(c[j]);
    if (c[j] != 0) {  // past n, c is 0
      if (mine.count == 0) {
        first = p[j];
      } else if (p[j] < mine.hi) {
        ordered = false;
      }
      ++mine.count;
      mine.hi = p[j] > mine.hi ? p[j] : mine.hi;
      mine.lo = p[j] < mine.lo ? p[j] : mine.lo;
    }
  }
  Summary before_me, all;
  SummaryScan(scan_storage.summary)
      .ExclusiveScan(mine, before_me, Summary{0u, kI32Min, kI32Max, 0u}, SummaryOp(), all);
  ordered = ordered && (mine.count == 0 || first >= before_me.hi);
  if (__syncthreads_and(ordered)) {
    // the stable order is index order: the scan's cap sums are the prefix
    unsigned int before = before_me.caps;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int cj = c[j];
      c[j] = clip_fill(quota, before, cj);
      before += static_cast<unsigned int>(cj);
    }
    store_items<L>(out, base, n, vec, c);
    return;
  }

  // 3. compact the kept slots in index order, as (key, slot): the key is
  // the priority with its sign bit flipped (unsigned order is signed order)
  constexpr int kCap = T * L;
  const int n_kept = static_cast<int>(all.count);
  // the key bits that differ somewhere: every key shares the bits above
  const int hb = 32 - __clz(static_cast<unsigned int>(all.lo ^ all.hi));
  // two buffers of (key, slot), b = 0 and 1: keys + b * kCap, idxs + b * kCap
  unsigned int* keys = reinterpret_cast<unsigned int*>(smem);
  uint16_t* idxs = reinterpret_cast<uint16_t*>(keys + 2 * kCap);
  uint16_t* counts = idxs + 2 * kCap;
  load_items<L>(cap, base, n, vec, c);
  load_items<L>(priority, base, n, vec, p);
  int pos = static_cast<int>(before_me.count);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (c[j] != 0) {
      keys[pos] = static_cast<unsigned int>(p[j]) ^ 0x80000000u;
      idxs[pos] = static_cast<uint16_t>(base + j);
      ++pos;
    }
  }
  __syncthreads();
  if (n_kept <= 32) {
    // every other slot gets 0 (clip(x, 0, 0)); then warp 0 fills the kept
    int zero[L];
#pragma unroll
    for (int j = 0; j < L; ++j) zero[j] = 0;
    store_items<L>(out, base, n, vec, zero);
    __syncthreads();  // the block's zeros land before warp 0's fill
    if (threadIdx.x < 32) warp_fill(keys, idxs, n_kept, cap, out, quota, ranked);
    return;
  }
  if constexpr (T > 32) {
    // 4. the sort, LSD, in the fewest passes the keys allow: the top 8 key
    // bits alone, then the top 16, then every bit.  An attempt that leaves
    // the keys in order is the stable order (equal keys share the digits, so
    // they kept index order).  The slot fills' keys (pod count * N + slot)
    // are in order after the top 16 bits whenever N is a power of two
    const int rounds = (n_kept + T - 1) / T;  // a warp's rounds of 32
    int at = 0;  // the buffer holding the current order
    auto sort_bits = [&](int lo_bit, int hi_bit, bool few) {
      for (int shift = lo_bit; shift < hi_bit; shift += kDigitBits) {
        const int width = hi_bit - shift < kDigitBits ? hi_bit - shift : kDigitBits;
        radix_pass<T>(keys + at * kCap, idxs + at * kCap, keys + (at ^ 1) * kCap,
                      idxs + (at ^ 1) * kCap, counts, scan_storage.caps, n_kept, rounds, shift,
                      (1u << width) - 1u, few);
        at ^= 1;
      }
    };
    auto in_order = [&]() {  // no key above its successor
      const unsigned int* sorted = keys + at * kCap;
      bool ok = true;
      for (int i = threadIdx.x + 1; i < n_kept; i += T) ok &= sorted[i - 1] <= sorted[i];
      return __syncthreads_and(ok) != 0;
    };
    if (hb <= kDigitBits) {
      sort_bits(0, hb, true);
    } else {
      sort_bits(hb - kDigitBits, hb, true);
      if (!in_order()) {
        at = 0;  // from the compacted order again
        if (hb <= 2 * kDigitBits) {
          sort_bits(0, hb, false);
        } else {
          sort_bits(hb - 2 * kDigitBits, hb, true);
          if (!in_order()) {
            // the bits below, then the top 16 again: ties keep index order
            sort_bits(0, hb - 2 * kDigitBits, false);
            sort_bits(hb - 2 * kDigitBits, hb, true);
          }
        }
      }
    }
    const uint16_t* idx = idxs + at * kCap;
    // 5. the caps' exclusive sum in sorted order, clipped, staged in shared
    // memory by slot (0 for the slots not kept) and written out whole.  Warp
    // w takes the sorted entries of its radix rounds, 32 at a time
    // (lane-consecutive: no bank conflicts)
    int* fill = reinterpret_cast<int*>(keys + at * kCap);  // the keys are done with
    for (int i = threadIdx.x; i < kCap / 4; i += T) {
      reinterpret_cast<int4*>(fill)[i] = make_int4(0, 0, 0, 0);
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int begin = warp * rounds * 32;
    // every round's cap gathered at once (rounds <= L), then each round's
    // inclusive scan, independent of the others; the carries come last
    unsigned int cq[L];
    unsigned int incl[L];
    unsigned int warp_sum = 0;
#pragma unroll
    for (int r = 0; r < L; ++r) {
      const int q = begin + r * 32 + lane;
      cq[r] = r < rounds && q < n_kept ? static_cast<unsigned int>(cap[idx[q]]) : 0u;
    }
#pragma unroll
    for (int r = 0; r < L; ++r) {
      incl[r] = cq[r];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned int up = __shfl_up_sync(0xffffffffu, incl[r], off);
        if (lane >= off) incl[r] += up;
      }
      warp_sum += __shfl_sync(0xffffffffu, incl[r], 31);
    }
    if (lane == 0) warp_sums[warp] = warp_sum;
    __syncthreads();  // the zeros and the warps' sums land
    unsigned int before = 0;
    for (int w = 0; w < warp; ++w) before += warp_sums[w];
#pragma unroll
    for (int r = 0; r < L; ++r) {
      const int q = begin + r * 32 + lane;
      if (r < rounds && q < n_kept) {
        fill[idx[q]] = clip_fill(quota, before + incl[r] - cq[r], static_cast<int>(cq[r]));
      }
      before += __shfl_sync(0xffffffffu, incl[r], 31);
    }
    __syncthreads();
    // the whole plane out, lane-consecutive
    if (vec) {
      for (int i = threadIdx.x; i < n / 4; i += T) {
        reinterpret_cast<int4*>(out)[i] = reinterpret_cast<const int4*>(fill)[i];
      }
    } else {
      for (int i = threadIdx.x; i < n; i += T) out[i] = fill[i];
    }
  }
}

template <int T, int L>
int launch(int n_batch, int n, const void* quota, const void* cap, const void* priority,
           void* out, cudaStream_t stream) {
  constexpr int smem = static_cast<int>(smem_bytes<T, L>());
  static bool attribute_set = false;  // once a template
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fill_priority_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set = true;
  }
  // 16-byte loads and stores: a tenant's plane starts on a 16-byte boundary
  const int vec = (n % 4 == 0) && ((reinterpret_cast<uintptr_t>(cap) |
                                    reinterpret_cast<uintptr_t>(priority) |
                                    reinterpret_cast<uintptr_t>(out)) % 16 == 0);
  fill_priority_kernel<T, L><<<n_batch, T, smem, stream>>>(
      n, vec, static_cast<const int32_t*>(quota), static_cast<const int32_t*>(cap),
      static_cast<const int32_t*>(priority), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// -- the multi-block path ------------------------------------------------------

constexpr int kTileThreads = 256;
constexpr int kTileItems = 4;
constexpr int kTile = kTileThreads * kTileItems;

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
  if (n <= 32) return launch<32, 1>(n_batch, n, quota, cap, priority, out, stream);
  const int items = (n + kThreads - 1) / kThreads;
  if (items <= 1) return launch<kThreads, 1>(n_batch, n, quota, cap, priority, out, stream);
  if (items <= 2) return launch<kThreads, 2>(n_batch, n, quota, cap, priority, out, stream);
  if (items <= 4) return launch<kThreads, 4>(n_batch, n, quota, cap, priority, out, stream);
  if (items <= 8) return launch<kThreads, 8>(n_batch, n, quota, cap, priority, out, stream);
  if (items <= 16) return launch<kThreads, 16>(n_batch, n, quota, cap, priority, out, stream);
  if (items <= 32) return launch<kThreads, 32>(n_batch, n, quota, cap, priority, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
