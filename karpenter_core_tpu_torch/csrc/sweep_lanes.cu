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
// Ranks may tie (nothing here assumes a permutation): each column is tested
// on its own.
//
// Bound on the H100: bytes.  At S = 64 lanes, C = 16 classes and E = 6,144
// existing nodes it must read the C x E count plane (393 KB) and write the
// S x E masks (393 KB): 0.24 us at 3.35 TB/s, far below a launch's latency,
// which is what bounds it in practice.
//
// Design: ONE launch of two kinds of blocks, 256 threads each, that run
// side by side: per group of L lanes, one block per class c for the counts
// and C blocks for the open rows (one slice of E each).  L is chosen on the
// host so each kind covers the 132 SMs (at the full shapes L = 8: 8 lane
// groups x 16 classes = 128 count blocks and 128 open-row blocks, two an
// SM; the crossed grid's 512 lanes take L = 32).  How each byte is read:
//  - the class sums: the block reads `rank` and its class's row of the
//    count plane once each, 16 bytes a thread a load (int4, coalesced),
//    and tests every column against its L lanes' sizes held in registers,
//    so one read serves L lanes.  (The first design read both once per
//    (lane, class) pair: 1,024 blocks and about 50 MB of L2 traffic; this
//    one reads about 6 MB, the count plane's 0.4 MB once from HBM.)
//  - the open rows: an open-row block writes its L lanes' rows over one of
//    C equal slices of E (16 columns a thread, one 16-byte store), reading
//    that slice of `rank` and `open_` once a lane.
// Each count[s,c] is finished by the one block that owns (s, c): its 256
// threads' sums are reduced by warp shuffles and one shared-memory step, in
// fixed order, and `base[c]` is added once, by that block, to the finished
// column sum.  No atomics, no scratch, no second launch: one launch a call.
// Unaligned or ragged E takes the same path with scalar loads and stores.
//
// Integer sums match the reference's int32 sums bit for bit: they run in
// unsigned arithmetic, which wraps as int32 addition does in XLA (and, being
// associative, in any order).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 32;  // lanes a block, each with its own running sum
constexpr int kTargetBlocks = 132;  // the H100's SMs

__device__ __forceinline__ uint32_t take(int32_t r, int32_t k, int32_t v) {
  return r < k ? static_cast<uint32_t>(v) : 0u;
}

__device__ __forceinline__ uint32_t keep(int32_t r, int32_t k, uint8_t o) {
  return (o && !(r < k)) ? 1u : 0u;
}

// kL: the most lanes a block may hold (its register arrays); n_sl <= kL
template <int kL>
__global__ void __launch_bounds__(kThreads) sweep_lanes_kernel(
    int n_lanes, int n_ex, int n_cls, int lanes_per_block, bool vec4, bool vec16,
    const int32_t* __restrict__ rank,          // [E]
    const uint8_t* __restrict__ open_,         // [E]
    const int32_t* __restrict__ base,          // [C]
    const int32_t* __restrict__ ex_cls_count,  // [C, E]
    const int32_t* __restrict__ sizes,         // [S]
    uint8_t* __restrict__ lane_open,           // [S, E]
    int32_t* __restrict__ count_out) {         // [S, C]
  const int s0 = blockIdx.x * lanes_per_block;
  const int n_sl = min(lanes_per_block, n_lanes - s0);
  const int c = blockIdx.y;  // a class below n_cls; at or past it, a slice of E
  const int n_slices = gridDim.y - n_cls;

  __shared__ int32_t k_s[kMaxLanes];
  __shared__ uint32_t warp_sums[kWarps][kL];
  if (threadIdx.x < n_sl) k_s[threadIdx.x] = sizes[s0 + threadIdx.x];
  __syncthreads();

  // -- the class sums: rank and row c read once, tested against kL lanes -----
  if (c < n_cls) {
    int32_t k[kL];
    uint32_t acc[kL];
#pragma unroll
    for (int s = 0; s < kL; ++s) {
      k[s] = s < n_sl ? k_s[s] : INT32_MIN;  // a lane past n_sl takes nothing
      acc[s] = 0u;
    }
    const int32_t* row = ex_cls_count + static_cast<size_t>(c) * n_ex;
    int e_done = 0;
    if (vec4) {
      const int n4 = n_ex / 4;
      const int4* rank4 = reinterpret_cast<const int4*>(rank);
      const int4* row4 = reinterpret_cast<const int4*>(row);
#pragma unroll 6
      for (int i = threadIdx.x; i < n4; i += kThreads) {
        const int4 r = __ldg(rank4 + i);
        const int4 v = __ldg(row4 + i);
#pragma unroll
        for (int s = 0; s < kL; ++s) {
          acc[s] += take(r.x, k[s], v.x) + take(r.y, k[s], v.y) + take(r.z, k[s], v.z) +
                    take(r.w, k[s], v.w);
        }
      }
      e_done = n4 * 4;
    }
    for (int e = e_done + threadIdx.x; e < n_ex; e += kThreads) {
      const int32_t r = __ldg(rank + e);
      const int32_t v = __ldg(row + e);
#pragma unroll
      for (int s = 0; s < kL; ++s) acc[s] += take(r, k[s], v);
    }

    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int s = 0; s < kL; ++s) {
      uint32_t v = acc[s];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if ((threadIdx.x & 31) == 0) warp_sums[warp][s] = v;
    }
    __syncthreads();
    if (threadIdx.x < n_sl) {
      uint32_t total = 0u;
      for (int w = 0; w < kWarps; ++w) total += warp_sums[w][threadIdx.x];
      count_out[static_cast<size_t>(s0 + threadIdx.x) * n_cls + c] =
          static_cast<int32_t>(static_cast<uint32_t>(base[c]) + total);
    }
    return;
  }

  // -- the open rows of this block's lanes over slice c - n_cls of E ---------
  const int slice = c - n_cls;
  if (vec16) {
    const int n16 = n_ex / 16;
    const int lo = static_cast<int>(static_cast<int64_t>(slice) * n16 / n_slices);
    const int hi = static_cast<int>(static_cast<int64_t>(slice + 1) * n16 / n_slices);
    const int width = hi - lo;
    for (int item = threadIdx.x; item < n_sl * width; item += kThreads) {
      const int sl = item / width;
      const int chunk = lo + item % width;
      const int32_t k = k_s[sl];
      const int4* r4 = reinterpret_cast<const int4*>(rank) + chunk * 4;
      const uint4 o = __ldg(reinterpret_cast<const uint4*>(open_) + chunk);
      uint32_t words[4];
      const uint32_t ow[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 r = __ldg(r4 + q);
        const uint32_t w = ow[q];
        words[q] = keep(r.x, k, w & 0xffu) | (keep(r.y, k, (w >> 8) & 0xffu) << 8) |
                   (keep(r.z, k, (w >> 16) & 0xffu) << 16) | (keep(r.w, k, w >> 24) << 24);
      }
      uint8_t* dst = lane_open + static_cast<size_t>(s0 + sl) * n_ex + chunk * 16;
      *reinterpret_cast<uint4*>(dst) = make_uint4(words[0], words[1], words[2], words[3]);
    }
  } else {
    const int lo = static_cast<int>(static_cast<int64_t>(slice) * n_ex / n_slices);
    const int hi = static_cast<int>(static_cast<int64_t>(slice + 1) * n_ex / n_slices);
    const int width = hi - lo;
    for (int item = threadIdx.x; item < n_sl * width; item += kThreads) {
      const int sl = item / width;
      const int e = lo + item % width;
      lane_open[static_cast<size_t>(s0 + sl) * n_ex + e] =
          static_cast<uint8_t>(keep(rank[e], k_s[sl], open_[e]));
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" int kc_sweep_lanes(
    int n_lanes, int n_ex, int n_cls,
    const void* rank, const void* open_, const void* base, const void* ex_cls_count,
    const void* sizes, void* lane_open, void* count_out, void* stream) {
  if (n_lanes <= 0) return 0;
  if (n_cls > 32767) return static_cast<int>(cudaErrorInvalidValue);
  const int slices = n_cls > 0 ? n_cls : 1;  // slices of E for the open rows
  // lanes a block: enough blocks to cover the SMs, at most kMaxLanes
  int64_t per = (static_cast<int64_t>(n_lanes) * slices + kTargetBlocks - 1) / kTargetBlocks;
  if (per < 1) per = 1;
  if (per > kMaxLanes) per = kMaxLanes;
  const int lanes_per_block = static_cast<int>(per);
  const bool vec4 = n_ex % 4 == 0 && aligned16(rank) && aligned16(ex_cls_count);
  const bool vec16 = n_ex % 16 == 0 && aligned16(rank) && aligned16(open_) &&
                     aligned16(lane_open);
  const dim3 grid((n_lanes + lanes_per_block - 1) / lanes_per_block, n_cls + slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int32_t*>(rank);
  const auto* o = static_cast<const uint8_t*>(open_);
  const auto* b = static_cast<const int32_t*>(base);
  const auto* cnt = static_cast<const int32_t*>(ex_cls_count);
  const auto* k = static_cast<const int32_t*>(sizes);
  auto* lo = static_cast<uint8_t*>(lane_open);
  auto* co = static_cast<int32_t*>(count_out);
  if (lanes_per_block <= 8) {
    sweep_lanes_kernel<8><<<grid, kThreads, 0, s>>>(n_lanes, n_ex, n_cls, lanes_per_block,
                                                     vec4, vec16, r, o, b, cnt, k, lo, co);
  } else {
    sweep_lanes_kernel<kMaxLanes><<<grid, kThreads, 0, s>>>(
        n_lanes, n_ex, n_cls, lanes_per_block, vec4, vec16, r, o, b, cnt, k, lo, co);
  }
  return static_cast<int>(cudaGetLastError());
}
