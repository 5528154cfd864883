// K20: the summary of every replica of a what-if study.
//
// Replaces the finish of `_monte_carlo_fn.one_replica`
// (karpenter_core_tpu/parallel/mesh.py:480-487) under `jax.vmap`, over the
// stacked outputs of a chunk of B replica solves (and the crossed grid's
// `jnp.sum(out.failed)`, :597):
//
//   scheduled[b] = sum over (c, n) of assign[b,c,n]                 (int32)
//   failed[b]    = sum over c of failed[b,c]                         (int32)
//   nodes[b]     = count of n with pod_count[b,n] > 0                (int32)
//   cost[b]      = sum over n of price[b,n] where it is finite        (f32)
//
// with price[b,n] the slot's cheapest offering, `node_prices`
// (karpenter_core_tpu/ops/solve.py:2140): the minimum of it_price[i, z, ct]
// over the viable types i and the allowed (zone, capacity type) cells, NaN
// winning as in `jnp.min`, +inf where there is none, and 0 where the slot
// is closed or holds no pod.  Integer sums run in unsigned arithmetic,
// which wraps as XLA's int32 sums do, in any order.
//
// The f32 cost sum follows XLA's CPU order, read from the object code of
// `jit(vmap(one_replica))` (its HLO rewrites the reduce over N slots into a
// reduce-window of 32 and a reduce of the window sums; the window loop is 32
// scalar `vaddss` from +0): while the row is longer than 32, it is padded
// with zeros evenly at both ends to a multiple of 32 and each window of 32
// is summed in order from +0.0; the last row of at most 32 is summed in
// order from +0.0.  Every add is `__fadd_rn` (no contraction).  A window's
// sum is one thread's loop over its 32 prices; the tree above the windows
// is the replica's last block's.
//
// Bound on the H100: bytes.  At B = 142 replicas of N = 8,192 slots,
// I = 1,000 types and C = 16 classes it must read each priced slot's
// viable row (7.2 MB a replica at 7,162 priced slots) and the C x N
// assignment plane (0.5 MB): 0.32 ms at 3.35 TB/s.
//
// Why not price each (type, cell) pair: on the study's rows nearly every
// type is viable and nearly every cell allowed, so a slot would take about
// I x Z * CT price lookups, and a chunk's shared-memory reads alone would
// outlast its byte bound.  So the catalog is ranked once a call
// (`replica_rank_kernel`, the first of the call's two launches): for each
// cell, the types in order of price, NaN first, ties by index.  A slot's
// minimum over a cell is then the price of the first viable type in that
// cell's order, and its price the NaN-winning minimum of those over its
// allowed cells: the same number as the minimum over every pair (a +0 and
// a -0 may trade places, which no sum from +0.0 can tell apart).  One
// ballot of a warp reads the first ranks of every allowed cell at once;
// where most types are viable, that round finds every cell's first one.
//
// How each byte is read.  The grid is (blocks a replica, replicas); a block
// takes `wpb` consecutive windows of one replica.  Its threads first read,
// coalesced, every position's open, pod-count, zone and capacity-type rows
// (into a flag and cell words in shared memory) and assignment columns.
// Then each warp takes four slots of each window and copies the viable rows
// of the priced ones (open, holding pods, some cell allowed) into its
// shared buffers with cp.async, 16 bytes a lane on each row's aligned body,
// all four rows in flight at once, the ragged ends a byte a lane; one
// rank-walk round (`walk_price`) then prices a slot.  The ranked cells'
// first entries stay in L1.  Rows wider than the shared buffers are read
// from device memory where the walk lands.
//
// Each block writes its windows' sums and its integer partials, fences and
// takes a ticket; the replica's last block finishes the tree and the sums
// and resets the ticket for the next call.  Two launches a call.
//
// Build (nvcc -Xptxas -v, sm_90a, CUDA 12.8): the study kernel, under
// `__launch_bounds__(256, 4)`, 62 registers and no spill (a 48-byte stack
// frame holds the `walk_price` call), 48 bytes of static shared memory and
// 4 wpb 32 (2 + cw) + 8 x 4 row_bytes dynamic: 35,840 bytes at the
// headline (I = 1,000, wpb = 8), so four blocks fit an SM; the rank kernel
// 32 registers, no spill, 17,408 bytes static.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "slot_price.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWindow = 32;
constexpr int kSlotsWarp = kWindow / kWarps;  // a window's slots a warp prices
constexpr int kRowStage = 3 * 1024;           // widest row held in shared memory
constexpr int kMaxWpb = 8;                    // windows a block
constexpr int kSms = 132;  // the H100's streaming multiprocessors (the grid's sizing only)
constexpr int kRankTile = 4096;               // prices a rank block stages at once

struct Dims {
  int n_slots, n_it, n_zones, n_ct, n_cls;
  int win, n_win, lead;  // window length, windows, zero padding before slot 0
  int cw;                // cell words a slot (Z * CT bits)
  int wpb;               // windows a block
  int head_words;        // prices, flags and cell words, rounded to 16 bytes
  int row_bytes;         // a staged row's buffer; 0: rows stay in device memory
};

// Rank every type within every cell by price: NaN first (by index), then
// ascending, ties by index.  A block: 32 types x 8 slices of the others,
// which it reads from the cell's price column staged in shared memory.
__global__ void __launch_bounds__(kThreads) replica_rank_kernel(
    int n_it, int n_cells, const float* __restrict__ it_price, int32_t* __restrict__ ord_idx,
    float* __restrict__ ord_price) {
  __shared__ float col[kRankTile];
  __shared__ int part[kWarps][32];
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  const float p = i < n_it ? __ldg(it_price + (size_t)i * n_cells + c) : 0.0f;
  const bool p_nan = isnan(p);
  int rank = 0;
  for (int j0 = 0; j0 < n_it; j0 += kRankTile) {
    const int m = min(kRankTile, n_it - j0);
    __syncthreads();
    for (int t = threadIdx.x; t < m; t += kThreads) {
      col[t] = __ldg(it_price + (size_t)(j0 + t) * n_cells + c);
    }
    __syncthreads();
    for (int t = slice; t < m; t += kWarps) {
      const float x = col[t];
      const int j = j0 + t;
      const bool x_nan = isnan(x);
      const bool before = (x_nan || p_nan) ? (x_nan && (!p_nan || j < i))
                                           : (x < p || (x == p && j < i));
      rank += before ? 1 : 0;
    }
  }
  part[slice][lane] = rank;
  __syncthreads();
  if (slice == 0 && i < n_it) {
    int total = 0;
    for (int s = 0; s < kWarps; ++s) total += part[s][lane];
    ord_idx[(size_t)c * n_it + total] = i;
    ord_price[(size_t)c * n_it + total] = p;
  }
}

__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* scratch) {
  // every thread's v summed (unsigned); the result is valid in thread 0
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t total = 0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) total += scratch[w];
  }
  return total;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The cheapest allowed offering of one slot, read from its viable row `rv`
// (shared or device memory) where the rank walk lands.  One round covers
// every allowed cell of a word: the lanes split into one segment a cell
// (`per` lanes, a power of two), lane k of a segment reads the cell's
// rank-k type, and the segment's first viable rank holds the cell's price.
// A cell none of whose first `per` types is viable walks on, 32 ranks at a
// time.  The minimum over the lanes (NaN winning) reaches every lane.
__device__ __noinline__ float walk_price(const Dims& d, const uint8_t* rv,
                                         const uint32_t* cells,
                                         const int32_t* __restrict__ ord_idx,
                                         const float* __restrict__ ord_price, int lane) {
  float best = INFINITY;
  for (int w = 0; w < d.cw; ++w) {
    const uint32_t m = cells[w];
    if (m == 0) continue;
    const int n_on = __popc(m);
    const int shift = 5 - (32 - __clz(n_on - 1));  // per = 32 / next power of two
    const int per = 1 << max(shift, 0);
    const int seg = lane >> max(shift, 0), rank = lane & (per - 1);
    const bool mine = seg < n_on;
    int c = -1;
    bool viable = false;
    float p = INFINITY;
    if (mine) {
      c = 32 * w + static_cast<int>(__fns(m, 0, seg + 1));
      if (rank < d.n_it) {
        const size_t at = (size_t)c * d.n_it + rank;
        viable = rv[__ldg(ord_idx + at)] != 0;
        p = __ldg(ord_price + at);
      }
    }
    const uint32_t hit = __ballot_sync(kFull, viable);
    const uint32_t seg_bits = per == 32 ? kFull : ((1u << per) - 1u) << ((seg * per) & 31);
    const uint32_t seg_hit = mine ? hit & seg_bits : 0u;
    if (seg_hit != 0 && lane == __ffs(seg_hit) - 1) best = kc::min_nan(best, p);
    for (uint32_t miss = __ballot_sync(kFull, mine && rank == 0 && seg_hit == 0); miss != 0;
         miss &= miss - 1) {
      const int cm = __shfl_sync(kFull, c, __ffs(miss) - 1);
      for (int k0 = per; k0 < d.n_it; k0 += 32) {
        const int k = k0 + lane;
        const size_t at = (size_t)cm * d.n_it + k;
        const uint32_t h = __ballot_sync(kFull, k < d.n_it && rv[__ldg(ord_idx + at)] != 0);
        if (h != 0) {
          if (lane == __ffs(h) - 1) best = kc::min_nan(best, __ldg(ord_price + at));
          break;
        }
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    best = kc::min_nan(best, __shfl_xor_sync(kFull, best, off));
  }
  return best;
}

__global__ void __launch_bounds__(kThreads, 4) replica_finish_kernel(
    const Dims d,
    const int32_t* __restrict__ assign,     // [B, C, N]
    const int32_t* __restrict__ failed,     // [B, C]
    const uint8_t* __restrict__ viable,     // [B, N, I]
    const uint8_t* __restrict__ zone,       // [B, N, Z]
    const uint8_t* __restrict__ ct,         // [B, N, CT]
    const uint8_t* __restrict__ open_,      // [B, N]
    const int32_t* __restrict__ pod_count,  // [B, N]
    const int32_t* __restrict__ ord_idx,    // [Z * CT, I] ranked types
    const float* __restrict__ ord_price,    // [Z * CT, I] their prices
    float* part_cost,                       // [B, W] window sums
    uint32_t* part_int,                     // [B, blocks, 2] scratch
    unsigned int* ticket,                   // [B] zeroed
    int32_t* __restrict__ scheduled_out,    // [B]
    int32_t* __restrict__ failed_out,       // [B]
    int32_t* __restrict__ nodes_out,        // [B]
    float* __restrict__ cost_out) {         // [B]
  // [wpb][32] prices, flags and [cw] cell words of the block's positions,
  // then the warps' four row buffers; the last block's tree reuses it as
  // 2 x [W] floats
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t red[kWarps];
  __shared__ int is_last;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_cells = d.n_zones * d.n_ct;
  const int w_first = blockIdx.x * d.wpb;
  const int w_end = min(d.n_win, w_first + d.wpb);
  const int n_pos = (w_end - w_first) * d.win;  // the block's window positions
  const int pos0 = w_first * d.win - d.lead;    // the slot of its first position
  float* price = reinterpret_cast<float*>(smem);
  uint32_t* flag = smem + d.wpb * kWindow;  // 0 closed or empty, 1 priced, 2 priced with cells
  uint32_t* cell = flag + d.wpb * kWindow;
  uint8_t* my_rows = reinterpret_cast<uint8_t*>(smem + d.head_words) +
                     (size_t)warp * kSlotsWarp * d.row_bytes;
  const size_t slots_b = (size_t)b * d.n_slots;

  // -- every position's flag, cell words and assignment column, in bulk ------
  uint32_t sched = 0, nodes = 0;
  for (int t = threadIdx.x; t < n_pos; t += kThreads) {
    const int n = pos0 + t;
    bool priced = false, any = false;
    if (n >= 0 && n < d.n_slots) {
      const size_t row = slots_b + n;
      const int32_t pc = pod_count[row];
      nodes += pc > 0 ? 1u : 0u;
      priced = open_[row] && pc > 0;
    }
    for (int k = 0; k < d.cw; ++k) cell[t * d.cw + k] = 0;
    if (priced) {
      const size_t row = slots_b + n;
      for (int z = 0; z < d.n_zones; ++z) {
        if (!zone[row * d.n_zones + z]) continue;
        for (int c = 0; c < d.n_ct; ++c) {
          if (ct[row * d.n_ct + c]) {
            const int j = z * d.n_ct + c;
            cell[t * d.cw + (j >> 5)] |= 1u << (j & 31);
            any = true;
          }
        }
      }
    }
    flag[t] = priced ? (any ? 2u : 1u) : 0u;
  }
  for (int t = threadIdx.x; t < d.n_cls * n_pos; t += kThreads) {
    const int c = t / n_pos;
    const int n = pos0 + (t - c * n_pos);
    if (n >= 0 && n < d.n_slots) {
      sched += static_cast<uint32_t>(assign[((size_t)b * d.n_cls + c) * d.n_slots + n]);
    }
  }
  __syncthreads();

  for (int w = w_first; w < w_end; ++w) {
    const int wpos = (w - w_first) * d.win;  // the window's first position
    bool walk[kSlotsWarp];
    const uint8_t* src[kSlotsWarp];
#pragma unroll
    for (int s = 0; s < kSlotsWarp; ++s) {
      const int q = warp + s * kWarps;
      walk[s] = q < d.win && flag[wpos + q] == 2u;
      src[s] = walk[s] ? viable + (slots_b + (pos0 + wpos + q)) * d.n_it : viable;
    }
    // -- their viable rows into shared memory: 16 bytes a lane by cp.async on
    //    the aligned body (every row's copies in flight at once), bytes at the
    //    ragged ends; the buffer keeps the row's alignment (`mis` bytes in)
    if (d.row_bytes > 0) {
      uint8_t* dst[kSlotsWarp];
      int end_off[kSlotsWarp];  // a lane's ragged byte of each row, or -1
      uint8_t end_byte[kSlotsWarp];
#pragma unroll
      for (int s = 0; s < kSlotsWarp; ++s) {
        dst[s] = my_rows + s * d.row_bytes;
        end_off[s] = -1;
        end_byte[s] = 0;
        if (!walk[s]) continue;
        const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src[s]) & 15);
        const int head = min((16 - mis) & 15, d.n_it);
        const int body = max(head, ((mis + d.n_it) & ~15) - mis);
        dst[s] += mis;
        const int off = lane < 16 ? lane : body + (lane - 16);
        if (lane < 16 ? off < head : off < d.n_it) {
          end_off[s] = off;
          end_byte[s] = src[s][off];
        }
        for (int o = head + 16 * lane; o < body; o += 16 * 32) cp_async16(dst[s] + o, src[s] + o);
        src[s] = dst[s];
      }
#pragma unroll
      for (int s = 0; s < kSlotsWarp; ++s) {
        if (end_off[s] >= 0) dst[s][end_off[s]] = end_byte[s];
      }
      cp_async_wait_all();
      __syncwarp();
    }
    float* wp = price + (w - w_first) * kWindow;
#pragma unroll
    for (int s = 0; s < kSlotsWarp; ++s) {
      const int q = warp + s * kWarps;
      if (q < d.win) {
        float p = flag[wpos + q] != 0u ? INFINITY : 0.0f;  // no cell; closed or empty
        if (walk[s]) p = walk_price(d, src[s], cell + (wpos + q) * d.cw, ord_idx, ord_price, lane);
        if (lane == 0) wp[q] = p;
      }
    }
    __syncwarp();  // the warp's rows are rewritten next window
  }
  __syncthreads();

  // -- the block's windows, each summed in order from +0.0 ------------------
  const int n_mine = w_end - w_first;
  if (threadIdx.x < n_mine) {
    const float* wp = price + threadIdx.x * kWindow;
    float acc = 0.0f;
    for (int j = 0; j < d.win; ++j) acc = __fadd_rn(acc, isfinite(wp[j]) ? wp[j] : 0.0f);
    part_cost[(size_t)b * d.n_win + w_first + threadIdx.x] = acc;
    __threadfence();
  }
  sched = block_sum(sched, red);
  nodes = block_sum(nodes, red);
  if (threadIdx.x == 0) {
    const size_t part = (size_t)b * gridDim.x + blockIdx.x;
    part_int[2 * part] = sched;
    part_int[2 * part + 1] = nodes;
    __threadfence();
    is_last = atomicAdd(&ticket[b], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // -- the replica's last block: the rest of the tree and the integer sums --
  float* row = reinterpret_cast<float*>(smem);
  float* next = row + d.n_win;
  for (int t = threadIdx.x; t < d.n_win; t += kThreads) {
    row[t] = __ldcg(part_cost + (size_t)b * d.n_win + t);
  }
  uint32_t s_sum = 0, n_sum = 0;
  for (int t = threadIdx.x; t < gridDim.x; t += kThreads) {
    const size_t q = (size_t)b * gridDim.x + t;
    s_sum += __ldcg(part_int + 2 * q);
    n_sum += __ldcg(part_int + 2 * q + 1);
  }
  s_sum = block_sum(s_sum, red);
  n_sum = block_sum(n_sum, red);
  int n = d.n_win;
  while (n > kWindow) {
    const int count = (n + kWindow - 1) / kWindow;
    const int pad = (count * kWindow - n) / 2;
    for (int j = threadIdx.x; j < count; j += kThreads) {
      float acc = 0.0f;
      for (int k = 0; k < kWindow; ++k) {
        const int idx = j * kWindow + k - pad;
        acc = __fadd_rn(acc, (idx >= 0 && idx < n) ? row[idx] : 0.0f);
      }
      next[j] = acc;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < count; j += kThreads) row[j] = next[j];
    __syncthreads();
    n = count;
  }
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) acc = __fadd_rn(acc, row[j]);
    uint32_t f_sum = 0;
    for (int c = 0; c < d.n_cls; ++c) {
      f_sum += static_cast<uint32_t>(failed[(size_t)b * d.n_cls + c]);
    }
    scheduled_out[b] = static_cast<int32_t>(s_sum);
    failed_out[b] = static_cast<int32_t>(f_sum);
    nodes_out[b] = static_cast<int32_t>(n_sum);
    cost_out[b] = acc;
    ticket[b] = 0;
  }
}

}  // namespace

// ord_idx / ord_price: [Z * CT, I] scratch; part_int: [B, W, 2] scratch
// (a replica uses one entry a block, at most W); ticket: [B] zeroed.
extern "C" int kc_replica_finish(
    int n_rep, int n_slots, int n_it, int n_zones, int n_ct, int n_cls,
    const void* assign, const void* failed, const void* viable, const void* zone,
    const void* ct, const void* open_, const void* pod_count, const void* it_price,
    void* ord_idx, void* ord_price, void* part_cost, void* part_int, void* ticket,
    void* scheduled_out, void* failed_out, void* nodes_out, void* cost_out, void* stream) {
  if (n_rep <= 0) return 0;
  if (n_slots <= 0 || n_rep > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Dims d;
  d.n_slots = n_slots;
  d.n_it = n_it;
  d.n_zones = n_zones;
  d.n_ct = n_ct;
  d.n_cls = n_cls;
  d.win = n_slots;
  d.n_win = 1;
  d.lead = 0;
  if (n_slots > kWindow) {
    d.win = kWindow;
    d.n_win = (n_slots + kWindow - 1) / kWindow;
    d.lead = (d.n_win * kWindow - n_slots) / 2;
  }
  const int n_cells = n_zones * n_ct;
  d.cw = std::max(1, (n_cells + 31) / 32);
  // about eight blocks an SM over the whole grid, at most kMaxWpb windows each
  const long long windows = (long long)d.n_win * n_rep;
  const long long want = windows / ((long long)kSms * 8);
  d.wpb = static_cast<int>(std::min<long long>(kMaxWpb, std::max(1LL, want)));
  const int n_blocks = (d.n_win + d.wpb - 1) / d.wpb;
  const int row_bytes = ((n_it + 15 + 15) / 16) * 16;
  d.row_bytes = row_bytes <= kRowStage ? row_bytes : 0;
  d.head_words = ((d.wpb * kWindow * (2 + d.cw) + 3) / 4) * 4;
  const size_t head = (size_t)4 * d.head_words;
  const size_t smem = std::max(head + (size_t)kWarps * kSlotsWarp * d.row_bytes,
                               (size_t)8 * d.n_win);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        replica_finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n_it > 0 && n_cells > 0) {
    replica_rank_kernel<<<dim3((n_it + 31) / 32, n_cells), kThreads, 0, s>>>(
        n_it, n_cells, static_cast<const float*>(it_price), static_cast<int32_t*>(ord_idx),
        static_cast<float*>(ord_price));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  replica_finish_kernel<<<dim3(n_blocks, n_rep), kThreads, smem, s>>>(
      d, static_cast<const int32_t*>(assign), static_cast<const int32_t*>(failed),
      static_cast<const uint8_t*>(viable), static_cast<const uint8_t*>(zone),
      static_cast<const uint8_t*>(ct), static_cast<const uint8_t*>(open_),
      static_cast<const int32_t*>(pod_count), static_cast<const int32_t*>(ord_idx),
      static_cast<const float*>(ord_price), static_cast<float*>(part_cost),
      static_cast<uint32_t*>(part_int), static_cast<unsigned int*>(ticket),
      static_cast<int32_t*>(scheduled_out), static_cast<int32_t*>(failed_out),
      static_cast<int32_t*>(nodes_out), static_cast<float*>(cost_out));
  return static_cast<int>(cudaGetLastError());
}
