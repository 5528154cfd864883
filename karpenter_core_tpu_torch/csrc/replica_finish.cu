// K20: the summary of every replica of a what-if study, in one launch.
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
// (karpenter_core_tpu/ops/solve.py:2140), computed by the device code K9
// uses (slot_price.cuh).  Integer sums run in unsigned arithmetic, which
// wraps as XLA's int32 sums do, in any order.
//
// The f32 cost sum follows XLA's CPU order, read from the object code of
// `jit(vmap(one_replica))` (its HLO rewrites the reduce over N slots into a
// reduce-window of 32 and a reduce of the window sums; the window loop is 32
// scalar `vaddss` from +0): while the row is longer than 32, it is padded
// with zeros evenly at both ends to a multiple of 32 and each window of 32
// is summed in order from +0.0; the last row of at most 32 is summed in
// order from +0.0.  Every add is `__fadd_rn` (no contraction).
//
// Bound on the H100: bytes.  At B = 128 replicas of N = 8,192 slots,
// I = 1,000 types and C = 16 classes it must read each open slot's viable
// row (8.2 MB a replica at 7,162 open slots) and the C x N assignment plane
// (0.5 MB): about 0.35 ms at 3.35 TB/s.
// Design: a grid of (windows, replicas); a block of 256 threads takes one
// first-level window of 32 slots of one replica.  Its warps price the slots
// (one warp a slot), its threads sum the window's assignment columns and
// open slots; thread 0 sums the window's prices in order.  The block writes
// its partials, fences, and takes a ticket; the replica's last block reads
// the partials back through L2 and finishes the tree (windows of 32 from
// +0.0, then the rest in order) and the integer sums.  One launch covers
// every replica and every level of the tree.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slot_price.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 32;

__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* scratch) {
  // every thread's v summed (unsigned); the result is valid in thread 0
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t total = 0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) total += scratch[w];
  }
  return total;
}

__global__ void __launch_bounds__(kThreads) replica_finish_kernel(
    int n_slots, int n_it, int n_zones, int n_ct, int n_cls, int win, int n_win, int lead,
    const int32_t* __restrict__ assign,     // [B, C, N]
    const int32_t* __restrict__ failed,     // [B, C]
    const uint8_t* __restrict__ viable,     // [B, N, I]
    const uint8_t* __restrict__ zone,       // [B, N, Z]
    const uint8_t* __restrict__ ct,         // [B, N, CT]
    const uint8_t* __restrict__ open_,      // [B, N]
    const int32_t* __restrict__ pod_count,  // [B, N]
    const float* __restrict__ it_price,     // [I, Z, CT]
    float* part_cost,                       // [B, W] scratch
    uint32_t* part_int,                     // [B, W, 2] scratch
    unsigned int* ticket,                   // [B] zeroed
    int32_t* __restrict__ scheduled_out,    // [B]
    int32_t* __restrict__ failed_out,       // [B]
    int32_t* __restrict__ nodes_out,        // [B]
    float* __restrict__ cost_out) {         // [B]
  extern __shared__ float smem[];  // [kWindow] prices, then 2 x [W] tree rows
  __shared__ uint32_t red[kWarps];
  __shared__ int is_last;
  float* price = smem;
  const int w = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int first = w * win - lead;  // slot of the window's first position

  for (int j = warp; j < win; j += kWarps) {
    const int n = first + j;
    float p = 0.0f;  // a padded position adds +0.0
    if (n >= 0 && n < n_slots) {
      const size_t row = static_cast<size_t>(b) * n_slots + n;
      p = kc::warp_slot_price(open_[row] && pod_count[row] > 0, viable + row * n_it,
                              zone + row * n_zones, ct + row * n_ct, it_price, n_it, n_zones,
                              n_ct, lane);
    }
    if (lane == 0) price[j] = p;
  }

  uint32_t sched = 0, nodes = 0;
  for (int t = threadIdx.x; t < n_cls * win; t += kThreads) {
    const int c = t / win;
    const int n = first + (t - c * win);
    if (n >= 0 && n < n_slots) {
      sched += static_cast<uint32_t>(
          assign[(static_cast<size_t>(b) * n_cls + c) * n_slots + n]);
    }
  }
  if (threadIdx.x < win) {
    const int n = first + threadIdx.x;
    if (n >= 0 && n < n_slots && pod_count[static_cast<size_t>(b) * n_slots + n] > 0) nodes = 1;
  }
  sched = block_sum(sched, red);  // its __syncthreads also orders the price writes
  nodes = block_sum(nodes, red);

  const size_t part = static_cast<size_t>(b) * n_win + w;
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int j = 0; j < win; ++j) {
      const float p = price[j];
      acc = __fadd_rn(acc, isfinite(p) ? p : 0.0f);
    }
    part_cost[part] = acc;
    part_int[2 * part] = sched;
    part_int[2 * part + 1] = nodes;
    __threadfence();
    is_last = atomicAdd(&ticket[b], 1u) == static_cast<unsigned int>(n_win - 1);
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the replica's last block: the rest of the tree and the integer sums
  float* row = smem + kWindow;
  float* next = row + n_win;
  uint32_t s_sum = 0, n_sum = 0;
  for (int t = threadIdx.x; t < n_win; t += kThreads) {
    const size_t q = static_cast<size_t>(b) * n_win + t;
    row[t] = __ldcg(part_cost + q);
    s_sum += __ldcg(part_int + 2 * q);
    n_sum += __ldcg(part_int + 2 * q + 1);
  }
  s_sum = block_sum(s_sum, red);
  n_sum = block_sum(n_sum, red);
  int n = n_win;
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
    for (int c = 0; c < n_cls; ++c) {
      f_sum += static_cast<uint32_t>(failed[static_cast<size_t>(b) * n_cls + c]);
    }
    scheduled_out[b] = static_cast<int32_t>(s_sum);
    failed_out[b] = static_cast<int32_t>(f_sum);
    nodes_out[b] = static_cast<int32_t>(n_sum);
    cost_out[b] = acc;
    ticket[b] = 0;
  }
}

}  // namespace

extern "C" int kc_replica_finish(
    int n_rep, int n_slots, int n_it, int n_zones, int n_ct, int n_cls,
    const void* assign, const void* failed, const void* viable, const void* zone,
    const void* ct, const void* open_, const void* pod_count, const void* it_price,
    void* part_cost, void* part_int, void* ticket, void* scheduled_out, void* failed_out,
    void* nodes_out, void* cost_out, void* stream) {
  if (n_rep <= 0) return 0;
  if (n_slots <= 0 || n_rep > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int win = n_slots, n_win = 1, lead = 0;
  if (n_slots > kWindow) {
    win = kWindow;
    n_win = (n_slots + kWindow - 1) / kWindow;
    lead = (n_win * kWindow - n_slots) / 2;
  }
  const size_t smem = (kWindow + 2 * static_cast<size_t>(n_win)) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_win, n_rep);
  replica_finish_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      n_slots, n_it, n_zones, n_ct, n_cls, win, n_win, lead,
      static_cast<const int32_t*>(assign), static_cast<const int32_t*>(failed),
      static_cast<const uint8_t*>(viable), static_cast<const uint8_t*>(zone),
      static_cast<const uint8_t*>(ct), static_cast<const uint8_t*>(open_),
      static_cast<const int32_t*>(pod_count), static_cast<const float*>(it_price),
      static_cast<float*>(part_cost), static_cast<uint32_t*>(part_int),
      static_cast<unsigned int*>(ticket), static_cast<int32_t*>(scheduled_out),
      static_cast<int32_t*>(failed_out), static_cast<int32_t*>(nodes_out),
      static_cast<float*>(cost_out));
  return static_cast<int>(cudaGetLastError());
}
