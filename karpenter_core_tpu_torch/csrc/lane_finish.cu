// K9: the finish of every lane of one consolidation sweep pass, with the
// replacement pricing.
//
// Replaces `node_prices` (karpenter_core_tpu/ops/solve.py:2140) and the rest
// of `sweep.one_prefix` (karpenter_core_tpu/ops/consolidate.py:83-100) under
// `jax.vmap`, over the stacked outputs of the pass's S lane solves:
//
//   price[s,n]  = min over (i, z, ct) with viable[s,n,i] & zone[s,n,z]
//                 & ct[s,n,ct] of it_price[i,z,ct]  (+inf when there is none),
//                 and 0 where the slot is closed or holds no pod
//   new_cost[s] = sum over n of price[s,n] where it is finite
//   failed[s]   = sum_c failed[s,c]                               (int32)
//   uninit[s]   = any over (c, e) of assign_existing[s,c,e] > 0 & ~init[e]
//
// Bound on the H100: bytes.  At S = 64 lanes, N = 16 slots, I = 1,000 types,
// C = 16 classes and E = 6,144 existing nodes it must read 25 MB of
// assign_existing and 1 MB of viability: about 8 us at 3.35 TB/s.
// Design: one block of 256 threads per lane.  Each warp prices one slot at
// a time (`kc::warp_slot_price`, slot_price.cuh, the code K20 shares).  The
// prices go to shared memory; the block then scans the lane's C x E
// assignment plane, coalesced, and `__syncthreads_or` gives uninit.  Thread
// 0 sums the slot prices in slot order (one IEEE round-to-nearest add each,
// `__fadd_rn`: the plain twin's order) and the class failures in unsigned
// arithmetic (int32 wrap).
//
// The reference's f32 sum of the slot prices may round in another order
// than this slot-order sum; the reference's own mesh parity suite allows
// that one leaf rtol 1e-6.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slot_price.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) lane_finish_kernel(
    int n_slots, int n_it, int n_zones, int n_ct, int n_cls, int n_ex,
    const uint8_t* __restrict__ viable,           // [S, N, I]
    const uint8_t* __restrict__ zone,             // [S, N, Z]
    const uint8_t* __restrict__ ct,               // [S, N, CT]
    const uint8_t* __restrict__ open_,            // [S, N]
    const int32_t* __restrict__ pod_count,        // [S, N]
    const int32_t* __restrict__ failed,           // [S, C]
    const int32_t* __restrict__ assign_existing,  // [S, C, E]
    const uint8_t* __restrict__ init,             // [E]
    const float* __restrict__ it_price,           // [I, Z, CT]
    float* __restrict__ price_out,                // [S, N]
    float* __restrict__ cost_out,                 // [S]
    int32_t* __restrict__ failed_out,             // [S]
    uint8_t* __restrict__ uninit_out) {           // [S]
  extern __shared__ float slot_price[];  // [N]
  const int s = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int n = warp; n < n_slots; n += kWarps) {
    const size_t row = static_cast<size_t>(s) * n_slots + n;
    const float best = kc::warp_slot_price(
        open_[row] && pod_count[row] > 0, viable + row * n_it, zone + row * n_zones,
        ct + row * n_ct, it_price, n_it, n_zones, n_ct, lane);
    if (lane == 0) {
      price_out[row] = best;
      slot_price[n] = best;
    }
  }

  int found = 0;
  const int32_t* a = assign_existing + static_cast<size_t>(s) * n_cls * n_ex;
  for (int c = 0; c < n_cls && !found; ++c) {
    const int32_t* a_row = a + static_cast<size_t>(c) * n_ex;
    for (int e = threadIdx.x; e < n_ex; e += kThreads) {
      if (a_row[e] > 0 && !init[e]) found = 1;
    }
  }
  const int any = __syncthreads_or(found);  // also orders the slot_price writes

  if (threadIdx.x == 0) {
    float cost = 0.0f;
    for (int n = 0; n < n_slots; ++n) {
      const float p = slot_price[n];
      if (isfinite(p)) cost = __fadd_rn(cost, p);
    }
    uint32_t total = 0;
    for (int c = 0; c < n_cls; ++c) {
      total += static_cast<uint32_t>(failed[static_cast<size_t>(s) * n_cls + c]);
    }
    cost_out[s] = cost;
    failed_out[s] = static_cast<int32_t>(total);
    uninit_out[s] = any ? 1 : 0;
  }
}

}  // namespace

extern "C" int kc_lane_finish(
    int n_lanes, int n_slots, int n_it, int n_zones, int n_ct, int n_cls, int n_ex,
    const void* viable, const void* zone, const void* ct, const void* open_,
    const void* pod_count, const void* failed, const void* assign_existing, const void* init,
    const void* it_price, void* price_out, void* cost_out, void* failed_out, void* uninit_out,
    void* stream) {
  if (n_lanes <= 0) return 0;
  const size_t smem = static_cast<size_t>(n_slots > 0 ? n_slots : 1) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  lane_finish_kernel<<<n_lanes, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      n_slots, n_it, n_zones, n_ct, n_cls, n_ex,
      static_cast<const uint8_t*>(viable), static_cast<const uint8_t*>(zone),
      static_cast<const uint8_t*>(ct), static_cast<const uint8_t*>(open_),
      static_cast<const int32_t*>(pod_count), static_cast<const int32_t*>(failed),
      static_cast<const int32_t*>(assign_existing), static_cast<const uint8_t*>(init),
      static_cast<const float*>(it_price), static_cast<float*>(price_out),
      static_cast<float*>(cost_out), static_cast<int32_t*>(failed_out),
      static_cast<uint8_t*>(uninit_out));
  return static_cast<int>(cudaGetLastError());
}
