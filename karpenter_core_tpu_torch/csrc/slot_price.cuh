// The cheapest offering of one new-node slot: the device code of
// `node_prices` (karpenter_core_tpu/ops/solve.py:2140) that K9
// (lane_finish.cu) runs; K20 (replica_finish.cu) takes `min_nan` from it
// and prices its slots by a rank walk of its own.
//
//   price = min over (i, z, ct) with viable[i] & zone[z] & ct[ct] of
//           it_price[i, z, ct]   (+inf when there is none),
//           and 0 where the slot is closed or holds no pod
//
// One warp prices one slot: its lanes stride over the instance types, skip
// the non-viable ones and take the minimum over the allowed (zone, capacity
// type) offerings; a shuffle reduction finishes the minimum in lane 0.  The
// allowed cells are read once a slot, into a bit mask (at most 32 cells; a
// wider catalog walks the masks), so a viable type costs only its allowed
// prices' loads.  A closed or empty slot, or one with no allowed cell, reads
// no type.  The minimum is exact in any order; a NaN price propagates as
// `jnp.min` and `torch.amin` propagate it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kc {

__device__ __forceinline__ float min_nan(float a, float b) {
  // the smaller of two floats; NaN wins, as in jnp.min / torch.amin
  return (isnan(b) || b < a) ? b : a;
}

// Every lane of the warp calls it with the same slot; lane 0 gets the price.
__device__ __forceinline__ float warp_slot_price(
    bool priced,               // open_ && pod_count > 0
    const uint8_t* viable,     // [I] the slot's row
    const uint8_t* zone,       // [Z]
    const uint8_t* ct,         // [CT]
    const float* it_price,     // [I, Z, CT]
    int n_it, int n_zones, int n_ct, int lane) {
  if (!priced) return 0.0f;
  float best = INFINITY;
  const int n_cells = n_zones * n_ct;
  if (n_cells <= 32) {
    uint32_t cells = 0;  // bit z * CT + c: offering (z, c) allowed
    for (int z = 0; z < n_zones; ++z) {
      if (!zone[z]) continue;
      for (int c = 0; c < n_ct; ++c) {
        if (ct[c]) cells |= 1u << (z * n_ct + c);
      }
    }
    if (cells != 0) {
      for (int i = lane; i < n_it; i += 32) {
        if (!viable[i]) continue;
        const float* p = it_price + static_cast<size_t>(i) * n_cells;
        for (uint32_t m = cells; m != 0; m &= m - 1) best = min_nan(best, p[__ffs(m) - 1]);
      }
    }
  } else {
    for (int i = lane; i < n_it; i += 32) {
      if (!viable[i]) continue;
      const float* p = it_price + static_cast<size_t>(i) * n_cells;
      for (int z = 0; z < n_zones; ++z) {
        if (!zone[z]) continue;
        for (int c = 0; c < n_ct; ++c) {
          if (ct[c]) best = min_nan(best, p[z * n_ct + c]);
        }
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    best = min_nan(best, __shfl_down_sync(0xffffffffu, best, off));
  }
  return best;
}

}  // namespace kc
