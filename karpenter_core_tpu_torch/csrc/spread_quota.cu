// K7: the per-zone quotas of one zone-spread class.
//
// Replaces the capped quota rounds of `_class_step`
// (karpenter_core_tpu/ops/solve.py:1440-1475) with the `_water_fill` (:277)
// they call: Z + 1 rounds, each of which water-fills the pods still to place
// over the active zones (lowest count first, topologygroup.go:155-182),
// capped at the level where the nearest finite-capacity zone saturates, at
// the skew bound over the frozen zones, and at each zone's capacity left;
// a zone whose capacity is used up freezes and bounds the later rounds.
// Then the member gate and the under-placement flag:
//
//   quotas       = member ? quotas : 0
//   fill_residual = m_rem > 0 & any(allowed & fillable & ~sat
//                   & counts_end - min_frozen_end < skew & cap - quotas > 0)
//
// Outputs quotas i32[Z], sat bool[Z], m_rem i32[], fill_residual bool[].
// Bound on the H100: latency.  It reads and writes a few dozen bytes and
// does a few hundred scalar operations; the time is the launch and the
// rounds' chain of dependent steps.
// Design: one warp a tenant (grid = B; every operand may carry a leading
// tenant axis, [B, Z] and [B]), lane z holding zone z's state in registers
// (count, quota, cap, sat, the allowed, fillable and unreachable flags;
// Z <= 32).  No per-zone array exists, so nothing is indexed at run time
// and nothing lives in local memory: each round is warp collectives.
// `min_frozen` and `lvl_sat` are `__reduce_min_sync`; the water-fill's
// stable ascending rank is a count over the Z values shuffled in (ties keep
// index order); the sorted values are gathered by shuffles; lane k's
// running sum adds s[0] .. s[k] one after another (never as a tree; past
// 16 zones in XLA's blocks of 16), so it rounds as the reference's cumsum
// does; `k_star` is `__popc(__ballot_sync)`;
// s[k_star] and cost[k_star] are one shuffle each; the filled levels go
// back to the zones through each zone's rank; the placed sum is
// `__reduce_add_sync` on unsigned values, so it wraps as the reference's
// int32 sum does.  A round that places no pod and saturates no zone leaves
// the state unchanged, so the later rounds would repeat it: the warp stops
// there (typically after two rounds) where the reference runs all Z + 1.
// (Under vmap the reference's rounds run to the last tenant's end with
// finished tenants frozen, which gives the same values.)  A solo call is
// B = 1.
// ptxas (sm_90a, -O3 -Xptxas -v): 43 registers, 0 bytes stack frame, 0
// bytes spill stores, 0 bytes spill loads.
// The inputs are read from device memory, so the class loop never reads
// the pod count or the group counts on the host.
//
// Arithmetic matches the reference bit for bit (its jitted `_water_fill`
// on the CPU):
//  - the water-fill sorts the zones by count, stably (ties keep index
//    order, as jnp.argsort), with non-allowed zones at BIG = 1e30;
//  - its prefix is the running f32 sum minus the element (`cumsum(s) - s`),
//    the sum in XLA's order (sequential up to 16 zones, blocks of 16 past
//    that); `idx * s - prefix` and `rem - floor * k` are each one fused
//    multiply-add (`__fmaf_rn`), as XLA contracts them, and every other
//    operation is its own IEEE round-to-nearest one (`__fsub_rn`,
//    `__fdiv_rn`, ...); a cost that is not finite becomes BIG; at most
//    Z + 1 rounds are counted, exactly as the loop;
//  - the float-to-int32 conversion saturates, and int32 sums wrap
//    (unsigned arithmetic) where `min_frozen + skew` can pass 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxZ = 32;
constexpr float kBig = 1e30f;
constexpr int32_t kUnlimited = 1 << 30;
constexpr int32_t kBigI = 1 << 30;

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t clip(int32_t x, int32_t lo, int32_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int32_t sat_i32(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return 2147483647;
  if (x <= -2147483648.0f) return -2147483647 - 1;
  return static_cast<int32_t>(x);
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCumsumBlock = 16;  // XLA's CPU scan block (kernels/fp32.py)

// min over the warp's zones of (taken ? value : BIGI), the reference's
// `where(taken, value, BIGI).min()`; a lane past the last zone adds the
// identity, not BIGI (a value can exceed BIGI)
__device__ __forceinline__ int32_t zone_min(bool mine, bool taken, int32_t value) {
  return __reduce_min_sync(kFull, mine ? (taken ? value : kBigI) : 2147483647);
}

// `_water_fill(count0, allowed, m)` for lane z's zone (z < n_zones; every
// lane of the warp calls it): the zone's quota of m pods over the allowed
// zones, filling the lowest-count zone first
__device__ __forceinline__ int32_t water_fill(int n_zones, int z, int32_t count0, bool allowed,
                                              int32_t m) {
  const bool mine = z < n_zones;
  const float c = allowed ? static_cast<float>(count0) : kBig;
  // stable ascending rank: #smaller + #equal before
  int rank = mine ? 0 : z;
  for (int j = 0; j < n_zones; ++j) {
    const float cj = __shfl_sync(kFull, c, j);
    if (mine && (cj < c || (cj == c && j < z))) ++rank;
  }
  // lane k: the k-th smallest value
  float s = kBig;
  for (int j = 0; j < n_zones; ++j) {
    const float cj = __shfl_sync(kFull, c, j);
    const int rj = __shfl_sync(kFull, rank, j);
    if (rj == z) s = cj;
  }
  // the running sum in sorted order as XLA's CPU cumsum takes it: one
  // element after another within each block of 16 (every block begun from
  // the element, never a tree), then block 0's total added to block 1's
  const int first = z & ~(kCumsumBlock - 1);
  float cum = 0.0f;
  for (int i = 0; i < n_zones; ++i) {
    const float si = __shfl_sync(kFull, s, i);
    if (i >= first && i <= z) cum = (i == first) ? si : __fadd_rn(cum, si);
  }
  const float block0 = __shfl_sync(kFull, cum, kCumsumBlock - 1);
  if (first > 0) cum = __fadd_rn(block0, cum);
  const float prefix = __fsub_rn(cum, s);
  const float ck = __fmaf_rn(static_cast<float>(z), s, -prefix);
  const float cost = isfinite(ck) ? ck : kBig;
  const float mf = static_cast<float>(m);
  int k_star = __popc(__ballot_sync(kFull, mine && cost <= mf)) - 1;
  k_star = k_star < 0 ? 0 : (k_star > n_zones - 1 ? n_zones - 1 : k_star);
  const float s_star = __shfl_sync(kFull, s, k_star);
  const float cost_star = __shfl_sync(kFull, cost, k_star);
  const float rem = __fsub_rn(mf, cost_star);
  const float k_count = static_cast<float>(k_star + 1);
  const float fl = floorf(__fdiv_rn(rem, k_count));
  const float level = __fadd_rn(s_star, fl);
  const float leftover = __fmaf_rn(-fl, k_count, rem);
  float f = s;
  if (z <= k_star) {
    const float extra = static_cast<float>(z) < leftover ? 1.0f : 0.0f;
    f = fmaxf(s, __fadd_rn(level, extra));
  }
  // back to the zone: its value is the one at its rank
  const float fz = __shfl_sync(kFull, f, rank);
  const float quota = allowed ? __fsub_rn(fz, c) : 0.0f;
  return sat_i32(fmaxf(quota, 0.0f));
}

__global__ void __launch_bounds__(32) spread_quota_kernel(
    int n_zones,
    const int32_t* __restrict__ counts,    // [Z] members per zone now
    const uint8_t* __restrict__ allowed,   // [Z] zones the class may use
    const uint8_t* __restrict__ fillable,  // [Z] zones with intake somewhere
    const int32_t* __restrict__ cap_pods,  // [Z] intake (UNLIMITED = no cap)
    const int32_t* __restrict__ skew_p,    // []  maxSkew
    const int32_t* __restrict__ m_p,       // []  pods of the class
    const uint8_t* __restrict__ member_p,  // []  the class counts in its group
    int32_t* __restrict__ quotas_out,      // [Z]
    uint8_t* __restrict__ sat_out,         // [Z]
    int32_t* __restrict__ m_rem_out,       // []
    uint8_t* __restrict__ residual_out) {  // []
  const int z = threadIdx.x;
  const bool mine = z < n_zones;
  // this block's tenant; lane z its zone z (lanes past Z hold a zone that
  // is not allowed, bounds nothing and places nothing)
  const size_t tb = blockIdx.x;
  const size_t at = tb * n_zones + z;
  const int32_t count = mine ? counts[at] : 0;
  const bool allow = mine && allowed[at] != 0;
  const bool fill = mine && fillable[at] != 0;
  const int32_t cap = mine ? cap_pods[at] : 0;
  const int32_t skew = skew_p[tb];
  int32_t m_rem = m_p[tb];
  const bool unreachable = allow && !fill;
  const bool finite_cap = mine && cap < kUnlimited;
  bool sat = false;
  int32_t quota = 0;
  for (int round = 0; round < n_zones + 1; ++round) {
    const int32_t now = wadd(count, quota);
    const bool active = allow && fill && !sat;
    const int32_t min_frozen = zone_min(mine, unreachable || sat, now);
    const int32_t cap_rem = clip(wsub(cap, quota), 0, kUnlimited);
    const int32_t lvl_sat = zone_min(mine, active && finite_cap, wadd(now, cap_rem));
    const int32_t q = water_fill(n_zones, z, now, active, m_rem);
    const int32_t skew_cap = clip(wsub(wadd(min_frozen, skew), now), 0, kUnlimited);
    const int32_t lvl_cap = clip(wsub(lvl_sat, now), 0, kUnlimited);
    int32_t qz = q < lvl_cap ? q : lvl_cap;
    const int32_t bound = skew_cap < cap_rem ? skew_cap : cap_rem;
    qz = qz < bound ? qz : bound;
    qz = active ? qz : 0;
    quota = wadd(quota, qz);
    const uint32_t placed = __reduce_add_sync(kFull, static_cast<uint32_t>(qz));
    m_rem = wsub(m_rem, static_cast<int32_t>(placed));
    const bool now_sat = active && finite_cap && quota >= cap;
    // a round that places nothing and saturates no zone leaves the state
    // (quotas, sat, m_rem) as it found it, so every later round repeats it:
    // stop (exact; the reference runs all Z + 1)
    const bool changed = __any_sync(kFull, qz != 0 || (now_sat && !sat));
    sat = sat || now_sat;
    if (!changed) break;
  }
  if (member_p[tb] == 0) quota = 0;
  const int32_t now = wadd(count, quota);
  const int32_t min_frozen_end = zone_min(mine, unreachable || sat, now);
  const bool skew_headroom = wsub(now, min_frozen_end) < skew;
  const bool cap_headroom = wsub(cap, quota) > 0;
  const bool headroom =
      __any_sync(kFull, allow && fill && !sat && skew_headroom && cap_headroom);
  if (mine) {
    quotas_out[at] = quota;
    sat_out[at] = sat ? 1 : 0;
  }
  if (z == 0) {
    m_rem_out[tb] = m_rem;
    residual_out[tb] = (m_rem > 0 && headroom) ? 1 : 0;
  }
}

}  // namespace

extern "C" int kc_spread_quota_max_zones() { return kMaxZ; }

extern "C" int kc_spread_quota(int n_batch, int n_zones, const void* counts, const void* allowed,
                               const void* fillable, const void* cap_pods, const void* skew,
                               const void* m, const void* member, void* quotas_out,
                               void* sat_out, void* m_rem_out, void* residual_out,
                               void* stream) {
  if (n_zones <= 0 || n_zones > kMaxZ) return static_cast<int>(cudaErrorInvalidValue);
  if (n_batch <= 0) return 0;
  spread_quota_kernel<<<n_batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      n_zones, static_cast<const int32_t*>(counts), static_cast<const uint8_t*>(allowed),
      static_cast<const uint8_t*>(fillable), static_cast<const int32_t*>(cap_pods),
      static_cast<const int32_t*>(skew), static_cast<const int32_t*>(m),
      static_cast<const uint8_t*>(member), static_cast<int32_t*>(quotas_out),
      static_cast<uint8_t*>(sat_out), static_cast<int32_t*>(m_rem_out),
      static_cast<uint8_t*>(residual_out));
  return static_cast<int>(cudaGetLastError());
}
