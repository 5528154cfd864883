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
// does a few hundred scalar operations; the time is the launch.
// Design: one warp a tenant (grid = B; every operand may carry a leading
// tenant axis, [B, Z] and [B]), whose lane 0 runs that tenant's rounds in
// order (Z <= 32) to their own end.  (Under vmap the reference's rounds run
// to the last tenant's end with finished tenants frozen, which gives the
// same values.)  A solo call is B = 1.
// Its per-zone arrays are indexed at run time, so they live in local memory:
// ptxas reports a 1,024-byte stack frame for sm_90a, and those accesses, not
// arithmetic, set the kernel's time.  Unrolling for a fixed Z = 3 would keep
// them in registers (PERF.md, Open questions).  The inputs are read from
// device memory, so the class loop never reads the pod count or the group
// counts on the host.
//
// Arithmetic matches the reference bit for bit:
//  - the water-fill sorts the zones by count, stably (ties keep index
//    order, as jnp.argsort), with non-allowed zones at BIG = 1e30;
//  - its prefix is the running f32 sum minus the element
//    (`cumsum(s) - s`), and `idx * s - prefix`, `rem / k`, `rem - floor *
//    k` are separate IEEE round-to-nearest operations (`__fmul_rn`,
//    `__fsub_rn`, `__fdiv_rn`, ...), never FMAs; a cost that is not finite
//    becomes BIG; at most Z + 1 rounds are counted, exactly as the loop;
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

// `_water_fill(count0, allowed, m)`: quotas q[Z] of m pods over the allowed
// zones, filling the lowest-count zone first
__device__ void water_fill(int n_zones, const int32_t* count0, const bool* allowed,
                           int32_t m, int32_t* q) {
  float c[kMaxZ];
  for (int z = 0; z < n_zones; ++z) c[z] = allowed[z] ? static_cast<float>(count0[z]) : kBig;
  // stable ascending argsort: rank = #smaller + #equal before
  int order[kMaxZ];
  for (int z = 0; z < n_zones; ++z) {
    int rank = 0;
    for (int j = 0; j < n_zones; ++j) {
      if (c[j] < c[z] || (c[j] == c[z] && j < z)) ++rank;
    }
    order[rank] = z;
  }
  float s[kMaxZ], cost[kMaxZ];
  float cum = 0.0f;
  for (int k = 0; k < n_zones; ++k) {
    s[k] = c[order[k]];
    cum = (k == 0) ? s[k] : __fadd_rn(cum, s[k]);
    const float prefix = __fsub_rn(cum, s[k]);
    const float ck = __fsub_rn(__fmul_rn(static_cast<float>(k), s[k]), prefix);
    cost[k] = isfinite(ck) ? ck : kBig;
  }
  const float mf = static_cast<float>(m);
  int k_star = -1;
  for (int k = 0; k < n_zones; ++k) k_star += cost[k] <= mf ? 1 : 0;
  k_star = k_star < 0 ? 0 : (k_star > n_zones - 1 ? n_zones - 1 : k_star);
  const float rem = __fsub_rn(mf, cost[k_star]);
  const float k_count = static_cast<float>(k_star + 1);
  const float fl = floorf(__fdiv_rn(rem, k_count));
  const float level = __fadd_rn(s[k_star], fl);
  const float leftover = __fsub_rn(rem, __fmul_rn(fl, k_count));
  for (int k = 0; k < n_zones; ++k) {
    float f = s[k];
    if (k <= k_star) {
      const float extra = static_cast<float>(k) < leftover ? 1.0f : 0.0f;
      f = fmaxf(s[k], __fadd_rn(level, extra));
    }
    const int z = order[k];
    const float quota = allowed[z] ? __fsub_rn(f, c[z]) : 0.0f;
    q[z] = sat_i32(fmaxf(quota, 0.0f));
  }
}

__global__ void spread_quota_kernel(
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
  if (threadIdx.x != 0) return;
  // this block's tenant
  const size_t tb = blockIdx.x;
  counts += tb * n_zones;
  allowed += tb * n_zones;
  fillable += tb * n_zones;
  cap_pods += tb * n_zones;
  skew_p += tb;
  m_p += tb;
  member_p += tb;
  quotas_out += tb * n_zones;
  sat_out += tb * n_zones;
  m_rem_out += tb;
  residual_out += tb;
  const int32_t skew = *skew_p;
  int32_t m_rem = *m_p;
  bool unreachable[kMaxZ], sat[kMaxZ], active[kMaxZ], finite_cap[kMaxZ];
  int32_t quotas[kMaxZ], now[kMaxZ], q[kMaxZ];
  for (int z = 0; z < n_zones; ++z) {
    unreachable[z] = allowed[z] && !fillable[z];
    finite_cap[z] = cap_pods[z] < kUnlimited;
    sat[z] = false;
    quotas[z] = 0;
  }
  for (int round = 0; round < n_zones + 1; ++round) {
    int32_t min_frozen = kBigI;
    int32_t lvl_sat = kBigI;
    for (int z = 0; z < n_zones; ++z) {
      now[z] = wadd(counts[z], quotas[z]);
      active[z] = allowed[z] && fillable[z] && !sat[z];
      if (unreachable[z] || sat[z]) min_frozen = now[z] < min_frozen ? now[z] : min_frozen;
    }
    for (int z = 0; z < n_zones; ++z) {
      const int32_t cap_rem = clip(wsub(cap_pods[z], quotas[z]), 0, kUnlimited);
      if (active[z] && finite_cap[z]) {
        const int32_t lvl = wadd(now[z], cap_rem);
        lvl_sat = lvl < lvl_sat ? lvl : lvl_sat;
      }
    }
    water_fill(n_zones, now, active, m_rem, q);
    int32_t placed = 0;
    for (int z = 0; z < n_zones; ++z) {
      const int32_t skew_cap = clip(wsub(wadd(min_frozen, skew), now[z]), 0, kUnlimited);
      const int32_t cap_rem = clip(wsub(cap_pods[z], quotas[z]), 0, kUnlimited);
      const int32_t lvl_cap = clip(wsub(lvl_sat, now[z]), 0, kUnlimited);
      int32_t qz = q[z] < lvl_cap ? q[z] : lvl_cap;
      const int32_t bound = skew_cap < cap_rem ? skew_cap : cap_rem;
      qz = qz < bound ? qz : bound;
      qz = active[z] ? qz : 0;
      quotas[z] = wadd(quotas[z], qz);
      placed = wadd(placed, qz);
    }
    m_rem = wsub(m_rem, placed);
    for (int z = 0; z < n_zones; ++z) {
      sat[z] = sat[z] || (active[z] && finite_cap[z] && quotas[z] >= cap_pods[z]);
    }
  }
  const bool member = *member_p != 0;
  int32_t min_frozen_end = kBigI;
  for (int z = 0; z < n_zones; ++z) {
    if (!member) quotas[z] = 0;
    now[z] = wadd(counts[z], quotas[z]);
    if (unreachable[z] || sat[z]) min_frozen_end = now[z] < min_frozen_end ? now[z] : min_frozen_end;
  }
  bool headroom = false;
  for (int z = 0; z < n_zones; ++z) {
    const bool skew_headroom = wsub(now[z], min_frozen_end) < skew;
    const bool cap_headroom = wsub(cap_pods[z], quotas[z]) > 0;
    headroom |= allowed[z] && fillable[z] && !sat[z] && skew_headroom && cap_headroom;
    quotas_out[z] = quotas[z];
    sat_out[z] = sat[z] ? 1 : 0;
  }
  *m_rem_out = m_rem;
  *residual_out = (m_rem > 0 && headroom) ? 1 : 0;
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
