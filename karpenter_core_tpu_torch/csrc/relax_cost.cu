// K14: the relax family's cell prices.
//
// Replaces the cost stage of `relax_core` (karpenter_core_tpu/relax/
// kernel.py:192-210): for every class c and (instance type i, zone z) cell,
// the objective score of the cheapest capacity type the class and each
// template allow, the cell's feasibility under each template, the per-pod
// unit price, the cheapest template (`tstar`, the first minimum) and the
// class's support.  The arithmetic is in kernels/relax.py; the two FMAs
// are the ones XLA's CPU object code for `relax_core` contains.
//
// Bound on the H100: bytes.  At the headline (C = 16, T = 5, I = 1,000,
// Z = 3, CT = 2) it writes the feas plane (240 KB) and reads the
// per-(class, template) planes (about 0.5 MB): well under a microsecond at
// 3.35 TB/s; the operations (a score per allowed capacity type per
// template per cell, 0.5 M) are smaller still.  Design: one thread per
// (c, i, z) cell, templates and capacity types unrolled in order; the row
// maximum of |cost| over the support goes through an integer atomicMax on
// the float's bits (the values are never negative).
// Float arithmetic is spelled with the _rn intrinsics so nvcc contracts
// nothing beyond XLA's two FMAs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 1e30f;
constexpr float kHalfBig = 5e29f;
constexpr float kPpCap = 1e6f;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || isnan(a)) ? a : b;  // NaN in either argument wins
}

__global__ void __launch_bounds__(kThreads) relax_cost_kernel(
    int n_c, int n_t, int n_i, int n_z, int n_ct, const uint8_t* __restrict__ it_int,
    const int32_t* __restrict__ per_pod, const uint8_t* __restrict__ key_ok,
    const uint8_t* __restrict__ tmpl_it, const uint8_t* __restrict__ cls_it,
    const uint8_t* __restrict__ tmpl_zone, const uint8_t* __restrict__ cls_zone,
    const uint8_t* __restrict__ tmpl_ct, const uint8_t* __restrict__ cls_ct,
    const uint8_t* __restrict__ it_avail, const float* __restrict__ price,
    const float* __restrict__ risk, const float* __restrict__ thr,
    const float* __restrict__ weights, const int32_t* __restrict__ counts,
    float* __restrict__ cost, uint8_t* __restrict__ support, int32_t* __restrict__ tstar,
    uint8_t* __restrict__ feas, float* __restrict__ cost_max) {
  const long long n_s = (long long)n_i * n_z;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)n_c * n_s) return;
  const int c = (int)(g / n_s);
  const int s = (int)(g - (long long)c * n_s);
  const int i = s / n_z;
  const int z = s - i * n_z;
  const float cw = weights[0], ra = weights[1], tw = weights[2];
  const float penalty = __fmul_rn(tw, thr[i]);
  const bool cls_ok = cls_it[(size_t)c * n_i + i] != 0;
  const bool cls_z = cls_zone[(size_t)c * n_z + z] != 0;
  float best_unit = kBig;
  int best_t = 0;
  bool any_feas = false;
  for (int t = 0; t < n_t; ++t) {
    const size_t cti = ((size_t)c * n_t + t) * n_i + i;
    const int pp = per_pod[cti];
    const bool base = tmpl_it[(size_t)t * n_i + i] && cls_ok && it_int[cti] && pp >= 1 &&
                      key_ok[(size_t)c * n_t + t];
    const bool tz = tmpl_zone[(size_t)t * n_z + z] && cls_z;
    float best = kBig;
    for (int k = 0; k < n_ct; ++k) {
      float sc = kBig;
      if (tmpl_ct[(size_t)t * n_ct + k] && cls_ct[(size_t)c * n_ct + k]) {
        const size_t j = ((size_t)i * n_z + z) * n_ct + k;
        const float p = price[j];
        if (it_avail[j] && isfinite(p)) {
          const float one = __fmaf_rn(ra, risk[j], 1.0f);
          sc = __fmaf_rn(__fmul_rn(cw, p), one, -penalty);
        }
      }
      best = nan_min(best, sc);
    }
    const bool f = base && tz && (best < kHalfBig);
    feas[cti * n_z + z] = f;
    const float pp_f = fminf(fmaxf((float)pp, 1.0f), kPpCap);
    const float unit = f ? __fdiv_rn(best, pp_f) : kBig;
    if (t == 0 || unit < best_unit) {  // the first minimum
      best_unit = unit;
      best_t = t;
    }
    any_feas = any_feas || f;
  }
  cost[g] = best_unit;
  tstar[g] = best_t;
  const bool sup = any_feas && counts[c] > 0;
  support[g] = sup;
  if (sup) atomicMax(reinterpret_cast<int*>(cost_max + c), __float_as_int(fabsf(best_unit)));
}

}  // namespace

extern "C" int kc_relax_cost(int n_c, int n_t, int n_i, int n_z, int n_ct, const void* it_int,
                             const void* per_pod, const void* key_ok, const void* tmpl_it,
                             const void* cls_it, const void* tmpl_zone, const void* cls_zone,
                             const void* tmpl_ct, const void* cls_ct, const void* it_avail,
                             const void* price, const void* risk, const void* thr,
                             const void* weights, const void* counts, void* cost,
                             void* support, void* tstar, void* feas, void* cost_max,
                             void* stream_p) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
  const long long cells = (long long)n_c * n_i * n_z;
  if (n_c <= 0 || n_t <= 0 || cells <= 0 || cells >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (int)((cells + kThreads - 1) / kThreads);
  relax_cost_kernel<<<blocks, kThreads, 0, stream>>>(
      n_c, n_t, n_i, n_z, n_ct, static_cast<const uint8_t*>(it_int),
      static_cast<const int32_t*>(per_pod), static_cast<const uint8_t*>(key_ok),
      static_cast<const uint8_t*>(tmpl_it), static_cast<const uint8_t*>(cls_it),
      static_cast<const uint8_t*>(tmpl_zone), static_cast<const uint8_t*>(cls_zone),
      static_cast<const uint8_t*>(tmpl_ct), static_cast<const uint8_t*>(cls_ct),
      static_cast<const uint8_t*>(it_avail), static_cast<const float*>(price),
      static_cast<const float*>(risk), static_cast<const float*>(thr),
      static_cast<const float*>(weights), static_cast<const int32_t*>(counts),
      static_cast<float*>(cost), static_cast<uint8_t*>(support), static_cast<int32_t*>(tstar),
      static_cast<uint8_t*>(feas), static_cast<float*>(cost_max));
  return static_cast<int>(cudaGetLastError());
}
