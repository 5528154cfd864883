// K5: how many pods of one class each existing node can still take.
//
// Replaces `_prep_existing` (karpenter_core_tpu/ops/solve.py:548), all but
// its requirement merge (that part is K3, whose `key_ok` this kernel reads):
//
//   cap[e]  = min_r floor((alloc[e,r] - used[e,r] + 1e-4) / max(req[r], 1e-9))
//             (BIG where req[r] == 0; clamped at 0; saturated to int32)
//   with host ports:   cap = min(cap, has_ports ? 1 : UNLIMITED),
//                      eligible only without a port conflict
//   with volume limits: free_d = vol_limit - vol_used - vol_add;
//                      cap = min(cap, max(min_d (per_pod_d > 0 ?
//                            floor(free_d / per_pod_d) : UNLIMITED), 0)),
//                      eligible only if free_d >= per_pod_d for every d
//   cap[e]  = eligible ? min(cap, host_cap[e]) : 0,  eligible = open & key_ok
//             & tolerated & any(zone & cls_zone) & any(ct & cls_ct) & ...
//   zone_full[e,z] = zone[e,z] & cls_zone[z];  ct_ok[e,c] = ct[e,c] & cls_ct[c]
//
// (existingnode.go:77-130 at class granularity.)  Bound on the H100: bytes.
// At E = 6,144 existing nodes it reads about 45 B and writes 9 B per node,
// 0.33 MB in all: 0.1 us at 3.35 TB/s, far below the launch latency.
// Tenant axis: the rows may be B tenants' nodes stacked ([B, E]), each
// with its own class vectors ([B, ...]); the flat row gives the tenant.  A
// solo call is B = 1.
// Design: one thread per node row; every per-class vector (requests, zones,
// capacity types, ports, volume counts) is a few bytes that every thread
// reads through L1.  Padded rows are closed (open = 0) and come out 0.
//
// Arithmetic matches the reference bit for bit: the subtraction, the add of
// 1e-4 and the divide are separate IEEE round-to-nearest operations
// (`__fsub_rn`, `__fadd_rn`, `__fdiv_rn`; built without --use_fast_math);
// the float-to-int32 conversion saturates as XLA's convert does, so a class
// with no requests (BIG on every resource) gets INT32_MAX; the volume
// counts are int32 that wrap as the reference's do (unsigned arithmetic),
// and their division floors, as jnp's `//` does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 1e30f;
constexpr int32_t kUnlimited = 1 << 30;

__device__ __forceinline__ int32_t sat_i32(float x) {
  // x >= 0 here; XLA converts out-of-range floats to the nearest int32
  return x >= 2147483648.0f ? 2147483647 : static_cast<int32_t>(x);
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
  // b > 0: rounds toward minus infinity, as Python and jnp do
  const int32_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__global__ void __launch_bounds__(kThreads) existing_intake_kernel(
    int n_total, int n_rows, int n_res, int n_zones, int n_ct, int n_ports, int n_drivers,
    int host_ports, int volume_limits,
    const float* __restrict__ alloc,        // [E, R]
    const float* __restrict__ used,         // [E, R]
    const uint8_t* __restrict__ open_,      // [E]
    const uint8_t* __restrict__ key_ok,     // [E]
    const uint8_t* __restrict__ tol,        // [E]
    const uint8_t* __restrict__ zone,       // [E, Z]
    const uint8_t* __restrict__ cls_zone,   // [Z]
    const uint8_t* __restrict__ ct,         // [E, CT]
    const uint8_t* __restrict__ cls_ct,     // [CT]
    const uint8_t* __restrict__ ports,      // [E, P]
    const uint8_t* __restrict__ cls_ports,  // [P]
    const int32_t* __restrict__ vol_limit,  // [E, D]
    const int32_t* __restrict__ vol_used,   // [E, D]
    const int32_t* __restrict__ vol_add,    // [E, D]
    const int32_t* __restrict__ per_pod,    // [D]
    const float* __restrict__ req,          // [R]
    const int32_t* __restrict__ host_cap,   // [E]
    int32_t* __restrict__ cap_out,          // [E]
    uint8_t* __restrict__ zone_full_out,    // [E, Z]
    uint8_t* __restrict__ ct_ok_out) {      // [E, CT]
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_total) return;
  // the row's tenant: its class vectors
  const int tb = e / n_rows;
  cls_zone += (size_t)tb * n_zones;
  cls_ct += (size_t)tb * n_ct;
  cls_ports += (size_t)tb * n_ports;
  per_pod += (size_t)tb * n_drivers;
  req += (size_t)tb * n_res;

  float count = 0.0f;
  for (int r = 0; r < n_res; ++r) {
    const float s = req[r];
    float per = kBig;
    if (s > 0.0f) {
      const float free_r = __fsub_rn(alloc[e * n_res + r], used[e * n_res + r]);
      per = floorf(__fdiv_rn(__fadd_rn(free_r, 1e-4f), fmaxf(s, 1e-9f)));
    }
    per = fmaxf(per, 0.0f);
    count = (r == 0) ? per : fminf(count, per);
  }
  int32_t cap = sat_i32(fminf(count, kBig));

  bool any_zone = false;
  for (int z = 0; z < n_zones; ++z) {
    const bool v = zone[e * n_zones + z] && cls_zone[z];
    zone_full_out[e * n_zones + z] = v ? 1 : 0;
    any_zone |= v;
  }
  bool any_ct = false;
  for (int c = 0; c < n_ct; ++c) {
    const bool v = ct[e * n_ct + c] && cls_ct[c];
    ct_ok_out[e * n_ct + c] = v ? 1 : 0;
    any_ct |= v;
  }
  bool elig = open_[e] && key_ok[e] && tol[e] && any_zone && any_ct;

  if (host_ports) {
    // a port conflict blocks the node; identical pods conflict with each
    // other, so a port-bearing class takes at most one pod per node
    bool has_ports = false;
    bool conflict = false;
    for (int p = 0; p < n_ports; ++p) {
      has_ports |= cls_ports[p] != 0;
      conflict |= ports[e * n_ports + p] && cls_ports[p];
    }
    elig = elig && !conflict;
    const int32_t port_cap = has_ports ? 1 : kUnlimited;
    cap = cap < port_cap ? cap : port_cap;
  }
  if (volume_limits) {
    bool vol_ok = true;
    int32_t cap_vol = 0;
    for (int d = 0; d < n_drivers; ++d) {
      const int32_t free_d = wsub(wsub(vol_limit[e * n_drivers + d], vol_used[e * n_drivers + d]),
                                  vol_add[e * n_drivers + d]);
      const int32_t need = per_pod[d];
      vol_ok = vol_ok && free_d >= need;
      const int32_t c = need > 0 ? floor_div(free_d, need) : kUnlimited;
      cap_vol = (d == 0) ? c : (c < cap_vol ? c : cap_vol);
    }
    cap_vol = cap_vol > 0 ? cap_vol : 0;
    cap = cap < cap_vol ? cap : cap_vol;
    elig = elig && vol_ok;
  }
  const int32_t hc = host_cap[e];
  cap_out[e] = elig ? (cap < hc ? cap : hc) : 0;
}

}  // namespace

extern "C" int kc_existing_intake(
    int n_batch, int n_rows, int n_res, int n_zones, int n_ct, int n_ports, int n_drivers,
    int host_ports, int volume_limits,
    const void* alloc, const void* used, const void* open_, const void* key_ok,
    const void* tol, const void* zone, const void* cls_zone, const void* ct,
    const void* cls_ct, const void* ports, const void* cls_ports, const void* vol_limit,
    const void* vol_used, const void* vol_add, const void* per_pod, const void* req,
    const void* host_cap, void* cap_out, void* zone_full_out, void* ct_ok_out,
    void* stream) {
  const long long total = static_cast<long long>(n_batch) * n_rows;
  if (total <= 0) return 0;
  if (n_drivers <= 0 && volume_limits) return static_cast<int>(cudaErrorInvalidValue);
  if (total > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  existing_intake_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int>(total), n_rows, n_res, n_zones, n_ct, n_ports, n_drivers, host_ports,
      volume_limits,
      static_cast<const float*>(alloc), static_cast<const float*>(used),
      static_cast<const uint8_t*>(open_), static_cast<const uint8_t*>(key_ok),
      static_cast<const uint8_t*>(tol), static_cast<const uint8_t*>(zone),
      static_cast<const uint8_t*>(cls_zone), static_cast<const uint8_t*>(ct),
      static_cast<const uint8_t*>(cls_ct), static_cast<const uint8_t*>(ports),
      static_cast<const uint8_t*>(cls_ports), static_cast<const int32_t*>(vol_limit),
      static_cast<const int32_t*>(vol_used), static_cast<const int32_t*>(vol_add),
      static_cast<const int32_t*>(per_pod), static_cast<const float*>(req),
      static_cast<const int32_t*>(host_cap), static_cast<int32_t*>(cap_out),
      static_cast<uint8_t*>(zone_full_out), static_cast<uint8_t*>(ct_ok_out));
  return static_cast<int>(cudaGetLastError());
}
