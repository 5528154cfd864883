// K6: one placement phase on the existing nodes, around the priority fill.
//
// Replaces `_phase_existing` (karpenter_core_tpu/ops/solve.py:624) but for
// its fill, which is K2 (`_fill_by_priority` :419).  Two entry points:
//
// kc_existing_mask — the caps and priorities the fill takes:
//   zone_ok[e,z] = zone[e,z] & cls_zone[z] & restrict[z]   (the LIVE zone mask)
//   cap[e]       = any_z zone_ok[e,z] ? prep_cap[e] : 0, then 0 where the
//                  extra eligibility (affinity targets, inverse
//                  anti-affinity, rows a zone-committal sweep already used)
//                  is false, then, for a single-node phase, 0 on every row
//                  but the first with cap > 0 (row 0 when there is none)
//   priority[e]  = cap[e] > 0 ? e : INT32_MAX   (index order:
//                  scheduler.go:176-180 tries existing nodes first, in order)
//
// kc_existing_commit — the existing-node state after `assigned` pods of the
// class land (`_phase_existing`'s tail and the committal block's commit):
//   used += assigned * req                   (every row, as the reference)
//   rows with assigned > 0: requirement planes <- merged (K3's output),
//   zone <- zone_new, ct <- ct_ok, ports |= cls_ports (host ports on),
//   vol_used += vol_add + assigned * per_pod (volume limits on)
//   pod_count += assigned
//
// Bound on the H100: bytes.  At E = 6,144 with K = 8 keys of one word the
// commit moves about 0.7 MB (read the state and the merged planes, write
// the state): 0.2 us at 3.35 TB/s; the mask about 0.1 MB.  Both sit far
// below the launch latency.
// Tenant axis: the rows may be B tenants' nodes stacked ([B, E]), each
// with its own class vectors ([B, ...]).  The mask runs one block a tenant
// (grid = B); the commit's flat row gives the tenant.  A solo call is B = 1.
// Design: the mask runs in ONE block of 1024 threads looping over the rows,
// because the single-node pin needs the first eligible row of the whole
// plane: a shared-memory atomicMin finds it between two passes, with no
// second launch and no host read.  The commit is one thread per row over a
// grid; each thread copies its row of every plane.
//
// Arithmetic matches the reference bit for bit: `used + assigned * req` is
// a product rounded to f32 and then a sum rounded to f32 (`__fmul_rn`,
// `__fadd_rn`), never an FMA, which nvcc would otherwise contract it into;
// int32 sums wrap as the reference's do (unsigned arithmetic).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaskThreads = 1024;
constexpr int kCommitThreads = 256;
constexpr int32_t kI32Max = 2147483647;

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

__global__ void __launch_bounds__(kMaskThreads) existing_mask_kernel(
    int n_rows, int n_zones, int has_extra, int single_node,
    const int32_t* __restrict__ prep_cap,   // [E]
    const uint8_t* __restrict__ zone,       // [E, Z]
    const uint8_t* __restrict__ cls_zone,   // [Z]
    const uint8_t* __restrict__ restrict_,  // [Z]
    const uint8_t* __restrict__ extra,      // [E] (has_extra)
    int32_t* __restrict__ cap_out,          // [E]
    int32_t* __restrict__ priority_out,     // [E]
    uint8_t* __restrict__ zone_ok_out) {    // [E, Z]
  // this block's tenant
  const size_t tb = blockIdx.x;
  prep_cap += tb * n_rows;
  zone += tb * n_rows * n_zones;
  cls_zone += tb * n_zones;
  restrict_ += tb * n_zones;
  if (has_extra) extra += tb * n_rows;
  cap_out += tb * n_rows;
  priority_out += tb * n_rows;
  zone_ok_out += tb * n_rows * n_zones;
  __shared__ int first;
  if (threadIdx.x == 0) first = kI32Max;
  __syncthreads();
  for (int e = threadIdx.x; e < n_rows; e += blockDim.x) {
    bool any_zone = false;
    for (int z = 0; z < n_zones; ++z) {
      const bool v = zone[e * n_zones + z] && cls_zone[z] && restrict_[z];
      zone_ok_out[e * n_zones + z] = v ? 1 : 0;
      any_zone |= v;
    }
    int32_t cap = any_zone ? prep_cap[e] : 0;
    if (has_extra && !extra[e]) cap = 0;
    cap_out[e] = cap;
    if (single_node && cap > 0) atomicMin(&first, e);
  }
  __syncthreads();
  // jnp.argmax of an all-False mask is 0
  const int pin = first == kI32Max ? 0 : first;
  for (int e = threadIdx.x; e < n_rows; e += blockDim.x) {
    int32_t cap = cap_out[e];
    if (single_node && e != pin) {
      cap = 0;
      cap_out[e] = 0;
    }
    priority_out[e] = cap > 0 ? e : kI32Max;
  }
}

__global__ void __launch_bounds__(kCommitThreads) existing_commit_kernel(
    int n_total, int n_rows, int n_res, int n_kw, int n_keys, int n_zones, int n_ct, int n_ports,
    int n_drivers, int host_ports, int volume_limits,
    const float* __restrict__ used,          // [E, R]
    const int32_t* __restrict__ kmask,       // [E, K*W]
    const uint8_t* __restrict__ kdef,        // [E, K]
    const uint8_t* __restrict__ kneg,        // [E, K]
    const float* __restrict__ kgt,           // [E, K]
    const float* __restrict__ klt,           // [E, K]
    const uint8_t* __restrict__ zone,        // [E, Z]
    const uint8_t* __restrict__ ct,          // [E, CT]
    const uint8_t* __restrict__ ports,       // [E, P]
    const int32_t* __restrict__ vol_used,    // [E, D]
    const int32_t* __restrict__ pod_count,   // [E]
    const int32_t* __restrict__ m_mask,      // [E, K*W]  merged (K3)
    const uint8_t* __restrict__ m_def,       // [E, K]
    const uint8_t* __restrict__ m_neg,       // [E, K]
    const float* __restrict__ m_gt,          // [E, K]
    const float* __restrict__ m_lt,          // [E, K]
    const uint8_t* __restrict__ zone_new,    // [E, Z]
    const uint8_t* __restrict__ ct_ok,       // [E, CT]
    const uint8_t* __restrict__ cls_ports,   // [P]
    const int32_t* __restrict__ vol_add,     // [E, D]
    const int32_t* __restrict__ per_pod,     // [D]
    const float* __restrict__ req,           // [R]
    const int32_t* __restrict__ assigned,    // [E]
    float* __restrict__ used_out,
    int32_t* __restrict__ kmask_out,
    uint8_t* __restrict__ kdef_out,
    uint8_t* __restrict__ kneg_out,
    float* __restrict__ kgt_out,
    float* __restrict__ klt_out,
    uint8_t* __restrict__ zone_out,
    uint8_t* __restrict__ ct_out,
    uint8_t* __restrict__ ports_out,
    int32_t* __restrict__ vol_used_out,
    int32_t* __restrict__ pod_count_out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_total) return;
  // the row's tenant: its class vectors
  const int tb = e / n_rows;
  cls_ports += (size_t)tb * n_ports;
  per_pod += (size_t)tb * n_drivers;
  req += (size_t)tb * n_res;
  const int32_t a = assigned[e];
  const bool sel = a > 0;
  const float af = static_cast<float>(a);
  for (int r = 0; r < n_res; ++r) {
    used_out[e * n_res + r] = __fadd_rn(used[e * n_res + r], __fmul_rn(af, req[r]));
  }
  for (int j = 0; j < n_kw; ++j) {
    kmask_out[(size_t)e * n_kw + j] = sel ? m_mask[(size_t)e * n_kw + j] : kmask[(size_t)e * n_kw + j];
  }
  for (int k = 0; k < n_keys; ++k) {
    const int i = e * n_keys + k;
    kdef_out[i] = sel ? m_def[i] : kdef[i];
    kneg_out[i] = sel ? m_neg[i] : kneg[i];
    kgt_out[i] = sel ? m_gt[i] : kgt[i];
    klt_out[i] = sel ? m_lt[i] : klt[i];
  }
  for (int z = 0; z < n_zones; ++z) {
    zone_out[e * n_zones + z] = sel ? zone_new[e * n_zones + z] : zone[e * n_zones + z];
  }
  for (int c = 0; c < n_ct; ++c) {
    ct_out[e * n_ct + c] = sel ? ct_ok[e * n_ct + c] : ct[e * n_ct + c];
  }
  for (int p = 0; p < n_ports; ++p) {
    const uint8_t have = ports[e * n_ports + p];
    ports_out[e * n_ports + p] = (host_ports && sel) ? (uint8_t)(have | cls_ports[p]) : have;
  }
  for (int d = 0; d < n_drivers; ++d) {
    const int i = e * n_drivers + d;
    vol_used_out[i] = (volume_limits && sel)
        ? wadd(wadd(vol_used[i], vol_add[i]), wmul(a, per_pod[d]))
        : vol_used[i];
  }
  pod_count_out[e] = wadd(pod_count[e], a);
}

}  // namespace

extern "C" int kc_existing_mask(int n_batch, int n_rows, int n_zones, int has_extra,
                                int single_node,
                                const void* prep_cap, const void* zone, const void* cls_zone,
                                const void* restrict_, const void* extra, void* cap_out,
                                void* priority_out, void* zone_ok_out, void* stream) {
  if (n_rows <= 0 || n_batch <= 0) return 0;
  existing_mask_kernel<<<n_batch, kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n_rows, n_zones, has_extra, single_node, static_cast<const int32_t*>(prep_cap),
      static_cast<const uint8_t*>(zone), static_cast<const uint8_t*>(cls_zone),
      static_cast<const uint8_t*>(restrict_), static_cast<const uint8_t*>(extra),
      static_cast<int32_t*>(cap_out), static_cast<int32_t*>(priority_out),
      static_cast<uint8_t*>(zone_ok_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kc_existing_commit(
    int n_batch, int n_rows, int n_res, int n_kw, int n_keys, int n_zones, int n_ct, int n_ports,
    int n_drivers, int host_ports, int volume_limits,
    const void* used, const void* kmask, const void* kdef, const void* kneg,
    const void* kgt, const void* klt, const void* zone, const void* ct, const void* ports,
    const void* vol_used, const void* pod_count, const void* m_mask, const void* m_def,
    const void* m_neg, const void* m_gt, const void* m_lt, const void* zone_new,
    const void* ct_ok, const void* cls_ports, const void* vol_add, const void* per_pod,
    const void* req, const void* assigned, void* used_out, void* kmask_out,
    void* kdef_out, void* kneg_out, void* kgt_out, void* klt_out, void* zone_out,
    void* ct_out, void* ports_out, void* vol_used_out, void* pod_count_out,
    void* stream) {
  const long long total = static_cast<long long>(n_batch) * n_rows;
  if (total <= 0) return 0;
  if (total > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((total + kCommitThreads - 1) / kCommitThreads);
  existing_commit_kernel<<<blocks, kCommitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int>(total), n_rows, n_res, n_kw, n_keys, n_zones, n_ct, n_ports, n_drivers,
      host_ports,
      volume_limits,
      static_cast<const float*>(used), static_cast<const int32_t*>(kmask),
      static_cast<const uint8_t*>(kdef), static_cast<const uint8_t*>(kneg),
      static_cast<const float*>(kgt), static_cast<const float*>(klt),
      static_cast<const uint8_t*>(zone), static_cast<const uint8_t*>(ct),
      static_cast<const uint8_t*>(ports), static_cast<const int32_t*>(vol_used),
      static_cast<const int32_t*>(pod_count), static_cast<const int32_t*>(m_mask),
      static_cast<const uint8_t*>(m_def), static_cast<const uint8_t*>(m_neg),
      static_cast<const float*>(m_gt), static_cast<const float*>(m_lt),
      static_cast<const uint8_t*>(zone_new), static_cast<const uint8_t*>(ct_ok),
      static_cast<const uint8_t*>(cls_ports), static_cast<const int32_t*>(vol_add),
      static_cast<const int32_t*>(per_pod), static_cast<const float*>(req),
      static_cast<const int32_t*>(assigned), static_cast<float*>(used_out),
      static_cast<int32_t*>(kmask_out), static_cast<uint8_t*>(kdef_out),
      static_cast<uint8_t*>(kneg_out), static_cast<float*>(kgt_out),
      static_cast<float*>(klt_out), static_cast<uint8_t*>(zone_out),
      static_cast<uint8_t*>(ct_out), static_cast<uint8_t*>(ports_out),
      static_cast<int32_t*>(vol_used_out), static_cast<int32_t*>(pod_count_out));
  return static_cast<int>(cudaGetLastError());
}
